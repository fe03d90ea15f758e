"""Traversal dispatch policy: which traversal each mode runs where.

``auto`` runs the GPU kernel on a GPU and the XLA loop elsewhere;
``bvh`` and ``brute`` are explicit references on every platform; the
kernel's interpret mode is never chosen by the render path.  The
platform is faked by patching ``jax.default_backend`` as the wavefront
module sees it, and the kernel entry points are replaced by spies, so
nothing here needs a GPU.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from vulkan_pathtracer_tpu.models import gltf
from vulkan_pathtracer_tpu.models.device_scene import build_device_scene
from vulkan_pathtracer_tpu.ops import traverse_gpu
from vulkan_pathtracer_tpu.ops.traverse import bvh_closest_hit
from vulkan_pathtracer_tpu.render import wavefront as wf


@pytest.fixture(scope="module")
def small_dev(request):
    scene = gltf.load(request.getfixturevalue("columns_glb"))
    return build_device_scene(scene, build_bvh=True, max_leaf_size=14)


@pytest.fixture
def rays():
    rng = np.random.default_rng(0)
    o = jnp.asarray(rng.uniform(-5, 5, (64, 3)).astype(np.float32))
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, jnp.asarray(d)


@pytest.fixture
def kernel_spy(monkeypatch):
    """Replace the kernel entry points with spies that record their
    keyword arguments and answer with the XLA reference."""
    calls = []

    def closest(scene, o, d, active=None, seed=None, **kw):
        calls.append(("closest", kw))
        return bvh_closest_hit(scene, o, d, active, seed=seed)

    def anyhit(scene, o, d, active=None, **kw):
        calls.append(("any", kw))
        h = bvh_closest_hit(scene, o, d, active).tri >= 0
        return h

    monkeypatch.setattr(traverse_gpu, "gpu_closest_hit", closest)
    monkeypatch.setattr(traverse_gpu, "gpu_any_hit", anyhit)
    return calls


def _fake_backend(monkeypatch, name):
    monkeypatch.setattr(wf.jax, "default_backend", lambda: name)


def test_size_keyed_leaf_policy():
    # One shared policy function (utils/config.py) feeds both the app
    # and bench defaults.
    from vulkan_pathtracer_tpu.utils.config import (
        LEAF28_MIN_TRIS,
        default_max_leaf,
    )

    assert default_max_leaf(0) == 14
    assert default_max_leaf(LEAF28_MIN_TRIS - 1) == 14
    assert default_max_leaf(LEAF28_MIN_TRIS) == 28
    assert default_max_leaf(3_300_000) == 28


def test_auto_on_cpu_runs_xla(small_dev, rays, kernel_spy):
    o, d = rays
    assert not wf._use_kernel(small_dev, "auto")
    hit = wf._closest_hit(small_dev, o, d, None, "auto")
    ref = bvh_closest_hit(small_dev, o, d)
    np.testing.assert_array_equal(np.asarray(hit.tri), np.asarray(ref.tri))
    wf._any_hit(small_dev, o, d, None, "auto")
    assert kernel_spy == []


def test_auto_on_gpu_runs_kernel_compiled(small_dev, rays, kernel_spy,
                                          monkeypatch):
    """On a GPU ``auto`` dispatches both kernel modes, never with
    interpret mode (the render path passes no interpret flag)."""
    _fake_backend(monkeypatch, "gpu")
    o, d = rays
    wf._closest_hit(small_dev, o, d, None, "auto")
    wf._any_hit(small_dev, o, d, None, "auto")
    assert [c[0] for c in kernel_spy] == ["closest", "any"]
    assert all(not kw.get("interpret", False) for _, kw in kernel_spy)


@pytest.mark.parametrize("traversal", ["bvh", "brute"])
def test_explicit_references_never_run_kernel(small_dev, rays, kernel_spy,
                                              monkeypatch, traversal):
    _fake_backend(monkeypatch, "gpu")
    o, d = rays
    hit = wf._closest_hit(small_dev, o, d, None, traversal)
    ref = bvh_closest_hit(small_dev, o, d)
    np.testing.assert_array_equal(np.asarray(hit.t < 1e32),
                                  np.asarray(ref.t < 1e32))
    wf._any_hit(small_dev, o, d, None, traversal)
    assert kernel_spy == []


def test_no_bvh_auto_runs_brute_force(request, monkeypatch, kernel_spy):
    _fake_backend(monkeypatch, "gpu")
    scene = gltf.load(request.getfixturevalue("box_glb"))
    dev = build_device_scene(scene, build_bvh=False)
    assert not wf._use_kernel(dev, "auto")
    o = jnp.zeros((8, 3), jnp.float32)
    d = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32), (8, 1))
    hit = wf._closest_hit(dev, o, d, None, "auto")
    assert hit.t.shape == (8,)
    assert kernel_spy == []


def test_anyhit_enabled_follows_emissive_free(small_dev, monkeypatch):
    monkeypatch.setattr(small_dev, "emissive_free", True)
    assert wf._anyhit_enabled(small_dev)
    monkeypatch.setattr(small_dev, "emissive_free", False)
    assert not wf._anyhit_enabled(small_dev)
