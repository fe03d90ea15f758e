"""ANY-HIT traversal (emissive-free last bounce) correctness.

The any-hit query's hit/miss mask must match closest-hit's
``t < MISS_T`` exactly: both evaluate the same per-triangle
Moller-Trumbore accept window, and "does some triangle accept" is an
order-independent OR.  The GPU kernel's any-hit mode is checked in
tests/test_traversal_parity.py.  Render-level: on emissive-free scenes
images match with the any-hit path on or off (hit lanes would only add
emissive x atten == 0; no RNG draws happen on a last bounce).
"""

import numpy as np
import jax.numpy as jnp
import pytest

import vulkan_pathtracer_tpu.render.wavefront as wf
from vulkan_pathtracer_tpu.models import gltf
from vulkan_pathtracer_tpu.models.device_scene import build_device_scene
from vulkan_pathtracer_tpu.ops.intersect import MISS_T


def _anyhit_off(monkeypatch):
    import jax

    monkeypatch.setattr(wf, "_anyhit_enabled", lambda scene: False)
    jax.clear_caches()


@pytest.fixture(scope="module")
def cols_dev(request):
    scene = gltf.load(request.getfixturevalue("columns_glb"))
    return build_device_scene(scene, build_bvh=True)


@pytest.fixture(scope="module")
def atrium_dev(tmp_path_factory):
    """Small emissive-free enclosed scene (the headline atrium's
    materials all have zero emissive factors)."""
    from assets.procedural import make_atrium

    path = str(tmp_path_factory.mktemp("anyhit") / "atrium.glb")
    make_atrium(path, detail=0.08)
    return build_device_scene(gltf.load(path), build_bvh=True)


def _rays(n, seed=3):
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-10, 10, size=(n, 3)).astype(np.float32)
    targets = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    d = targets - origins
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(origins), jnp.asarray(d)


def test_emissive_free_flag(request, atrium_dev):
    assert atrium_dev.emissive_free
    # The columns scene carries one emissive material (its glowing
    # prop) and Cornell has an area light: both must keep closest-hit.
    cols = gltf.load(request.getfixturevalue("columns_glb"))
    assert not build_device_scene(cols, build_bvh=False).emissive_free
    cornell = gltf.load(request.getfixturevalue("cornell_glb"))
    assert not build_device_scene(cornell, build_bvh=False).emissive_free


def test_anyhit_dispatch_and_sorted(cols_dev):
    """_any_hit / _any_hit_sorted agree with the XLA closest-hit
    mask."""
    from vulkan_pathtracer_tpu.ops.traverse import bvh_closest_hit
    from vulkan_pathtracer_tpu.render.wavefront import (
        _any_hit,
        _any_hit_sorted,
    )

    o, d = _rays(1200, seed=7)
    active = jnp.asarray(np.arange(1200) % 5 != 0)
    ref = bvh_closest_hit(cols_dev, o, d, active)
    ref_mask = (np.asarray(ref.t) < MISS_T) & np.asarray(active)
    got = _any_hit(cols_dev, o, d, active, "bvh")
    np.testing.assert_array_equal(np.asarray(got), ref_mask)
    got_s = _any_hit_sorted(cols_dev, o, d, active, "bvh")
    np.testing.assert_array_equal(np.asarray(got_s), ref_mask)


@pytest.mark.slow
def test_render_identical_with_anyhit_off(atrium_dev, monkeypatch):
    """Full render of an emissive-free scene: bit-identical image with
    the any-hit last bounce on vs off."""
    from vulkan_pathtracer_tpu.render.pipeline import render_rows

    dev = atrium_dev
    assert dev.emissive_free
    args = (dev, jnp.asarray([0.0, 2.0, 6.0]),
            jnp.asarray([4.0, 0.0, 0.0]), jnp.asarray([0.0, 2.25, 0.0]),
            jnp.asarray([0.0, 0.0, -1.0]), jnp.uint32(1))
    kw = dict(num_samples=1, num_bounces=2, width=64, height=48,
              traversal="bvh", sort_secondary=True)
    img_on, rays_on = render_rows(*args, **kw)
    _anyhit_off(monkeypatch)
    img_off, rays_off = render_rows(*args, **kw)
    np.testing.assert_array_equal(np.asarray(img_on),
                                  np.asarray(img_off))
    assert float(rays_on) == float(rays_off)


@pytest.mark.slow
def test_pooled_identical_with_anyhit_off(atrium_dev, monkeypatch):
    """Pooled wavefront (frames-in-flight): any-hit last bounce on vs
    off — tight allclose (program-shape reassociation), exact rays."""
    from vulkan_pathtracer_tpu.render.wavefront import (
        trace_wavefront_pooled,
    )

    dev = atrium_dev
    n = 3072
    o, d = _rays(n, seed=23)
    rng = np.random.default_rng(29)
    sx = jnp.asarray(rng.integers(0, 2**32, size=n, dtype=np.uint32))
    sy = jnp.asarray(rng.integers(0, 2**32, size=n, dtype=np.uint32))
    kw = dict(num_bounces=2, traversal="bvh", sort_secondary=True,
              chunk=1024)
    c_on, r_on = trace_wavefront_pooled(dev, o, d, sx, sy, **kw)
    _anyhit_off(monkeypatch)
    c_off, r_off = trace_wavefront_pooled(dev, o, d, sx, sy, **kw)
    np.testing.assert_allclose(np.asarray(c_on), np.asarray(c_off),
                               rtol=1e-6, atol=1e-6)
    assert float(r_on) == float(r_off)


@pytest.mark.slow
def test_progressive_batch_identical_with_anyhit_off(atrium_dev,
                                                     monkeypatch):
    """Joint progressive batch (the convergence path): bit-identical
    sum image with the any-hit last bounce on vs off."""
    from vulkan_pathtracer_tpu.render.wavefront import (
        trace_progressive_batch,
    )

    dev = atrium_dev
    n = 2048
    o, d = _rays(n, seed=13)
    rng = np.random.default_rng(21)
    sx = jnp.asarray(rng.integers(0, 2**32, size=(4, n), dtype=np.uint32))
    sy = jnp.asarray(rng.integers(0, 2**32, size=(4, n), dtype=np.uint32))
    kw = dict(batch=4, num_bounces=3, traversal="bvh",
              sort_secondary=True, chunk=1024)
    c_on, r_on = trace_progressive_batch(dev, o, d, sx, sy, **kw)
    _anyhit_off(monkeypatch)
    c_off, r_off = trace_progressive_batch(dev, o, d, sx, sy, **kw)
    # The two last-bounce lax.map programs differ in shape, so XLA
    # fuses the (identical) sky math differently: ~1 ulp on a handful
    # of elements (same class as the documented chunked-vs-unchunked
    # reassociation).  Hit/miss masks and ray counts are exact.
    np.testing.assert_allclose(np.asarray(c_on), np.asarray(c_off),
                               rtol=1e-6, atol=1e-6)
    assert float(r_on) == float(r_off)
