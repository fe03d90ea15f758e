"""Multi-chip sharding on the 8-device virtual CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vulkan_pathtracer_tpu.models import gltf
from vulkan_pathtracer_tpu.models.camera import Camera
from vulkan_pathtracer_tpu.models.device_scene import build_device_scene
from vulkan_pathtracer_tpu.parallel.mesh import make_render_mesh
from vulkan_pathtracer_tpu.parallel.sharding import (
    make_sharded_render,
    replicate_scene,
)
from vulkan_pathtracer_tpu.render.pipeline import render_frame


@pytest.fixture(scope="module")
def box_dev(request):
    scene = gltf.load(request.getfixturevalue("box_glb"))
    return build_device_scene(scene, build_bvh=True)


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_tiled_render_matches_single_chip(box_dev):
    mesh = make_render_mesh(8)
    dev = replicate_scene(box_dev, mesh)
    cam = Camera(aspect_ratio=1.0, position=np.array([0, 0, -3], np.float32))
    pos, hor, ver, fwd = (jnp.asarray(v) for v in cam.push_constants())

    height, width = 32, 32
    sharded = make_sharded_render(
        mesh, dev, num_samples=1, num_bounces=2,
        width=width, height=height, traversal="bvh",
    )
    img_sharded, rays_sharded = sharded(dev, pos, hor, ver, fwd, jnp.uint32(0))

    img_single, rays_single = render_frame(
        box_dev, pos, hor, ver, fwd, jnp.uint32(0),
        num_samples=1, num_bounces=2, width=width, height=height,
        traversal="bvh",
    )
    # Tile decomposition must be exact: same pixels, same RNG streams.
    np.testing.assert_array_equal(np.asarray(img_sharded),
                                  np.asarray(img_single))
    assert float(rays_sharded) == float(rays_single)


def test_spp_mode_runs(box_dev):
    mesh = make_render_mesh(4)
    dev = replicate_scene(box_dev, mesh)
    cam = Camera(aspect_ratio=1.0, position=np.array([0, 0, -3], np.float32))
    pos, hor, ver, fwd = (jnp.asarray(v) for v in cam.push_constants())
    sharded = make_sharded_render(
        mesh, dev, num_samples=1, num_bounces=2,
        width=16, height=16, traversal="bvh", mode="spp",
    )
    img, rays = sharded(dev, pos, hor, ver, fwd, jnp.uint32(0))
    img = np.asarray(img)
    assert img.shape == (16, 16, 3)
    assert np.isfinite(img).all()
    # 4 devices x full frame of rays each
    assert float(rays) >= 4 * 16 * 16


def test_height_divisibility_error(box_dev):
    mesh = make_render_mesh(8)
    with pytest.raises(ValueError):
        make_sharded_render(mesh, box_dev, num_samples=1, num_bounces=2,
                            width=16, height=17)


@pytest.mark.slow
def test_graft_entry_dryrun():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_graft_entry_single():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    image, rays = fn(*args)
    image = np.asarray(image)
    assert image.shape == (64, 64, 3)
    assert np.isfinite(image).all()


def test_instanced_scene_sharded_tiles(columns_glb):
    """Two-level (instanced) scenes replicate across the mesh and the
    sharded tile render matches the single-chip instanced render."""
    import jax.numpy as jnp

    from vulkan_pathtracer_tpu.models import gltf
    from vulkan_pathtracer_tpu.models.camera import Camera
    from vulkan_pathtracer_tpu.models.instanced_scene import (
        build_instanced_scene,
    )
    from vulkan_pathtracer_tpu.parallel.mesh import make_render_mesh
    from vulkan_pathtracer_tpu.parallel.sharding import (
        make_sharded_render,
        replicate_scene,
    )
    from vulkan_pathtracer_tpu.render.pipeline import render_frame

    host = gltf.load(columns_glb)
    inst = build_instanced_scene(host, max_leaf_size=8)
    cam = Camera(aspect_ratio=1.0,
                 position=np.array([0, 2, -8], np.float32))
    pos, hor, ver, fwd = (jnp.asarray(v) for v in cam.push_constants())
    kw = dict(num_samples=1, num_bounces=2, width=16, height=32,
              traversal="bvh")

    ref, _ = render_frame(inst, pos, hor, ver, fwd, jnp.uint32(0), **kw)

    mesh = make_render_mesh(8)
    dev = replicate_scene(inst, mesh)
    render = make_sharded_render(mesh, dev, mode="tiles", **kw)
    img, _ = render(dev, pos, hor, ver, fwd, jnp.uint32(0))
    np.testing.assert_allclose(np.asarray(img), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
