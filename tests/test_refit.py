"""BVH refit + animated scene rebake (the TLAS-refit analog)."""

import numpy as np
import jax.numpy as jnp

from vulkan_pathtracer_tpu.models import gltf
from vulkan_pathtracer_tpu.models.animation import build_animated_scene
from vulkan_pathtracer_tpu.models.camera import Camera
from vulkan_pathtracer_tpu.models.device_scene import build_device_scene
from vulkan_pathtracer_tpu.ops.refit import refit_scene
from vulkan_pathtracer_tpu.render.pipeline import RenderPipeline, render_frame
from vulkan_pathtracer_tpu.utils.config import RenderConfig


def test_refit_reproduces_build_bounds(columns_glb):
    """Refitting the unmodified scene must reproduce the build AABBs."""
    scene = gltf.load(columns_glb)
    dev = build_device_scene(scene, build_bvh=True)
    refitted = refit_scene(dev)
    np.testing.assert_allclose(
        np.asarray(refitted.bvh_bmin), np.asarray(dev.bvh_bmin),
        rtol=1e-6, atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(refitted.bvh_bmax), np.asarray(dev.bvh_bmax),
        rtol=1e-6, atol=1e-6,
    )


def test_animated_identity_matches_static(box_glb):
    scene = gltf.load(box_glb)
    anim = build_animated_scene(scene)
    transforms = anim.initial_transforms(scene)
    dev = anim.with_transforms(transforms)

    np.testing.assert_allclose(
        np.asarray(dev.tri_v0), np.asarray(anim.base.tri_v0), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(dev.bvh_bmin), np.asarray(anim.base.bvh_bmin), atol=1e-5
    )


def test_animated_translation_moves_hits(box_glb):
    scene = gltf.load(box_glb)
    anim = build_animated_scene(scene)
    t0 = np.asarray(anim.initial_transforms(scene))

    cam = Camera(aspect_ratio=1.0, position=np.array([0, 0, -3], np.float32))
    pos, hor, ver, fwd = (jnp.asarray(v) for v in cam.push_constants())

    def render(dev):
        img, _ = render_frame(
            dev, pos, hor, ver, fwd, jnp.uint32(0),
            num_samples=1, num_bounces=2, width=32, height=32,
            traversal="bvh",
        )
        return np.asarray(img)

    img_before = render(anim.with_transforms(jnp.asarray(t0)))
    # Move the box out of view.
    t1 = t0.copy()
    t1[0, :3, 3] += np.array([100.0, 0.0, 0.0])
    img_after = render(anim.with_transforms(jnp.asarray(t1)))

    # After the move every pixel is sky (blue >= red, strictly positive).
    assert (img_after[..., 2] >= img_after[..., 0]).all()
    assert img_after.min() > 0.1
    # Before the move the box occludes the center: images must differ.
    patch_b = img_before[12:20, 12:20]
    patch_a = img_after[12:20, 12:20]
    assert np.abs(patch_b - patch_a).max() > 0.05


def test_animated_rotation_keeps_finite(columns_glb):
    scene = gltf.load(columns_glb)
    anim = build_animated_scene(scene)
    t = np.asarray(anim.initial_transforms(scene))
    # Rotate all instances 45 deg about Y.
    c, s = np.cos(np.pi / 4), np.sin(np.pi / 4)
    R = np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]],
                 np.float32)
    t2 = np.einsum("ij,njk->nik", R, t)
    dev = anim.with_transforms(jnp.asarray(t2))

    cam = Camera(aspect_ratio=1.0, position=np.array([0, 3, -10], np.float32))
    pos, hor, ver, fwd = (jnp.asarray(v) for v in cam.push_constants())
    img, _ = render_frame(
        dev, pos, hor, ver, fwd, jnp.uint32(0),
        num_samples=1, num_bounces=2, width=32, height=32, traversal="bvh",
    )
    assert np.isfinite(np.asarray(img)).all()


def test_ray_chunking_is_exact(box_glb):
    """Chunked dispatch must be bit-identical to unchunked."""
    scene = gltf.load(box_glb)
    dev = build_device_scene(scene, build_bvh=True)
    cam = Camera(aspect_ratio=1.0, position=np.array([0.3, 0.2, -3], np.float32))
    pos, hor, ver, fwd = (jnp.asarray(v) for v in cam.push_constants())

    kwargs = dict(num_samples=2, num_bounces=2, width=32, height=32,
                  traversal="bvh")
    img_a, rays_a = render_frame(dev, pos, hor, ver, fwd, jnp.uint32(1),
                                 ray_chunk=0, **kwargs)
    img_b, rays_b = render_frame(dev, pos, hor, ver, fwd, jnp.uint32(1),
                                 ray_chunk=256, **kwargs)
    # Different XLA fusion decisions between the two programs allow
    # 1-ulp drift; the sampling decisions themselves must agree.
    np.testing.assert_allclose(np.asarray(img_a), np.asarray(img_b),
                               atol=1e-6)
    assert float(rays_a) == float(rays_b)
