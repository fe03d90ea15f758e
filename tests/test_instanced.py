"""Two-level BVH / instancing vs the flat world-space bake.

The columns scene instantiates per-material column meshes across a
grid (true multi-instance input).  The instanced build must produce
identical hits/images to the flat bake, store geometry once, and
support O(transforms) animation updates.
"""

import copy

import numpy as np
import jax.numpy as jnp
import pytest

from vulkan_pathtracer_tpu.models import gltf
from vulkan_pathtracer_tpu.models.device_scene import build_device_scene
from vulkan_pathtracer_tpu.models.instanced_scene import (
    build_instanced_scene,
    update_instance_transforms,
)
from vulkan_pathtracer_tpu.ops.traverse import bvh_closest_hit


@pytest.fixture(scope="module")
def scenes(request):
    host = gltf.load(request.getfixturevalue("columns_glb"))
    flat = build_device_scene(host, build_bvh=True, max_leaf_size=8)
    inst = build_instanced_scene(host, max_leaf_size=8)
    return host, flat, inst


def _rays(n, seed=3):
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-10, 10, size=(n, 3)).astype(np.float32)
    targets = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    d = targets - origins
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(origins), jnp.asarray(d)


def test_geometry_stored_once(scenes):
    host, flat, inst = scenes
    # Flat bake duplicates each instanced mesh; the instanced build
    # stores each mesh once.
    mesh_tris = sum(
        sum(p.indices.shape[0] // 3
            for p in host.primitives[m.start:m.end])
        for m in host.meshes
    )
    assert inst.num_triangles <= mesh_tris * 2  # block padding only
    assert flat.num_triangles > 2 * inst.num_triangles  # 16 insts/mesh


def test_instanced_traversal_matches_flat(scenes):
    _, flat, inst = scenes
    o, d = _rays(1500)
    ref = bvh_closest_hit(flat, o, d)
    got = bvh_closest_hit(inst, o, d)
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t),
                               rtol=1e-4, atol=1e-4)


def test_instanced_shading_parity(scenes):
    """Interpolated+transformed object-space attributes must match the
    flat bake's pre-transformed ones (linear => equal up to rounding);
    primitive/material payload ids identical (Tlas.zig:43-46 parity:
    instance_custom_index = the mesh's first primitive)."""
    from vulkan_pathtracer_tpu.render.shading import get_triangle_data

    _, flat, inst = scenes
    o, d = _rays(900, seed=11)
    ref_hit = bvh_closest_hit(flat, o, d)
    got_hit = bvh_closest_hit(inst, o, d)
    hit_mask = np.asarray(ref_hit.t) < 1e31
    ref_td = get_triangle_data(flat, ref_hit)
    got_td = get_triangle_data(inst, got_hit)
    np.testing.assert_array_equal(
        np.asarray(got_td.material_index)[hit_mask],
        np.asarray(ref_td.material_index)[hit_mask],
    )
    np.testing.assert_array_equal(
        np.asarray(got_td.primitive_index)[hit_mask],
        np.asarray(ref_td.primitive_index)[hit_mask],
    )
    np.testing.assert_allclose(
        np.asarray(got_td.normal)[hit_mask],
        np.asarray(ref_td.normal)[hit_mask], rtol=1e-3, atol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(got_td.geometry_normal)[hit_mask],
        np.asarray(ref_td.geometry_normal)[hit_mask],
        rtol=1e-3, atol=1e-4,
    )


def test_instanced_render_matches_flat(scenes):
    from vulkan_pathtracer_tpu.models.camera import Camera
    from vulkan_pathtracer_tpu.render.pipeline import render_frame

    _, flat, inst = scenes
    cam = Camera(aspect_ratio=1.0,
                 position=np.array([0, 2, -8], np.float32))
    pos, hor, ver, fwd = (jnp.asarray(v) for v in cam.push_constants())
    kw = dict(num_samples=1, num_bounces=2, width=40, height=40)
    img_a, _ = render_frame(flat, pos, hor, ver, fwd, jnp.uint32(0),
                            traversal="bvh", **kw)
    img_b, _ = render_frame(inst, pos, hor, ver, fwd, jnp.uint32(0),
                            traversal="bvh", **kw)
    np.testing.assert_allclose(np.asarray(img_a), np.asarray(img_b),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.slow
def test_update_instance_transforms(scenes):
    """O(transforms) animation: moving instances on-device must match
    a flat re-bake of the transformed host scene."""
    host, _, inst = scenes
    n_inst = len(host.instances)
    rng = np.random.default_rng(5)
    transforms = np.stack([i.transform for i in host.instances]).astype(
        np.float64
    )
    shift = rng.uniform(-1.5, 1.5, size=(n_inst, 3))
    transforms[:, :3, 3] += shift
    moved = update_instance_transforms(inst, transforms)

    host2 = copy.deepcopy(host)
    for i, t in zip(host2.instances, transforms):
        i.transform = t.astype(np.float32)
    flat2 = build_device_scene(host2, build_bvh=True, max_leaf_size=8)

    o, d = _rays(1200, seed=13)
    ref = bvh_closest_hit(flat2, o, d)
    got = bvh_closest_hit(moved, o, d)
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t),
                               rtol=1e-4, atol=1e-4)

    # The GPU kernel reads the regenerated packed node rows directly.
    from vulkan_pathtracer_tpu.ops.traverse_gpu import gpu_closest_hit

    kg = gpu_closest_hit(moved, o, d, interpret=True)
    np.testing.assert_allclose(np.asarray(kg.t), np.asarray(got.t),
                               rtol=1e-5, atol=1e-5)


def test_mirrored_instance_culling():
    """A negative-determinant instance transform must keep world-space
    backface culling semantics (det_sign flip)."""
    import tempfile

    from assets.procedural import make_box  # noqa: F401  (writer deps)
    from assets import procedural as pr

    # One box mesh, two instances: identity and X-mirrored.
    prim = pr.box_prim((0, 0, 0), (1, 1, 1), 0)
    mats = [pr.MaterialDesc(base_color=(1, 0, 0, 1))]
    nodes = [
        pr.NodeDesc(mesh=0, translation=(-1.5, 0, 0)),
        pr.NodeDesc(mesh=0, translation=(1.5, 0, 0),
                    scale=(-1.0, 1.0, 1.0)),
    ]
    path = tempfile.mktemp(suffix=".glb")
    pr.write_glb(path, meshes=[[prim]], materials=mats, nodes=nodes)
    host = gltf.load(path)
    flat = build_device_scene(host, build_bvh=True, max_leaf_size=8)
    inst = build_instanced_scene(host, max_leaf_size=8)
    o, d = _rays(800, seed=23)
    ref = bvh_closest_hit(flat, o, d)
    got = bvh_closest_hit(inst, o, d)
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t),
                               rtol=1e-4, atol=1e-4)
