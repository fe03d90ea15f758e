"""BVH build invariants + traversal == brute force (SURVEY.md §4 plan)."""

import numpy as np
import jax.numpy as jnp
import pytest

from vulkan_pathtracer_tpu.models import gltf
from vulkan_pathtracer_tpu.models.device_scene import build_device_scene
from vulkan_pathtracer_tpu.ops.bvh import build_bvh_host, validate_bvh
from vulkan_pathtracer_tpu.ops.intersect import brute_force_closest_hit
from vulkan_pathtracer_tpu.ops.traverse import bvh_closest_hit


def random_triangles(rng, n, spread=10.0, size=0.5):
    v0 = rng.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
    e1 = rng.normal(size=(n, 3)).astype(np.float32) * size
    e2 = rng.normal(size=(n, 3)).astype(np.float32) * size
    return v0, e1, e2


def test_bvh_invariants_random():
    rng = np.random.default_rng(5)
    v0, e1, e2 = random_triangles(rng, 1000)
    bvh = build_bvh_host(v0, e1, e2, max_leaf_size=4)
    validate_bvh(bvh, v0[bvh.tri_order], e1[bvh.tri_order], e2[bvh.tri_order])
    assert bvh.skip[0] == bvh.node_count


def test_bvh_single_triangle():
    v0 = np.zeros((1, 3), np.float32)
    e1 = np.array([[1, 0, 0]], np.float32)
    e2 = np.array([[0, 1, 0]], np.float32)
    bvh = build_bvh_host(v0, e1, e2)
    assert bvh.node_count == 1
    assert bvh.leaf_first[0] == 0 and bvh.leaf_count[0] == 1


@pytest.mark.parametrize("scene_fixture", ["box_glb", "columns_glb"])
def test_traversal_matches_brute_force(scene_fixture, request):
    scene = gltf.load(request.getfixturevalue(scene_fixture))
    dev = build_device_scene(scene, build_bvh=True)
    assert dev.has_bvh

    rng = np.random.default_rng(9)
    n = 512
    # rays from a shell looking inward + some outward (misses)
    origins = rng.uniform(-12, 12, size=(n, 3)).astype(np.float32)
    targets = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    dirs = targets - origins
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)

    o = jnp.asarray(origins)
    d = jnp.asarray(dirs)
    brute = brute_force_closest_hit(dev, o, d)
    trav = bvh_closest_hit(dev, o, d)

    np.testing.assert_allclose(
        np.asarray(trav.t), np.asarray(brute.t), rtol=1e-5, atol=1e-5
    )
    # Same triangle except possible exact-tie cases.
    same = np.asarray(trav.tri) == np.asarray(brute.tri)
    assert same.mean() > 0.99


def test_traversal_respects_active_mask(box_glb):
    scene = gltf.load(box_glb)
    dev = build_device_scene(scene, build_bvh=True)
    o = jnp.tile(jnp.array([[0.0, 0.0, -3.0]], jnp.float32), (4, 1))
    d = jnp.tile(jnp.array([[0.0, 0.0, 1.0]], jnp.float32), (4, 1))
    active = jnp.array([True, False, True, False])
    hit = bvh_closest_hit(dev, o, d, active=active)
    t = np.asarray(hit.t)
    assert t[0] < 1e31 and t[2] < 1e31
    assert t[1] >= 1e31 and t[3] >= 1e31


def test_leaf_order_contiguous(columns_glb):
    scene = gltf.load(columns_glb)
    dev = build_device_scene(scene, build_bvh=True)
    first = np.asarray(dev.bvh_leaf_first)
    count = np.asarray(dev.bvh_leaf_count)
    leaves = first >= 0
    total = count[leaves].sum()
    # Leaf ranges cover every triangle once per octant order.
    assert total == dev.num_triangles * dev.bvh_orders


def test_octant_orders_consistent(columns_glb):
    """Each octant block is a permutation of the build-order nodes and
    its skip pointers stay within the block."""
    scene = gltf.load(columns_glb)
    dev = build_device_scene(scene, build_bvh=True)
    assert dev.bvh_orders == 8
    n = np.asarray(dev.bvh_skip).shape[0] // 8
    perm = np.asarray(dev.bvh_perm).reshape(8, n)
    skip = np.asarray(dev.bvh_skip).reshape(8, n)
    for o in range(8):
        assert sorted(perm[o]) == list(range(n))
        assert (skip[o] > o * n).all() and (skip[o] <= (o + 1) * n).all()
    # Octant 0 root must be the build root.
    assert perm[0, 0] == 0
