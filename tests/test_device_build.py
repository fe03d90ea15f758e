"""Device-side LBVH build (ops/device_build.py): tree invariants,
traversal parity vs brute force, and the deforming-geometry per-frame
rebuild (SURVEY §7 M2; reference analog RaytracingPass.zig:451-465)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vulkan_pathtracer_tpu.models import gltf
from vulkan_pathtracer_tpu.models.device_scene import build_device_scene
from vulkan_pathtracer_tpu.ops.device_build import (
    build_radix_tree,
    device_build_bvh,
    device_rebuild_scene,
    morton_codes_device,
)
from vulkan_pathtracer_tpu.ops.intersect import brute_force_closest_hit
from vulkan_pathtracer_tpu.ops.traverse import bvh_closest_hit


def _rand_tris(n, seed=0, lo=-4.0, hi=4.0):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    e1 = rng.uniform(-0.4, 0.4, size=(n, 3)).astype(np.float32)
    e2 = rng.uniform(-0.4, 0.4, size=(n, 3)).astype(np.float32)
    return jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2)


def _rays(n, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, size=(n, 3)).astype(np.float32)
    tgt = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d.astype(np.float32))


def test_radix_tree_structure():
    """Every internal node's children partition its leaf range; every
    leaf is reachable exactly once (random + duplicate-code cases)."""
    rng = np.random.default_rng(3)
    for codes in (
        np.sort(rng.integers(0, 1 << 30, 64, dtype=np.uint32)),
        np.sort(np.repeat(
            rng.integers(0, 1 << 30, 8, dtype=np.uint32), 8)),
        np.zeros(16, np.uint32),  # all duplicates
    ):
        L = codes.shape[0]
        tree = jax.tree_util.tree_map(
            np.asarray, build_radix_tree(jnp.asarray(codes)))
        leaf_base = L - 1
        for i in range(L - 1):
            l, r = tree.left[i], tree.right[i]
            fl = tree.first[l] if l < leaf_base else l - leaf_base
            ll = tree.last[l] if l < leaf_base else l - leaf_base
            fr = tree.first[r] if r < leaf_base else r - leaf_base
            lr = tree.last[r] if r < leaf_base else r - leaf_base
            assert fl == tree.first[i]
            assert lr == tree.last[i]
            assert ll + 1 == fr
        # Reachability from the root (node with full range).
        roots = [i for i in range(L - 1)
                 if tree.first[i] == 0 and tree.last[i] == L - 1]
        assert roots, "no root spans the full range"
        seen = set()
        stack = [roots[0]]
        while stack:
            n = stack.pop()
            assert n not in seen
            seen.add(n)
            if n < leaf_base:
                stack.append(int(tree.left[n]))
                stack.append(int(tree.right[n]))
        assert len(seen) == 2 * L - 1


@pytest.mark.parametrize("n_tris", [5, 100, 1000])
def test_device_build_invariants(n_tris):
    """validate_bvh-style checks per octant on the device-built
    arrays: skip pointers escape monotonically, leaf ranges cover all
    slots once, every node box contains its leaf triangles."""
    v0, e1, e2 = _rand_tris(n_tris)
    built = device_build_bvh(v0, e1, e2, num_triangles=n_tris,
                             block=8, octants=8)
    n_nodes = built["n_nodes"]
    bmin = np.asarray(built["bmin"]).reshape(8, n_nodes, 3)
    bmax = np.asarray(built["bmax"]).reshape(8, n_nodes, 3)
    skip = np.asarray(built["skip_local"]).reshape(8, n_nodes)
    lf = np.asarray(built["leaf_first"]).reshape(8, n_nodes)
    lc = np.asarray(built["leaf_count"]).reshape(8, n_nodes)
    sv0 = np.asarray(built["tri_v0"])
    sv1 = sv0 + np.asarray(built["tri_e1"])
    sv2 = sv0 + np.asarray(built["tri_e2"])
    tmin = np.minimum(np.minimum(sv0, sv1), sv2)
    tmax = np.maximum(np.maximum(sv0, sv1), sv2)
    for o in range(8):
        covered = np.zeros(sv0.shape[0], np.int32)
        for n in range(n_nodes):
            assert skip[o, n] > n
            if lf[o, n] >= 0:
                a, c = lf[o, n], lc[o, n]
                covered[a:a + c] += 1
                eps = 1e-4
                assert (tmin[a:a + c] >= bmin[o, n] - eps).all()
                assert (tmax[a:a + c] <= bmax[o, n] + eps).all()
        assert (covered[:n_tris] == 1).all()
        # Padding slots are never covered... they belong to the last
        # block: covered only if within the last leaf's count.
        order = np.asarray(built["tri_order"])
        assert sorted(order.tolist()) == list(range(n_tris))


def test_device_build_traversal_parity(columns_glb):
    """Render-grade parity: XLA skip-pointer traversal over the
    device-built scene == brute force over the same triangles."""
    host = gltf.load(columns_glb)
    template = build_device_scene(host, build_bvh=False)
    rebuilt = device_rebuild_scene(
        template, template.tri_v0, template.tri_e1, template.tri_e2,
        template.tri_gn, template.tri_attr)
    o, d = _rays(1000)
    ref = brute_force_closest_hit(template, o, d)
    got = bvh_closest_hit(rebuilt, o, d)
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t),
                               rtol=1e-5, atol=1e-5)
    # tri ids map through tri_order: compare world hit points instead.
    hit_ref = np.asarray(o) + np.asarray(ref.t)[:, None] * np.asarray(d)
    hit_got = np.asarray(o) + np.asarray(got.t)[:, None] * np.asarray(d)
    np.testing.assert_allclose(hit_got, hit_ref, rtol=1e-4, atol=1e-4)


def test_deforming_rebuild_per_frame(columns_glb):
    """DEFORMING geometry: bend the mesh with a frame-dependent
    warp, rebuild on device each frame (one jitted call), and check
    hits match brute force over the deformed triangles."""
    host = gltf.load(columns_glb)
    template = build_device_scene(host, build_bvh=False)
    t = template.num_triangles

    @jax.jit
    def deform(phase):
        v0, e1, e2 = template.tri_v0, template.tri_e1, template.tri_e2
        # Nonlinear warp: twist around y by a height-dependent angle.
        def warp(p):
            ang = 0.3 * jnp.sin(phase) * p[:, 1:2]
            ca, sa = jnp.cos(ang), jnp.sin(ang)
            x = ca[:, 0] * p[:, 0] - sa[:, 0] * p[:, 2]
            z = sa[:, 0] * p[:, 0] + ca[:, 0] * p[:, 2]
            return jnp.stack([x, p[:, 1], z], axis=1)

        w0 = warp(v0)
        w1 = warp(v0 + e1)
        w2 = warp(v0 + e2)
        gn = jnp.cross(w1 - w0, w2 - w0)
        return w0, w1 - w0, w2 - w0, gn

    @jax.jit
    def rebuild(phase):
        w0, we1, we2, gn = deform(phase)
        return device_rebuild_scene(template, w0, we1, we2, gn,
                                    template.tri_attr)

    o, d = _rays(500, seed=9)
    for phase in (0.0, 1.0):
        scene_f = rebuild(jnp.float32(phase))
        w0, we1, we2, _ = deform(jnp.float32(phase))
        plain = dataclasses.replace(
            template, tri_v0=w0, tri_e1=we1, tri_e2=we2)
        ref = brute_force_closest_hit(plain, o, d)
        got = bvh_closest_hit(scene_f, o, d)
        np.testing.assert_allclose(np.asarray(got.t),
                                   np.asarray(ref.t),
                                   rtol=1e-5, atol=1e-5)
