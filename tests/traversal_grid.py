"""Shared scene/ray grid for the traversal parity tests.

Every scene kind the renderer builds a BVH for, at every leaf size the
bake supports, with rays aimed into the scene from around it.  Scenes
are built once per (kind, leaf) and process.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import tempfile

import numpy as np
import jax.numpy as jnp

from vulkan_pathtracer_tpu.ops.intersect import MISS_T

SCENES = ["box", "cornell", "columns", "sphere", "atrium", "lbvh",
          "refit", "instanced", "mirrored"]
LEAVES = [4, 8, 14, 28]
N_RAYS = 200  # not a multiple of the kernel's block: exercises padding


@functools.lru_cache(maxsize=None)
def host_scene(kind: str):
    """Host glTF scene for a grid kind (instanced kinds share their
    flat twin's host scene)."""
    from assets import procedural as pr
    from vulkan_pathtracer_tpu.models import gltf

    path = os.path.join(tempfile.mkdtemp(prefix="trav_grid_"),
                        f"{kind}.glb")
    if kind == "box":
        pr.make_box(path)
    elif kind == "cornell":
        pr.make_cornell(path)
    elif kind in ("columns", "lbvh", "refit", "instanced"):
        pr.make_columns(path, grid=3, segments=3, n_materials=4)
    elif kind == "sphere":
        pr.make_textured_sphere(path, lat=12, lon=24)
    elif kind == "atrium":
        pr.make_atrium(path, detail=0.05)
    elif kind == "mirrored":
        # One box mesh, two instances: identity and X-mirrored (a
        # negative-determinant transform flips world winding).
        prim = pr.box_prim((0, 0, 0), (1, 1, 1), 0)
        pr.write_glb(
            path, meshes=[[prim]],
            materials=[pr.MaterialDesc(base_color=(1, 0, 0, 1))],
            nodes=[pr.NodeDesc(mesh=0, translation=(-1.5, 0, 0)),
                   pr.NodeDesc(mesh=0, translation=(1.5, 0, 0),
                               scale=(-1.0, 1.0, 1.0))])
    else:
        raise ValueError(kind)
    return gltf.load(path)


@functools.lru_cache(maxsize=None)
def flat_scene(kind: str):
    """World-space bake without a BVH: the ray bounds for every kind,
    and the brute-force oracle's input for two-level kinds."""
    from vulkan_pathtracer_tpu.models.device_scene import build_device_scene

    return build_device_scene(host_scene(kind), build_bvh=False)


INSTANCED = ("instanced", "mirrored")


@functools.lru_cache(maxsize=None)
def bvh_scene(kind: str, leaf: int):
    """DeviceScene with a BVH at leaf size ``leaf``."""
    from vulkan_pathtracer_tpu.models.device_scene import build_device_scene

    host = host_scene(kind)
    if kind in INSTANCED:
        from vulkan_pathtracer_tpu.models.instanced_scene import (
            build_instanced_scene,
        )

        return build_instanced_scene(host, max_leaf_size=leaf)
    if kind == "lbvh":
        from vulkan_pathtracer_tpu.ops.device_build import (
            device_rebuild_scene,
        )

        template = dataclasses.replace(flat_scene(kind), max_leaf_size=leaf)
        return device_rebuild_scene(
            template, template.tri_v0, template.tri_e1, template.tri_e2,
            template.tri_gn, template.tri_attr)
    if kind == "refit":
        from vulkan_pathtracer_tpu.models.animation import (
            build_animated_scene,
        )

        anim = build_animated_scene(host, max_leaf_size=leaf)
        xf = np.array(anim.initial_transforms(host))
        rng = np.random.default_rng(leaf)
        xf[:, :3, 3] += rng.uniform(-0.5, 0.5, size=(xf.shape[0], 3))
        return anim.with_transforms(jnp.asarray(xf))
    return build_device_scene(host, build_bvh=True, max_leaf_size=leaf)


def oracle_scene(kind: str, leaf: int):
    """Brute-force input with world-space triangles: the BVH scene
    itself (same triangle ids), except for two-level scenes, whose
    triangles are object space — their oracle is the flat bake, and
    only t and hit/miss are comparable."""
    return flat_scene(kind) if kind in INSTANCED else bvh_scene(kind, leaf)


def rays(kind: str, n: int = N_RAYS, seed: int = 0):
    """Rays from a shell around the scene's bounds toward points near
    its centre, so most of them hit something."""
    flat = flat_scene(kind)
    v0 = np.asarray(flat.tri_v0)[: flat.num_triangles]
    lo, hi = v0.min(axis=0), v0.max(axis=0)
    c, ext = (lo + hi) / 2, np.maximum(hi - lo, 1e-3)
    rng = np.random.default_rng(seed)
    o = c + ext * rng.uniform(-0.9, 0.9, size=(n, 3))
    t = c + 0.3 * ext * rng.uniform(-1, 1, size=(n, 3))
    d = t - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (jnp.asarray(o.astype(np.float32)),
            jnp.asarray(d.astype(np.float32)))


def active_mask(n: int, partial: bool):
    return jnp.asarray(np.arange(n) % 3 != 0 if partial
                       else np.ones(n, bool))


def assert_hits_match(got, ref, active, compare_tri: bool = True):
    """Same hit/miss on every ray; t to 1e-5 relative; the same
    triangle except where two triangles tie in t (a shared edge)."""
    g_t, r_t = np.asarray(got.t), np.asarray(ref.t)
    g_hit, r_hit = g_t < MISS_T, r_t < MISS_T
    np.testing.assert_array_equal(g_hit, r_hit)
    assert not g_hit[~np.asarray(active)].any()
    np.testing.assert_allclose(g_t[r_hit], r_t[r_hit], rtol=1e-5)
    if compare_tri:
        g_tri, r_tri = np.asarray(got.tri), np.asarray(ref.tri)
        differ = g_tri != r_tri
        tie = np.abs(g_t - r_t) <= 1e-5 * np.maximum(np.abs(r_t), 1.0)
        assert not (differ & ~tie).any()
