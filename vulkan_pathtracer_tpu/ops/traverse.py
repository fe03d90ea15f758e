"""Stackless BVH traversal over skip-pointer-linearized nodes — the
plain XLA reference.

The reference gets traversal from the hardware TLAS behind
``traceRayEXT`` (ray_gen.rgen:50-63).  Skip-pointer (escape-index)
traversal keeps per-ray state at O(1), with no stack:

    state      = one int32 node cursor per ray
    box hit    -> cursor + 1          (preorder: first child)
    miss/leaf  -> skip[cursor]        (escape the subtree)
    done       <=> cursor == n_nodes

Every while-loop iteration advances *all* rays by one node: an AABB
slab test plus, for rays sitting on a leaf, a max_leaf_size-unrolled
Möller–Trumbore against the leaf's contiguous triangle block.  Rays
that finish early idle until the slowest ray in the dispatch finishes.
All node/triangle fetches are ``jnp.take`` gathers.

On a GPU the same algorithm runs per ray in ``ops.traverse_gpu``;
this module stays the reference it is tested against.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from vulkan_pathtracer_tpu.ops.intersect import (
    MISS_T,
    TMAX,
    TMIN,
    Hit,
    moller_trumbore,
)


def _safe_inv(d):
    eps = jnp.float32(1e-20)
    return 1.0 / jnp.where(
        jnp.abs(d) < eps, jnp.where(d >= 0.0, eps, -eps), d
    )


def bvh_closest_hit(scene, origin, direction, active=None,
                    tmin=TMIN, tmax=TMAX, seed=None) -> Hit:
    """Closest-hit query for a batch of rays against scene's BVH.

    scene: DeviceScene with bvh_* arrays present.
    origin, direction: (N, 3) f32. active: optional (N,) bool.
    seed: optional prior Hit that pre-tightens t_best (results
    unchanged — the seed is itself a valid hit).
    """
    max_leaf_size = scene.max_leaf_size
    n = origin.shape[0]
    n_nodes = scene.bvh_skip.shape[0] // scene.bvh_orders

    inv_d = _safe_inv(direction)

    # Direction octant selects the near-first linearization
    # (bvh_orders == 8); with a single order every ray uses block 0.
    if scene.bvh_orders == 8:
        octant = (
            (direction[:, 0] < 0).astype(jnp.int32)
            + 2 * (direction[:, 1] < 0).astype(jnp.int32)
            + 4 * (direction[:, 2] < 0).astype(jnp.int32)
        )
        base = octant * jnp.int32(n_nodes)
    else:
        base = jnp.zeros((n,), dtype=jnp.int32)
    done_sentinel = base + jnp.int32(n_nodes)  # per ray

    node0 = base
    if active is not None:
        node0 = jnp.where(active, node0, done_sentinel)

    if seed is not None:
        t0 = seed.t
        tri0 = seed.tri
        u0 = seed.u
        v0_ = seed.v
    else:
        t0 = jnp.full((n,), MISS_T, dtype=jnp.float32)
        tri0 = jnp.full((n,), -1, dtype=jnp.int32)
        u0 = jnp.zeros((n,), dtype=jnp.float32)
        v0_ = jnp.zeros((n,), dtype=jnp.float32)

    ox, oy, oz = origin[:, 0], origin[:, 1], origin[:, 2]
    ix, iy, iz = inv_d[:, 0], inv_d[:, 1], inv_d[:, 2]

    use_packed = getattr(scene, "bvh_packed", None) is not None
    n_blocks = scene.tri_blocks.shape[0] if use_packed else 0

    def cond(state):
        node, *_ = state
        return jnp.any(node < done_sentinel)

    def body(state):
        node, t_best, tri_best, u_best, v_best = state
        live = node < done_sentinel
        nd = jnp.minimum(node, done_sentinel - 1)  # clamp within block

        if use_packed:
            # ONE row gather for the whole node record.
            rec = jnp.take(scene.bvh_packed, nd, axis=0)  # (N, 8)
            bmin = rec[:, 0:3]
            bmax = rec[:, 3:6]
            # Packed skips are octant-local; rebase per ray.
            skip = jax.lax.bitcast_convert_type(rec[:, 6], jnp.int32) + base
            leaf_first = jax.lax.bitcast_convert_type(rec[:, 7], jnp.int32)
        else:
            bmin = jnp.take(scene.bvh_bmin, nd, axis=0)
            bmax = jnp.take(scene.bvh_bmax, nd, axis=0)
            skip = jnp.take(scene.bvh_skip, nd, axis=0)
            leaf_first = jnp.take(scene.bvh_leaf_first, nd, axis=0)

        # Slab test against [tmin, min(t_best, tmax)].
        tx0 = (bmin[:, 0] - ox) * ix
        tx1 = (bmax[:, 0] - ox) * ix
        ty0 = (bmin[:, 1] - oy) * iy
        ty1 = (bmax[:, 1] - oy) * iy
        tz0 = (bmin[:, 2] - oz) * iz
        tz1 = (bmax[:, 2] - oz) * iz
        tn = jnp.maximum(
            jnp.maximum(jnp.minimum(tx0, tx1), jnp.minimum(ty0, ty1)),
            jnp.maximum(jnp.minimum(tz0, tz1), jnp.float32(tmin)),
        )
        t_limit = jnp.minimum(t_best, jnp.float32(tmax))
        tf = jnp.minimum(
            jnp.minimum(jnp.maximum(tx0, tx1), jnp.maximum(ty0, ty1)),
            jnp.minimum(jnp.maximum(tz0, tz1), t_limit),
        )
        box_hit = live & (tn <= tf)

        is_leaf = leaf_first >= 0
        do_leaf = box_hit & is_leaf

        if use_packed and getattr(scene, "instanced", False):
            # Two-level leaf: value packs (instance << mb_bits | global
            # mesh leaf block).  Transform the ray into object space
            # (affine, direction unnormalized => world t preserved) and
            # cull on world winding via det_sign.
            mb_mask = (1 << scene.mb_bits) - 1
            block_idx = jnp.where(
                do_leaf, jnp.minimum(leaf_first & mb_mask, n_blocks - 1),
                0,
            )
            inst = jnp.where(do_leaf, leaf_first >> scene.mb_bits, 0)
            inv_rows = jnp.take(scene.inst_inv, inst, axis=0)  # (N, 16)
            ia = inv_rows[:, 0:9].reshape(-1, 3, 3)
            it = inv_rows[:, 9:12]
            det_sign = inv_rows[:, 12]
            o_obj = jnp.einsum("njk,nk->nj", ia, origin) + it
            d_obj = jnp.einsum("njk,nk->nj", ia, direction)
            rows = jnp.take(scene.tri_blocks, block_idx, axis=0)
            t_lim = jnp.minimum(t_best, jnp.float32(tmax))
            for k in range(max_leaf_size):
                tri9 = rows[:, k * 9:(k + 1) * 9]
                hit, t, u, v = moller_trumbore(
                    o_obj, d_obj,
                    tri9[:, 0:3], tri9[:, 3:6], tri9[:, 6:9],
                    tmin, t_lim, det_sign=det_sign,
                )
                take = do_leaf & hit & (t < t_best)
                t_best = jnp.where(take, t, t_best)
                tri_best = jnp.where(
                    take,
                    leaf_first * jnp.int32(max_leaf_size)
                    + jnp.int32(k),
                    tri_best,
                )
                u_best = jnp.where(take, u, u_best)
                v_best = jnp.where(take, v, v_best)
        elif use_packed:
            # ONE row gather for the whole (padded, degenerate-safe)
            # triangle block: [tri0(v0,e1,e2) .. tri3(...)], 9 f32 each.
            block_idx = jnp.where(
                do_leaf, jnp.minimum(leaf_first // max_leaf_size,
                                     n_blocks - 1), 0
            )
            rows = jnp.take(scene.tri_blocks, block_idx, axis=0)
            t_lim = jnp.minimum(t_best, jnp.float32(tmax))
            for k in range(max_leaf_size):
                tri9 = rows[:, k * 9:(k + 1) * 9]
                hit, t, u, v = moller_trumbore(
                    origin, direction,
                    tri9[:, 0:3], tri9[:, 3:6], tri9[:, 6:9],
                    tmin, t_lim,
                )
                take = do_leaf & hit & (t < t_best)
                t_best = jnp.where(take, t, t_best)
                tri_best = jnp.where(
                    take, (leaf_first + k).astype(jnp.int32), tri_best
                )
                u_best = jnp.where(take, u, u_best)
                v_best = jnp.where(take, v, v_best)
        else:
            leaf_count = jnp.take(scene.bvh_leaf_count, nd, axis=0)
            for k in range(max_leaf_size):
                ti = jnp.minimum(
                    leaf_first + k, scene.tri_v0.shape[0] - 1
                )
                valid = do_leaf & (k < leaf_count)
                tv0 = jnp.take(scene.tri_v0, ti, axis=0)
                te1 = jnp.take(scene.tri_e1, ti, axis=0)
                te2 = jnp.take(scene.tri_e2, ti, axis=0)
                t_lim = jnp.minimum(t_best, jnp.float32(tmax))
                hit, t, u, v = moller_trumbore(
                    origin, direction, tv0, te1, te2, tmin, t_lim
                )
                take = valid & hit
                t_best = jnp.where(take, t, t_best)
                tri_best = jnp.where(take, ti.astype(jnp.int32), tri_best)
                u_best = jnp.where(take, u, u_best)
                v_best = jnp.where(take, v, v_best)

        descend = box_hit & ~is_leaf
        next_node = jnp.where(descend, node + 1, skip)
        node = jnp.where(live, next_node, node)
        return node, t_best, tri_best, u_best, v_best

    _, t_best, tri_best, u_best, v_best = jax.lax.while_loop(
        cond, body, (node0, t0, tri0, u0, v0_)
    )
    return Hit(t=t_best, tri=tri_best, u=u_best, v=v_best)
