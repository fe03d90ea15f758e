"""Per-ray BVH traversal kernel for the GPU (Pallas, Triton route).

The same skip-pointer stackless algorithm as the plain reference
``ops.traverse.bvh_closest_hit``, written for a SIMT machine:

- one ray per lane, ``block`` rays per program; the node cursor,
  ``t_best``, ``tri``, ``u`` and ``v`` live in registers;
- the ray's direction octant picks one of the ``bvh_orders``
  near-first linearizations (``scene.bvh_packed`` rows are
  octant-local);
- node rows (8 f32) and leaf triangles (9 f32 each, from
  ``scene.tri_blocks``) are loaded per lane from global memory; the
  tables are small enough to stay L2-resident, and nothing of size
  (N, 9 * leaf) is ever materialized;
- each program loops until ITS rays are done, not until the slowest
  ray of the dispatch is;
- ``any_hit=True`` retires a lane on its first accepted hit (the
  analog of ``gl_RayFlagsTerminateOnFirstHitEXT``);
- two-level scenes decode leaves in object space through
  ``scene.inst_inv`` exactly as the reference does.

Results match the reference up to FMA contraction in the float32
intersection math (tests/test_traversal_parity.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from vulkan_pathtracer_tpu.ops.intersect import MISS_T, TMAX, TMIN, Hit

# Rays per program and warps per program: one ray per thread, one
# warp per program — measured fastest on the H100 against 64/128/256-ray
# programs (PERF.md): a program runs until its slowest ray is done, so
# smaller programs waste fewer idle lanes.
BLOCK = 32
NUM_WARPS = 1


def _safe_inv(d):
    # Python-float literals: the Triton lowering cannot negate a
    # folded constant.
    return 1.0 / jnp.where(jnp.abs(d) < 1e-20,
                           jnp.where(d >= 0.0, 1e-20, -1e-20), d)


def _kernel(rays_ref, nodes_ref, tris_ref, inst_ref,
            t_ref, tri_ref, u_ref, v_ref, *,
            n_nodes, orders, leaf, n_blocks, instanced, mb_bits,
            any_hit, block, tmin, tmax):
    lanes = pl.ds(pl.program_id(0) * block, block)
    ox, oy, oz = rays_ref[0, lanes], rays_ref[1, lanes], rays_ref[2, lanes]
    dx, dy, dz = rays_ref[3, lanes], rays_ref[4, lanes], rays_ref[5, lanes]
    t0 = rays_ref[6, lanes]
    active = rays_ref[7, lanes] > 0.5
    ix, iy, iz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
    if orders == 8:
        octant = ((dx < 0.0).astype(jnp.int32)
                  + 2 * (dy < 0.0).astype(jnp.int32)
                  + 4 * (dz < 0.0).astype(jnp.int32))
        base = octant * n_nodes
    else:
        base = jnp.zeros((block,), jnp.int32)
    node0 = jnp.where(active, 0, n_nodes).astype(jnp.int32)
    tri0 = jnp.full((block,), -1, jnp.int32)
    zero = jnp.zeros((block,), jnp.float32)

    def link(g, c):
        return jax.lax.bitcast_convert_type(nodes_ref[g, c], jnp.int32)

    def leaf_visit(do_leaf, lf, t, tri, u, v):
        if instanced:
            blk = jnp.where(do_leaf, jnp.minimum(lf & ((1 << mb_bits) - 1),
                                                 n_blocks - 1), 0)
            inst = jnp.where(do_leaf, jax.lax.shift_right_arithmetic(
                lf, jnp.int32(mb_bits)), 0)
            m = [inst_ref[inst, c] for c in range(13)]
            # o_obj = invA @ o + invT; d_obj = invA @ d (row-major 3x3).
            qox = m[0] * ox + m[1] * oy + m[2] * oz + m[9]
            qoy = m[3] * ox + m[4] * oy + m[5] * oz + m[10]
            qoz = m[6] * ox + m[7] * oy + m[8] * oz + m[11]
            qdx = m[0] * dx + m[1] * dy + m[2] * dz
            qdy = m[3] * dx + m[4] * dy + m[5] * dz
            qdz = m[6] * dx + m[7] * dy + m[8] * dz
            det_sign = m[12]
            tri_base = lf * leaf
        else:
            blk = jnp.where(do_leaf, jnp.minimum(
                jax.lax.div(jnp.maximum(lf, 0), jnp.int32(leaf)),
                n_blocks - 1), 0)
            qox, qoy, qoz, qdx, qdy, qdz = ox, oy, oz, dx, dy, dz
            det_sign = None
            tri_base = lf

        def tri_body(k, carry):
            t, tri, u, v = carry
            c = k * 9
            v0x, v0y, v0z = (tris_ref[blk, c], tris_ref[blk, c + 1],
                             tris_ref[blk, c + 2])
            e1x, e1y, e1z = (tris_ref[blk, c + 3], tris_ref[blk, c + 4],
                             tris_ref[blk, c + 5])
            e2x, e2y, e2z = (tris_ref[blk, c + 6], tris_ref[blk, c + 7],
                             tris_ref[blk, c + 8])
            # Möller–Trumbore, term for term as ops.intersect.
            px = qdy * e2z - qdz * e2y
            py = qdz * e2x - qdx * e2z
            pz = qdx * e2y - qdy * e2x
            det = e1x * px + e1y * py + e1z * pz
            front = (det * det_sign > 0.0) if instanced else (det > 0.0)
            inv_det = 1.0 / jnp.where(front, det, 1.0)
            sx, sy, sz = qox - v0x, qoy - v0y, qoz - v0z
            uu = (sx * px + sy * py + sz * pz) * inv_det
            qx = sy * e1z - sz * e1y
            qy = sz * e1x - sx * e1z
            qz = sx * e1y - sy * e1x
            vv = (qdx * qx + qdy * qy + qdz * qz) * inv_det
            tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
            take = (do_leaf & front & (uu >= 0.0) & (vv >= 0.0)
                    & (uu + vv <= 1.0) & (tt > tmin)
                    & (tt < jnp.minimum(t, tmax)))
            return (jnp.where(take, tt, t),
                    jnp.where(take, tri_base + k, tri),
                    jnp.where(take, uu, u), jnp.where(take, vv, v))

        return jax.lax.fori_loop(0, leaf, tri_body, (t, tri, u, v))

    def cond(state):
        node = state[0]
        return jnp.max((node < n_nodes).astype(jnp.int32)) > 0

    def body(state):
        node, t, tri, u, v = state
        live = node < n_nodes
        g = base + jnp.minimum(node, n_nodes - 1)
        tx0 = (nodes_ref[g, 0] - ox) * ix
        tx1 = (nodes_ref[g, 3] - ox) * ix
        ty0 = (nodes_ref[g, 1] - oy) * iy
        ty1 = (nodes_ref[g, 4] - oy) * iy
        tz0 = (nodes_ref[g, 2] - oz) * iz
        tz1 = (nodes_ref[g, 5] - oz) * iz
        tn = jnp.maximum(
            jnp.maximum(jnp.minimum(tx0, tx1), jnp.minimum(ty0, ty1)),
            jnp.maximum(jnp.minimum(tz0, tz1), tmin))
        tf = jnp.minimum(
            jnp.minimum(jnp.maximum(tx0, tx1), jnp.maximum(ty0, ty1)),
            jnp.minimum(jnp.maximum(tz0, tz1), jnp.minimum(t, tmax)))
        box_hit = live & (tn <= tf)
        skip = link(g, 6)
        lf = link(g, 7)
        is_leaf = lf >= 0
        do_leaf = box_hit & is_leaf
        # Only programs with a lane on a leaf pay for the leaf loop.
        t, tri, u, v = jax.lax.cond(
            jnp.max(do_leaf.astype(jnp.int32)) > 0,
            lambda a: leaf_visit(do_leaf, lf, *a),
            lambda a: a,
            (t, tri, u, v))
        nxt = jnp.where(box_hit & ~is_leaf, node + 1, skip)
        node = jnp.where(live, nxt, node)
        if any_hit:
            node = jnp.where(tri >= 0, n_nodes, node)
        return node, t, tri, u, v

    _, t, tri, u, v = jax.lax.while_loop(
        cond, body, (node0, t0, tri0, zero, zero))
    t_ref[lanes] = t
    tri_ref[lanes] = tri
    u_ref[lanes] = u
    v_ref[lanes] = v


def _pack_rays(origin, direction, active, t_init, block):
    """(8, N padded to the block) ray table: origin, direction, initial
    t_best, active flag.  Padding lanes are inactive, so their cursors
    start done and their outputs stay at the miss."""
    n = origin.shape[0]
    pad = -(-n // block) * block - n
    rays = jnp.concatenate([
        origin.T, direction.T, t_init[None],
        active.astype(jnp.float32)[None]], axis=0)
    tail = jnp.zeros((8, pad), jnp.float32).at[6].set(MISS_T)
    return jnp.concatenate([rays, tail], axis=1)


def _launch(scene, rays, *, any_hit, interpret, block, num_warps):
    """Run the kernel over a packed ray table; (t, tri, u, v) padded."""
    n_pad = rays.shape[1]
    instanced = bool(getattr(scene, "instanced", False))
    inst = scene.inst_inv if instanced else jnp.zeros((1, 16), jnp.float32)
    kernel = functools.partial(
        _kernel,
        n_nodes=scene.bvh_packed.shape[0] // scene.bvh_orders,
        orders=scene.bvh_orders, leaf=scene.max_leaf_size,
        n_blocks=scene.tri_blocks.shape[0], instanced=instanced,
        mb_bits=int(scene.mb_bits), any_hit=any_hit, block=block,
        tmin=TMIN, tmax=TMAX)
    f32 = jax.ShapeDtypeStruct((n_pad,), jnp.float32)
    return pl.pallas_call(
        kernel,
        out_shape=(f32, jax.ShapeDtypeStruct((n_pad,), jnp.int32), f32, f32),
        grid=(n_pad // block,),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=num_warps,
                                           num_stages=1),
        interpret=interpret,
        name="bvh_traverse_anyhit" if any_hit else "bvh_traverse",
    )(rays, scene.bvh_packed, scene.tri_blocks, inst)


@functools.partial(jax.jit, static_argnames=(
    "any_hit", "interpret", "block", "num_warps"))
def _traverse(scene, origin, direction, active, t_init, *, any_hit,
              interpret, block=BLOCK, num_warps=NUM_WARPS):
    n = origin.shape[0]
    t, tri, u, v = _launch(
        scene, _pack_rays(origin, direction, active, t_init, block),
        any_hit=any_hit, interpret=interpret, block=block,
        num_warps=num_warps)
    return Hit(t=t[:n], tri=tri[:n], u=u[:n], v=v[:n])


def gpu_closest_hit(scene, origin, direction, active=None, seed=None, *,
                    interpret: bool = False) -> Hit:
    """Closest hit for (N, 3) rays; same contract as
    ``ops.traverse.bvh_closest_hit`` (``seed`` pre-tightens t_best and
    is returned where nothing nearer is found).  ``interpret`` runs the
    kernel in the Pallas interpreter (CPU tests only)."""
    n = origin.shape[0]
    if active is None:
        active = jnp.ones((n,), bool)
    t_init = (jnp.full((n,), MISS_T, jnp.float32) if seed is None
              else seed.t)
    hit = _traverse(scene, origin, direction, active, t_init,
                    any_hit=False, interpret=interpret)
    if seed is None:
        return hit
    found = hit.tri >= 0
    return Hit(t=jnp.where(found, hit.t, seed.t),
               tri=jnp.where(found, hit.tri, seed.tri),
               u=jnp.where(found, hit.u, seed.u),
               v=jnp.where(found, hit.v, seed.v))


def gpu_any_hit(scene, origin, direction, active=None, *,
                interpret: bool = False):
    """(N,) bool: True exactly where a closest-hit query would report a
    hit.  Each lane stops at its first accepted triangle."""
    n = origin.shape[0]
    if active is None:
        active = jnp.ones((n,), bool)
    hit = _traverse(scene, origin, direction, active,
                    jnp.full((n,), MISS_T, jnp.float32), any_hit=True,
                    interpret=interpret)
    return hit.tri >= 0
