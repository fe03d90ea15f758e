"""Device-side LBVH build — SURVEY §7 M2 completed.

The reference gets per-frame acceleration-structure builds from the
Vulkan driver (RaytracingPass.zig:451-465, Tlas.zig:157-171,
``prefer_fast_trace``); rigid motion is covered here by the instanced
TLAS refit, but DEFORMING geometry needs a real device rebuild.  This
module builds the full traversal structure (octant-ordered skip-
pointer arrays + packed node records + leaf blocks) as
one jittable JAX program, so an animated mesh re-sorts and re-builds
every frame without a host round trip.

Structure (everything vectorized, no data-dependent shapes):

1. 30-bit Morton codes of triangle centroids; one
   ``lax.sort_key_val`` orders triangles (the "device radix sort"
   duty).
2. Fixed leaf blocks of ``block`` consecutive sorted triangles (the
   host builder's variable ranges are padded to blocks downstream
   anyway; fixed blocks keep every shape static).
3. Karras-style radix tree over the leaf representative codes
   (vectorized doubling + binary searches; index tie-break on
   duplicate codes) — the same "split at highest differing Morton
   bit" semantics as the host builder.
4. AABB fit + per-octant subtree extents by a bottom-up fixpoint of
   whole-array gathers (bounded by the radix-tree depth
   <= 32 + log2(L)).
5. The 8 direction-octant preorders WITHOUT 8 tree walks: flipping
   the Morton bits of the negative axes (code XOR mask) yields an
   isomorphic radix tree with children swapped exactly where the
   octant wants near-to-far order, and every subtree remains a
   contiguous leaf run under the flipped stable order (prefix sets
   are XOR-invariant; ties keep index order).  So octant o's DFS
   preorder is just the 2-key sort (subtree start in flipped order
   asc, subtree size desc), and its skip pointer is
   ``preorder + 2*leaves - 1``.

Parity: tests/test_device_build.py checks validate_bvh invariants,
exact traversal agreement vs brute force, and the deforming-geometry
per-frame rebuild path.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

BIG = np.float32(3e38)


def _morton3d_device(q):
    """(N, 3) uint32 in [0, 1023] -> 30-bit Morton codes."""
    def expand(v):
        v = v & jnp.uint32(0x3FF)
        v = (v | (v << jnp.uint32(16))) & jnp.uint32(0x030000FF)
        v = (v | (v << jnp.uint32(8))) & jnp.uint32(0x0300F00F)
        v = (v | (v << jnp.uint32(4))) & jnp.uint32(0x030C30C3)
        v = (v | (v << jnp.uint32(2))) & jnp.uint32(0x09249249)
        return v

    return (expand(q[:, 0]) | (expand(q[:, 1]) << jnp.uint32(1))
            | (expand(q[:, 2]) << jnp.uint32(2)))


def morton_codes_device(centroids, valid):
    """Morton codes normalized to the AABB of the VALID centroids."""
    big = jnp.float32(BIG)
    lo = jnp.min(jnp.where(valid[:, None], centroids, big), axis=0)
    hi = jnp.max(jnp.where(valid[:, None], centroids, -big), axis=0)
    extent = jnp.maximum(hi - lo, 1e-12)
    q = jnp.clip((centroids - lo) / extent * 1023.0, 0.0, 1023.0)
    return _morton3d_device(q.astype(jnp.uint32)), lo, hi


class RadixTree(NamedTuple):
    """Karras tree over L leaves: ids 0..L-2 internal, L-1..2L-2 leaf."""
    left: jnp.ndarray       # (2L-1,) int32 child id (-1 for leaves)
    right: jnp.ndarray      # (2L-1,) int32
    first: jnp.ndarray      # (2L-1,) int32 first leaf of subtree
    last: jnp.ndarray       # (2L-1,) int32 last leaf (inclusive)


def build_radix_tree(cb) -> RadixTree:
    """Vectorized Karras 2012 over sorted leaf codes cb (L,) uint32."""
    L = cb.shape[0]
    ids = jnp.arange(L - 1, dtype=jnp.int32)

    def delta(i, j):
        valid = (j >= 0) & (j < L)
        jc = jnp.clip(j, 0, L - 1)
        x = cb[i] ^ cb[jc]
        tie = jax.lax.clz(i.astype(jnp.uint32) ^ jc.astype(jnp.uint32))
        d = jnp.where(x == jnp.uint32(0),
                      32 + tie.astype(jnp.int32),
                      jax.lax.clz(x).astype(jnp.int32))
        return jnp.where(valid, d, -1)

    i = ids
    d = jnp.sign(delta(i, i + 1) - delta(i, i - 1)).astype(jnp.int32)
    d = jnp.where(d == 0, 1, d)
    delta_min = delta(i, i - d)

    # Doubling search for an upper bound on the range length.
    lmax = jnp.full_like(i, 2)
    for _ in range(26):  # covers L up to 2^26 leaves
        grow = delta(i, i + lmax * d) > delta_min
        lmax = jnp.where(grow, lmax * 2, lmax)

    # Binary search for the exact other end.
    l = jnp.zeros_like(i)
    for s in range(1, 27):
        t = lmax >> s
        cand = l + t
        ok = (t >= 1) & (delta(i, i + cand * d) > delta_min)
        l = jnp.where(ok, cand, l)
    j = i + l * d
    first = jnp.minimum(i, j)
    last = jnp.maximum(i, j)

    # Split search (paper's halving loop, masked to run the t==1 step
    # exactly once).
    delta_node = delta(i, j)
    s = jnp.zeros_like(i)
    t = l
    done = jnp.zeros(i.shape, bool)
    for _ in range(27):
        t = jnp.where(done, t, (t + 1) // 2)
        ok = (~done) & (delta(i, i + (s + t) * d) > delta_node)
        s = jnp.where(ok, s + t, s)
        done = done | (t <= 1)
    gamma = i + s * d + jnp.minimum(d, 0)

    leaf_base = L - 1
    left = jnp.where(first == gamma, leaf_base + gamma, gamma)
    right = jnp.where(last == gamma + 1, leaf_base + gamma + 1,
                      gamma + 1)

    leaf_ids = jnp.arange(L, dtype=jnp.int32)
    all_left = jnp.concatenate([left.astype(jnp.int32),
                                jnp.full((L,), -1, jnp.int32)])
    all_right = jnp.concatenate([right.astype(jnp.int32),
                                 jnp.full((L,), -1, jnp.int32)])
    all_first = jnp.concatenate([first.astype(jnp.int32), leaf_ids])
    all_last = jnp.concatenate([last.astype(jnp.int32), leaf_ids])
    return RadixTree(all_left, all_right, all_first, all_last)


def _depth_bound(L: int) -> int:
    return 34 + max(int(np.ceil(np.log2(max(L, 2)))), 1)


def _bottom_up_min(tree: RadixTree, leaf_vals, passes: int):
    """Fixpoint fold of per-node minima over (num_nodes, k) int32:
    internal node <- elementwise min of children (leaves fixed)."""
    L = leaf_vals.shape[0]
    n = 2 * L - 1
    big = jnp.int32(2 ** 30)
    vals = jnp.concatenate(
        [jnp.full((L - 1,) + leaf_vals.shape[1:], big, jnp.int32),
         leaf_vals], axis=0)
    li = jnp.maximum(tree.left, 0)
    ri = jnp.maximum(tree.right, 0)
    internal = (tree.left >= 0)
    shape_ones = (1,) * (leaf_vals.ndim - 1)
    mask = internal.reshape((n,) + shape_ones)
    for _ in range(passes):
        child = jnp.minimum(jnp.take(vals, li, axis=0),
                            jnp.take(vals, ri, axis=0))
        vals = jnp.where(mask, child, vals)
    return vals


def device_build_bvh(tri_v0, tri_e1, tri_e2, *, num_triangles: int,
                     block: int, octants: int = 8):
    """Build the complete traversal structure on device.

    tri_* are CANONICAL-order triangle arrays whose first
    ``num_triangles`` rows are real (storage may be padded).  Returns
    a dict of arrays shaped like the host bake's BVH fields plus
    ``tri_order`` (slot -> canonical triangle, padded slots -1).
    All shapes depend only on (num_triangles, block, octants).
    """
    t = num_triangles
    L = max((t + block - 1) // block, 1)
    n_slots = L * block

    v0 = tri_v0[:t]
    cent = v0 + (tri_e1[:t] + tri_e2[:t]) / 3.0
    codes, _, _ = morton_codes_device(
        cent, jnp.ones((t,), bool))
    sorted_codes, tri_order = jax.lax.sort_key_val(
        codes, jnp.arange(t, dtype=jnp.int32))

    # Reordered + padded triangle slots; pads are degenerate (e=0:
    # Moller-Trumbore det==0 -> never hit) and excluded from bounds
    # via leaf_count.
    def slot_gather(arr):
        idx = jnp.concatenate(
            [tri_order,
             jnp.zeros((n_slots - t,), jnp.int32)])
        out = jnp.take(arr[:t], idx, axis=0)
        if n_slots > t:
            zero_tail = jnp.arange(n_slots) >= t
            out = jnp.where(zero_tail.reshape((-1,) + (1,) * (out.ndim - 1)),
                            jnp.zeros_like(out), out)
        return out

    s_v0 = slot_gather(tri_v0)
    s_e1 = slot_gather(tri_e1)
    s_e2 = slot_gather(tri_e2)

    # Leaf representatives: first member's code.
    cb = sorted_codes[jnp.arange(L, dtype=jnp.int32) * block]

    if L == 1:
        # Single leaf: a 1-node tree per octant.
        lo = jnp.min(jnp.minimum(jnp.minimum(s_v0, s_v0 + s_e1),
                                 s_v0 + s_e2)[:t], axis=0)
        hi = jnp.max(jnp.maximum(jnp.maximum(s_v0, s_v0 + s_e1),
                                 s_v0 + s_e2)[:t], axis=0)
        o = octants
        return dict(
            bmin=jnp.broadcast_to(lo[None, :], (o, 3)),
            bmax=jnp.broadcast_to(hi[None, :], (o, 3)),
            skip_local=jnp.ones((o,), jnp.int32),
            leaf_first=jnp.zeros((o,), jnp.int32),
            leaf_count=jnp.full((o,), min(block, t), jnp.int32),
            perm=jnp.zeros((o,), jnp.int32),
            left=jnp.full((1,), -1, jnp.int32),
            right=jnp.full((1,), -1, jnp.int32),
            leaf_first_build=jnp.zeros((1,), jnp.int32),
            leaf_count_build=jnp.full((1,), min(block, t), jnp.int32),
            tri_order=tri_order,
            tri_v0=s_v0, tri_e1=s_e1, tri_e2=s_e2,
            n_nodes=1, depth=1,
        )

    tree = build_radix_tree(cb)
    n_nodes = 2 * L - 1
    leaf_base = L - 1
    passes = _depth_bound(L)

    # Per-leaf AABBs over valid members.
    v1 = s_v0 + s_e1
    v2 = s_v0 + s_e2
    t_min = jnp.minimum(jnp.minimum(s_v0, v1), v2)
    t_max = jnp.maximum(jnp.maximum(s_v0, v1), v2)
    slot_valid = (jnp.arange(n_slots) < t)
    t_min = jnp.where(slot_valid[:, None], t_min, BIG)
    t_max = jnp.where(slot_valid[:, None], t_max, -BIG)
    leaf_min = t_min.reshape(L, block, 3).min(axis=1)
    leaf_max = t_max.reshape(L, block, 3).max(axis=1)

    # Bottom-up AABB fit (fixpoint of child unions).
    li = jnp.maximum(tree.left, 0)
    ri = jnp.maximum(tree.right, 0)
    internal = (tree.left >= 0)[:, None]
    bmin = jnp.concatenate([jnp.full((L - 1, 3), BIG, jnp.float32),
                            leaf_min])
    bmax = jnp.concatenate([jnp.full((L - 1, 3), -BIG, jnp.float32),
                            leaf_max])
    for _ in range(passes):
        cmin = jnp.minimum(jnp.take(bmin, li, axis=0),
                           jnp.take(bmin, ri, axis=0))
        cmax = jnp.maximum(jnp.take(bmax, li, axis=0),
                           jnp.take(bmax, ri, axis=0))
        bmin = jnp.where(internal, cmin, bmin)
        bmax = jnp.where(internal, cmax, bmax)

    # Octant leaf ranks: position of each canonical leaf in the
    # bit-flipped stable order.
    sizes = (tree.last - tree.first + 1).astype(jnp.int32)  # leaves
    leaf_counts = jnp.minimum(
        jnp.full((L,), block, jnp.int32),
        t - jnp.arange(L, dtype=jnp.int32) * block)
    leaf_first_slots = jnp.arange(L, dtype=jnp.int32) * block

    per_oct = []
    for o in range(octants):
        mask = np.uint32(0)
        if o & 1:
            mask |= 0x09249249  # flip x bits
        if o & 2:
            mask |= 0x12492492  # flip y bits
        if o & 4:
            mask |= 0x24924924  # flip z bits
        flipped = cb ^ jnp.uint32(mask)
        forder = jnp.argsort(flipped, stable=True)
        rank = jnp.zeros((L,), jnp.int32).at[forder].set(
            jnp.arange(L, dtype=jnp.int32))
        # Subtree start in flipped order = min member rank.
        start = _bottom_up_min(tree, rank[:, None], passes)[:, 0]
        # Preorder: (start asc, size desc) lexicographic.
        _, _, perm = jax.lax.sort(
            (start, -sizes, jnp.arange(n_nodes, dtype=jnp.int32)),
            num_keys=2)
        sz = jnp.take(sizes, perm)
        skip_local = (jnp.arange(n_nodes, dtype=jnp.int32)
                      + 2 * sz - 1)
        is_leaf = perm >= leaf_base
        leaf_id = jnp.maximum(perm - leaf_base, 0)
        lf = jnp.where(is_leaf, jnp.take(leaf_first_slots, leaf_id),
                       -1)
        lc = jnp.where(is_leaf, jnp.take(leaf_counts, leaf_id), 0)
        per_oct.append((
            jnp.take(bmin, perm, axis=0),
            jnp.take(bmax, perm, axis=0),
            skip_local, lf, lc, perm,
        ))

    stack = lambda k: jnp.concatenate([po[k] for po in per_oct], axis=0)
    leaf_first_build = jnp.concatenate(
        [jnp.full((L - 1,), -1, jnp.int32), leaf_first_slots])
    leaf_count_build = jnp.concatenate(
        [jnp.zeros((L - 1,), jnp.int32), leaf_counts])
    return dict(
        bmin=stack(0), bmax=stack(1), skip_local=stack(2),
        leaf_first=stack(3), leaf_count=stack(4), perm=stack(5),
        left=tree.left, right=tree.right,
        leaf_first_build=leaf_first_build,
        leaf_count_build=leaf_count_build,
        tri_order=tri_order,
        tri_v0=s_v0, tri_e1=s_e1, tri_e2=s_e2,
        n_nodes=n_nodes, depth=passes,
    )


def device_rebuild_scene(template, tri_v0, tri_e1, tri_e2, tri_gn,
                         tri_attr):
    """Rebuild a DeviceScene's acceleration + triangle storage on
    device from CANONICAL-order triangle data (deforming geometry).

    ``template`` is a DeviceScene whose canonical per-triangle
    attribute rows are passed in ``tri_attr`` (34-f32 shading rows)
    and ``tri_gn``; its material/texture arrays are reused as-is.
    Returns a new DeviceScene with identical array shapes each frame
    (jit-friendly: wrap the caller in jax.jit).
    """
    t = template.num_triangles
    block = template.max_leaf_size
    octants = template.bvh_orders
    built = device_build_bvh(tri_v0, tri_e1, tri_e2,
                             num_triangles=t, block=block,
                             octants=octants)
    n_nodes = built["n_nodes"]
    n_slots = built["tri_v0"].shape[0]

    def slot_gather(arr, fill=0.0):
        idx = jnp.concatenate(
            [built["tri_order"],
             jnp.zeros((n_slots - t,), jnp.int32)])
        out = jnp.take(arr[:t], idx, axis=0)
        tail = (jnp.arange(n_slots) >= t)
        return jnp.where(tail.reshape((-1,) + (1,) * (out.ndim - 1)),
                         jnp.full_like(out, fill), out)

    s_gn = slot_gather(tri_gn)
    s_attr = slot_gather(tri_attr)
    s_index = slot_gather(template.tri_index)
    s_material = slot_gather(template.tri_material)
    s_primitive = slot_gather(template.tri_primitive)
    s_local = slot_gather(template.tri_local)

    # Storage shape compatibility: hit.tri indexes the reordered slot
    # arrays, so every per-triangle array must cover n_slots rows;
    # pad beyond that only to keep the template's (possibly larger)
    # padded storage shape.
    def fit(arr, like):
        rows = max(like.shape[0], n_slots)
        if arr.shape[0] < rows:
            pad = [(0, rows - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
            return jnp.pad(arr, pad)
        return arr

    tail = jnp.stack(
        [jax.lax.bitcast_convert_type(built["skip_local"], jnp.float32),
         jax.lax.bitcast_convert_type(built["leaf_first"], jnp.float32)],
        axis=1)
    packed = jnp.concatenate([built["bmin"], built["bmax"], tail],
                             axis=1)
    skip_offsets = (jnp.arange(octants, dtype=jnp.int32)
                    .repeat(n_nodes) * n_nodes)
    flat = jnp.concatenate(
        [built["tri_v0"], built["tri_e1"], built["tri_e2"]], axis=1)
    return dataclasses.replace(
        template,
        tri_v0=fit(built["tri_v0"], template.tri_v0),
        tri_e1=fit(built["tri_e1"], template.tri_e1),
        tri_e2=fit(built["tri_e2"], template.tri_e2),
        tri_gn=fit(s_gn, template.tri_gn),
        tri_attr=fit(s_attr, template.tri_attr),
        tri_index=fit(s_index, template.tri_index),
        tri_material=fit(s_material, template.tri_material),
        tri_primitive=fit(s_primitive, template.tri_primitive),
        tri_local=fit(s_local, template.tri_local),
        bvh_bmin=built["bmin"],
        bvh_bmax=built["bmax"],
        bvh_skip=built["skip_local"] + skip_offsets,
        bvh_leaf_first=built["leaf_first"],
        bvh_leaf_count=built["leaf_count"],
        bvh_perm=built["perm"],
        bvh_left=built["left"],
        bvh_right=built["right"],
        bvh_leaf_first_build=built["leaf_first_build"],
        bvh_leaf_count_build=built["leaf_count_build"],
        bvh_packed=packed,
        bvh_packed_tail=tail,
        tri_blocks=flat.reshape(n_slots // block, block * 9),
        bvh_depth=built["depth"],
        bvh_orders=octants,
        max_leaf_size=block,
    )
