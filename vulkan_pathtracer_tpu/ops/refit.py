"""Device-side BVH AABB refit — the TLAS-refit analog.

The reference rebuilds nothing per frame (static scenes only); the
animated fly-through config (BASELINE configs[4]) needs per-frame
bounds updates.  Topology (Morton order, skip pointers) is kept from
the build; only AABBs are recomputed on-device:

1. Leaf AABBs from their (contiguous) triangle ranges — a
   max_leaf_size-unrolled gather + min/max fold.
2. Internal AABBs by a fixed-point bottom-up sweep: every internal
   node takes the union of its children; after ``depth`` sweeps the
   root is correct.  Children always have larger preorder indices than
   parents, but the sweep is written as whole-array gathers rather
   than per-level scatters — depth x O(Nn) work.

Refit preserves correctness under arbitrary motion; quality degrades
only if triangles migrate far from their Morton-ordered neighborhoods
(same tradeoff as hardware TLAS refit vs rebuild).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

BIG = np.float32(3e38)


def refit_aabbs(tri_v0, tri_e1, tri_e2, leaf_first, leaf_count,
                left, right, *, depth: int, max_leaf_size: int):
    """Recompute (bmin, bmax) for the whole tree from triangle arrays."""
    n_tris = tri_v0.shape[0]

    # Per-triangle AABBs.
    v1 = tri_v0 + tri_e1
    v2 = tri_v0 + tri_e2
    t_min = jnp.minimum(jnp.minimum(tri_v0, v1), v2)
    t_max = jnp.maximum(jnp.maximum(tri_v0, v1), v2)

    is_leaf = leaf_first >= 0
    first = jnp.maximum(leaf_first, 0)

    bmin = jnp.full((leaf_first.shape[0], 3), BIG, dtype=jnp.float32)
    bmax = jnp.full((leaf_first.shape[0], 3), -BIG, dtype=jnp.float32)
    for k in range(max_leaf_size):
        ti = jnp.minimum(first + k, n_tris - 1)
        valid = (is_leaf & (k < leaf_count))[:, None]
        bmin = jnp.minimum(bmin, jnp.where(valid, jnp.take(t_min, ti, axis=0), BIG))
        bmax = jnp.maximum(bmax, jnp.where(valid, jnp.take(t_max, ti, axis=0), -BIG))

    # Bottom-up fixed point over internal nodes.
    li = jnp.maximum(left, 0)
    ri = jnp.maximum(right, 0)
    internal = (~is_leaf)[:, None]
    for _ in range(max(depth - 1, 0)):
        child_min = jnp.minimum(jnp.take(bmin, li, axis=0),
                                jnp.take(bmin, ri, axis=0))
        child_max = jnp.maximum(jnp.take(bmax, li, axis=0),
                                jnp.take(bmax, ri, axis=0))
        bmin = jnp.where(internal, child_min, bmin)
        bmax = jnp.where(internal, child_max, bmax)
    return bmin, bmax


def refit_scene(scene):
    """Return a copy of a DeviceScene with refitted BVH bounds
    (after its triangle arrays changed).

    The refit runs over the build-order tree; the traversal arrays
    (possibly 8 octant-ordered blocks) are regenerated by a gather
    through ``bvh_perm``.
    """
    import dataclasses

    bmin, bmax = refit_aabbs(
        scene.tri_v0, scene.tri_e1, scene.tri_e2,
        scene.bvh_leaf_first_build, scene.bvh_leaf_count_build,
        scene.bvh_left, scene.bvh_right,
        depth=scene.bvh_depth, max_leaf_size=scene.max_leaf_size,
    )
    bmin_s = jnp.take(bmin, scene.bvh_perm, axis=0)
    bmax_s = jnp.take(bmax, scene.bvh_perm, axis=0)
    updates = dict(bvh_bmin=bmin_s, bvh_bmax=bmax_s)
    if scene.bvh_packed is not None:
        updates["bvh_packed"] = jnp.concatenate(
            [bmin_s, bmax_s, scene.bvh_packed_tail], axis=1
        )
        n_rows = scene.tri_blocks.shape[0] * scene.max_leaf_size
        flat = jnp.concatenate(
            [scene.tri_v0[:n_rows], scene.tri_e1[:n_rows],
             scene.tri_e2[:n_rows]], axis=1,
        )
        updates["tri_blocks"] = flat.reshape(scene.tri_blocks.shape)
    return dataclasses.replace(scene, **updates)
