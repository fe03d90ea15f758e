"""Device sorting / wavefront reordering — the stand-in for the GPU
hardware ray scheduler (reference: the Vulkan ray-tracing pipeline
behind ray_gen.rgen:50-63 schedules rays in hardware; this build sorts
bounce rays by a coherence key instead, so ordering cost is
first-class).

Design:

1. Keys are sorted with XLA's comparator sort (``argsort``); the
   permutation is applied with ONE (N, 16) row gather of the packed
   wavefront state.
2. ``VKPT_SORT_CHUNK`` = C > 1 sorts C-lane groups by their min key
   and gathers (N/C, C*16) rows instead — fewer, bigger rows, at the
   cost of a coarser order.
3. ``VKPT_PERMUTE=laxsort`` runs a single lax.sort carrying the 16
   payload columns as extra operands, so the comparator network moves
   the payload during the sort (c == 1 only).

Which of these pays on a given device is not measured yet (PERF.md).
Results are bit-exact per-lane under ANY order: ordering is
scheduling-only (tests/test_wavefront_sort.py).
"""

from __future__ import annotations

import os

import jax.numpy as jnp
from jax import lax


def sort_chunk() -> int:
    """Group size for wavefront sorts (VKPT_SORT_CHUNK, default 1)."""
    return int(os.environ.get("VKPT_SORT_CHUNK", "1"))


def permute_mode() -> str:
    """VKPT_PERMUTE: 'gather' (default, argsort + row gather) or
    'laxsort' (one fused comparator sort carrying the payload columns
    as extra lax.sort operands — measured 1.34x on the whole ordering
    step at 2M lanes, experiments/joint_sort_cost.py).  laxsort is
    unstable across equal keys; per-lane results are exact under any
    order (ordering is scheduling-only), so this is a perf knob."""
    return os.environ.get("VKPT_PERMUTE", "gather")


def state_sort_order(key, c: int):
    """(group_order | None, lane_order) permutations grouping lanes
    by key; group-granular when c > 1 and c divides the lane count."""
    m = key.shape[0]
    if c > 1 and m % c == 0:
        rep = key.reshape(m // c, c).min(axis=1)
        gorder = jnp.argsort(rep)
        lane = (gorder[:, None].astype(jnp.int32) * c
                + jnp.arange(c, dtype=jnp.int32)[None, :]).reshape(-1)
        return gorder, lane
    return None, jnp.argsort(key)


def permute_rows(state, key, c: int):
    """Reorder a packed (M, K) row matrix so equal/nearby keys become
    contiguous; uses the big-row gather when c > 1.  With
    VKPT_PERMUTE=laxsort (and c == 1) the argsort + (M, K) row gather
    is replaced by one lax.sort carrying the K payload columns."""
    if c <= 1 and permute_mode() == "laxsort":
        cols = tuple(state[:, i] for i in range(state.shape[1]))
        out = lax.sort((key,) + cols, num_keys=1)
        return jnp.stack(out[1:], axis=1)
    gorder, lane = state_sort_order(key, c)
    if gorder is None:
        return state[lane]
    m, k = state.shape
    return state.reshape(m // c, c * k)[gorder].reshape(m, k)
