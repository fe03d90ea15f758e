"""Reference half of the traversal parity grid: the XLA skip-pointer
loop (ops/traverse.py) against brute force over every triangle, for
every scene kind, leaf size, query mode and ray activity.  It stays
valid whichever traversal the GPU runs."""

import jax
import numpy as np
import pytest

from traversal_grid import (
    INSTANCED,
    LEAVES,
    N_RAYS,
    SCENES,
    active_mask,
    assert_hits_match,
    bvh_scene,
    oracle_scene,
    rays,
)
from vulkan_pathtracer_tpu.ops.intersect import MISS_T, brute_force_closest_hit
from vulkan_pathtracer_tpu.ops.traverse import bvh_closest_hit

_xla = jax.jit(bvh_closest_hit)
_brute = jax.jit(brute_force_closest_hit)


@pytest.mark.parametrize("partial", [False, True],
                         ids=["all-active", "partial-active"])
@pytest.mark.parametrize("mode", ["closest", "any"])
@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("kind", SCENES)
def test_xla_matches_brute_force(kind, leaf, mode, partial):
    dev = bvh_scene(kind, leaf)
    o, d = rays(kind)
    act = active_mask(N_RAYS, partial)
    got = _xla(dev, o, d, act)
    ref = _brute(oracle_scene(kind, leaf), o, d, act)
    if mode == "closest":
        assert_hits_match(got, ref, act, compare_tri=kind not in INSTANCED)
    else:
        np.testing.assert_array_equal(
            (np.asarray(got.t) < MISS_T) & np.asarray(act),
            (np.asarray(ref.t) < MISS_T) & np.asarray(act))
