"""Kernel half of the traversal parity grid, plus the kernel wrapper.

The GPU traversal kernel (ops/traverse_gpu.py) against the XLA
reference loop, over the same grid as tests/test_traversal_parity.py.
Here it runs in the Pallas interpreter; the ``gpu``-marked cases run
it compiled for the card (``python chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from traversal_grid import (
    LEAVES,
    N_RAYS,
    SCENES,
    active_mask,
    assert_hits_match,
    bvh_scene,
    rays,
)
from vulkan_pathtracer_tpu.ops import traverse_gpu
from vulkan_pathtracer_tpu.ops.intersect import MISS_T, Hit
from vulkan_pathtracer_tpu.ops.traverse import bvh_closest_hit

_xla = jax.jit(bvh_closest_hit)


def _check(kind, leaf, mode, partial, interpret):
    dev = bvh_scene(kind, leaf)
    o, d = rays(kind)
    act = active_mask(N_RAYS, partial)
    ref = _xla(dev, o, d, act)
    if mode == "closest":
        got = traverse_gpu.gpu_closest_hit(dev, o, d, act,
                                           interpret=interpret)
        assert_hits_match(got, ref, act)
    else:
        got = traverse_gpu.gpu_any_hit(dev, o, d, act, interpret=interpret)
        np.testing.assert_array_equal(
            np.asarray(got),
            (np.asarray(ref.t) < MISS_T) & np.asarray(act))


_grid = pytest.mark.parametrize
_GRID = [
    _grid("partial", [False, True], ids=["all-active", "partial-active"]),
    _grid("mode", ["closest", "any"]),
    _grid("leaf", LEAVES),
    _grid("kind", SCENES),
]


def _on_grid(fn):
    for mark in _GRID:
        fn = mark(fn)
    return fn


@_on_grid
def test_kernel_matches_xla(kind, leaf, mode, partial):
    _check(kind, leaf, mode, partial, interpret=True)


@pytest.mark.gpu
@_on_grid
def test_kernel_matches_xla_on_gpu(gpu, kind, leaf, mode, partial):
    _check(kind, leaf, mode, partial, interpret=False)


# ---- wrapper: padding, ray counts, seeds, block shapes -------------------

@pytest.fixture(scope="module")
def cols():
    return bvh_scene("columns", 8)


@pytest.mark.parametrize("n", [1, 31, 64, 65, 130])
def test_ray_counts_not_a_block_multiple(cols, n):
    """Ray counts are padded up to the block with inactive lanes and
    sliced back; padding never leaks into the results."""
    o, d = rays("columns", n=n, seed=n)
    got = traverse_gpu.gpu_closest_hit(cols, o, d, interpret=True)
    assert got.t.shape == got.tri.shape == (n,)
    assert_hits_match(got, bvh_closest_hit(cols, o, d),
                      jnp.ones(n, bool))


@pytest.mark.parametrize("block,num_warps", [(64, 2), (128, 4)])
def test_block_shape_does_not_change_results(cols, block, num_warps):
    o, d = rays("columns", n=150, seed=4)
    act, t0 = jnp.ones(150, bool), jnp.full(150, MISS_T)
    a = traverse_gpu._traverse(cols, o, d, act, t0, any_hit=False,
                               interpret=True)
    b = traverse_gpu._traverse(cols, o, d, act, t0, any_hit=False,
                               interpret=True, block=block,
                               num_warps=num_warps)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_padding_lanes_are_inactive(cols):
    """The padded ray table carries active = 0 past N, so the padding
    lanes' cursors start done and their outputs stay at the miss."""
    o, d = rays("columns", n=70, seed=1)
    block = traverse_gpu.BLOCK
    table = traverse_gpu._pack_rays(o, d, jnp.ones(70, bool),
                                    jnp.full(70, MISS_T), block)
    n_pad = -(-70 // block) * block
    assert table.shape == (8, n_pad)
    assert (np.asarray(table[7, 70:]) == 0).all()
    t, tri, _, _ = traverse_gpu._launch(
        cols, table, any_hit=False, interpret=True, block=block,
        num_warps=traverse_gpu.NUM_WARPS)
    assert t.shape == tri.shape == (n_pad,)
    assert (np.asarray(t[70:]) == MISS_T).all()
    assert (np.asarray(tri[70:]) == -1).all()


def test_seed_pretightens_and_survives(cols):
    """A seed hit pre-tightens t_best; where nothing nearer exists the
    seed itself is returned (the XLA reference's contract)."""
    o, d = rays("columns", n=120, seed=7)
    ref = bvh_closest_hit(cols, o, d)
    far = jnp.where(ref.t < MISS_T, ref.t * 2.0, MISS_T)
    seed = Hit(t=jnp.where(ref.t < MISS_T, ref.t, far),
               tri=jnp.where(ref.t < MISS_T, ref.tri, -1),
               u=ref.u, v=ref.v)
    got = traverse_gpu.gpu_closest_hit(cols, o, d, seed=seed,
                                       interpret=True)
    want = bvh_closest_hit(cols, o, d, seed=seed)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_kernel_under_shard_map_on_eight_devices(cols):
    """The kernel composes with shard_map over the 8-device virtual
    mesh (rays sharded, scene replicated), as the sharded renders run
    it on a GPU mesh."""
    from vulkan_pathtracer_tpu.parallel.mesh import (
        TILE_AXIS,
        make_render_mesh,
    )

    mesh = make_render_mesh(8)
    o, d = rays("columns", n=8 * 40, seed=3)
    fn = jax.jit(jax.shard_map(
        lambda s, o, d: traverse_gpu.gpu_closest_hit(s, o, d,
                                                    interpret=True),
        mesh=mesh, in_specs=(P(), P(TILE_AXIS), P(TILE_AXIS)),
        out_specs=P(TILE_AXIS), check_vma=False))
    got = fn(cols, o, d)
    assert_hits_match(got, bvh_closest_hit(cols, o, d),
                      jnp.ones(o.shape[0], bool))
