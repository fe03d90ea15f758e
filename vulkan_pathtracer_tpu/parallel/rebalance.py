"""Cross-chip ray-queue rebalancing — the SURVEY §2 parallelism
checklist's stretch item.

In image-tile data parallelism every chip traces the bounce rays its
own tile generated; enclosed regions keep bouncing while sky tiles go
idle, so per-chip alive counts diverge.  The classic GPU answer is a
global work queue; the answer here is a *balanced exchange over the
device interconnect* each bounce, built from two local sorts and one ``all_to_all``:

  1. locally sort the packed wavefront by the production bounce key
     (direction octant, origin Morton; dead lanes keyed to the end);
  2. split the sorted shard into ``d`` equal strips and
     ``lax.all_to_all`` them: chip ``i`` receives strip ``i`` from
     every chip — a stratified sample of the global key distribution,
     so every chip ends up with the SAME alive fraction (+-1 strip)
     and a spread of key ranges;
  3. locally re-sort so traversal packets are coherent again.

Everything rides device collectives under ``shard_map`` — no host round
trips.  Results are exact: traversal and shading are per-lane, and
each lane's color is routed home by a psum'd scatter-add at the end
(every lane is written by exactly one chip).

The wavefront itself is the pooled frames-in-flight state of
``render/wavefront.py`` (packed (M, 16) rows), so this path renders F
frames with different cameras across d chips with per-bounce load
balancing.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vulkan_pathtracer_tpu.models.device_scene import DeviceScene
from vulkan_pathtracer_tpu.parallel.mesh import TILE_AXIS
from vulkan_pathtracer_tpu.render.wavefront import (
    _any_hit,
    _anyhit_enabled,
    _bounce_sort_key,
    _closest_hit,
    _pack_state,
    _permute_state,
    _shade_and_extend,
    _sort_chunk,
    _unpack_state,
    sky_color,
)


def _balanced_exchange(state, key, n_dev: int):
    """Local sort by ``key`` -> strided-strip all_to_all -> caller
    re-sorts.  state: (m_local, 16); key: (m_local,) uint32.

    Strips are dealt ROUND-ROBIN from the sorted shard (row r goes to
    strip r % n_dev), so every strip is a strided sample of the full
    local key distribution.  Contiguous quantile strips would send all
    low-key (= alive-first) rows to low-index chips, concentrating the
    load instead of balancing it.
    """
    state = _permute_state(state, key, _sort_chunk())
    strips = state.reshape(state.shape[0] // n_dev, n_dev, 16)
    strips = strips.transpose(1, 0, 2)
    mixed = jax.lax.all_to_all(strips, TILE_AXIS, split_axis=0,
                               concat_axis=0, tiled=False)
    return mixed.reshape(-1, 16)


def make_pooled_sharded_render(mesh: Mesh, scene_example: DeviceScene, *,
                               num_bounces: int,
                               traversal: str = "auto",
                               russian_roulette: bool = False,
                               rr_start_bounce: int = 2,
                               sort_secondary: bool = True,
                               rebalance: bool = True,
                               chunk: int = 1 << 20):
    """Build a jitted sharded pooled-wavefront tracer.

    Returns fn(scene, origin (M,3), direction (M,3), seed_x (M,),
    seed_y (M,)) -> (color (M,3) in lane order, rays traced).  M must
    be divisible by d*d (d = mesh size); callers pad with dead lanes.
    """
    n_dev = mesh.devices.size
    replicated = P()
    scene_spec = jax.tree_util.tree_map(lambda _: replicated,
                                        scene_example)

    def body(scene, o, d, sx, sy):
        m_local = o.shape[0]
        me = jax.lax.axis_index(TILE_AXIS)
        lane = (me.astype(jnp.uint32) * jnp.uint32(m_local)
                + jnp.arange(m_local, dtype=jnp.uint32))
        state = _pack_state(
            o, d,
            jnp.ones((m_local, 3), jnp.float32),
            jnp.zeros((m_local, 3), jnp.float32),
            sx, sy, jnp.ones((m_local,), bool), lane,
        )
        local_chunk = min(chunk, m_local)
        if m_local % local_chunk:
            local_chunk = m_local
        n_chunks = m_local // local_chunk
        rays_traced = jnp.float32(0.0)

        def chunk_fn(last, rr):
            # Emissive-free last bounce: the any-hit query (sky/miss
            # decision only) — mirrors trace_wavefront_pooled, so the
            # rebalanced multi-device program takes the same path
            # single-device renders do.
            anyhit = last and _anyhit_enabled(scene)

            def fn(st):
                co, cd, atten, color, csx, csy, c_alive, c_lane = \
                    _unpack_state(st)

                def work(args):
                    co, cd, atten, color, csx, csy, c_alive = args
                    if anyhit:
                        hm = _any_hit(scene, co, cd, c_alive, traversal)
                        missed = c_alive & ~hm
                        color2 = color + jnp.where(
                            missed[:, None], atten * sky_color(cd), 0.0)
                        return (co, cd, atten, color2, csx, csy,
                                jnp.zeros_like(c_alive))
                    hit = _closest_hit(scene, co, cd, c_alive, traversal)
                    return _shade_and_extend(
                        scene, hit, co, cd, atten, color, csx, csy,
                        c_alive, last=last, rr=rr,
                    )

                def skip(args):
                    co, cd, atten, color, csx, csy, c_alive = args
                    return (co, cd, atten, color, csx, csy,
                            jnp.zeros_like(c_alive))

                count = jnp.sum(c_alive.astype(jnp.float32))
                co, cd, atten, color, csx, csy, c_alive = jax.lax.cond(
                    count > 0, work, skip,
                    (co, cd, atten, color, csx, csy, c_alive),
                )
                return _pack_state(co, cd, atten, color, csx, csy,
                                   c_alive, c_lane), count

            return fn

        for j in range(num_bounces):
            if j > 0:
                so, sd, _, _, _, _, alive, _ = _unpack_state(state)
                key = _bounce_sort_key(scene, so, sd, alive)
                if rebalance:
                    state = _balanced_exchange(state, key, n_dev)
                    so, sd, _, _, _, _, alive, _ = _unpack_state(state)
                    key = _bounce_sort_key(scene, so, sd, alive)
                if sort_secondary:
                    state = _permute_state(state, key, _sort_chunk())
            last = j == num_bounces - 1
            rr = russian_roulette and (j + 1) >= rr_start_bounce
            st, counts = jax.lax.map(
                chunk_fn(last, rr),
                state.reshape(n_chunks, local_chunk, 16),
            )
            state = st.reshape(-1, 16)
            rays_traced = rays_traced + jnp.sum(counts)

        _, _, _, color, _, _, _, out_lane = _unpack_state(state)
        m_total = m_local * n_dev
        full = jnp.zeros((m_total, 3), jnp.float32).at[
            out_lane.astype(jnp.int32)
        ].add(color, mode="drop")
        full = jax.lax.psum(full, TILE_AXIS)
        mine = jax.lax.dynamic_slice(
            full, (me * m_local, 0), (m_local, 3)
        )
        return mine, jax.lax.psum(rays_traced, TILE_AXIS)

    sharded = shard_map(
        body,
        mesh=mesh,
        in_specs=(scene_spec, P(TILE_AXIS), P(TILE_AXIS), P(TILE_AXIS),
                  P(TILE_AXIS)),
        out_specs=(P(TILE_AXIS), replicated),
        check_vma=False,
    )

    @jax.jit
    def fn(scene, origin, direction, seed_x, seed_y):
        return sharded(scene, origin, direction, seed_x, seed_y)

    return fn
