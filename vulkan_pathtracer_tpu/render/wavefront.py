"""The wavefront bounce loop — the analog of ray_gen.rgen:44-102.

One *sample* = up to NUM_BOUNCES segments per ray.  The bounce loop is
Python-unrolled under jit (NUM_BOUNCES is a spec-constant analog), so
XLA sees a fixed kernel sequence per bounce:

    closest-hit (BVH traversal or brute force)
      -> sky/emissive accumulation
      -> attribute + material fetch (gathers)
      -> BRDF sampling (VPU math)
      -> next-ray state update (masked)

Lanes don't branch; dead paths are masked out and their RNG state is
left untouched, which keeps the per-lane random stream *bit-exact*
with the reference's early `break`s (miss -> no draw; draws happen
before the lambert_in kill check, ray_gen.rgen:87-93).

Radiometric contract reproduced exactly (ray_gen.rgen:33-104):
sky = mix(white, (.5,.7,1), .5*(dir.y+1)); emissive x 10;
f0 = mix(0.02, albedo, metallic); diffuse_albedo = albedo*(1-metallic);
roughness >= 0.006; origin offset 1e-5 * geometry_normal; path kill on
lambert_in <= 0; atten *= brdf * cos / pdf.

Deliberate deviation: the pdf divide is clamped with
``max(density, 1e-30)`` whereas the reference divides unguarded
(ray_gen.rgen:95).  On degenerate lanes (density == 0) the reference
produces inf/NaN attenuation; those lanes are already masked dead here
(lambert_in <= 0 kills them before the weight is applied), so the
clamp only prevents transient NaNs from tripping ``jax_debug_nans`` —
live-lane radiance is unchanged.

Russian roulette is an *extension* (off by default): survival
probability = clamp(max-component of atten), drawn from the same
pcg2d stream, applied from ``rr_start_bounce`` on.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from vulkan_pathtracer_tpu.ops import rng, traverse_gpu
from vulkan_pathtracer_tpu.ops.brdf import (
    ShadingInfo,
    brdf,
    get_brdf_density,
    sample_brdf,
)
from vulkan_pathtracer_tpu.ops.intersect import (
    MISS_T,
    brute_force_closest_hit,
)
from vulkan_pathtracer_tpu.ops.traverse import bvh_closest_hit
from vulkan_pathtracer_tpu.ops.vecmath import dot, mix
from vulkan_pathtracer_tpu.render.shading import (
    get_emissive_lean,
    get_material_data,
    get_triangle_data,
)

SKY_WHITE = (1.0, 1.0, 1.0)
SKY_BLUE = (0.5, 0.7, 1.0)
EMISSIVE_SCALE = 10.0       # ray_gen.rgen:75
ORIGIN_OFFSET = 1e-5        # ray_gen.rgen:86
ROUGHNESS_FLOOR = 0.006     # ray_gen.rgen:84
F0_DIELECTRIC = 0.02        # ray_gen.rgen:82

def _use_kernel(scene, traversal: str) -> bool:
    """``auto`` on a GPU runs the per-ray Pallas kernel
    (ops/traverse_gpu.py), measured far faster there than the XLA loop
    (PERF.md); everywhere else ``auto`` and ``bvh`` run the XLA loop,
    which stays the plain reference.  Never picks interpret mode."""
    return (traversal == "auto" and scene.has_bvh
            and jax.default_backend() == "gpu")


def _closest_hit(scene, origin, direction, active, traversal: str,
                 seed=None):
    if _use_kernel(scene, traversal):
        return traverse_gpu.gpu_closest_hit(scene, origin, direction,
                                            active, seed=seed)
    if not getattr(scene, "instanced", False) and (
            traversal == "brute"
            or (traversal == "auto" and not scene.has_bvh)):
        return brute_force_closest_hit(scene, origin, direction, active)
    return bvh_closest_hit(scene, origin, direction, active, seed=seed)


def _anyhit_enabled(scene) -> bool:
    """Whether the last bounce may use an occlusion query: the scene
    must be statically emissive-free (last-bounce radiance is then
    only the sky/miss decision — emissive x atten is identically zero
    for hit lanes)."""
    return bool(getattr(scene, "emissive_free", False))


def _any_hit(scene, origin, direction, active, traversal: str):
    """Occlusion query: (N,) bool, True exactly where _closest_hit
    would report a hit (t < MISS_T).  On the GPU kernel path each lane
    stops at its first accepted triangle (the analog of
    gl_RayFlagsTerminateOnFirstHitEXT); elsewhere it is closest-hit
    plus a t comparison (exact, no speedup)."""
    if _use_kernel(scene, traversal):
        return traverse_gpu.gpu_any_hit(scene, origin, direction, active)
    hit = _closest_hit(scene, origin, direction, active, traversal)
    h = hit.t < MISS_T
    if active is not None:
        h = h & active
    return h


def _any_hit_sorted(scene, origin, direction, active, traversal: str):
    """Sorted-dispatch any-hit: one payload row gather in, one column
    gather back for the single hit bit."""
    key = _bounce_sort_key(
        scene, origin, direction,
        jnp.ones(origin.shape[0], bool) if active is None else active,
    )
    _, order = _state_sort_order(key, _sort_chunk())
    inv = jnp.zeros_like(order).at[order].set(
        jnp.arange(order.shape[0], dtype=order.dtype)
    )
    cols = [origin, direction]
    if active is not None:
        cols.append(active.astype(jnp.float32)[:, None])
    payload = jnp.take(jnp.concatenate(cols, axis=1), order, axis=0)
    o_s, d_s = payload[:, 0:3], payload[:, 3:6]
    act_s = payload[:, 6] > 0.5 if active is not None else None
    hit_s = _any_hit(scene, o_s, d_s, act_s, traversal)
    return jnp.take(hit_s, inv, axis=0)


def _interleave10(v):
    v = v & jnp.uint32(0x3FF)
    v = (v | (v << 16)) & jnp.uint32(0x030000FF)
    v = (v | (v << 8)) & jnp.uint32(0x0300F00F)
    v = (v | (v << 4)) & jnp.uint32(0x030C30C3)
    v = (v | (v << 2)) & jnp.uint32(0x09249249)
    return v


# Wavefront ordering lives in ops/sort.py (measured rationale there);
# re-exported under the historic names used across render/parallel.
from vulkan_pathtracer_tpu.ops.sort import (  # noqa: E402
    permute_rows as _permute_state,
    sort_chunk as _sort_chunk,
    state_sort_order as _state_sort_order,
)


def _closest_hit_sorted(scene, origin, direction, active, traversal: str,
                        seed=None):
    """Sort rays by the bounce key (_bounce_sort_key: 6d endpoint-pair
    Morton by default) before traversal so neighbouring rays take
    similar paths through the tree (dead rays cluster at the end), then
    scatter results back to pixel order.  Per-ray results are identical
    to the unsorted dispatch."""
    key = _bounce_sort_key(
        scene, origin, direction,
        jnp.ones(origin.shape[0], bool) if active is None else active,
    )
    _, order = _state_sort_order(key, _sort_chunk())
    # Inverse permutation via scatter (O(n)), not a second argsort.
    inv = jnp.zeros_like(order).at[order].set(
        jnp.arange(order.shape[0], dtype=order.dtype)
    )
    # Apply the permutation with ONE row gather each way: o/d/active
    # (/seed) ride in one payload row and the hit in one (N, 4) row.
    # Bit-exact: gathers are exact, int channels ride as f32 bitcasts.
    cols = [origin, direction]
    if active is not None:
        cols.append(active.astype(jnp.float32)[:, None])
    if seed is not None:
        cols.extend([
            seed.t[:, None],
            jax.lax.bitcast_convert_type(seed.tri, jnp.float32)[:, None],
            seed.u[:, None], seed.v[:, None],
        ])
    payload = jnp.take(jnp.concatenate(cols, axis=1), order, axis=0)
    o_s, d_s = payload[:, 0:3], payload[:, 3:6]
    c = 6
    act_s = None
    if active is not None:
        act_s = payload[:, c] > 0.5
        c += 1
    seed_s = None
    if seed is not None:
        seed_s = type(seed)(
            t=payload[:, c],
            tri=jax.lax.bitcast_convert_type(payload[:, c + 1],
                                             jnp.int32),
            u=payload[:, c + 2], v=payload[:, c + 3],
        )
    hit = _closest_hit(scene, o_s, d_s, act_s, traversal, seed=seed_s)
    hp = jnp.take(
        jnp.stack(
            [hit.t,
             jax.lax.bitcast_convert_type(hit.tri, jnp.float32),
             hit.u, hit.v],
            axis=1,
        ),
        inv, axis=0,
    )
    return type(hit)(
        t=hp[:, 0],
        tri=jax.lax.bitcast_convert_type(hp[:, 1], jnp.int32),
        u=hp[:, 2], v=hp[:, 3],
    )


def sky_color(direction):
    """ray_gen.rgen:65-70."""
    t = 0.5 * (direction[:, 1] + 1.0)
    white = jnp.array(SKY_WHITE, dtype=jnp.float32)
    blue = jnp.array(SKY_BLUE, dtype=jnp.float32)
    return mix(white[None, :], blue[None, :], t[:, None])


def trace_sample(scene, origin, direction, seed_x, seed_y, *,
                 num_bounces: int, traversal: str = "auto",
                 russian_roulette: bool = False, rr_start_bounce: int = 2,
                 sort_secondary: bool = False,
                 seed_secondary: bool = False):
    """Trace one sample for all rays.

    Returns (color (N,3), new_seed_x, new_seed_y, rays_traced_f32).
    """
    n = origin.shape[0]
    color = jnp.zeros((n, 3), dtype=jnp.float32)
    atten = jnp.ones((n, 3), dtype=jnp.float32)
    alive = jnp.ones((n,), dtype=bool)
    rays_traced = jnp.float32(0.0)

    prev_hit = None
    for j in range(num_bounces):
        rays_traced = rays_traced + jnp.sum(alive.astype(jnp.float32))
        seed = None
        if (seed_secondary and j > 0 and prev_hit is not None
                and getattr(scene, "tri_blocks", None) is not None):
            # Seed t_best with a hit in the previous bounce's leaf
            # block: in INTERIOR scenes bounce rays usually strike
            # nearby geometry, and a tight initial bound lets traversal
            # prune most of the tree (the seed is a valid hit, so
            # results are unchanged). In open scenes the pre-pass is
            # overhead — hence opt-in (config.seed_secondary).
            from vulkan_pathtracer_tpu.ops.intersect import leaf_seed_hit

            prev_block = jnp.maximum(prev_hit.tri, 0) // scene.max_leaf_size
            seed = leaf_seed_hit(scene, origin, direction, prev_block,
                                 active=alive)
        if j == num_bounces - 1 and _anyhit_enabled(scene):
            # Last bounce of an emissive-free scene: radiance needs
            # only the sky/miss decision — ANY-HIT traversal (values
            # identical: hit lanes would add emissive x atten == 0,
            # and no RNG draws happen on the last bounce).
            if sort_secondary and j > 0:
                hit_mask = _any_hit_sorted(scene, origin, direction,
                                           alive, traversal)
            else:
                hit_mask = _any_hit(scene, origin, direction, alive,
                                    traversal)
            missed = alive & ~hit_mask
            color = color + jnp.where(
                missed[:, None], atten * sky_color(direction), 0.0
            )
            alive = jnp.zeros_like(alive)
            continue
        if sort_secondary and j > 0:
            hit = _closest_hit_sorted(scene, origin, direction, alive,
                                      traversal, seed=seed)
        else:
            hit = _closest_hit(scene, origin, direction, alive, traversal,
                               seed=seed)
        prev_hit = hit
        missed = alive & (hit.t >= MISS_T)
        did_hit = alive & ~missed

        color = color + jnp.where(
            missed[:, None], atten * sky_color(direction), 0.0
        )

        tri_data = mat = None
        if j == num_bounces - 1:
            # Last bounce: only emissive feeds radiance — skip the
            # 34-f32 attribute-row gather + material decode when the
            # scene supports the lean fetch (values identical).
            emissive = get_emissive_lean(scene, hit)
        else:
            emissive = None
        if emissive is None:
            tri_data = get_triangle_data(scene, hit)
            mat = get_material_data(scene, tri_data)
            emissive = mat.emissive

        color = color + jnp.where(
            did_hit[:, None], emissive * EMISSIVE_SCALE * atten, 0.0
        )

        if j < num_bounces - 1:
            out_dir = -direction
            shading = ShadingInfo(
                normal=mat.normal,
                out_dir=out_dir,
                lambert_out=dot(mat.normal, out_dir),
                fresnel_0=mix(
                    jnp.float32(F0_DIELECTRIC),
                    mat.albedo[:, :3],
                    mat.metallic[:, None],
                ),
                diffuse_albedo=mat.albedo[:, :3]
                - mat.metallic[:, None] * mat.albedo[:, :3],
                roughness=jnp.maximum(ROUGHNESS_FLOOR, mat.roughness),
            )

            # Draw exactly where the reference draws (hit & not last
            # bounce) so the stream stays aligned with its breaks.
            nsx, nsy, rx, ry = rng.pcg2d(seed_x, seed_y)
            seed_x = jnp.where(did_hit, nsx, seed_x)
            seed_y = jnp.where(did_hit, nsy, seed_y)

            new_origin = (
                origin
                + hit.t[:, None] * direction
                + tri_data.geometry_normal * ORIGIN_OFFSET
            )
            new_direction = sample_brdf(shading, rx, ry)

            density = get_brdf_density(shading, new_direction)
            lambert_in = dot(shading.normal, new_direction)
            killed = lambert_in <= 0.0

            weight = (
                brdf(shading, new_direction)
                * lambert_in[:, None]
                / jnp.maximum(density, jnp.float32(1e-30))[:, None]
            )
            survive = did_hit & ~killed
            atten = jnp.where(survive[:, None], atten * weight, atten)
            origin = jnp.where(did_hit[:, None], new_origin, origin)
            direction = jnp.where(did_hit[:, None], new_direction, direction)
            alive = survive

            if russian_roulette and j + 1 >= rr_start_bounce:
                p_survive = jnp.clip(
                    jnp.max(atten, axis=-1), 0.05, 1.0
                )
                nsx, nsy, rrx, _ = rng.pcg2d(seed_x, seed_y)
                seed_x = jnp.where(alive, nsx, seed_x)
                seed_y = jnp.where(alive, nsy, seed_y)
                rr_kill = rrx >= p_survive
                atten = jnp.where(
                    (alive & ~rr_kill)[:, None], atten / p_survive[:, None], atten
                )
                alive = alive & ~rr_kill
        else:
            alive = jnp.zeros_like(alive)

    return color, seed_x, seed_y, rays_traced


def _bounce_sort_key(scene, origin, direction, alive):
    """Bounce-ray sort key; dead lanes to the end.  Two layouts:

    - "6d" (default): interleaved origin/endpoint Morton, 5 bits per
      axis each, endpoint = origin + 0.5*diag*direction.  Binning by
      BOTH ends of the working segment groups rays that share a cell
      AND a direction corridor.  Ordering affects only efficiency,
      never results.
    - "octant" (VKPT_SORT_KEY=octant): direction octant (3 bits) |
      origin Morton.
    """
    import os

    octant = (
        (direction[:, 0] < 0).astype(jnp.uint32)
        + 2 * (direction[:, 1] < 0).astype(jnp.uint32)
        + 4 * (direction[:, 2] < 0).astype(jnp.uint32)
    )
    if not scene.has_bvh:
        return jnp.where(alive, octant, jnp.uint32(0xFFFFFFFF))
    lo = scene.bvh_packed[0, 0:3]
    hi = scene.bvh_packed[0, 3:6]
    ext = jnp.maximum(hi - lo, 1e-9)
    if os.environ.get("VKPT_SORT_KEY", "6d") == "6d":
        frac = float(os.environ.get("VKPT_SORT_L", "0.5"))
        L = frac * jnp.linalg.norm(ext)
        qo = jnp.clip((origin - lo) / ext * 31.0, 0.0, 31.0).astype(
            jnp.uint32)
        qe = jnp.clip((origin + L * direction - lo) / ext * 31.0,
                      0.0, 31.0).astype(jnp.uint32)
        key = jnp.zeros(origin.shape[0], jnp.uint32)
        for b in range(4, -1, -1):
            for comp in (qo[:, 0], qo[:, 1], qo[:, 2],
                         qe[:, 0], qe[:, 1], qe[:, 2]):
                key = (key << jnp.uint32(1)) | (
                    (comp >> jnp.uint32(b)) & jnp.uint32(1))
    else:
        q = jnp.clip((origin - lo) / ext * 1023.0, 0.0, 1023.0).astype(
            jnp.uint32
        )
        morton = (
            _interleave10(q[:, 0])
            | (_interleave10(q[:, 1]) << 1)
            | (_interleave10(q[:, 2]) << 2)
        )
        key = (octant << jnp.uint32(28)) | (morton >> jnp.uint32(2))
    return jnp.where(alive, key, jnp.uint32(0xFFFFFFFF))


def _shade_and_extend(scene, hit, origin, direction, atten, color,
                      seed_x, seed_y, alive, *, last: bool,
                      rr: bool):
    """One bounce's shading + next-ray generation on a lane set —
    identical math/draw order to trace_sample's loop body."""
    missed = alive & (hit.t >= MISS_T)
    did_hit = alive & ~missed
    color = color + jnp.where(
        missed[:, None], atten * sky_color(direction), 0.0
    )
    emissive = get_emissive_lean(scene, hit) if last else None
    if emissive is None:
        tri_data = get_triangle_data(scene, hit)
        mat = get_material_data(scene, tri_data)
        emissive = mat.emissive
    color = color + jnp.where(
        did_hit[:, None], emissive * EMISSIVE_SCALE * atten, 0.0
    )
    if last:
        return origin, direction, atten, color, seed_x, seed_y, \
            jnp.zeros_like(alive)

    out_dir = -direction
    sh = ShadingInfo(
        normal=mat.normal,
        out_dir=out_dir,
        lambert_out=dot(mat.normal, out_dir),
        fresnel_0=mix(jnp.float32(F0_DIELECTRIC), mat.albedo[:, :3],
                      mat.metallic[:, None]),
        diffuse_albedo=mat.albedo[:, :3]
        - mat.metallic[:, None] * mat.albedo[:, :3],
        roughness=jnp.maximum(ROUGHNESS_FLOOR, mat.roughness),
    )
    nsx, nsy, rx, ry = rng.pcg2d(seed_x, seed_y)
    seed_x = jnp.where(did_hit, nsx, seed_x)
    seed_y = jnp.where(did_hit, nsy, seed_y)
    new_origin = (
        origin + hit.t[:, None] * direction
        + tri_data.geometry_normal * ORIGIN_OFFSET
    )
    new_direction = sample_brdf(sh, rx, ry)
    density = get_brdf_density(sh, new_direction)
    lambert_in = dot(sh.normal, new_direction)
    weight = (
        brdf(sh, new_direction) * lambert_in[:, None]
        / jnp.maximum(density, jnp.float32(1e-30))[:, None]
    )
    survive = did_hit & (lambert_in > 0.0)
    atten = jnp.where(survive[:, None], atten * weight, atten)
    origin = jnp.where(did_hit[:, None], new_origin, origin)
    direction = jnp.where(did_hit[:, None], new_direction, direction)
    alive = survive
    if rr:
        p_survive = jnp.clip(jnp.max(atten, axis=-1), 0.05, 1.0)
        nsx, nsy, rrx, _ = rng.pcg2d(seed_x, seed_y)
        seed_x = jnp.where(alive, nsx, seed_x)
        seed_y = jnp.where(alive, nsy, seed_y)
        rr_kill = rrx >= p_survive
        atten = jnp.where((alive & ~rr_kill)[:, None],
                          atten / p_survive[:, None], atten)
        alive = alive & ~rr_kill
    return origin, direction, atten, color, seed_x, seed_y, alive


# Packed wavefront state columns ((M, 16) f32): origin, direction,
# attenuation, accumulated color, pcg2d seeds (bitcast), alive flag,
# original lane id (bitcast).  One row gather re-sorts the whole
# wavefront per bounce.
_ST_O = slice(0, 3)
_ST_D = slice(3, 6)
_ST_ATT = slice(6, 9)
_ST_COL = slice(9, 12)
_ST_SX = 12
_ST_SY = 13
_ST_ALIVE = 14
_ST_LANE = 15

WAVEFRONT_CHUNK = 1 << 20  # rays per chunked dispatch (bounds HBM temps)


def _pack_state(o, d, atten, color, sx, sy, alive, lane):
    return jnp.concatenate(
        [
            o, d, atten, color,
            jax.lax.bitcast_convert_type(sx, jnp.float32)[:, None],
            jax.lax.bitcast_convert_type(sy, jnp.float32)[:, None],
            alive.astype(jnp.float32)[:, None],
            jax.lax.bitcast_convert_type(lane, jnp.float32)[:, None],
        ],
        axis=1,
    )


def _unpack_state(st):
    return (
        st[:, _ST_O], st[:, _ST_D], st[:, _ST_ATT], st[:, _ST_COL],
        jax.lax.bitcast_convert_type(st[:, _ST_SX], jnp.uint32),
        jax.lax.bitcast_convert_type(st[:, _ST_SY], jnp.uint32),
        st[:, _ST_ALIVE] > 0.5,
        jax.lax.bitcast_convert_type(st[:, _ST_LANE], jnp.uint32),
    )


def trace_wavefront_pooled(scene, origin, direction, seed_x, seed_y, *,
                           num_bounces: int, traversal: str = "auto",
                           russian_roulette: bool = False,
                           rr_start_bounce: int = 2,
                           sort_secondary: bool = True,
                           chunk: int = None):
    """Trace a POOLED wavefront of rays from several frames (possibly
    different cameras) jointly: frames-in-flight as one ray stream.

    Where ``trace_progressive_batch`` exploits a static camera (one
    shared primary hit), this path keeps every frame's own primary
    rays but merges ALL frames into one packed state matrix so each
    bounce's global sort orders rays drawn from an F-times denser key
    space.

    Exactness: per-(pixel, frame) pcg2d streams are seeded
    independently (frame_count seeds the stream, ray_gen.rgen:41), the
    shading math per lane is identical to ``trace_sample``, and every
    lane scatters to its own output row — hits and RNG streams are
    bit-exact vs rendering each frame alone; radiance matches up to
    XLA fma-fusion differences between the two programs (~1 ulp, same
    as render_frames_joint).  Requires 1 spp (the per-pixel stream's
    sequential sample draws forbid cross-sample pooling).

    ``origin``/``direction``: (M, 3) pooled bounce-0 rays (all frames
    concatenated, any coherent order); ``seed_x``/``seed_y``: (M,).
    Returns (color (M, 3) in input lane order, physical rays traced).
    """
    m = origin.shape[0]
    if chunk is None:
        chunk = WAVEFRONT_CHUNK
    chunk = min(chunk, m)

    lane = jnp.arange(m, dtype=jnp.uint32)
    state = _pack_state(
        origin, direction,
        jnp.ones((m, 3), jnp.float32),
        jnp.zeros((m, 3), jnp.float32),
        seed_x, seed_y,
        jnp.ones((m,), bool), lane,
    )
    pad = (-m) % chunk
    if pad:
        state = jnp.pad(state, ((0, pad), (0, 0)))
    n_chunks = state.shape[0] // chunk
    rays_traced = jnp.float32(0.0)

    def chunk_fn(last: bool, rr: bool):
        anyhit = last and _anyhit_enabled(scene)

        def fn(st):
            o, d, atten, color, csx, csy, c_alive, c_lane = \
                _unpack_state(st)

            def work(args):
                o, d, atten, color, csx, csy, c_alive = args
                if anyhit:
                    # Emissive-free last bounce: sky/miss only.
                    hm = _any_hit(scene, o, d, c_alive, traversal)
                    missed = c_alive & ~hm
                    color2 = color + jnp.where(
                        missed[:, None], atten * sky_color(d), 0.0)
                    return (o, d, atten, color2, csx, csy,
                            jnp.zeros_like(c_alive))
                hit = _closest_hit(scene, o, d, c_alive, traversal)
                return _shade_and_extend(
                    scene, hit, o, d, atten, color, csx, csy, c_alive,
                    last=last, rr=rr,
                )

            def skip(args):
                o, d, atten, color, csx, csy, c_alive = args
                return (o, d, atten, color, csx, csy,
                        jnp.zeros_like(c_alive))

            count = jnp.sum(c_alive.astype(jnp.float32))
            o, d, atten, color, csx, csy, c_alive = jax.lax.cond(
                count > 0, work, skip,
                (o, d, atten, color, csx, csy, c_alive),
            )
            return _pack_state(o, d, atten, color, csx, csy, c_alive,
                               c_lane), count

        return fn

    for j in range(num_bounces):
        if sort_secondary and j > 0:
            o, d, _, _, _, _, alive, _ = _unpack_state(state)
            key = _bounce_sort_key(scene, o, d, alive)
            state = _permute_state(state, key, _sort_chunk())
        last = j == num_bounces - 1
        rr = russian_roulette and (j + 1) >= rr_start_bounce
        state, counts = jax.lax.map(
            chunk_fn(last, rr), state.reshape(n_chunks, chunk, 16)
        )
        state = state.reshape(-1, 16)
        rays_traced = rays_traced + jnp.sum(counts)

    _, _, _, color, _, _, _, out_lane = _unpack_state(state)
    # Pad lanes carry lane id 0 but only ever zero color (alive=False
    # from the first bounce), so the scatter-add is exact.
    color_out = jnp.zeros((m, 3), jnp.float32).at[
        out_lane.astype(jnp.int32)
    ].add(color, mode="drop")
    return color_out, rays_traced


def trace_progressive_batch(scene, origin, direction, seed_x, seed_y, *,
                            batch: int, num_bounces: int,
                            traversal: str = "auto",
                            russian_roulette: bool = False,
                            rr_start_bounce: int = 2,
                            sort_secondary: bool = True,
                            chunk: int = WAVEFRONT_CHUNK):
    """Trace ``batch`` progressive frames of the SAME camera jointly as
    one persistent wavefront.

    Structure (SURVEY.md §7 M3 made real):

    1. The primary hit is camera-determined and identical across
       frames (frame_count only seeds the RNG, ray_gen.rgen:41) —
       traced and shaded ONCE per batch.
    2. All frames' bounce-j rays live in one packed (batch*N, 16)
       state matrix, globally re-sorted per bounce by the bounce key
       with dead rays at the end.
    3. The sorted wavefront is traversed+shaded in fixed-size chunks
       under lax.map (bounds peak HBM); chunks whose rays are all dead
       skip traversal and shading entirely via lax.cond — true
       wavefront compaction at chunk granularity with zero extra data
       movement.

    Exactness: per-frame pcg2d streams are independent (frame index
    seeds them), so vectorizing over frames preserves every stream
    bit-exactly; sorting is scheduling-only (hits, RNG draws, and ray
    counts are exact).  Chunked dispatch (VKPT_CHUNK) is allclose-
    not-bitexact vs the unchunked program: XLA reassociates the
    shading arithmetic differently across program shapes (~2^-18
    diffs on a few permille of lanes — tests assert tight allclose +
    exact ray counts).  Requires 1 spp
    (cross-SAMPLE batching would break the per-pixel stream's
    sequential draw order).

    ``seed_x/seed_y``: (batch, N) uint32.  Returns
    (color_sum (N, 3) summed over frames, physical rays traced).
    """
    n = origin.shape[0]
    b = batch
    m = b * n

    rays_traced = jnp.float32(n)

    # ---- bounce 0: shared across frames ----
    hit0 = _closest_hit(scene, origin, direction, None, traversal)
    missed0 = hit0.t >= MISS_T
    did0 = ~missed0
    tri0 = get_triangle_data(scene, hit0)
    mat0 = get_material_data(scene, tri0)

    base = jnp.where(missed0[:, None], sky_color(direction), 0.0)
    base = base + jnp.where(
        did0[:, None], mat0.emissive * EMISSIVE_SCALE, 0.0
    )
    color_sum = jnp.float32(float(b)) * base  # atten == 1 at bounce 0

    if num_bounces == 1:
        return color_sum, rays_traced

    out_dir0 = -direction
    shading0 = ShadingInfo(
        normal=mat0.normal,
        out_dir=out_dir0,
        lambert_out=dot(mat0.normal, out_dir0),
        fresnel_0=mix(jnp.float32(F0_DIELECTRIC), mat0.albedo[:, :3],
                      mat0.metallic[:, None]),
        diffuse_albedo=mat0.albedo[:, :3]
        - mat0.metallic[:, None] * mat0.albedo[:, :3],
        roughness=jnp.maximum(ROUGHNESS_FLOOR, mat0.roughness),
    )

    def tile_b(x):
        return jnp.broadcast_to(
            x[None], (b,) + x.shape
        ).reshape((b * n,) + x.shape[1:])

    sh = ShadingInfo(*(tile_b(f) for f in shading0))
    sx = seed_x.reshape(-1)
    sy = seed_y.reshape(-1)
    did0_b = tile_b(did0)

    nsx, nsy, rx, ry = rng.pcg2d(sx, sy)
    sx = jnp.where(did0_b, nsx, sx)
    sy = jnp.where(did0_b, nsy, sy)

    new_origin0 = (
        origin + hit0.t[:, None] * direction
        + tri0.geometry_normal * ORIGIN_OFFSET
    )
    o_b = tile_b(new_origin0)
    d_b = sample_brdf(sh, rx, ry)
    density = get_brdf_density(sh, d_b)
    lambert_in = dot(sh.normal, d_b)
    weight = (
        brdf(sh, d_b) * lambert_in[:, None]
        / jnp.maximum(density, jnp.float32(1e-30))[:, None]
    )
    alive = did0_b & (lambert_in > 0.0)
    atten = jnp.where(alive[:, None], weight, 1.0)
    o_b = jnp.where(did0_b[:, None], o_b, tile_b(origin))
    d_b = jnp.where(did0_b[:, None], d_b, tile_b(direction))
    if russian_roulette and 1 >= rr_start_bounce:
        p_survive = jnp.clip(jnp.max(atten, axis=-1), 0.05, 1.0)
        nsx, nsy, rrx, _ = rng.pcg2d(sx, sy)
        sx = jnp.where(alive, nsx, sx)
        sy = jnp.where(alive, nsy, sy)
        rr_kill = rrx >= p_survive
        atten = jnp.where((alive & ~rr_kill)[:, None],
                          atten / p_survive[:, None], atten)
        alive = alive & ~rr_kill

    lane = jnp.arange(m, dtype=jnp.uint32)
    color0 = jnp.zeros((m, 3), jnp.float32)
    state = _pack_state(o_b, d_b, atten, color0, sx, sy, alive, lane)

    # Pad to a chunk multiple with dead lanes (lane 0 accumulates only
    # zeros from them).
    chunk = min(chunk, m)
    pad = (-m) % chunk
    if pad:
        state = jnp.pad(state, ((0, pad), (0, 0)))
    n_chunks = state.shape[0] // chunk

    def chunk_fn(last: bool, rr: bool):
        anyhit = last and _anyhit_enabled(scene)

        def fn(st):
            o, d, atten, color, csx, csy, c_alive, c_lane = \
                _unpack_state(st)

            def work(args):
                o, d, atten, color, csx, csy, c_alive = args
                if anyhit:
                    # Emissive-free last bounce: sky/miss only.
                    hm = _any_hit(scene, o, d, c_alive, traversal)
                    missed = c_alive & ~hm
                    col2 = color + jnp.where(
                        missed[:, None], atten * sky_color(d), 0.0)
                    return (o, d, atten, col2, csx, csy,
                            jnp.zeros_like(c_alive))
                hit = _closest_hit(scene, o, d, c_alive, traversal)
                o2, d2, att2, col2, sx2, sy2, al2 = _shade_and_extend(
                    scene, hit, o, d, atten, color, csx, csy, c_alive,
                    last=last, rr=rr,
                )
                return o2, d2, att2, col2, sx2, sy2, al2

            def skip(args):
                o, d, atten, color, csx, csy, c_alive = args
                return (o, d, atten, color, csx, csy,
                        jnp.zeros_like(c_alive))

            count = jnp.sum(c_alive.astype(jnp.float32))
            o, d, atten, color, csx, csy, c_alive = jax.lax.cond(
                count > 0, work, skip,
                (o, d, atten, color, csx, csy, c_alive),
            )
            return _pack_state(o, d, atten, color, csx, csy, c_alive,
                               c_lane), count

        return fn

    for j in range(1, num_bounces):
        last = j == num_bounces - 1
        if sort_secondary:
            o, d, _, _, _, _, alive, _ = _unpack_state(state)
            key = _bounce_sort_key(scene, o, d, alive)
            state = _permute_state(state, key, _sort_chunk())
        rr = russian_roulette and (j + 1) >= rr_start_bounce
        state, counts = jax.lax.map(
            chunk_fn(last, rr), state.reshape(n_chunks, chunk, 16)
        )
        state = state.reshape(-1, 16)
        rays_traced = rays_traced + jnp.sum(counts)

    _, _, _, color, _, _, _, lane = _unpack_state(state)
    pix = (lane % jnp.uint32(n)).astype(jnp.int32)
    color_sum = color_sum + jnp.zeros((n, 3), jnp.float32).at[pix].add(
        color
    )
    return color_sum, rays_traced
