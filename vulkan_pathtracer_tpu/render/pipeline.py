"""Compiled render pipeline — the RT-pipeline + SBT analog.

The reference burns NUM_SAMPLES/NUM_BOUNCES into SPIR-V specialization
constants at pipeline creation (RayTracingPipeline.zig:286-320) and
passes camera + frame_count as push constants each frame
(ray_gen.rgen:23-29).  Here the split is identical under XLA:

- static (recompile on change): samples, bounces, render resolution,
  traversal mode, RR — the RenderConfig.static_key().
- traced (per-call): camera position/horizontal/vertical/forward and
  the frame counter.

``RenderPipeline.render(camera, frame)`` returns linear radiance
(H, W, 3) f32 on device plus the number of rays actually traced
(for Mrays/s stats).

Sample iteration uses ``lax.scan`` with the pcg2d state as carry so
every sample continues the *same* per-pixel random stream as the
reference's inner sample loop (ray_gen.rgen:44).
"""

from __future__ import annotations

import functools
import os
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vulkan_pathtracer_tpu.models.camera import Camera
from vulkan_pathtracer_tpu.models.device_scene import DeviceScene
from vulkan_pathtracer_tpu.ops import rng
from vulkan_pathtracer_tpu.ops.vecmath import normalize
from vulkan_pathtracer_tpu.render.wavefront import trace_sample
from vulkan_pathtracer_tpu.utils.config import RenderConfig


def generate_rays(position, horizontal, vertical, forward,
                  width: int, height: int, y_offset=0, rows: int = None):
    """Primary rays — ray_gen.rgen:34-48.

    Renders image rows [y_offset, y_offset + rows) of a (height, width)
    launch (rows defaults to height); NDC is always computed against
    the full launch size, so sharded tiles compose exactly.
    Returns (origin (N,3), direction (N,3)) with N = rows*W, row-major.
    """
    if rows is None:
        rows = height
    ys = jnp.arange(rows, dtype=jnp.float32) + jnp.asarray(
        y_offset, jnp.float32
    )
    xs = jnp.arange(width, dtype=jnp.float32)
    px = (xs + 0.5) / jnp.float32(width) * 2.0 - 1.0   # d.x
    py = (ys + 0.5) / jnp.float32(height) * 2.0 - 1.0  # d.y
    dx = jnp.tile(px[None, :], (rows, 1)).reshape(-1)
    dy = jnp.repeat(py, width)
    direction = normalize(
        forward[None, :]
        + horizontal[None, :] * dx[:, None]
        - vertical[None, :] * dy[:, None]
    )
    origin = jnp.broadcast_to(position[None, :], direction.shape)
    return origin, direction


def generate_rays_at(position, horizontal, vertical, forward,
                     width: int, height: int, x_idx, y_idx):
    """Primary rays for explicit pixel coordinates (x_idx, y_idx)
    ((N,) int32, y in FULL-image rows).  Same per-lane f32 formula as
    generate_rays — generating directly in a permuted (e.g. 2D-tile)
    order is bit-identical to generating row-major and gathering, and
    removes the permutation gathers entirely."""
    px = (x_idx.astype(jnp.float32) + 0.5) / jnp.float32(width) \
        * 2.0 - 1.0
    py = (y_idx.astype(jnp.float32) + 0.5) / jnp.float32(height) \
        * 2.0 - 1.0
    direction = normalize(
        forward[None, :]
        + horizontal[None, :] * px[:, None]
        - vertical[None, :] * py[:, None]
    )
    origin = jnp.broadcast_to(position[None, :], direction.shape)
    return origin, direction


def _pixel_seeds(width: int, height: int, frame, y_offset=0,
                 rows: int = None):
    if rows is None:
        rows = height
    xs = jnp.arange(width, dtype=jnp.uint32)
    ys = jnp.arange(rows, dtype=jnp.uint32) + jnp.asarray(
        y_offset, jnp.uint32
    )
    px = jnp.tile(xs[None, :], (rows, 1)).reshape(-1)
    py = jnp.repeat(ys, width)
    return rng.prng_seed(px, py, frame)


# Target rays per dispatch chunk: bounds the device memory the
# traversal and shading temporaries of one lax.map body take.
# VKPT_RAY_CHUNK overrides.
DEFAULT_RAY_CHUNK = int(os.environ.get("VKPT_RAY_CHUNK", 1 << 19))

# Primary rays are dispatched in 2D image tiles, not scanlines, so
# neighbouring lanes of a traversal program share a tight frustum.
# Pure scheduling — per-pixel results unchanged.
TILE_H = int(os.environ.get("VKPT_TILE_H", 32))
TILE_W = int(os.environ.get("VKPT_TILE_W", 64))


def _tile_order(rows: int, width: int):
    """(order, inverse): permutation mapping tile-major lane ->
    scanline pixel index.  Stable sort keeps row-major order within a
    tile and groups ragged edge tiles."""
    y, x = np.mgrid[0:rows, 0:width]
    tiles_x = (width + TILE_W - 1) // TILE_W
    key = ((y // TILE_H).astype(np.int64) * tiles_x
           + (x // TILE_W)).reshape(-1)
    order = np.argsort(key, kind="stable").astype(np.int32)
    inv = np.argsort(order).astype(np.int32)
    return order, inv


def tile_inverse(height: int, width: int):
    """Host-side inverse pixel permutation for presentation, or None
    when the launch doesn't use tile order.  Callers rendering with
    ``present_order=False`` apply it once at present/save time —
    radiance sums and progressive accumulation are order-invariant,
    so the per-frame device gather is presentation-layer work."""
    if height > TILE_H and width > TILE_W:
        _, t_inv = _tile_order(height, width)
        return t_inv
    return None


def _pick_chunks(n: int, target: int) -> int:
    """Smallest chunk count >= n/target that divides n exactly.

    Bounded scan: if no divisor lands within 4x of the ideal count
    (prime-ish n), fall back to a single chunk rather than degrade
    into thousands of tiny dispatches."""
    if target <= 0 or n <= target:
        return 1
    ideal = -(-n // target)
    num = ideal
    while n % num:
        num += 1
        if num > 4 * ideal:
            return 1
    return num


def render_rows(scene: DeviceScene, position, horizontal, vertical,
                forward, frame, *, num_samples: int, num_bounces: int,
                width: int, height: int, y_offset=0, rows: int = None,
                traversal: str = "auto", russian_roulette: bool = False,
                rr_start_bounce: int = 2,
                ray_chunk: int = DEFAULT_RAY_CHUNK,
                sort_secondary: bool = False,
                seed_secondary: bool = False,
                present_order: bool = True):
    """Render image rows [y_offset, y_offset+rows): the shared core of
    the single-chip frame and the per-device tile under shard_map.

    Rays are dispatched in chunks (lax.map) when the launch exceeds
    ``ray_chunk``: this bounds peak HBM for the traversal state and
    lets early-converging chunks finish without waiting on the global
    slowest ray (the wavefront analog of workgroup scheduling).

    ``present_order=False`` returns radiance in DISPATCH (2D-tile)
    order, skipping the per-frame inverse-permutation gather: frame
    loops that only accumulate (sums are order-invariant) present via
    tile_inverse() once at output time — the swapchain analog of
    presenting from the storage image only when shown.
    """
    if rows is None:
        rows = height
    n = rows * width

    # Trace in 2D-tile order (see _tile_order); colors are scattered
    # back to scanline order after the bounce loop.  Rays and seeds
    # are GENERATED directly in tile order from the static pixel
    # permutation (bit-identical to row-major + gather, per-lane
    # elementwise math), which saves four column gathers per frame.
    tile_inv = None
    if rows > TILE_H and width > TILE_W:
        t_order, t_inv = _tile_order(rows, width)
        tile_inv = jnp.asarray(t_inv)
        pix = jnp.asarray(t_order)
        x_idx = pix % width
        y_idx = pix // width + jnp.asarray(y_offset, jnp.int32)
        origin, direction = generate_rays_at(
            position, horizontal, vertical, forward, width, height,
            x_idx, y_idx,
        )
        seed_x, seed_y = rng.prng_seed(
            x_idx.astype(jnp.uint32), y_idx.astype(jnp.uint32), frame
        )
    else:
        origin, direction = generate_rays(
            position, horizontal, vertical, forward, width, height,
            y_offset=y_offset, rows=rows,
        )
        seed_x, seed_y = _pixel_seeds(width, height, frame,
                                      y_offset=y_offset, rows=rows)

    def trace_chunk(chunk):
        o, d, sx, sy = chunk

        def sample_body(carry, _):
            sx, sy, acc, rays = carry
            color, sx, sy, traced = trace_sample(
                scene, o, d, sx, sy,
                num_bounces=num_bounces,
                traversal=traversal,
                russian_roulette=russian_roulette,
                rr_start_bounce=rr_start_bounce,
                sort_secondary=sort_secondary,
                seed_secondary=seed_secondary,
            )
            return (sx, sy, acc + color, rays + traced), None

        init = (
            sx, sy,
            jnp.zeros((o.shape[0], 3), dtype=jnp.float32),
            jnp.float32(0.0),
        )
        if num_samples == 1:
            (_, _, acc, rays), _ = sample_body(init, None)
        else:
            (_, _, acc, rays), _ = jax.lax.scan(
                sample_body, init, None, length=num_samples
            )
        return acc, rays

    num_chunks = _pick_chunks(n, ray_chunk)
    if num_chunks == 1:
        acc, rays = trace_chunk((origin, direction, seed_x, seed_y))
    else:
        c = n // num_chunks
        acc, rays = jax.lax.map(
            trace_chunk,
            (
                origin.reshape(num_chunks, c, 3),
                direction.reshape(num_chunks, c, 3),
                seed_x.reshape(num_chunks, c),
                seed_y.reshape(num_chunks, c),
            ),
        )
        acc = acc.reshape(n, 3)
        rays = jnp.sum(rays)
    if tile_inv is not None and present_order:
        acc = acc[tile_inv]
    image = (acc / jnp.float32(num_samples)).reshape(rows, width, 3)
    return image, rays




@functools.partial(
    jax.jit,
    static_argnames=(
        "num_samples", "num_bounces", "width", "height", "traversal",
        "russian_roulette", "rr_start_bounce", "ray_chunk",
        "sort_secondary", "seed_secondary", "present_order",
    ),
)
def render_frame(scene: DeviceScene, position, horizontal, vertical,
                 forward, frame, *, num_samples: int, num_bounces: int,
                 width: int, height: int, traversal: str = "auto",
                 russian_roulette: bool = False, rr_start_bounce: int = 2,
                 ray_chunk: int = DEFAULT_RAY_CHUNK,
                 sort_secondary: bool = False,
                 seed_secondary: bool = False,
                 present_order: bool = True):
    """One full frame: (H, W, 3) f32 linear radiance + rays traced.
    With ``present_order=False`` radiance stays in dispatch order
    (see render_rows) — present via tile_inverse()."""
    return render_rows(
        scene, position, horizontal, vertical, forward, frame,
        num_samples=num_samples, num_bounces=num_bounces,
        width=width, height=height, traversal=traversal,
        russian_roulette=russian_roulette, rr_start_bounce=rr_start_bounce,
        ray_chunk=ray_chunk, sort_secondary=sort_secondary,
        seed_secondary=seed_secondary, present_order=present_order,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "num_samples", "num_bounces", "width", "height", "traversal",
        "russian_roulette", "rr_start_bounce", "ray_chunk",
        "sort_secondary", "seed_secondary", "batch",
    ),
)
def render_frames_batch(scene: DeviceScene, position, horizontal, vertical,
                        forward, frame0, *, batch: int, num_samples: int,
                        num_bounces: int, width: int, height: int,
                        traversal: str = "auto",
                        russian_roulette: bool = False,
                        rr_start_bounce: int = 2,
                        ray_chunk: int = DEFAULT_RAY_CHUNK,
                        sort_secondary: bool = False,
                        seed_secondary: bool = False):
    """Progressive batch: render ``batch`` consecutive frames (frame0,
    frame0+1, ...) in ONE dispatch and return their radiance SUM.

    Progressive accumulation (frame_count is only an RNG seed,
    ray_gen.rgen:41) needs no host work between frames, so a
    device-side lax.scan amortizes the per-frame dispatch.
    Returns (sum_image (H, W, 3), rays_total).
    """
    def body(carry, k):
        acc, rays = carry
        image, traced = render_rows(
            scene, position, horizontal, vertical, forward,
            frame0 + k.astype(jnp.uint32),
            num_samples=num_samples, num_bounces=num_bounces,
            width=width, height=height, traversal=traversal,
            russian_roulette=russian_roulette,
            rr_start_bounce=rr_start_bounce, ray_chunk=ray_chunk,
            sort_secondary=sort_secondary, seed_secondary=seed_secondary,
        )
        return (acc + image, rays + traced), None

    init = (
        jnp.zeros((height, width, 3), dtype=jnp.float32),
        jnp.float32(0.0),
    )
    (acc, rays), _ = jax.lax.scan(
        body, init, jnp.arange(batch, dtype=jnp.uint32)
    )
    return acc, rays


@functools.partial(
    jax.jit,
    static_argnames=(
        "batch", "num_bounces", "width", "height", "traversal",
        "russian_roulette", "rr_start_bounce", "sort_secondary",
    ),
)
def render_frames_joint(scene: DeviceScene, position, horizontal,
                        vertical, forward, frame0, *, batch: int,
                        num_bounces: int, width: int, height: int,
                        traversal: str = "auto",
                        russian_roulette: bool = False,
                        rr_start_bounce: int = 2,
                        sort_secondary: bool = True):
    """Progressive batch, JOINT wavefront (1 spp per frame): the
    primary hit is traced/shaded once for all ``batch`` frames (the
    camera is static; frame_count only seeds the RNG), and every
    bounce level sorts all frames' rays together (see
    render/wavefront.trace_progressive_batch).  Returns
    (sum_image (H, W, 3), rays_physically_traced)."""
    from vulkan_pathtracer_tpu.render.wavefront import (
        trace_progressive_batch,
    )

    n = height * width
    tile_inv = None
    if height > TILE_H and width > TILE_W:
        # Generate directly in tile order (see render_rows).
        t_order, t_inv = _tile_order(height, width)
        tile_inv = jnp.asarray(t_inv)
        pix = jnp.asarray(t_order)
        x_idx = pix % width
        y_idx = pix // width
        origin, direction = generate_rays_at(
            position, horizontal, vertical, forward, width, height,
            x_idx, y_idx,
        )
        px = x_idx.astype(jnp.uint32)
        py = y_idx.astype(jnp.uint32)
    else:
        origin, direction = generate_rays(
            position, horizontal, vertical, forward, width, height,
        )
        px = jnp.tile(jnp.arange(width, dtype=jnp.uint32)[None, :],
                      (height, 1)).reshape(-1)
        py = jnp.repeat(jnp.arange(height, dtype=jnp.uint32), width)

    frames = frame0 + jnp.arange(batch, dtype=jnp.uint32)
    seed_x, seed_y = jax.vmap(
        lambda f: rng.prng_seed(px, py, f)
    )(frames)

    # VKPT_CHUNK overrides the wavefront chunk size (rays per lax.map
    # body; default wavefront.WAVEFRONT_CHUNK).  Read at trace time —
    # a changed value forms a new jit cache entry only via
    # jax.clear_caches() or a fresh process (bench runs are fresh
    # processes; this is a measurement knob, not a live config).
    chunk_env = os.environ.get("VKPT_CHUNK")
    color_sum, rays = trace_progressive_batch(
        scene, origin, direction, seed_x, seed_y,
        batch=batch, num_bounces=num_bounces, traversal=traversal,
        russian_roulette=russian_roulette,
        rr_start_bounce=rr_start_bounce, sort_secondary=sort_secondary,
        **({} if not chunk_env else {"chunk": int(chunk_env)}),
    )
    if tile_inv is not None:
        color_sum = color_sum[tile_inv]
    return color_sum.reshape(height, width, 3), rays


@functools.partial(
    jax.jit,
    static_argnames=(
        "num_bounces", "width", "height", "traversal",
        "russian_roulette", "rr_start_bounce", "sort_secondary",
        "ray_chunk",
    ),
)
def render_frames_pooled(scene: DeviceScene, positions, horizontals,
                         verticals, forwards, frames, *,
                         num_bounces: int, width: int, height: int,
                         traversal: str = "auto",
                         russian_roulette: bool = False,
                         rr_start_bounce: int = 2,
                         sort_secondary: bool = True,
                         ray_chunk: int = None):
    """Render F frames with (possibly) DIFFERENT cameras as ONE pooled
    wavefront — frames-in-flight as a ray stream (1 spp).

    The reference keeps multiple swapchain frames in flight
    (GraphicsContext.zig frame resources); here their rays are pooled
    and every bounce's global sort orders an F-times denser key space.
    Per-frame
    images match rendering each frame alone to ~1 ulp (see
    wavefront.trace_wavefront_pooled).

    ``positions``..``forwards``: (F, 3) camera push constants;
    ``frames``: (F,) uint32 frame counters.  Returns
    (images (F, H, W, 3) f32, rays traced).
    """
    from vulkan_pathtracer_tpu.render.wavefront import (
        trace_wavefront_pooled,
    )

    f = positions.shape[0]
    n = height * width

    tile_inv = None
    if height > TILE_H and width > TILE_W:
        # Generate directly in tile order (see render_rows).
        t_order, t_inv = _tile_order(height, width)
        tile_inv = jnp.asarray(t_inv)
        pix = jnp.asarray(t_order)
        x_idx = pix % width
        y_idx = pix // width
        o_f, d_f = jax.vmap(
            lambda p, h, v, fw: generate_rays_at(
                p, h, v, fw, width, height, x_idx, y_idx)
        )(positions, horizontals, verticals, forwards)
        px = x_idx.astype(jnp.uint32)
        py = y_idx.astype(jnp.uint32)
    else:
        o_f, d_f = jax.vmap(
            lambda p, h, v, fw: generate_rays(p, h, v, fw, width,
                                              height)
        )(positions, horizontals, verticals, forwards)
        px = jnp.tile(jnp.arange(width, dtype=jnp.uint32)[None, :],
                      (height, 1)).reshape(-1)
        py = jnp.repeat(jnp.arange(height, dtype=jnp.uint32), width)

    seed_x, seed_y = jax.vmap(
        lambda fr: rng.prng_seed(px, py, fr)
    )(frames)

    color, rays = trace_wavefront_pooled(
        scene,
        o_f.reshape(f * n, 3), d_f.reshape(f * n, 3),
        seed_x.reshape(-1), seed_y.reshape(-1),
        num_bounces=num_bounces, traversal=traversal,
        russian_roulette=russian_roulette,
        rr_start_bounce=rr_start_bounce,
        sort_secondary=sort_secondary,
        **({} if ray_chunk is None else {"chunk": ray_chunk}),
    )
    color = color.reshape(f, n, 3)
    if tile_inv is not None:
        color = color[:, tile_inv]
    return color.reshape(f, height, width, 3), rays


class RenderPipeline:
    """Holds the scene + config and renders frames (the analog of
    RaytracingPass + RayTracingPipeline)."""

    def __init__(self, scene: DeviceScene, config: RenderConfig):
        self.scene = scene
        self.config = config
        self.width = config.render_width
        self.height = config.render_height
        traversal = config.traversal
        if traversal == "auto" and not scene.has_bvh:
            traversal = "brute"
        # "auto" + BVH stays auto: the wavefront picks the GPU kernel on
        # a GPU and the XLA traversal elsewhere.
        self._traversal = traversal
        # Bounce-ray sorting costs an argsort + row gathers per bounce;
        # on small scenes traversal is cheaper than the sort, so gate
        # it on scene size.
        self._sort_secondary = (
            config.sort_secondary and scene.num_triangles >= 16384
        )

    def render(self, camera: Camera, frame: int,
               present_order: bool = True) -> Tuple[jnp.ndarray, float]:
        """``present_order=False`` skips the per-frame inverse tile
        gather; the returned radiance is in dispatch
        order — accumulate freely (order-invariant) and convert once
        with ``to_present`` when showing/saving."""
        position, horizontal, vertical, forward = (
            jnp.asarray(v) for v in camera.push_constants()
        )
        image, rays = render_frame(
            self.scene,
            position, horizontal, vertical, forward,
            jnp.uint32(frame),
            num_samples=self.config.num_samples,
            num_bounces=self.config.num_bounces,
            width=self.width,
            height=self.height,
            traversal=self._traversal,
            russian_roulette=self.config.russian_roulette,
            rr_start_bounce=self.config.rr_start_bounce,
            ray_chunk=self.config.ray_chunk,
            sort_secondary=self._sort_secondary,
            seed_secondary=self.config.seed_secondary,
            present_order=present_order,
        )
        return image, rays

    def to_present(self, image: np.ndarray) -> np.ndarray:
        """Host-side dispatch-order -> scanline conversion (inverse of
        the static 2D-tile permutation); identity when the launch
        didn't use tile order."""
        t_inv = tile_inverse(self.height, self.width)
        if t_inv is None:
            return image
        h, w = self.height, self.width
        return np.asarray(image).reshape(h * w, 3)[t_inv].reshape(h, w, 3)

    def render_numpy(self, camera: Camera, frame: int):
        image, rays = self.render(camera, frame)
        return np.asarray(image), float(rays)

    def render_batch_sum(self, camera: Camera, frame0: int, batch: int,
                         joint: bool = None):
        """Sum of `batch` consecutive progressive frames in one
        dispatch.  At 1 spp the joint wavefront path is used (shared
        primary hit + cross-frame sorted bounces); multi-spp — or
        ``joint=False`` — falls back to the sequential device-side
        scan (same radiance up to XLA reassociation).  ``joint=True``
        forces the joint structure even at batch=1."""
        position, horizontal, vertical, forward = (
            jnp.asarray(v) for v in camera.push_constants()
        )
        use_joint = (self.config.num_samples == 1
                     and (batch > 1 if joint is None
                          else (joint and batch >= 1)))
        if use_joint:
            return render_frames_joint(
                self.scene, position, horizontal, vertical, forward,
                jnp.uint32(frame0),
                batch=batch,
                num_bounces=self.config.num_bounces,
                width=self.width,
                height=self.height,
                traversal=self._traversal,
                russian_roulette=self.config.russian_roulette,
                rr_start_bounce=self.config.rr_start_bounce,
                sort_secondary=self._sort_secondary,
            )
        return render_frames_batch(
            self.scene, position, horizontal, vertical, forward,
            jnp.uint32(frame0),
            batch=batch,
            num_samples=self.config.num_samples,
            num_bounces=self.config.num_bounces,
            width=self.width,
            height=self.height,
            traversal=self._traversal,
            russian_roulette=self.config.russian_roulette,
            rr_start_bounce=self.config.rr_start_bounce,
            ray_chunk=self.config.ray_chunk,
            sort_secondary=self._sort_secondary,
            seed_secondary=self.config.seed_secondary,
        )

    def render_pooled(self, cameras, frames):
        """Render ``len(cameras)`` frames (one Camera + frame counter
        each) as a single pooled wavefront — frames-in-flight
        throughput mode (1 spp only).  Returns (images (F, H, W, 3),
        rays traced); each image matches ``render(cameras[i],
        frames[i])`` to ~1 ulp."""
        if self.config.num_samples != 1:
            raise ValueError(
                "render_pooled requires 1 spp (cross-sample pooling "
                "would break the per-pixel RNG stream's draw order)"
            )
        pcs = [cam.push_constants() for cam in cameras]
        positions = jnp.asarray(np.stack([p[0] for p in pcs]))
        horizontals = jnp.asarray(np.stack([p[1] for p in pcs]))
        verticals = jnp.asarray(np.stack([p[2] for p in pcs]))
        forwards = jnp.asarray(np.stack([p[3] for p in pcs]))
        frames_arr = jnp.asarray(np.asarray(frames, dtype=np.uint32))
        return render_frames_pooled(
            self.scene, positions, horizontals, verticals, forwards,
            frames_arr,
            num_bounces=self.config.num_bounces,
            width=self.width, height=self.height,
            traversal=self._traversal,
            russian_roulette=self.config.russian_roulette,
            rr_start_bounce=self.config.rr_start_bounce,
            sort_secondary=self._sort_secondary,
        )

    def resize(self, width: int, height: int) -> "RenderPipeline":
        """Resolution change — the RaytracingPass.resize analog
        (RaytracingPass.zig:677-704).  Like the reference, the new
        render target uses the FULL new extent (the resolution divider
        is not reapplied — documented quirk); a new pipeline (=
        recompile on next render) is returned.
        """
        import dataclasses

        new_config = dataclasses.replace(
            self.config,
            resolution_x=width,
            resolution_y=height,
            render_resolution_divider=1,
        )
        return RenderPipeline(self.scene, new_config)
