"""Headless driver loop — the ``main.zig`` analog.

Startup mirrors main() (SURVEY.md §3.1): parse CLI -> load scene ->
bake device arrays + BVH (the BLAS/TLAS build boundary) -> compile the
render pipeline (the RT-pipeline/SBT creation) -> frame loop.  The
frame loop (SURVEY.md §3.2) becomes: camera-path update -> jitted
render step -> stats lap -> optional accumulation/checkpoint ->
present = PNG write.

Run:  python -m vulkan_pathtracer_tpu --scene-path scene.glb [flags]
"""

from __future__ import annotations

import sys

import numpy as np

from vulkan_pathtracer_tpu.app.camera_path import CameraPath
from vulkan_pathtracer_tpu.models import gltf
from vulkan_pathtracer_tpu.models.camera import Camera
from vulkan_pathtracer_tpu.models.device_scene import build_device_scene
from vulkan_pathtracer_tpu.render.output import Accumulator, upsample_nearest
from vulkan_pathtracer_tpu.render.pipeline import RenderPipeline
from vulkan_pathtracer_tpu.utils.cli import parse_args
from vulkan_pathtracer_tpu.utils.compile_cache import enable_compile_cache
from vulkan_pathtracer_tpu.utils.config import default_max_leaf
from vulkan_pathtracer_tpu.utils.png import write_png
from vulkan_pathtracer_tpu.utils.stats import Stats
from vulkan_pathtracer_tpu.utils.timer import Timer


def main(argv=None) -> int:
    config, args = parse_args(argv)

    import os

    import jax

    # The device comes from plain JAX_PLATFORMS; the persistent compile
    # cache makes repeated CLI invocations skip recompiles.
    enable_compile_cache()

    if config.enable_validation:
        jax.config.update("jax_debug_nans", True)

    print(f"loading scene: {args.scene_path}", file=sys.stderr)
    scene = gltf.load(args.scene_path,
                      quirk_mode=args.gltf_quirk_mode)
    print(
        f"scene: {len(scene.instances)} instances, "
        f"{len(scene.primitives)} primitives, "
        f"{scene.triangle_count} triangles, "
        f"{len(scene.materials)} materials, {len(scene.textures)} textures",
        file=sys.stderr,
    )

    if getattr(args, "instanced", False):
        from vulkan_pathtracer_tpu.models.instanced_scene import (
            build_instanced_scene,
        )

        # Leaf 14 for two-level scenes.  VKPT_LEAF overrides.
        dev = build_instanced_scene(
            scene, max_leaf_size=int(os.environ.get("VKPT_LEAF", "14")),
        )
        print(
            f"two-level BVH: {dev.num_triangles} shared triangles, "
            f"{dev.inst_inv.shape[0]} instances", file=sys.stderr,
        )
    else:
        # Size-keyed leaf policy (utils/config.py).  VKPT_LEAF overrides.
        default_leaf = default_max_leaf(scene.triangle_count)
        dev = build_device_scene(
            scene, build_bvh=(config.traversal != "brute"),
            max_leaf_size=int(os.environ.get("VKPT_LEAF",
                                             default_leaf)),
        )
    if config.enable_validation and dev.has_bvh:
        from vulkan_pathtracer_tpu.ops.bvh import build_bvh_host, validate_bvh

        host_bvh = build_bvh_host(
            np.asarray(dev.tri_v0)[: dev.num_triangles],
            np.asarray(dev.tri_e1)[: dev.num_triangles],
            np.asarray(dev.tri_e2)[: dev.num_triangles],
        )
        validate_bvh(
            host_bvh,
            np.asarray(dev.tri_v0)[: dev.num_triangles][host_bvh.tri_order],
            np.asarray(dev.tri_e1)[: dev.num_triangles][host_bvh.tri_order],
            np.asarray(dev.tri_e2)[: dev.num_triangles][host_bvh.tri_order],
        )
        print("BVH invariants validated", file=sys.stderr)

    if config.enable_validation:
        # Checkified smoke dispatch (index OOB / NaN / div checks) —
        # the validation-layer analog (see utils/validation.py).
        from vulkan_pathtracer_tpu.utils.validation import checked_render

        cam_v = Camera(aspect_ratio=config.aspect_ratio)
        checked_render(dev, cam_v, config)
        print("checkify render validation passed", file=sys.stderr)

    if args.devices > 1:
        from vulkan_pathtracer_tpu.parallel.sharding import (
            ShardedRenderPipeline,
        )

        pipeline = ShardedRenderPipeline(dev, config, args.devices,
                                         mode=args.shard_mode)
        print(
            f"sharding framebuffer across {args.devices} devices "
            f"(mode={args.shard_mode})", file=sys.stderr,
        )
    else:
        pipeline = RenderPipeline(dev, config)

    camera = Camera(aspect_ratio=config.aspect_ratio)
    path = CameraPath.load(args.camera_path) if args.camera_path else None

    if getattr(args, "interactive", False):
        from vulkan_pathtracer_tpu.app.viewer import run_viewer

        frames = run_viewer(pipeline, camera,
                            max_frames=args.frames if args.frames > 1
                            else 0)
        print(f"viewer closed after {frames} frames", file=sys.stderr)
        return 0

    rays_per_frame = (
        config.render_width * config.render_height
        * config.num_samples * config.num_bounces
    )
    stats = Stats(rays_per_frame=rays_per_frame,
                  spp_per_frame=config.num_samples)
    timer = Timer()

    acc = None
    start_frame = 0
    if config.progressive:
        if args.checkpoint:
            import os

            if os.path.exists(args.checkpoint):
                acc = Accumulator.load(args.checkpoint)
                start_frame = acc.frame
                print(
                    f"resumed checkpoint at frame {start_frame} "
                    f"({acc.spp} spp)", file=sys.stderr,
                )
        if acc is None:
            acc = Accumulator(config.render_width, config.render_height,
                              config.num_samples)

    profile_ctx = None
    if args.profile:
        from vulkan_pathtracer_tpu.utils.profiling import trace

        profile_ctx = trace(args.profile)
        profile_ctx.__enter__()
        print(f"profiling to {args.profile}", file=sys.stderr)

    if (config.progressive and args.batch_frames > 1
            and not args.camera_path and args.devices <= 1):
        # Static-camera progressive: render batches of frames per
        # dispatch (the frame counter is only an RNG seed).
        frame = start_frame
        frames_since_save = 0
        while frame < args.frames:
            b = min(args.batch_frames, args.frames - frame)
            sum_img, rays = pipeline.render_batch_sum(camera, frame, b)
            acc.add_frames_sum(np.asarray(sum_img), b)
            frame += b
            frames_since_save += b
            if (args.checkpoint and args.checkpoint_interval
                    and frames_since_save >= args.checkpoint_interval):
                acc.save(args.checkpoint)
                frames_since_save = 0
            dt = timer.lap()
            stats.lap(dt, timer.one_second_elapsed,
                      rays_this_frame=int(float(rays)))
            if timer.one_second_elapsed:
                stats.log()
        if profile_ctx is not None:
            profile_ctx.__exit__(None, None, None)
        _present(acc.mean, config, args.output)
        print(f"wrote {args.output} ({acc.spp} spp)", file=sys.stderr)
        stats.log()
        return 0

    if (getattr(args, "pool_frames", 1) > 1 and config.num_samples == 1
            and args.devices <= 1 and acc is None):
        # Frames-in-flight: pooled wavefront over groups of camera-path
        # frames (throughput mode; per-frame images unchanged).
        image = None
        frame = start_frame
        while frame < args.frames:
            g = min(args.pool_frames, args.frames - frame)
            cams = []
            for k in range(frame, frame + g):
                cam_k = Camera(aspect_ratio=config.aspect_ratio,
                               position=camera.position.copy(),
                               yaw=camera.yaw, pitch=camera.pitch)
                if path is not None:
                    t = path.duration * k / max(args.frames - 1, 1)
                    path.apply(cam_k, t)
                cams.append(cam_k)
            images_dev, rays = pipeline.render_pooled(
                cams, list(range(frame, frame + g))
            )
            image = np.asarray(images_dev[-1])
            frame += g
            dt = timer.lap()
            # Attribute the group's wall time evenly across its frames
            # so FPS/frame-time stats stay per-frame.
            for _ in range(g):
                stats.lap(dt / g, timer.one_second_elapsed,
                          rays_this_frame=int(float(rays)) // g)
            if timer.one_second_elapsed:
                stats.log()
            if args.save_every and frame % args.save_every == 0:
                _present(image, config, args.output)
        if profile_ctx is not None:
            profile_ctx.__exit__(None, None, None)
        if image is not None:
            _present(image, config, args.output)
            print(f"wrote {args.output}", file=sys.stderr)
        stats.log()
        return 0

    image = None
    for frame in range(start_frame, args.frames):
        if path is not None:
            t = path.duration * frame / max(args.frames - 1, 1)
            path.apply(camera, t)
        # Render in dispatch order (skips the per-frame inverse tile
        # gather) and convert on host once fetched — accumulation is
        # order-invariant, presentation happens at save time.
        image_dev, rays = pipeline.render(camera, frame,
                                          present_order=False)
        image = pipeline.to_present(np.asarray(image_dev))
        if acc is not None:
            acc.add_frame(image)
            if args.checkpoint and args.checkpoint_interval and (
                (frame + 1) % args.checkpoint_interval == 0
            ):
                acc.save(args.checkpoint)
        dt = timer.lap()
        stats.lap(dt, timer.one_second_elapsed,
                  rays_this_frame=int(float(rays)))
        if timer.one_second_elapsed:
            stats.log()
        if args.save_every and (frame + 1) % args.save_every == 0:
            _present(acc.mean if acc is not None else image, config,
                     args.output)

    if profile_ctx is not None:
        profile_ctx.__exit__(None, None, None)

    final = acc.mean if acc is not None else image
    if final is not None:
        _present(final, config, args.output)
        print(f"wrote {args.output}", file=sys.stderr)
    stats.log()
    return 0


def _present(image: np.ndarray, config, output: str) -> None:
    """Divider upsample (nearest blit, RaytracingPass.zig:599-635) +
    unorm8 quantize + PNG."""
    if config.render_resolution_divider > 1:
        image = upsample_nearest(image, config.resolution_x,
                                 config.resolution_y)
    write_png(output, image)


if __name__ == "__main__":
    raise SystemExit(main())
