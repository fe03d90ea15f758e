"""Headline benchmark: Mrays/s on the GPU, Sponza-class scene at 1080p.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N,
   "device": {...}, "detail": {...}}

``device`` names what the run measured: JAX's platform, device kind
and device count, and the card's name and power limit from
``nvidia-smi``.  The bench fails (exit 1, an ``error`` JSON line) when
JAX finds no GPU.  North star (BASELINE.json): >= 200 Mrays/s per
device on Sponza at 1080p; vs_baseline = value / 200.  No Sponza asset
ships here, so the stand-in is the procedural atrium
(assets/procedural.make_atrium) at Sponza's triangle count.

Env knobs: BENCH_WIDTH/HEIGHT/SPP/BOUNCES/FRAMES/GRID/SEGMENTS/SCENE/LEAF.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import numpy as np
    import jax

    from vulkan_pathtracer_tpu.utils.compile_cache import (
        enable_compile_cache,
    )
    from vulkan_pathtracer_tpu.utils.device import (
        nvidia_smi_power,
        require_gpu,
    )

    enable_compile_cache()
    try:
        device = require_gpu()
    except RuntimeError as e:
        print(json.dumps({"metric": "mrays_per_sec_per_chip",
                          "error": str(e)}))
        return 1
    device["nvidia_smi"] = nvidia_smi_power()

    from assets.procedural import make_columns
    from vulkan_pathtracer_tpu.models import gltf
    from vulkan_pathtracer_tpu.models.camera import Camera
    from vulkan_pathtracer_tpu.models.device_scene import build_device_scene
    from vulkan_pathtracer_tpu.render.pipeline import RenderPipeline
    from vulkan_pathtracer_tpu.utils.config import (
        RenderConfig,
        default_max_leaf,
    )

    width = int(os.environ.get("BENCH_WIDTH", 1920))
    height = int(os.environ.get("BENCH_HEIGHT", 1080))
    spp = int(os.environ.get("BENCH_SPP", 1))
    bounces = int(os.environ.get("BENCH_BOUNCES", 2))
    frames = int(os.environ.get("BENCH_FRAMES", 4))
    grid = int(os.environ.get("BENCH_GRID", 14))
    segments = int(os.environ.get("BENCH_SEGMENTS", 24))
    # Default headline scene: the enclosed Sponza-class atrium at
    # Sponza's triangle count (~260k) — BASELINE.json names Sponza
    # (an interior courtyard), and round 1's open columns scene both
    # undersized the load (56k tris) and misrepresented bounce-ray
    # behavior (open sky everywhere).  BENCH_SCENE=columns restores
    # the old stand-in.
    # BENCH_SCENE accepts either a procedural kind (atrium, columns,
    # box, cornell, sphere) or a PATH to a real .glb/.gltf asset —
    # BASELINE configs name Box/DamagedHelmet/Sponza, and the moment a
    # real asset is available the headline must be able to consume it
    # without code changes (VERDICT r4 item 6; Scene.zig:79-136 loads
    # arbitrary glTF).  No real assets ship in this zero-egress
    # environment, so the default stays the procedural atrium stand-in
    # (documented in BASELINE.md).
    scene_kind = os.environ.get("BENCH_SCENE", "atrium")
    scene_is_file = scene_kind.lower().endswith((".glb", ".gltf"))
    if scene_is_file and not os.path.exists(scene_kind):
        print(f"BENCH_SCENE file not found: {scene_kind}",
              file=sys.stderr)
        return 1

    if scene_is_file:
        scene_path = scene_kind
        scene_kind = os.path.basename(scene_kind)
    elif scene_kind in ("atrium", "atrium_mixed"):
        from assets.procedural import make_atrium

        mixed = scene_kind == "atrium_mixed"
        detail = float(os.environ.get("BENCH_DETAIL",
                                      35 if mixed else 4.1))
        scene_path = os.path.join(
            tempfile.gettempdir(),
            f"bench_{scene_kind}_{detail}.glb"
        )
        if not os.path.exists(scene_path):
            make_atrium(scene_path, detail=detail, mixed=mixed)
    elif scene_kind == "columns":
        scene_path = os.path.join(
            tempfile.gettempdir(), f"bench_columns_{grid}_{segments}.glb"
        )
        if not os.path.exists(scene_path):
            make_columns(scene_path, grid=grid, segments=segments,
                         n_materials=32)
    else:
        from assets.procedural import (
            make_box,
            make_cornell,
            make_textured_sphere,
        )

        makers = {"box": make_box, "cornell": make_cornell,
                  "sphere": make_textured_sphere}
        scene_path = os.path.join(
            tempfile.gettempdir(), f"bench_{scene_kind}.glb"
        )
        if not os.path.exists(scene_path):
            makers[scene_kind](scene_path)

    # Default: size-keyed leaf policy (utils/config.default_max_leaf).
    scene = gltf.load(scene_path)
    max_leaf = int(os.environ.get(
        "BENCH_LEAF", default_max_leaf(scene.triangle_count)))
    dev = build_device_scene(scene, build_bvh=True, max_leaf_size=max_leaf)
    print(
        f"bench scene: {dev.num_triangles} triangles, "
        f"{len(scene.materials)} materials; device(s): {jax.devices()}",
        file=sys.stderr,
    )

    config = RenderConfig(
        num_samples=spp, num_bounces=bounces,
        resolution_x=width, resolution_y=height,
        traversal=os.environ.get("BENCH_TRAVERSAL", "auto"),
        russian_roulette=os.environ.get("BENCH_RR", "0") == "1",
    )
    pipeline = RenderPipeline(dev, config)

    from vulkan_pathtracer_tpu.app.camera_path import orbit_path

    if scene_kind in ("atrium", "atrium_mixed"):
        # Interior orbit: the camera stays inside the court (the whole
        # point of a Sponza-class scene is interior traversal).
        path = orbit_path(radius=4.5, height=2.2, duration=4.0,
                          center=(0.0, 1.2, 0.0))
    else:
        # Orbit radius from the scene bounds (host-kept root AABB —
        # reading it off the device would sync behind the uploads).
        root_min, root_max = dev.root_bounds_host
        extent = float(np.max(root_max - root_min))
        center = (root_min + root_max) * 0.5
        path = orbit_path(radius=0.75 * extent, height=0.35 * extent,
                          duration=4.0, center=tuple(center))
    cam = Camera(aspect_ratio=config.aspect_ratio)

    # Convergence mode (BENCH_MODE=spp): time-to-target-spp on a
    # static camera via the joint progressive batch (BASELINE primary
    # metric family: spp/sec @ 1080p, time to 1024-spp frame).
    if os.environ.get("BENCH_MODE") == "spp":
        target_spp = int(os.environ.get("BENCH_TARGET_SPP", 128))
        batch = int(os.environ.get("BENCH_BATCH", 32))
        # BENCH_JOINT=0: sequential device-side scan instead of the
        # joint wavefront.
        joint = os.environ.get("BENCH_JOINT", "1") == "1"
        path.apply(cam, 0.0)
        # Warm up / compile.
        sum_img, rays = pipeline.render_batch_sum(cam, 0, batch,
                                                  joint=joint)
        _ = float(sum_img.sum()), float(rays)
        acc = None
        spp = 0
        t0 = time.perf_counter()
        total_rays = 0.0
        while spp < target_spp:
            b = min(batch, target_spp - spp)
            sum_img, rays = pipeline.render_batch_sum(cam, spp, b,
                                                      joint=joint)
            acc = sum_img if acc is None else acc + sum_img
            spp += b
            total_rays += float(rays)
        _ = float(acc.sum())  # force completion
        elapsed = time.perf_counter() - t0
        spp_s = target_spp / elapsed
        eq_mrays = spp_s * width * height * bounces / 1e6
        result = {
            "metric": "spp_per_sec_1080p",
            "value": spp_s,
            "unit": "spp/s",
            "vs_baseline": eq_mrays / 200.0,
            "device": device,
            "detail": {
                "width": width, "height": height, "bounces": bounces,
                "target_spp": target_spp, "batch": batch,
                "seconds_to_target": elapsed,
                "triangles": int(dev.num_triangles),
                "equivalent_mrays_per_sec": eq_mrays,
                "physical_mrays_per_sec": total_rays / elapsed / 1e6,
            },
        }
        print(json.dumps(result))
        return 0

    # BENCH_HEADLINE=joint: render each frame through the joint
    # wavefront structure at batch=1.  Radiance matches render() up to
    # XLA reassociation; ray counts are identical.
    if os.environ.get("BENCH_HEADLINE") == "joint":
        def render_once(f):
            return pipeline.render_batch_sum(cam, f, 1, joint=True)
    else:
        def render_once(f):
            return pipeline.render(cam, frame=f, present_order=False)

    # Warmup / compile; timing below forces completion by fetching
    # device scalars.
    path.apply(cam, 0.0)
    image, rays = render_once(0)
    _ = float(image.sum()), float(rays)

    # Min over passes, with every pass reported.
    passes = int(os.environ.get("BENCH_PASSES", 3))
    elapsed = float("inf")
    total_rays = 0.0
    pass_times = []
    for p in range(passes):
        checksums = []
        ray_counts = []
        t0 = time.perf_counter()
        for f in range(frames):
            path.apply(cam, 4.0 * f / max(frames, 1))
            # Dispatch-order radiance: checksums are order-
            # invariant; the app converts once at present time.
            image, rays = render_once(f + 1)
            checksums.append(image.sum())
            ray_counts.append(rays)
        # Fetch everything: forces real completion of every frame.
        pass_rays = float(sum(float(r) for r in ray_counts))
        _ = [float(c) for c in checksums]
        dt = time.perf_counter() - t0
        pass_times.append(dt)
        if dt < elapsed:
            elapsed = dt
            total_rays = pass_rays

    mrays = total_rays / elapsed / 1e6
    fps = frames / elapsed
    result = {
        "metric": "mrays_per_sec_per_chip",
        "value": mrays,
        "unit": "Mrays/s",
        "vs_baseline": mrays / 200.0,
        "device": device,
        "detail": {
            "width": width, "height": height, "spp": spp,
            "bounces": bounces, "frames": frames,
            "triangles": int(dev.num_triangles),
            "fps": fps,
            "frame_ms": 1000.0 * elapsed / frames,
            "scene": scene_kind,
            "pass_seconds": pass_times,
            "leaf": int(dev.max_leaf_size),
        },
    }

    # Sidecar: the 56k-triangle open columns scene, an open-sky
    # workload beside the enclosed atrium.  BENCH_COMPARE=0 disables.
    if (scene_kind == "atrium"
            and os.environ.get("BENCH_COMPARE", "1") != "0"):
        cmp_path = os.path.join(tempfile.gettempdir(),
                                "bench_columns_14_24.glb")
        if not os.path.exists(cmp_path):
            make_columns(cmp_path, grid=14, segments=24,
                         n_materials=32)
        cscene = gltf.load(cmp_path)
        cdev = build_device_scene(cscene, build_bvh=True,
                                  max_leaf_size=max_leaf)
        cpipe = RenderPipeline(cdev, config)
        root_min, root_max = cdev.root_bounds_host
        extent = float(np.max(root_max - root_min))
        center = (root_min + root_max) * 0.5
        cpath = orbit_path(radius=0.75 * extent,
                           height=0.35 * extent,
                           duration=4.0, center=tuple(center))
        cpath.apply(cam, 0.0)
        image, rays = cpipe.render(cam, frame=0,
                                   present_order=False)
        _ = float(image.sum()), float(rays)
        t0 = time.perf_counter()
        csums = []
        crays = []
        for f in range(2):
            cpath.apply(cam, 2.0 * f)
            image, rays = cpipe.render(cam, frame=f + 1,
                                       present_order=False)
            csums.append(image.sum())
            crays.append(rays)
        ctotal = float(sum(float(r) for r in crays))
        _ = [float(c) for c in csums]
        celapsed = time.perf_counter() - t0
        result["detail"]["columns56k_mrays_per_sec"] = (
            ctotal / celapsed / 1e6)

    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
