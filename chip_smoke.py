"""Chip smoke: the renderer's main path, end to end, on one GPU.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the multi-device path only

One process drives the card(s): a JAX process reserves most of a
card's memory, so nothing here starts a second one — the CLI runs
in-process through ``app.main.main(argv)`` and the GPU-marked tests
through ``pytest.main``.

Phases (one card), each printing its own lines, every time printed
beside the card's name and power limit:

1. device check — fails unless JAX runs on a GPU;
2. compile the 1080p frame at real widths, print memory_analysis();
3. kernel parity — the GPU traversal kernel against the XLA reference
   loop on the atrium's 1080p primaries and key-sorted secondaries
   (closest and any hit), with both times;
4. the CLI render (1920x1080, 3 frames) and a check of its PNG;
5. frame parity — the atrium frame (traversal="auto") against the
   traversal="bvh" frame of the same seed, plus frame times;
6. two joint progressive batches at 1080p;
7. the gpu-marked tests (tests/test_traversal_kernel.py).

``--four``: BASELINE.json config 4's multi-device paths on four
cards — the sharded tile and spp renders (parallel/sharding.py), the
all_to_all rebalanced pooled wavefront (parallel/rebalance.py) and the
CLI's ``--devices 4`` — each compared with the one-card result.

Any failure exits non-zero.  The last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

# The GPU is the only platform this script accepts.
os.environ["JAX_PLATFORMS"] = "cuda"
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# Scene: the procedural Sponza-class atrium (246,444 triangles at this
# detail), leaf 28 from utils/config.default_max_leaf.
ATRIUM_DETAIL = 4.1
WIDTH, HEIGHT = 1920, 1080
# Tolerances (float32 on both sides; traversal has no matrix product,
# so differences come only from FMA contraction and summation order).
RAY_MISMATCH_MAX = 1e-5   # fraction of rays whose hit/miss or tri differ
T_REL_MAX = 1e-5          # t, relative, where tri agrees
FRAME_REL_MAX = 1e-4      # mean |a - b| / mean |b| over a frame
# Rays traced by two different programs (one card vs four): a last-bit
# difference can flip one grazing bounce, so counts agree to this.
RAYS_REL_MAX = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, *args, reps: int = 3):
    """(result, best ms over ``reps`` warm runs)."""
    import jax

    out = fn(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return out, best * 1e3


def frame_rel_diff(a, b) -> float:
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).mean() / max(np.abs(b).mean(), 1e-30))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def atrium(tmp: str, leaf: int = None):
    """(host path, DeviceScene, Camera) for the 1080p atrium, camera on
    the bench's interior orbit."""
    from assets.procedural import make_atrium
    from vulkan_pathtracer_tpu.app.camera_path import orbit_path
    from vulkan_pathtracer_tpu.models import gltf
    from vulkan_pathtracer_tpu.models.camera import Camera
    from vulkan_pathtracer_tpu.models.device_scene import build_device_scene
    from vulkan_pathtracer_tpu.utils.config import default_max_leaf

    path = os.path.join(tmp, "atrium.glb")
    make_atrium(path, detail=ATRIUM_DETAIL)
    host = gltf.load(path)
    dev = build_device_scene(
        host, max_leaf_size=leaf or default_max_leaf(host.triangle_count))
    cam = Camera(aspect_ratio=WIDTH / HEIGHT)
    orbit = orbit_path(radius=4.5, height=2.2, duration=4.0,
                       center=(0.0, 1.2, 0.0))
    orbit.apply(cam, 0.0)
    cam_path = os.path.join(tmp, "orbit.json")
    with open(cam_path, "w") as f:
        json.dump(orbit.keyframes, f)
    return path, cam_path, dev, cam


def compare_rays(name, ref, got, power):
    import numpy as np

    r_tri, g_tri = np.asarray(ref.tri), np.asarray(got.tri)
    r_t, g_t = np.asarray(ref.t), np.asarray(got.t)
    same = r_tri == g_tri
    hit_mis = float(np.mean((r_tri >= 0) != (g_tri >= 0)))
    tri_mis = float(np.mean(~same))
    both = same & (r_tri >= 0)
    t_rel = float(np.max(np.abs(r_t - g_t)[both]
                         / np.abs(r_t)[both], initial=0.0))
    log(f"{name}: rays {r_t.shape[0]} hit_mismatch {hit_mis:.3e} "
        f"tri_mismatch {tri_mis:.3e} t_rel_max {t_rel:.3e} [{power}]")
    check(hit_mis <= RAY_MISMATCH_MAX and tri_mis <= RAY_MISMATCH_MAX
          and t_rel <= T_REL_MAX, f"{name} parity out of tolerance")


def one_card(power: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import pytest

    from vulkan_pathtracer_tpu.app.main import main as cli_main
    from vulkan_pathtracer_tpu.ops.traverse import bvh_closest_hit
    from vulkan_pathtracer_tpu.ops.traverse_gpu import (
        gpu_any_hit,
        gpu_closest_hit,
    )
    from vulkan_pathtracer_tpu.render.pipeline import (
        RenderPipeline,
        generate_rays,
        render_frame,
    )
    from vulkan_pathtracer_tpu.render.shading import get_triangle_data
    from vulkan_pathtracer_tpu.render.wavefront import _bounce_sort_key
    from vulkan_pathtracer_tpu.utils.config import RenderConfig
    from vulkan_pathtracer_tpu.utils.png import read_png

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        scene_path, cam_path, dev, cam = atrium(tmp)
        log(f"scene: atrium {dev.num_triangles} triangles, leaf "
            f"{dev.max_leaf_size}, generated + baked in "
            f"{time.perf_counter() - t0:.1f} s")

        # ---- phase 2: compile at real widths ------------------------
        config = RenderConfig(resolution_x=WIDTH, resolution_y=HEIGHT)
        pipe = RenderPipeline(dev, config)
        pcs = [jnp.asarray(v) for v in cam.push_constants()]
        t0 = time.perf_counter()
        compiled = render_frame.lower(
            dev, *pcs, jnp.uint32(1),
            num_samples=1, num_bounces=2, width=WIDTH, height=HEIGHT,
            traversal=pipe._traversal, ray_chunk=config.ray_chunk,
            sort_secondary=pipe._sort_secondary,
            seed_secondary=False, present_order=False).compile()
        log(f"compile: 1080p frame in {time.perf_counter() - t0:.1f} s")
        log(f"compile: memory_analysis {compiled.memory_analysis()}")

        # ---- phase 3: kernel parity at real widths ------------------
        o, d = generate_rays(*pcs, WIDTH, HEIGHT)
        xla = jax.jit(lambda o, d, a: bvh_closest_hit(dev, o, d, a))
        kern = jax.jit(lambda o, d, a: gpu_closest_hit(dev, o, d, a))
        anyk = jax.jit(lambda o, d, a: gpu_any_hit(dev, o, d, a))
        ones = jnp.ones(o.shape[0], bool)
        ref, ms_x = timed(xla, o, d, ones)
        got, ms_k = timed(kern, o, d, ones)
        log(f"primaries: kernel {ms_k:.3f} ms, XLA {ms_x:.3f} ms "
            f"[{power}]")
        compare_rays("parity primaries", ref, got, power)

        # Secondaries: one diffuse-ish bounce off the primary hits,
        # key-sorted as the wavefront sorts them.
        gn = get_triangle_data(dev, ref).geometry_normal
        r = jax.random.normal(jax.random.PRNGKey(0), d.shape)
        nd = r / jnp.linalg.norm(r, axis=1, keepdims=True) + gn
        nd = nd / jnp.linalg.norm(nd, axis=1, keepdims=True)
        alive = ref.tri >= 0
        o2 = jnp.where(alive[:, None], o + ref.t[:, None] * d + gn * 1e-5,
                       o)
        order = jnp.argsort(_bounce_sort_key(dev, o2, nd, alive))
        o2, d2, a2 = o2[order], nd[order], alive[order]
        ref2, ms_x = timed(xla, o2, d2, a2)
        got2, ms_k = timed(kern, o2, d2, a2)
        log(f"secondaries: kernel {ms_k:.3f} ms, XLA {ms_x:.3f} ms, "
            f"alive {float(a2.mean()):.4f} [{power}]")
        compare_rays("parity secondaries", ref2, got2, power)
        ah, ms_a = timed(anyk, o2, d2, a2)
        ah_mis = float(np.mean(np.asarray(ah)
                               != (np.asarray(ref2.tri) >= 0)))
        log(f"any-hit secondaries: kernel {ms_a:.3f} ms, mismatch "
            f"{ah_mis:.3e} [{power}]")
        check(ah_mis <= RAY_MISMATCH_MAX, "any-hit parity")

        # ---- phase 4: the CLI ---------------------------------------
        out_png = os.path.join(tmp, "out.png")
        t0 = time.perf_counter()
        rc = cli_main(["-s", scene_path, "-x", str(WIDTH), "-y",
                       str(HEIGHT), "--frames", "3", "--camera-path",
                       cam_path, "-o", out_png])
        check(rc == 0, f"CLI exit code {rc}")
        img = read_png(out_png)
        log(f"cli: 3 frames in {time.perf_counter() - t0:.1f} s, png "
            f"{img.shape} mean {img.mean():.2f} std {img.std():.2f}")
        check(img.shape == (HEIGHT, WIDTH, 3), "CLI PNG shape")
        check(img.std() > 5.0 and 5.0 < img.mean() < 250.0,
              "CLI PNG is flat")

        # ---- phase 5: frame parity + frame times --------------------
        ref_pipe = RenderPipeline(dev, RenderConfig(
            resolution_x=WIDTH, resolution_y=HEIGHT, traversal="bvh"))
        frame_auto, ms_auto = timed(lambda: pipe.render(cam, 1))
        frame_bvh, ms_bvh = timed(lambda: ref_pipe.render(cam, 1),
                                  reps=1)
        img_a, rays_a = frame_auto
        img_b, rays_b = frame_bvh
        rel = frame_rel_diff(img_a, img_b)
        log(f"frame: auto {ms_auto:.3f} ms ({float(rays_a) / ms_auto / 1e3:.2f}"
            f" Mrays/s), bvh {ms_bvh:.3f} ms [{power}]")
        log(f"frame parity: mean rel diff {rel:.3e} (limit "
            f"{FRAME_REL_MAX:.0e}), rays {float(rays_a):.0f} vs "
            f"{float(rays_b):.0f}")
        check(bool(jnp.isfinite(img_a).all()), "frame not finite")
        check(rel <= FRAME_REL_MAX and float(rays_a) == float(rays_b),
              "frame parity out of tolerance")

        # ---- phase 6: two joint progressive batches -----------------
        batch = 8
        total = None
        t0 = time.perf_counter()
        for b in range(2):
            s, rays = pipe.render_batch_sum(cam, b * batch, batch)
            s = np.asarray(s)
            total = s if total is None else total + s
        dt = time.perf_counter() - t0
        mean_img = total / (2 * batch)
        rel = frame_rel_diff(mean_img.mean(), np.asarray(img_a).mean())
        log(f"progressive: 2 batches of {batch} spp in {dt * 1e3:.1f} ms "
            f"(compile included), mean {mean_img.mean():.4f} vs 1-spp "
            f"frame {float(np.asarray(img_a).mean()):.4f} [{power}]")
        check(np.isfinite(total).all() and total.shape == (HEIGHT, WIDTH, 3),
              "progressive sum")
        check(rel < 0.05, "progressive mean far from the frame mean")

    # ---- phase 7: gpu-marked tests ----------------------------------
    class Count:
        passed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                Count.passed += 1

    here = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(here, "tests",
                                   "test_traversal_kernel.py")],
                     plugins=[Count()])
    log(f"gpu tests: rc {int(rc)}, {Count.passed} passed")
    check(int(rc) == 0 and Count.passed > 0, "gpu-marked tests")


def four_cards(power: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from vulkan_pathtracer_tpu.app.main import main as cli_main
    from vulkan_pathtracer_tpu.parallel.mesh import make_render_mesh
    from vulkan_pathtracer_tpu.parallel.rebalance import (
        make_pooled_sharded_render,
    )
    from vulkan_pathtracer_tpu.parallel.sharding import (
        make_sharded_render,
        replicate_scene,
    )
    from vulkan_pathtracer_tpu.render.pipeline import (
        _pixel_seeds,
        generate_rays,
        render_frame,
    )
    from vulkan_pathtracer_tpu.render.wavefront import trace_wavefront_pooled
    from vulkan_pathtracer_tpu.utils.png import read_png

    check(len(jax.devices()) == 4, "--four needs four cards")
    with tempfile.TemporaryDirectory() as tmp:
        scene_path, cam_path, dev, cam = atrium(tmp)
        pcs = [jnp.asarray(v) for v in cam.push_constants()]
        mesh = make_render_mesh(4)
        rdev = replicate_scene(dev, mesh)
        kw = dict(num_samples=1, num_bounces=2, width=WIDTH, height=HEIGHT,
                  traversal="auto")

        def one(frame):
            img, rays = render_frame(dev, *pcs, jnp.uint32(frame), **kw)
            return np.asarray(img), float(rays)

        # Tiles: each card renders a quarter of the rows.
        tiles = make_sharded_render(mesh, rdev, mode="tiles", **kw)
        (img4, rays4), ms4 = timed(tiles, rdev, *pcs, jnp.uint32(1))
        img1, rays1 = one(1)
        rel = frame_rel_diff(img4, img1)
        log(f"4-card tiles: {ms4:.3f} ms, mean rel diff vs 1 card "
            f"{rel:.3e}, rays {float(rays4):.0f} vs {rays1:.0f} [{power}]")
        check(rel <= FRAME_REL_MAX
              and abs(float(rays4) - rays1) <= RAYS_REL_MAX * rays1,
              "tiles")

        # spp: card k renders frame 4f + k; the mean over cards must
        # match the one-card mean of the same four frames.
        spp = make_sharded_render(mesh, rdev, mode="spp", **kw)
        (img4, _), ms4 = timed(spp, rdev, *pcs, jnp.uint32(0))
        img1 = np.mean([one(k)[0] for k in range(4)], axis=0)
        rel = frame_rel_diff(img4, img1)
        log(f"4-card spp: {ms4:.3f} ms, mean rel diff vs 1 card "
            f"{rel:.3e} [{power}]")
        check(rel <= FRAME_REL_MAX, "spp")

        # Pooled wavefront with per-bounce all_to_all rebalancing.
        o, d = generate_rays(*pcs, WIDTH, HEIGHT)
        sx, sy = _pixel_seeds(WIDTH, HEIGHT, jnp.uint32(2))
        pooled = make_pooled_sharded_render(mesh, rdev, num_bounces=2,
                                            traversal="auto")
        (c4, r4), ms4 = timed(pooled, rdev, o, d, sx, sy)
        c1, r1 = trace_wavefront_pooled(dev, o, d, sx, sy, num_bounces=2,
                                        traversal="auto")
        rel = frame_rel_diff(c4, c1)
        log(f"4-card rebalanced pooled: {ms4:.3f} ms, mean rel diff vs "
            f"1 card {rel:.3e}, rays {float(r4):.0f} vs {float(r1):.0f} "
            f"[{power}]")
        check(rel <= FRAME_REL_MAX
              and abs(float(r4) - float(r1)) <= RAYS_REL_MAX * float(r1),
              "pooled")

        # The CLI's --devices 4 against the one-card CLI.
        pngs = {}
        for n in (1, 4):
            out = os.path.join(tmp, f"cli{n}.png")
            argv = ["-s", scene_path, "-x", str(WIDTH), "-y", str(HEIGHT),
                    "--frames", "2", "--camera-path", cam_path, "-o", out]
            if n > 1:
                argv += ["--devices", str(n)]
            check(cli_main(argv) == 0, f"CLI --devices {n}")
            pngs[n] = read_png(out).astype(np.float64)
        rel = frame_rel_diff(pngs[4], pngs[1])
        log(f"cli --devices 4: png mean rel diff vs 1 card {rel:.3e} "
            f"(limit 1e-3, 8-bit)")
        check(rel <= 1e-3, "CLI --devices 4")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run the four-card multi-device path only")
    args = parser.parse_args(argv)

    # ---- phase 1: device check ---------------------------------------
    import jax

    from vulkan_pathtracer_tpu.utils.compile_cache import (
        enable_compile_cache,
    )
    from vulkan_pathtracer_tpu.utils.device import (
        nvidia_smi_power,
        require_gpu,
    )

    device = require_gpu()
    smi = nvidia_smi_power()
    log(f"device: {device} jax {jax.__version__}")
    log(smi)
    power = smi.replace("\n", "; ")
    enable_compile_cache()
    t0 = time.perf_counter()
    (four_cards if args.four else one_card)(power)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
