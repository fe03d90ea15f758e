"""Sharded rendering: framebuffer tiling across a device mesh.

Image-space data parallelism (SURVEY.md §2 parallelism checklist):
the scene is replicated to every chip, the framebuffer is tiled along
rows, and each device runs the full wavefront loop on its tile under
``shard_map``.  The output carries a row-sharded ``NamedSharding``;
XLA's all-gather materializes the full frame only when the
host (or a downstream replicated op) asks for it.

An alternative ``mode="spp"`` shards *samples* instead: every device
renders the full frame with a decorrelated frame seed and radiance is
``psum``-averaged across the mesh — useful when the image is small but
spp is large (time-to-converged-frame metric).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from vulkan_pathtracer_tpu.models.device_scene import DeviceScene
from vulkan_pathtracer_tpu.parallel.mesh import TILE_AXIS
from vulkan_pathtracer_tpu.render.pipeline import render_rows


def make_sharded_render(mesh: Mesh, scene_example: DeviceScene, *,
                        num_samples: int, num_bounces: int,
                        width: int, height: int, traversal: str = "bvh",
                        russian_roulette: bool = False,
                        rr_start_bounce: int = 2, mode: str = "tiles",
                        ray_chunk: int = 0):
    """Build a jitted sharded frame function.

    Returns fn(scene, position, horizontal, vertical, forward, frame)
    -> ((H, W, 3) row-sharded radiance, rays_traced_total).
    """
    n_dev = mesh.devices.size
    if height % n_dev != 0:
        raise ValueError(
            f"height {height} must be divisible by mesh size {n_dev}"
        )
    rows_per_device = height // n_dev

    replicated = P()
    scene_spec = jax.tree_util.tree_map(lambda _: replicated, scene_example)

    if mode == "tiles":
        def tile_fn(scene, position, horizontal, vertical, forward, frame):
            tile = jax.lax.axis_index(TILE_AXIS)
            y0 = tile.astype(jnp.uint32) * jnp.uint32(rows_per_device)
            image, rays = render_rows(
                scene, position, horizontal, vertical, forward, frame,
                num_samples=num_samples, num_bounces=num_bounces,
                width=width, height=height,
                y_offset=y0, rows=rows_per_device,
                traversal=traversal, russian_roulette=russian_roulette,
                rr_start_bounce=rr_start_bounce, ray_chunk=ray_chunk,
            )
            rays = jax.lax.psum(rays, TILE_AXIS)
            return image, rays

        sharded = shard_map(
            tile_fn,
            mesh=mesh,
            in_specs=(scene_spec, replicated, replicated, replicated,
                      replicated, replicated),
            out_specs=(P(TILE_AXIS), replicated),
            check_vma=False,
        )
    elif mode == "spp":
        def spp_fn(scene, position, horizontal, vertical, forward, frame):
            # Decorrelate each device's sample set via the frame seed
            # (frame_count is only an RNG seed in the reference too,
            # ray_gen.rgen:41 / main.zig:269).
            dev = jax.lax.axis_index(TILE_AXIS).astype(jnp.uint32)
            image, rays = render_rows(
                scene, position, horizontal, vertical, forward,
                frame * jnp.uint32(mesh.devices.size) + dev,
                num_samples=num_samples, num_bounces=num_bounces,
                width=width, height=height,
                traversal=traversal, russian_roulette=russian_roulette,
                rr_start_bounce=rr_start_bounce, ray_chunk=ray_chunk,
            )
            image = jax.lax.pmean(image, TILE_AXIS)
            rays = jax.lax.psum(rays, TILE_AXIS)
            return image, rays

        sharded = shard_map(
            spp_fn,
            mesh=mesh,
            in_specs=(scene_spec, replicated, replicated, replicated,
                      replicated, replicated),
            out_specs=(replicated, replicated),
            check_vma=False,
        )
    else:
        raise ValueError(f"unknown mode {mode}")

    return jax.jit(sharded)


class ShardedRenderPipeline:
    """Drop-in RenderPipeline replacement over an N-device mesh
    (the --devices N path of the app driver)."""

    def __init__(self, scene: DeviceScene, config, n_devices: int,
                 mode: str = "tiles"):
        from vulkan_pathtracer_tpu.parallel.mesh import make_render_mesh

        self.config = config
        self.width = config.render_width
        self.height = config.render_height
        self.mesh = make_render_mesh(n_devices)
        self.scene = replicate_scene(scene, self.mesh)
        traversal = config.traversal
        if traversal == "auto" and not scene.has_bvh:
            traversal = "brute"
        self._fn = make_sharded_render(
            self.mesh, self.scene,
            num_samples=config.num_samples,
            num_bounces=config.num_bounces,
            width=self.width, height=self.height,
            traversal=traversal,
            russian_roulette=config.russian_roulette,
            rr_start_bounce=config.rr_start_bounce,
            mode=mode,
            ray_chunk=config.ray_chunk,
        )

    def render(self, camera, frame: int, present_order: bool = True):
        """Same contract as RenderPipeline.render; the sharded frame is
        always assembled in scanline order, so ``present_order`` has
        nothing to skip."""
        del present_order
        position, horizontal, vertical, forward = (
            jnp.asarray(v) for v in camera.push_constants()
        )
        return self._fn(self.scene, position, horizontal, vertical,
                        forward, jnp.uint32(frame))

    def to_present(self, image):
        return image


def replicate_scene(scene: DeviceScene, mesh: Mesh) -> DeviceScene:
    """Place every scene array replicated over the mesh.

    Multi-process meshes need ``jax.make_array_from_callback`` rather
    than ``jax.device_put``: device_put runs a cross-process value-
    equality check, and several baked tables pack int32 payloads in
    float32 lanes (e.g. bvh_packed's leaf_first = -1 -> 0xFFFFFFFF =
    NaN), which the numeric check rejects (NaN != NaN) even when the
    bakes are byte-identical on every process — found by the REAL
    two-process group test (tests/test_distributed_real.py)."""
    sharding = NamedSharding(mesh, P())
    multiprocess = jax.process_count() > 1

    def put(x):
        if x is None:
            return None
        if not multiprocess:
            return jax.device_put(x, sharding)
        import numpy as np

        host = np.asarray(x)
        return jax.make_array_from_callback(
            host.shape, sharding, lambda idx: host[idx])

    leaves, treedef = jax.tree_util.tree_flatten(scene)
    return jax.tree_util.tree_unflatten(treedef, [put(l) for l in leaves])
