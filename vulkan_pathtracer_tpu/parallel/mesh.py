"""Device mesh setup.

The reference is strictly single-GPU (GraphicsContext.zig picks one
physical device, one graphics queue).  Multi-chip scaling is new
capability here (BASELINE.json configs[4]): a 1-D ``jax.sharding.Mesh``
over the local devices, with the framebuffer tiled along the row axis
("image-space data parallelism", SURVEY.md §2 checklist).  Radiance
tiles ride the collectives XLA inserts for the output sharding
(all-gather on host fetch), not any hand-rolled transport.
"""

from __future__ import annotations

from typing import Optional

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

TILE_AXIS = "tiles"


def make_render_mesh(n_devices: Optional[int] = None) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return jax.make_mesh((len(devices),), (TILE_AXIS,),
                         devices=devices)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def row_sharded(mesh: Mesh) -> NamedSharding:
    """Shard an (H, W, C) framebuffer across rows."""
    return NamedSharding(mesh, P(TILE_AXIS))
