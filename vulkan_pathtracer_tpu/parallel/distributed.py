"""Multi-host (multi-slice) initialization.

The reference has no networking at all (SURVEY.md §2: no NCCL/MPI/
Gloo/UCX anywhere); multi-host rendering is new capability here.  It needs no custom
transport: ``jax.distributed`` forms the process group, every host
contributes its local devices to one global mesh, and the same
``shard_map`` framebuffer tiling from parallel/sharding.py runs
unchanged — XLA routes the collectives (NCCL on GPUs).

Single-host runs (including this dev environment) skip initialization
entirely, so all code paths stay testable on one machine.
"""

from __future__ import annotations

import os
from typing import Optional

import jax


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed when running multi-host.

    Reads JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID
    when arguments are omitted.  Returns True when a multi-process
    group was formed.
    """
    coordinator = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    n = num_processes if num_processes is not None else int(
        os.environ.get("JAX_NUM_PROCESSES", "0") or 0
    )
    pid = process_id if process_id is not None else int(
        os.environ.get("JAX_PROCESS_ID", "-1") or -1
    )
    if coordinator and n > 1 and pid >= 0:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=n,
            process_id=pid,
        )
        return True
    return False


def global_mesh(tile_axis: str = "tiles"):
    """A 1-D mesh over every device across all processes."""
    return jax.make_mesh((len(jax.devices()),), (tile_axis,))


def is_primary() -> bool:
    return jax.process_index() == 0
