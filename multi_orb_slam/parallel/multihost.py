"""Multi-host setup helpers.

The reference is a single-process system (SURVEY.md §2.4); this engine
scales over devices with a 1-D global mesh, and over hosts with
`jax.distributed`.  This module wraps the initialization and mesh
construction so drivers can run unchanged on 1 host or N hosts:

    from multi_orb_slam.parallel import multihost
    mesh = multihost.init_and_mesh()           # all devices, axis "data"
    step = dist_ba.make_dist_ba_step(mesh)     # sharded global BA

On several hosts every host runs the same program; frames are processed
data-parallel per host (each host tracks its own camera stream or its shard
of a multi-session map) while distributed BA reduces the shared Schur camera
system across the mesh (`parallel/dist_ba.py`).  The GPUs of one machine
are joined all to all by NVLink, so the mesh follows the algorithm alone.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """jax.distributed.initialize with env-var fallbacks.

    No-op for single-process runs.  Nothing discovers a cluster on its
    own: pass the three arguments explicitly or via
    JAX_COORDINATOR_ADDRESS (e.g. localhost:<port>) / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID.
    """
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    num_processes = num_processes or _int_env("JAX_NUM_PROCESSES")
    process_id = process_id if process_id is not None else _int_env(
        "JAX_PROCESS_ID")
    if coordinator is None and num_processes in (None, 1):
        return  # single process
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def _int_env(name):
    v = os.environ.get(name)
    return int(v) if v is not None else None


def global_mesh(axis: str = "data") -> Mesh:
    """1-D mesh over every device of every process (NVLink within a
    machine, the network across; XLA routes the psum accordingly)."""
    return Mesh(np.array(jax.devices()), (axis,))


def init_and_mesh(axis: str = "data") -> Mesh:
    initialize()
    return global_mesh(axis)
