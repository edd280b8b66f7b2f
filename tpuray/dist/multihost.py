"""Multi-host (multi-process) entry path.

The reference is a single-process, single-GPU program (SURVEY.md §2.5); the
scaling story is ray-tile data parallelism over a global mesh
spanning hosts: `jax.distributed.initialize` + a Mesh over
`jax.devices()` (all processes), with per-host addressable shards of the
frame. Collectives go over NCCL (NVLink within a host, the network across
hosts); nothing in the render/train step changes — the same `shard_map`
programs run on the global mesh.

No multi-host hardware exists in this container, so this module is the
one-flag-away entry: `initialize()` wires the JAX distributed runtime when
coordinator env vars are present (or args are passed) and degrades to
single-process otherwise. The multi-process path itself is exercised by
`scripts/dryrun_multiprocess.py`, which launches N real OS processes on the
CPU backend with a loopback coordinator.
"""
from __future__ import annotations

import os

import jax


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None) -> bool:
    """Initialize the JAX distributed runtime if a multi-process setup is
    configured; return True iff running multi-process.

    Configuration sources, in order:
      - explicit args;
      - standard env vars (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
        JAX_PROCESS_ID, or their TPURAY_* aliases);
      - a cluster environment that jax.distributed.initialize() detects
        by itself when called with no arguments.
    """
    env = os.environ
    coordinator_address = (coordinator_address
                           or env.get("JAX_COORDINATOR_ADDRESS")
                           or env.get("TPURAY_COORDINATOR"))
    if num_processes is None:
        n = env.get("JAX_NUM_PROCESSES") or env.get("TPURAY_NUM_PROCESSES")
        num_processes = int(n) if n else None
    if process_id is None:
        p = env.get("JAX_PROCESS_ID") or env.get("TPURAY_PROCESS_ID")
        process_id = int(p) if p else None

    if coordinator_address is None and num_processes is None:
        # nothing names a cluster: stay a single process rather than probe
        return False

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    return jax.process_count() > 1


def global_mesh(axis: str = "tiles") -> "jax.sharding.Mesh":
    """Mesh over every device of every process (call after initialize())."""
    import numpy as np
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()), (axis,))


def process_rows(height: int, n_devices: int | None = None
                 ) -> tuple[int, int]:
    """This process's contiguous row span [lo, hi) of a row-sharded frame
    padded to the device count — what a multi-host driver renders and
    writes locally (device_get of the global array is per-host addressable
    shards only)."""
    n = n_devices or jax.device_count()
    hp = (height + n - 1) // n * n
    rows_per_dev = hp // n
    # device *ids* need not be contiguous across processes (CPU backend
    # spaces them 2048 apart); position in the global device order is what
    # the row sharding follows
    order = {d: i for i, d in enumerate(jax.devices())}
    local = [order[d] for d in jax.local_devices()]
    lo = min(local) * rows_per_dev
    hi = (max(local) + 1) * rows_per_dev
    return lo, min(hi, height)
