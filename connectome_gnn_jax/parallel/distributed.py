"""Multi-process (multi-host) execution layer.

Scales training from one process to ``N`` processes (the N-host half of
the north star: 1 device → 1 host → N hosts).  The design is
JAX-native: after :func:`initialize_distributed`, ``jax.devices()`` spans
every process, one process-spanning :class:`~jax.sharding.Mesh` is built
(:func:`connectome_gnn_jax.parallel.mesh.create_mesh` needs no changes —
collectives ride the host's device interconnect (NVLink on a multi-GPU
host) and the network across hosts, inserted by XLA),
and the existing shard_map train steps run unchanged.  What this module
adds is the *data* side:

* each process materializes ONLY its own shards (loader shards via
  ``process_index``/``process_count``; the giant-graph partitioners take a
  ``shard_range``), and
* :func:`assemble_global` lifts per-process local shard stacks into global
  ``jax.Array``s (``jax.make_array_from_process_local_data``) that the
  jitted steps consume.

The reference has no distributed layer of any kind (SURVEY §0/§5: no
torch.distributed, no collectives, single process).  On CPU the
cross-process collective transport is gloo — which is how the
multiprocess dryrun harness (``benchmarks/multiprocess.py``) validates
this exact program graph without a GPU cluster: same shard_map programs, same
collectives, real process boundaries.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join (or start) a multi-process JAX job.

    Call once per process, BEFORE any other jax use.  Where no cluster
    environment describes the job (a bare GPU host, the CPU test rig),
    all three arguments are required — ``coordinator_address`` as
    ``localhost:<port>`` on one host; on CPU the gloo collective
    transport is selected.  No-op when ``num_processes == 1`` and no
    coordinator is given (single-process runs need no cluster).
    """
    if coordinator_address is None and (num_processes or 1) == 1:
        return
    # NB: do NOT probe jax.process_count() here — it would initialize the
    # local backend before the cluster is joined.
    if jax.distributed.is_initialized():
        return
    # CPU backend: cross-process collectives need an explicit transport.
    platforms = os.environ.get("JAX_PLATFORMS") or (
        getattr(jax.config, "jax_platforms", None) or ""
    )
    if str(platforms).startswith("cpu"):
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def process_count() -> int:
    return jax.process_count()


def process_index() -> int:
    return jax.process_index()


def local_shard_range(num_shards: int) -> tuple[int, int]:
    """The contiguous ``[lo, hi)`` slice of ``num_shards`` global shards
    this process owns.

    Assumes shard ``d`` of a 1-D mesh axis lives on global device ``d``
    and devices are process-contiguous in ``jax.devices()`` order — true
    for meshes built by :func:`~connectome_gnn_jax.parallel.mesh.create_mesh`
    over the default device list.
    """
    procs = jax.process_count()
    if num_shards % procs:
        raise ValueError(
            f"num_shards={num_shards} not divisible by process_count={procs}"
        )
    per = num_shards // procs
    lo = jax.process_index() * per
    return lo, lo + per


def assemble_global(stacked_local, mesh: Mesh, axis_name: str = "data"):
    """Lift a per-process local shard stack into a global sharded pytree.

    Every array leaf of ``stacked_local`` carries this process's shards on
    the leading axis (``D_local = D_global / process_count``); the result's
    leaves are global ``jax.Array``s of leading size ``D_global`` sharded
    ``P(axis_name)`` over ``mesh``.  Single-process: a plain sharded
    ``device_put`` (leading axis must then be the full ``D_global``).

    For 2-D meshes pass ``axis_name`` as the axis the LEADING leaf axis is
    sharded over; leaves must then carry every other mesh axis whole.
    """
    sharding = NamedSharding(mesh, P(axis_name))
    d_global = int(mesh.shape[axis_name])

    if jax.process_count() == 1:

        def put(x):
            if hasattr(x, "sharding") and x.sharding == sharding:
                return x
            return jax.device_put(x, sharding)

        return jax.tree_util.tree_map(put, stacked_local)

    def lift(x):
        x = np.asarray(x)
        global_shape = (d_global,) + x.shape[1:]
        return jax.make_array_from_process_local_data(
            sharding, x, global_shape
        )

    return jax.tree_util.tree_map(lift, stacked_local)
