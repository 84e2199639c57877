#!/usr/bin/env python3
"""Peak-host-memory comparison of giant-graph ingest paths (VERDICT #8).

Measures ``ru_maxrss`` of two ways to produce ONE process's shard of a
1M-node / 40M-edge banded giant graph (the north-star config, built like
``benchmarks/suite.py`` 5d):

* ``materialized`` — the round-1 flow: ``to_banded`` packs the FULL
  ~5.4 GB block band on the host, then ``partition_banded(...,
  shard_range=(0, 1))`` slices this process's slab out of it;
* ``streamed`` — ``partition_banded_from_coo(..., shard_range=(0, 1))``
  packs ONLY this process's slab straight from the COO arrays
  (``native.band_pack_range``), bitwise-equal output.

Each mode runs in a fresh subprocess (so allocator high-water marks don't
leak between modes) on the CPU backend.  Note the CPU backend can alias
jax↔numpy buffers, which *understates* the materialized path's cost on a
real accelerator host (where ``np.asarray(a.band)`` is a genuine device→host
copy); the streamed path's advantage is therefore a lower bound.

Usage: python benchmarks/ingest_rss.py [--nodes 1048576] [--json]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

CHILD = r"""
import json, resource, sys, time
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")

mode, num_nodes = sys.argv[1], int(sys.argv[2])
degree, band_nodes, block = 38, 512, 256

rng = np.random.default_rng(0)
E = num_nodes * degree
receivers = np.repeat(np.arange(num_nodes, dtype=np.int64), degree)
senders = np.clip(
    receivers + rng.integers(-band_nodes, band_nodes + 1, E), 0, num_nodes - 1
)
weights = rng.random(E, np.float32)
x = rng.random((num_nodes, 8), np.float32)
rss_coo = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss

num_shards = 8
t0 = time.perf_counter()
if mode == "materialized":
    from connectome_gnn_jax.ops.banded import to_banded
    from connectome_gnn_jax.parallel import partition_banded

    a = to_banded(senders, receivers, weights, num_nodes, block=block)
    shard = partition_banded(a, x, num_shards, shard_range=(0, 1))
else:
    from connectome_gnn_jax.parallel import partition_banded_from_coo

    W = -(-band_nodes // block)
    shard = partition_banded_from_coo(
        senders, receivers, weights, x, num_nodes, num_shards,
        block=block, bandwidth=W, shard_range=(0, 1),
    )
dt = time.perf_counter() - t0
checksum = float(np.asarray(shard.band).sum())
print(json.dumps({
    "mode": mode,
    "wall_s": round(dt, 2),
    "peak_rss_gb": round(
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6, 2
    ),
    "coo_baseline_rss_gb": round(rss_coo / 1e6, 2),
    "band_checksum": checksum,
    "slab_gb": round(np.asarray(shard.band).nbytes / 1e9, 2),
}))
"""


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--nodes", type=int, default=1 << 20)
    p.add_argument("--json", action="store_true")
    args = p.parse_args()

    results = {}
    for mode in ("streamed", "materialized"):
        out = subprocess.run(
            [sys.executable, "-c", CHILD, mode, str(args.nodes)],
            capture_output=True, text=True, check=True,
        )
        results[mode] = json.loads(out.stdout.strip().splitlines()[-1])
        if not args.json:
            print(results[mode])

    assert (
        results["streamed"]["band_checksum"]
        == results["materialized"]["band_checksum"]
    ), "paths disagree"
    summary = {
        "num_nodes": args.nodes,
        "num_edges": args.nodes * 38,
        "streamed": results["streamed"],
        "materialized": results["materialized"],
        "peak_rss_ratio": round(
            results["materialized"]["peak_rss_gb"]
            / results["streamed"]["peak_rss_gb"], 2,
        ),
    }
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
