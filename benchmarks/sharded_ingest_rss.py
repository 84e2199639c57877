#!/usr/bin/env python3
"""Peak-host-memory comparison of graph-sharded partition ingest.

Round 4's `ShardedGraphCSR.partition` materialized ALL D shards' padded
arrays in every process's host memory — at the scale the beyond-
replication mode exists for, that is the whole graph per host.  This
harness measures ``ru_maxrss`` of producing ONE process's shard of the
1M-node / 44M-edge north-star graph two ways:

* ``materialized`` — full COO in memory → ``ShardedGraphCSR.partition``
  (all 8 shards) → keep shard 0;
* ``streamed`` — ``ShardedGraphCSR.partition_streamed`` over a chunked
  COO generator with ``shard_range=(0, 1)`` and a per-shard feature
  reader: the full edge list and feature table never exist in this
  process (the INGEST_r02 discipline applied to the sharded sampler).

Both modes consume the SAME deterministic chunk stream; slab checksums
must agree.  Each mode runs in a fresh subprocess so allocator
high-water marks don't leak.

Usage: python benchmarks/sharded_ingest_rss.py [--nodes 1048576]
                                               [--out INGEST_r05.json]
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

from connectome_gnn_jax.parallel import ShardedGraphCSR

mode, N = sys.argv[1], int(sys.argv[2])
degree, band, F, D = 44, 512, 64, 8
NPC = 65536  # nodes per stream chunk


def chunk_iter():
    for lo in range(0, N, NPC):
        hi = min(N, lo + NPC)
        rng = np.random.default_rng(1000 + lo)
        recv = np.repeat(np.arange(lo, hi, dtype=np.int64), degree)
        snd = np.clip(
            recv + rng.integers(-band, band + 1, len(recv)), 0, N - 1
        )
        yield snd, recv, rng.random(len(recv), np.float32)


P = -(-N // D)


def feat_reader(a, b):
    return np.random.default_rng(5000 + a).random((b - a, F), np.float32)


t0 = time.perf_counter()
if mode == "materialized":
    from connectome_gnn_jax.data.graph import ConnectomeGraph

    snds, recvs, ws = [], [], []
    for s, r, w in chunk_iter():
        snds.append(s); recvs.append(r); ws.append(w)
    feats = np.concatenate([
        feat_reader(d * P, min((d + 1) * P, N)) for d in range(D)
    ])
    g = ConnectomeGraph(
        node_features=feats,
        edge_index=np.stack([
            np.concatenate(snds), np.concatenate(recvs)
        ]).astype(np.int32),
        edge_weight=np.concatenate(ws),
    )
    full = ShardedGraphCSR.partition(g, D)
    sw = np.asarray(full.sender_weight)[0]
    fx = np.asarray(full.node_features)[0]
else:
    part = ShardedGraphCSR.partition_streamed(
        chunk_iter, feat_reader, N, D, shard_range=(0, 1)
    )
    sw = np.asarray(part.sender_weight)[0]
    fx = np.asarray(part.node_features)[0]
dt = time.perf_counter() - t0

print(json.dumps({
    "mode": mode,
    "wall_s": round(dt, 2),
    "peak_rss_gb": round(
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6, 3
    ),
    "shard0_edge_checksum": int(sw[:, 0].astype(np.int64).sum()),
    "shard0_feat_checksum": round(float(fx.sum()), 1),
    "shard0_slab_gb": round((sw.nbytes + fx.nbytes) / 1e9, 3),
}))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=1_048_576)
    ap.add_argument("--out", default="INGEST_r05.json")
    args = ap.parse_args()

    rows = {}
    for mode in ("materialized", "streamed"):
        proc = subprocess.run(
            [sys.executable, "-c", CHILD, mode, str(args.nodes)],
            capture_output=True, text=True, timeout=1800,
        )
        if proc.returncode:
            print(proc.stdout[-2000:], proc.stderr[-2000:])
            return 1
        rows[mode] = json.loads(proc.stdout.strip().splitlines()[-1])

    same = all(
        rows["materialized"][k] == rows["streamed"][k]
        for k in ("shard0_edge_checksum", "shard0_feat_checksum")
    )
    artifact = {
        "what": "peak host RSS to produce ONE shard of the 1M/44M "
                "graph-sharded partition (8 shards)",
        "nodes": args.nodes,
        **rows,
        "checksums_match": same,
        "rss_ratio": round(
            rows["materialized"]["peak_rss_gb"]
            / max(rows["streamed"]["peak_rss_gb"], 1e-9), 2,
        ),
    }
    s = json.dumps(artifact, indent=2)
    print(s)
    with open(args.out, "w") as f:
        f.write(s + "\n")
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
