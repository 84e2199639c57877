#!/usr/bin/env python3
"""GPU measurements behind the layout cost model and the int8 band path.

1. ``scatter_ns_per_edge`` — a ``segment_sum`` COO SpMM at the config-5
   shape (262,144 nodes, 16 edges per node, F = 64), seconds per call
   over edges.  ``data/layout.py`` prices out-of-band edges with it.
2. ``stream_gbps`` — a large elementwise pass (1 GiB read + 1 GiB
   written).  ``data/layout.py`` prices band streaming with it.
3. Band SpMM times at the same node count (block 256, bandwidth 1):
   f32 einsum, int8 band × bf16 activations, and w8a8.
4. Whether XLA materializes the int8 band in a wider type: the optimized
   HLO of the feature-major int8 SpMM is searched for band-sized bf16 or
   f32 buffers, and the full text is written to
   ``chiprun_out/band_quant_fm.hlo.txt``.

Times are medians of host-clock calls ending in ``block_until_ready``.
Needs a GPU; prints the card's name and power limit first, then one
JSON object.

Usage:
    python benchmarks/gpu_calibration.py
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

OUT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chiprun_out"
)


def median_time(fn, *args, n: int = 20) -> float:
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def scatter_ns_per_edge(num_nodes=262_144, degree=16, feat=64) -> dict:
    from connectome_gnn_jax.ops import coo_spmm

    rng = np.random.default_rng(0)
    E = num_nodes * degree
    receivers = jnp.asarray(np.sort(rng.integers(0, num_nodes, E)), jnp.int32)
    senders = jnp.asarray(rng.integers(0, num_nodes, E), jnp.int32)
    w = jnp.asarray(rng.random(E), jnp.float32)
    x = jnp.asarray(rng.standard_normal((num_nodes, feat)), jnp.float32)
    fn = jax.jit(lambda w, s, r, x: coo_spmm(w, s, r, x, num_nodes,
                                              indices_are_sorted=True))
    dt = median_time(fn, w, senders, receivers, x)
    return {"coo_spmm_ms": dt * 1e3, "edges": E,
            "scatter_ns_per_edge": dt / E * 1e9}


def stream_gbps(gib: float = 1.0) -> dict:
    n = int(gib * (1 << 30)) // 4
    x = jnp.ones((n,), jnp.float32)
    fn = jax.jit(lambda v: v + 1.0)
    dt = median_time(fn, x)
    return {"stream_ms": dt * 1e3, "stream_gbps": 2 * n * 4 / dt / 1e9}


def band_paths(num_nodes=262_144, feat=64) -> dict:
    from connectome_gnn_jax.data import generate_spatial_graph
    from connectome_gnn_jax.ops import (
        banded_spmm, banded_spmm_quant_fm, banded_spmm_quant_fm_w8a8,
        quantize_band, to_banded, to_feature_major,
    )

    g = generate_spatial_graph(num_nodes, degree=16, band=256,
                               num_features=feat, seed=0)
    a = to_banded(g.edge_index[0], g.edge_index[1], g.edge_weight,
                  num_nodes, block=256)
    q = to_feature_major(quantize_band(a))
    x = jnp.asarray(g.node_features)
    xT = x.T

    f32 = jax.jit(lambda band, v: banded_spmm(a._replace(band=band), v))
    bf16 = jax.jit(lambda bq, s, v: banded_spmm_quant_fm(
        q._replace(band_qT=bq, scales=s), v))
    w8a8 = jax.jit(lambda bq, s, v: banded_spmm_quant_fm_w8a8(
        q._replace(band_qT=bq, scales=s), v))
    res = {
        "block": a.block, "bandwidth": a.bandwidth,
        "band_f32_bytes": int(a.band.size * 4),
        "f32_ms": median_time(f32, a.band, x) * 1e3,
        "int8_bf16_ms": median_time(bf16, q.band_qT, q.scales, xT) * 1e3,
        "w8a8_ms": median_time(w8a8, q.band_qT, q.scales, xT) * 1e3,
    }
    res["f32_band_gbps"] = res["band_f32_bytes"] / (res["f32_ms"] / 1e3) / 1e9

    hlo = bf16.lower(q.band_qT, q.scales, xT).compile().as_text()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "band_quant_fm.hlo.txt"), "w") as f:
        f.write(hlo)
    nb, blk = a.num_blocks, a.block
    D = 2 * a.bandwidth + 1
    wide = re.compile(
        rf"(bf16|f16|f32)\[({nb},{D},{blk},{blk}|{nb},{blk},{blk})\]"
    )
    res["wide_band_buffers"] = [
        line.strip()[:240] for line in hlo.splitlines()
        if "=" in line and wide.search(line.split("=", 1)[1][:80])
    ]
    res["gemm_ops"] = [
        line.strip()[:240] for line in hlo.splitlines()
        if "custom_call_target=" in line or "__triton_gemm" in line
        or "kind=kCustom" in line
    ]
    return res


def main() -> None:
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("gpu_calibration.py measures the GPU; none found")
    from connectome_gnn_jax.utils import enable_compile_cache

    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card: {card}  device_kind: {jax.devices()[0].device_kind}")
    out = {**scatter_ns_per_edge(), **stream_gbps(), **band_paths()}
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
