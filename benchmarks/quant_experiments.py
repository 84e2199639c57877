#!/usr/bin/env python3
"""Quantized-band SpMM at the 1M-node config.

Times, at the exact 5d geometry (1M nodes / ~40M edges, ±512-node band,
block 256, F=64):

1. ``f32``      — f32 band via the XLA einsum (``banded_spmm``);
2. ``quant``    — int8 band × bf16 activations, one scaled product per
                  diagonal (``banded_spmm_quant``);
3. ``dequant``  — dequantize to f32, then the f32 einsum
                  (``banded_spmm_quant_xla``, the correctness oracle);

plus a one-pass correctness check of each quant path against the f32
output (relative Frobenius error ≲1% for int8 per-tile symmetric
quantization of uniform weights; the per-entry analytic bound is
asserted in tests/test_banded_quant.py).  Timing methodology =
benchmarks/suite.py (chained normalized-feedback fori_loops,
full-vs-quarter differencing); the f32 band buffer is deleted before the
quant timings so device memory never holds two 5.4 GB bands at once.

Usage: python benchmarks/quant_experiments.py [--iters 10]
"""

from __future__ import annotations

import argparse
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")
from benchmarks.suite import chained_loop_time  # noqa: E402

from connectome_gnn_jax.ops.banded import BandedMatrix, banded_spmm  # noqa: E402
from connectome_gnn_jax.ops.banded_quant import (  # noqa: E402
    QuantizedBandedMatrix,
    banded_spmm_quant,
    banded_spmm_quant_xla,
    quantize_band,
)


def build_band(num_nodes, degree, band_nodes, block):
    """On-device band construction, identical to suite.py 5d."""
    rng = np.random.default_rng(0)
    E = num_nodes * degree
    receivers = np.repeat(np.arange(num_nodes, dtype=np.int64), degree)
    senders = np.clip(
        receivers + rng.integers(-band_nodes, band_nodes + 1, E), 0,
        num_nodes - 1,
    )
    W = -(-band_nodes // block)
    nb = num_nodes // block
    dcount = 2 * W + 1
    rb = receivers // block
    d = senders // block - rb + W
    lin = (
        ((rb * dcount + d) * block + receivers % block) * block
        + senders % block
    ).astype(np.int32)

    @jax.jit
    def build(lin_idx, key):
        w = jax.random.uniform(key, (E,), jnp.float32)
        flat = jnp.zeros(nb * dcount * block * block, jnp.float32)
        return flat.at[lin_idx].add(w).reshape(nb, dcount, block, block)

    band = build(jnp.asarray(lin), jax.random.PRNGKey(0))
    return BandedMatrix(band, num_nodes, W), E


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--nodes", type=int, default=1 << 20)
    p.add_argument("--feat", type=int, default=64)
    p.add_argument(
        "--phases", default="checks,f32,quant,dequant",
        help="comma list among checks,f32,quant,dequant (split long runs)",
    )
    args = p.parse_args()
    phases = set(args.phases.split(","))

    a, E = build_band(args.nodes, 38, 512, 256)
    x0 = jax.random.normal(
        jax.random.PRNGKey(1), (args.nodes, args.feat), jnp.float32
    )
    q = quantize_band(a)

    if "checks" in phases:
        # one-pass correctness of both quant paths vs f32
        ref = banded_spmm(a, x0)
        ref_norm = float(jnp.linalg.norm(ref))
        for name, fn in [
            ("dequant", lambda: banded_spmm_quant_xla(q, x0)),
            ("quant", lambda: banded_spmm_quant(q, x0)),
        ]:
            err = float(jnp.linalg.norm(fn() - ref)) / ref_norm
            print(json.dumps({"check": name, "rel_frobenius_err": err}))
            assert err < 2e-2, f"{name} error {err} out of bound"
        del ref

    results = {}

    def record(name, dt):
        results[name] = {
            "ms_per_spmm": dt * 1e3,
            "edges_per_s": E / dt,
        }
        print(json.dumps({"timing": name, **results[name]}))

    if "f32" in phases:
        record(
            "f32_xla",
            chained_loop_time(
                lambda v, b: banded_spmm(a._replace(band=b), v),
                x0, args.iters, a.band,
            ),
        )

    # free the f32 band before quant timings (memory headroom)
    a.band.delete()

    if "quant" in phases:
        record(
            "quant",
            chained_loop_time(
                lambda v, bq, s: banded_spmm_quant(
                    QuantizedBandedMatrix(bq, s, q.num_nodes, q.bandwidth), v
                ),
                x0, args.iters, q.band_q, q.scales,
            ),
        )

    if "dequant" in phases:
        record(
            "dequant",
            chained_loop_time(
                lambda v, bq, s: banded_spmm_quant_xla(
                    QuantizedBandedMatrix(bq, s, q.num_nodes, q.bandwidth), v
                ),
                x0, args.iters, q.band_q, q.scales,
            ),
        )

    if "quant" in results and "f32_xla" in results:
        print(json.dumps({
            "summary": {
                "device_kind": jax.devices()[0].device_kind,
                "num_nodes": args.nodes,
                "num_edges": E,
                "f32_xla_ms": results["f32_xla"]["ms_per_spmm"],
                "quant_ms": results["quant"]["ms_per_spmm"],
                "quant_edges_per_s": results["quant"]["edges_per_s"],
                "speedup_vs_f32": results["f32_xla"]["ms_per_spmm"]
                / results["quant"]["ms_per_spmm"],
            }
        }))


if __name__ == "__main__":
    main()
