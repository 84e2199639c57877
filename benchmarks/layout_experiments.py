#!/usr/bin/env python3
"""Adversarial locality-recovery benchmark (VERDICT r2 #4).

Every banded/hybrid win so far was measured on graphs GENERATED
band-ordered.  This harness is the adversarial version: giant graphs
arrive with scrambled node ids, and the one-call pipeline
(``connectome_gnn_jax.data.layout``) must rediscover the latent
structure — native RCM reordering, cost-model band/remainder split —
and the rebuilt layout is then measured on chip against the raw scatter
SpMM on the scrambled input.

Cases:
  permuted_spatial      pure ±512-band graph, ids scrambled — the plan
                        should recover (near-)banded layout and ~the 5d
                        throughput.
  small_world_10/_30    band bulk + 10%/30% uniform shortcuts, scrambled
                        — the plan should pick hybrid; the achieved
                        remainder fraction IS the "remainder-size lever"
                        number the hybrid-quant decision rests on
                        (docs/ARCHITECTURE.md).

Also records: host plan/build seconds (one-time, amortized over a run),
bandwidth before/after RCM, chosen width, and the cost model's predicted
per-SpMM time vs measured (calibration check).

Writes LAYOUT_r03.json with --json.

Usage:
    python benchmarks/layout_experiments.py [--json] [--scale small|full]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np

from benchmarks.suite import chained_loop_time
from connectome_gnn_jax.data import generate_spatial_graph
from connectome_gnn_jax.data.layout import build_layout, plan_layout
from connectome_gnn_jax.data.reorder import apply_ordering
from connectome_gnn_jax.ops.banded import BandedMatrix, banded_spmm, hybrid_spmm
from connectome_gnn_jax.ops.segment import coo_spmm


def _time_coo(s, r, w, x, num_nodes, iters, max_edges=8 << 20):
    """Per-edge scatter rate.  Above ``max_edges`` a uniform subset is
    measured instead: XLA materializes the gathered messages
    (``E×F×4`` bytes — 10 GB at 40M edges/F=64, OOM on a 16 GB chip),
    and the op is latency-bound at a constant ns/edge
    (``benchmarks/spmm_experiments.py``), so the per-edge rate from a
    subset is the honest baseline.  Returns ``(dt_for_subset, subset_e)``.
    """
    e = s.shape[0]
    if e > max_edges:
        idx = np.random.default_rng(0).choice(e, max_edges, replace=False)
        s, r, w = s[idx], r[idx], w[idx]
        e = max_edges
    order = np.argsort(r, kind="stable")
    sj = jnp.asarray(s[order].astype(np.int32))
    rj = jnp.asarray(r[order].astype(np.int32))
    wj = jnp.asarray(w[order])
    dt = chained_loop_time(
        lambda v, wv, sv, rv: coo_spmm(
            wv, sv, rv, v, num_nodes, indices_are_sorted=True
        ),
        x, iters, wj, sj, rj,
    )
    return dt, e


def _time_layout(adj, x, num_nodes, iters):
    if isinstance(adj, BandedMatrix):
        return chained_loop_time(
            lambda v, band: banded_spmm(adj._replace(band=band), v),
            x, iters, adj.band,
        )
    if type(adj) is tuple:  # plain coo triple (NamedTuples are tuples too)
        s, r, w = adj
        chunk = (4 << 20) if s.shape[0] > (8 << 20) else None
        return chained_loop_time(
            lambda v, wv, sv, rv: coo_spmm(
                wv, sv, rv, v, num_nodes, indices_are_sorted=True,
                edge_chunk=chunk,
            ),
            x, iters, jnp.asarray(w), jnp.asarray(s), jnp.asarray(r),
        )
    # hybrid; chunk giant remainders so the gather intermediate fits HBM
    chunk = (
        (4 << 20)
        if int(adj.remainder_weights.shape[0]) > (8 << 20)
        else None
    )
    return chained_loop_time(
        lambda v, band, rs, rr, rw: hybrid_spmm(
            adj._replace(
                band=adj.band._replace(band=band),
                remainder_senders=rs, remainder_receivers=rr,
                remainder_weights=rw,
            ),
            v, remainder_chunk=chunk,
        ),
        x, iters,
        adj.band.band, adj.remainder_senders, adj.remainder_receivers,
        adj.remainder_weights,
    )


def run_case(
    name: str,
    *,
    num_nodes: int,
    degree: int,
    band: int,
    shortcut_frac: float,
    feat: int = 64,
    block: int = 256,
    iters: int = 4,
    coo_iters: int = 3,
    seed: int = 0,
) -> dict:
    g = generate_spatial_graph(
        num_nodes, degree=degree, band=band, seed=seed,
        shortcut_frac=shortcut_frac,
    )
    rng = np.random.default_rng(seed + 1)
    perm = rng.permutation(num_nodes)
    gs = apply_ordering(g, perm)  # the adversarial, scrambled input
    E = gs.num_edges
    s, r, w = gs.edge_index[0], gs.edge_index[1], gs.edge_weight
    x = jnp.asarray(
        rng.standard_normal((num_nodes, feat)).astype(np.float32)
    )

    # --- baseline: raw scatter SpMM on the scrambled ids --------------
    dt_coo, coo_e = _time_coo(s, r, w, x, num_nodes, coo_iters)
    scatter_rate = coo_e / dt_coo  # edges/s, per-edge latency bound

    # --- recovery pipeline (host, timed) ------------------------------
    # band budget 6 GB: the chip must also hold the remainder's gathered
    # messages and the activation windows alongside the band
    t0 = time.perf_counter()
    plan = plan_layout(s, r, num_nodes, weights=w, block=block, feat=feat,
                       max_band_gb=6.0)
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    adj = build_layout(plan, s, r, w, num_nodes)
    build_s = time.perf_counter() - t0

    # --- measured throughput of the chosen layout ---------------------
    x_perm = x[jnp.asarray(plan.perm)] if plan.reordered else x
    dt_layout = _time_layout(adj, x_perm, num_nodes, iters)

    # correctness through the permutation (one pass, loose fp tolerance)
    if isinstance(adj, BandedMatrix):
        out = banded_spmm(adj, x_perm)
    elif type(adj) is tuple:  # plain coo triple (NamedTuples are tuples too)
        out = coo_spmm(
            jnp.asarray(adj[2]), jnp.asarray(adj[0]), jnp.asarray(adj[1]),
            x_perm, num_nodes, indices_are_sorted=True,
            edge_chunk=(4 << 20) if adj[0].shape[0] > (8 << 20) else None,
        )
    else:
        out = hybrid_spmm(
            adj, x_perm,
            remainder_chunk=(
                (4 << 20)
                if int(adj.remainder_weights.shape[0]) > (8 << 20)
                else None
            ),
        )
    # host-side chunked oracle (a one-pass device coo_spmm at 40M edges
    # materializes the 10 GB gathered-messages tensor and OOMs the chip)
    xh = np.asarray(x)
    ref = np.zeros((num_nodes, xh.shape[1]), np.float64)
    for lo in range(0, E, 8 << 20):
        hi = min(lo + (8 << 20), E)
        np.add.at(
            ref, r[lo:hi],
            w[lo:hi, None].astype(np.float64) * xh[s[lo:hi]],
        )
    ref_p = ref[plan.perm]
    outh = np.asarray(out, np.float64)
    rel = float(np.linalg.norm(outh - ref_p) / np.linalg.norm(ref_p))

    return {
        "case": name,
        "num_nodes": num_nodes,
        "num_edges": E,
        "shortcut_frac": shortcut_frac,
        "chosen_format": plan.format,
        "bandwidth_blocks": plan.bandwidth,
        "remainder_frac": plan.remainder_frac,
        "bandwidth_before": plan.bandwidth_before,
        "bandwidth_after": plan.bandwidth_after,
        "plan_s": plan_s,
        "build_s": build_s,
        "scatter_edges_per_s": scatter_rate,
        "scatter_edges_measured": coo_e,
        "layout_edges_per_s": E / dt_layout,
        "uplift": (E / dt_layout) / scatter_rate,
        "predicted_us": plan.est_us["chosen"],
        "measured_us": dt_layout * 1e6,
        "rel_err_vs_scatter_oracle": rel,
    }


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--json", action="store_true")
    p.add_argument("--scale", default="full", choices=["small", "full"])
    p.add_argument("--cases", default="permuted_spatial,small_world_10,small_world_30")
    args = p.parse_args()

    if args.scale == "full":
        dims = dict(num_nodes=1 << 20, degree=38, band=512)
    else:
        dims = dict(num_nodes=1 << 16, degree=16, band=512)

    specs = {
        "permuted_spatial": dict(shortcut_frac=0.0),
        "small_world_10": dict(shortcut_frac=0.1),
        "small_world_30": dict(shortcut_frac=0.3),
    }
    results = []
    for name in args.cases.split(","):
        name = name.strip()
        print(f"# running {name} ...", file=sys.stderr, flush=True)
        results.append(run_case(name, **dims, **specs[name]))
        print(
            f"#   {results[-1]['chosen_format']} W={results[-1]['bandwidth_blocks']}"
            f" rem={results[-1]['remainder_frac']:.3f}"
            f" uplift={results[-1]['uplift']:.1f}x",
            file=sys.stderr, flush=True,
        )

    out = {
        "round": 4,
        "harness": "benchmarks/layout_experiments.py",
        "scale": args.scale,
        "results": results,
    }
    if args.json:
        print(json.dumps(out, indent=2))
    else:
        for rr in results:
            print(rr)


if __name__ == "__main__":
    main()
