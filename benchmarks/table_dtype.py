#!/usr/bin/env python3
"""Reduced-precision device-resident feature tables at north-star scale.

Backs docs/ARCHITECTURE.md's replication-headroom claim with code and
measurements (VERDICT r4 missing #5): at 1M nodes / 44M edges,

* residency — measured device bytes of the CSR per ``feature_dtype``
  (f32 0.61 GB → bf16 ~0.48 → int8 ~0.42: how much bigger a graph can
  still REPLICATE per device);
* step time — device-sampled training step (config-SD shape: 1024
  seeds, fanout 10×10) per dtype — whether narrower rows make the
  gather faster;
* value error — keep-all logits vs the f32 table (the table rounding
  is the ONLY difference; sampled subgraphs are identical).

Usage: python benchmarks/table_dtype.py [--out TABLE_DTYPE_r05.json]
       (run on the GPU; nothing else may use the card meanwhile)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax
import jax.numpy as jnp
import numpy as np


def _fetch(x) -> float:
    """Wait for ``x`` and pull its sum to the host."""
    return float(jnp.sum(x))


def _csr_bytes(csr) -> int:
    return int(sum(
        np.prod(x.shape) * x.dtype.itemsize
        for x in jax.tree_util.tree_leaves(csr)
    ))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=1 << 20)
    ap.add_argument("--degree", type=int, default=38)
    ap.add_argument("--feat", type=int, default=64)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default="TABLE_DTYPE_r05.json")
    args = ap.parse_args()

    from connectome_gnn_jax.data import (
        DeviceGraphCSR,
        device_sample,
        device_sampled_gcn,
        generate_spatial_graph,
    )
    from connectome_gnn_jax.train import Trainer

    print(f"backend: {jax.devices()[0].platform}", file=sys.stderr)
    g = generate_spatial_graph(
        args.nodes, degree=args.degree, band=512, seed=11,
        shortcut_frac=0.1, num_features=args.feat,
    )
    labels = (g.degree() > np.median(g.degree())).astype(np.int32)

    # value error on a SMALL keep-all probe (identical subgraphs)
    gs = generate_spatial_graph(512, degree=6, band=24, seed=3,
                                num_features=args.feat)
    f32s = DeviceGraphCSR.from_graph(gs)
    md = f32s.max_in_degree
    from connectome_gnn_jax.models import NodeGCN

    probe_model = NodeGCN(in_channels=args.feat, hidden_dim=32,
                          num_layers=2)
    pp, ps = probe_model.init(jax.random.PRNGKey(0))

    def probe_logits(csr):
        import dataclasses

        b = device_sample(
            csr, jnp.arange(32, dtype=jnp.int32), jax.random.PRNGKey(5),
            (md, md),
        )
        b = dataclasses.replace(
            b, labels=jnp.zeros(32, jnp.int32),
            label_mask=jnp.ones(32, bool), seed_mask=jnp.ones(32, bool),
        )
        out, _ = probe_model.apply(pp, ps, b, train=False)
        return np.asarray(out)

    ref_logits = probe_logits(f32s)

    rows = {}
    for dt in ("float32", "bfloat16", "int8"):
        model = device_sampled_gcn(
            g, hidden_dim=64, fanout=(10, 10), feature_dtype=dt
        )
        loader = model.make_loader(
            np.arange(args.nodes), labels, batch_size=args.batch, seed=0,
            drop_last=True,
        )
        trainer = Trainer(model, prefetch_depth=2)
        it = trainer._iterate(loader)

        def one(b):
            (trainer.params, trainer.state, trainer.opt_state,
             trainer._rng, loss, _, _) = trainer._train_step(
                trainer.params, trainer.state, trainer.opt_state,
                trainer._rng, b,
            )
            return loss

        for _ in range(3):
            _fetch(one(next(it)))
        t0 = time.perf_counter()
        loss = None
        for _ in range(args.steps):
            loss = one(next(it))
        _fetch(loss)
        dtime = (time.perf_counter() - t0) / args.steps
        if hasattr(it, "close"):
            it.close()

        err = float(np.max(np.abs(
            probe_logits(
                DeviceGraphCSR.from_graph(gs, feature_dtype=dt)
            ) - ref_logits
        )))
        rows[dt] = {
            "resident_gb": round(_csr_bytes(model.csr) / 1e9, 4),
            "ms_per_step": dtime * 1e3,
            "keep_all_logits_max_abs_err_vs_f32": err,
        }
        print(f"{dt}: {rows[dt]}", file=sys.stderr)

    base = rows["float32"]
    for dt in rows:
        rows[dt]["residency_ratio"] = round(
            base["resident_gb"] / rows[dt]["resident_gb"], 3
        )
        rows[dt]["step_ratio"] = round(
            base["ms_per_step"] / rows[dt]["ms_per_step"], 3
        )

    artifact = {
        "what": "device-resident feature-table dtype: residency, "
                "train-step time, value error (1M/44M, SD shape)",
        "nodes": args.nodes, "degree": args.degree,
        "batch": args.batch, "fanout": [10, 10], "features": args.feat,
        "backend": jax.devices()[0].platform,
        **rows,
        "notes": [
            "residency bounds the graph size that still replicates "
            "per chip: int8 tables fit ~1.45x the f32 graph per GB; "
            "the edge pairs (352 MB) dominate beyond that",
            "step_ratio: whether the gather is latency- or "
            "byte-bound",
        ],
    }
    s = json.dumps(artifact, indent=2)
    print(s)
    with open(args.out, "w") as f:
        f.write(s + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
