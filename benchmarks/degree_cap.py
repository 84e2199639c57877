#!/usr/bin/env python3
"""The skewed-degree memory cliff, measured — and the in_degree_cap fix.

Every sampler draw buffer is sized by the GLOBAL ``max_in_degree``
(uniforms ``[Fb, max_deg]`` f32 per hop, plus the top_k over them), so a
single power-law hub prices every step of training on the whole graph.
This harness builds the adversarial case at the config-SD shape — the
262k spatial graph plus a handful of hub nodes with thousands of
in-edges — and measures, per ``in_degree_cap`` setting:

* host prep time and device residency of the CSR;
* the per-hop draw-buffer bytes the static shapes imply;
* the real device-sampled train-step time (SD protocol: resident CSR,
  ~8 KB SeedBatch per step, sampling fused into the jitted step).

The uncapped row is the cliff (hop-1 uniforms alone are
``4·S·f0·max_deg`` bytes ≈ 336 MB at hub degree 8192); the capped rows
bound it at ``cap`` with the top-|weight| clamp
(``data/device_sampling.py::cap_in_degree_mask``), whose semantics are
unit-tested (tests/test_sharded_sampling.py).

Usage: python benchmarks/degree_cap.py [--out DEGREE_CAP_r05.json]
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


def _skewed_graph(num_nodes, degree, hubs, hub_deg, seed=0):
    from connectome_gnn_jax.data import ConnectomeGraph, generate_spatial_graph

    g = generate_spatial_graph(num_nodes, degree=degree, band=512,
                               seed=seed, shortcut_frac=0.1)
    rng = np.random.default_rng(seed + 1)
    hub_nodes = rng.choice(num_nodes, size=hubs, replace=False)
    hs = rng.integers(0, num_nodes, size=hubs * hub_deg)
    hd = np.repeat(hub_nodes, hub_deg)
    hw = rng.beta(2.0, 5.0, size=hubs * hub_deg).astype(np.float32)
    src = np.concatenate([g.edge_index[0], hs])
    dst = np.concatenate([g.edge_index[1], hd])
    w = np.concatenate([g.edge_weight, hw])
    return ConnectomeGraph(
        node_features=g.node_features,
        edge_index=np.stack([src, dst]),
        edge_weight=w,
    )


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=262_144)
    ap.add_argument("--degree", type=int, default=16)
    ap.add_argument("--hubs", type=int, default=16)
    ap.add_argument("--hub-deg", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default="DEGREE_CAP_r05.json")
    args = ap.parse_args()

    from connectome_gnn_jax.data import device_sampled_gcn
    from connectome_gnn_jax.train import Trainer

    print(f"backend: {jax.devices()[0].platform}", file=sys.stderr)
    g = _skewed_graph(args.nodes, args.degree, args.hubs, args.hub_deg)
    deg = np.bincount(g.edge_index[1], minlength=args.nodes)
    labels = (deg > np.median(deg)).astype(np.int32)
    fanout = (10, 10)
    S = args.batch

    rows = {}
    for name, cap in (("uncapped", None), ("cap128", 128), ("cap64", 64)):
        t0 = time.perf_counter()
        try:
            model = device_sampled_gcn(
                g, hidden_dim=64, fanout=fanout, in_degree_cap=cap
            )
        except Exception as e:  # record the cliff honestly
            rows[name] = {"failed": f"{type(e).__name__}: {e}"}
            continue
        prep_s = time.perf_counter() - t0
        md = model.csr.max_in_degree
        # static draw-buffer bytes per hop: uniforms [Fb, max_deg] f32
        fb, bufs = S, []
        for f in fanout:
            bufs.append(4 * fb * md)
            fb *= min(f, md)

        loader = model.make_loader(
            np.arange(args.nodes), labels, batch_size=args.batch,
            seed=0, drop_last=True,
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

        try:
            for _ in range(3):
                _fetch(one(next(it)))
            t0 = time.perf_counter()
            loss = None
            for _ in range(args.steps):
                loss = one(next(it))
            _fetch(loss)
            ms = (time.perf_counter() - t0) / args.steps * 1e3
        except Exception as e:
            rows[name] = {
                "max_in_degree": md, "prep_s": prep_s,
                "draw_buffer_bytes_per_hop": bufs,
                "failed": f"{type(e).__name__}: {e}",
            }
            continue
        finally:
            if hasattr(it, "close"):
                it.close()
        rows[name] = {
            "max_in_degree": md,
            "prep_s": round(prep_s, 3),
            "resident_mb": round(_csr_bytes(model.csr) / 1e6, 1),
            "draw_buffer_bytes_per_hop": bufs,
            "ms_per_step": ms,
        }
        print(f"{name}: {rows[name]}", file=sys.stderr)

    if "ms_per_step" in rows.get("uncapped", {}):
        base = rows["uncapped"]["ms_per_step"]
        for n, r in rows.items():
            if "ms_per_step" in r:
                r["speedup_vs_uncapped"] = round(base / r["ms_per_step"], 2)

    artifact = {
        "what": "skewed-degree draw-buffer cliff vs in_degree_cap "
                "(SD shape + power-law hubs, device-sampled train step)",
        "nodes": args.nodes, "degree": args.degree,
        "hubs": args.hubs, "hub_in_degree": args.hub_deg,
        "batch": args.batch, "fanout": list(fanout),
        "backend": jax.devices()[0].platform,
        **rows,
        "notes": [
            "draw_buffer_bytes_per_hop = 4*Fb*max_deg (the f32 uniform "
            "buffer each hop materializes; top_k runs over it too) - "
            "one hub node sets max_deg for every step on the graph",
            "in_degree_cap keeps each node's cap largest-|w| in-edges "
            "(deterministic tie-break; semantics unit-tested); capped "
            "hub nodes sample from their strongest cap edges - a "
            "documented sparsification, not an approximation of the "
            "uncapped sampler",
        ],
    }
    s = json.dumps(artifact, indent=2)
    print(s)
    with open(args.out, "w") as f:
        f.write(s + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
