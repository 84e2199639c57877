#!/usr/bin/env python3
"""Headline benchmark: GCN serving edge-message throughput on the GPU.

Times the serving forward of the flagship GCNConnectome at the reference
demo config (batch = 16 subjects × 84 regions, hidden = 64, 3 layers):
the jitted ``forward_auto`` step that ``Trainer.predict`` runs per batch
(the fused Triton kernel, weights packed once).  Reports edge-messages
per second — 3 layers × the batch's real edges over the time per batch —
against the reference's measured CPU number (BASELINE.md: 8.05 ms/batch
⇒ ~3.96 M edge-messages/s).

The time per batch is the host clock around ``ITERS`` back-to-back
calls ending in ``block_until_ready`` (a busy server's throughput).
Before timing, the served logits are checked against ``model.apply`` at
``"highest"`` precision.

Needs a GPU.  Prints the card's name and power limit, then ONE JSON
line: {"metric", "value", "unit", "vs_baseline", "device"}.
"""

from __future__ import annotations

import json
import subprocess
import time

import jax
import numpy as np

BASELINE_EDGE_MSGS_PER_S = 3.96e6  # reference torch CPU, BASELINE.md
ITERS = 2000
#: Max |served − reference| / max |reference|; TF32 dots (default
#: precision) keep ~3 decimal digits.
TOL = 2e-2


def main() -> None:
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX found {devices}")

    from connectome_gnn_jax.data import collate_dense, generate_dataset
    from connectome_gnn_jax.models import GCNConnectome
    from connectome_gnn_jax.ops.fused_pallas import (
        forward_auto,
        pack_fused_weights,
    )
    from connectome_gnn_jax.utils import enable_compile_cache

    enable_compile_cache()
    graphs = generate_dataset(num_subjects=16, num_regions=84, seed=42)
    batch = collate_dense(graphs)
    real_edges = sum(g.num_edges for g in graphs)

    model = GCNConnectome(in_channels=5, hidden_dim=64, num_classes=2,
                          num_layers=3)
    params, state = model.init(jax.random.PRNGKey(0))
    weights = pack_fused_weights(model, params, state)
    serve = jax.jit(
        lambda p, s, w, b: forward_auto(model, p, s, b, weights=w)
    )
    args = (params, state, weights, batch)

    with jax.default_matmul_precision("highest"):
        ref = np.asarray(model.apply(params, state, batch, train=False)[0])
    got = np.asarray(serve(*args))
    err = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
    if not err <= TOL:
        raise SystemExit(f"served logits off the reference: {err:.3g}")

    serve(*args).block_until_ready()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        out = serve(*args)
    out.block_until_ready()
    dt = (time.perf_counter() - t0) / ITERS

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card)
    rate = model.num_layers * real_edges / dt
    print(json.dumps({
        "metric": "gcn_fwd_edge_messages_per_s",
        "value": rate,
        "unit": "edge-messages/s (bs=16, h=64, L=3, 84-node WS graphs)",
        "vs_baseline": rate / BASELINE_EDGE_MSGS_PER_S,
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind,
                   "count": len(devices)},
    }))


if __name__ == "__main__":
    main()
