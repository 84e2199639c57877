#!/usr/bin/env python3
"""Fused serving kernel vs XLA's plain forward, on the GPU.

For each serving shape the fused kernels take (GCN and GraphSAGE at
batch 16 × 84 regions, hidden 64; GCN packed 512 graphs), this checks
the fused forward against the float32 reference at ``"highest"``
precision, then times two jitted forwards in turns (kernel, XLA, XLA,
kernel, ...):

* ``fused`` — :func:`~connectome_gnn_jax.ops.fused_pallas.forward_auto`
  with weights packed once (:func:`pack_fused_weights`), the
  Triton-route kernel as ``Trainer.predict`` serves with it;
* ``xla`` — ``model.apply(train=False)``, what XLA makes of the plain
  version.

Per path, from the host clock around work that ends in
``block_until_ready``:

* ``us_per_batch`` — back-to-back dispatch of ``--iters`` jitted calls,
  one sync at the end (throughput of a busy server);
* ``latency_us`` — median of single synchronous calls (an idle server);
* ``predict_graphs_per_s`` — ``Trainer.predict`` over 2048 graphs, the
  serving entry point end to end;

and from a profiler trace of 100 calls, the device time per call, per
kernel.

Both run at the default matmul precision (TF32 dots on tensor cores).
Needs a GPU; prints the card's name and power limit, one JSON line per
shape, and exits non-zero if the fused kernel disagrees with the
reference.

Usage:
    python benchmarks/fused_serving.py [--iters 2000] [--rounds 3]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

#: Max |fused − reference| over max |reference| at TF32 dots.
TF32_TOL = 2e-2
#: The same bound with IEEE float32 dots in both.
F32_TOL = 1e-4

SHAPES = {
    "gcn_b16_n84": ("gcn", 16, 84, 64),
    "sage_b16_n84": ("sage", 16, 84, 64),
    "gcn_packed512_n84": ("gcn", 512, 84, 64),
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def _rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def device_time_per_call(call, n: int = 100) -> dict:
    """Trace ``n`` back-to-back calls and reduce the GPU planes: per
    trace line, events per call, summed event time per call (us) and the
    union of event intervals per call (busy time, us)."""
    import glob
    import tempfile

    call().block_until_ready()
    with tempfile.TemporaryDirectory() as d:
        jax.profiler.start_trace(d)
        for _ in range(n):
            out = call()
        out.block_until_ready()
        jax.profiler.stop_trace()
        (path,) = glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                            recursive=True)
        data = jax.profiler.ProfileData.from_file(path)
    lines = {}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            spans = sorted((e.start_ns, e.start_ns + e.duration_ns)
                           for e in line.events)
            busy, end = 0.0, float("-inf")
            for s, e in spans:
                busy += max(0.0, e - max(s, end))
                end = max(end, e)
            by_name = {}
            for e in line.events:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.duration_ns
            lines[f"{plane.name}|{line.name}"] = {
                "events_per_call": len(spans) / n,
                "sum_us_per_call": sum(e - s for s, e in spans) / n / 1e3,
                "busy_us_per_call": busy / n / 1e3,
                "us_per_call_by_name": {
                    k: v / n / 1e3 for k, v in sorted(
                        by_name.items(), key=lambda kv: -kv[1])[:8]
                },
            }
    return lines


def run_shape(name, family, B, regions, hidden, iters, rounds):
    from connectome_gnn_jax import ConnectomeDataLoader, Trainer
    from connectome_gnn_jax.data import collate_dense, generate_dataset
    from connectome_gnn_jax.models import GCNConnectome, GraphSAGEConnectome
    from connectome_gnn_jax.ops.fused_pallas import (
        forward_auto,
        pack_fused_weights,
    )

    cls = GCNConnectome if family == "gcn" else GraphSAGEConnectome
    model = cls(in_channels=5, hidden_dim=hidden, num_layers=3)
    params, state = model.init(jax.random.PRNGKey(0))
    graphs = generate_dataset(num_subjects=B, num_regions=regions, seed=2)
    batch = collate_dense(graphs)
    # non-trivial BatchNorm statistics, as after training
    _, state = jax.jit(
        lambda p, s, b: model.apply(p, s, b, train=True,
                                    rng=jax.random.PRNGKey(1))
    )(params, state, batch)

    weights = pack_fused_weights(model, params, state)
    fused = jax.jit(
        lambda p, s, w, b: forward_auto(model, p, s, b, weights=w)
    )
    xla = jax.jit(lambda p, s, w, b: model.apply(p, s, b, train=False)[0])
    args = (params, state, weights, batch)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(xla(*args))
        err_f32 = _rel_err(fused(*args), ref)
    err_tf32 = _rel_err(fused(*args), ref)
    err_xla_tf32 = _rel_err(xla(*args), ref)
    if not (err_f32 <= F32_TOL and err_tf32 <= TF32_TOL):
        raise SystemExit(
            f"{name}: fused kernel off the reference "
            f"(f32 {err_f32:.3g}, tf32 {err_tf32:.3g})"
        )

    def throughput(fn):
        out = fn(*args)
        out.block_until_ready()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        out.block_until_ready()
        return (time.perf_counter() - t0) / iters * 1e6

    def latency(fn, n=200):
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn(*args).block_until_ready()
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts) * 1e6

    # end to end through the serving entry point: Trainer.predict over a
    # loader of 2048 graphs
    trainer = Trainer(model, params=params, state=state)
    loader = ConnectomeDataLoader(
        graphs * (2048 // B), batch_size=B, shuffle=False, layout="dense"
    )

    def predict_graphs_per_s(prefer_fused):
        trainer.predict(loader, prefer_fused=prefer_fused)
        t0 = time.perf_counter()
        out = trainer.predict(loader, prefer_fused=prefer_fused)
        return len(out) / (time.perf_counter() - t0)

    runs = {"fused": [], "xla": []}
    lat = {"fused": [], "xla": []}
    e2e = {"fused": [], "xla": []}
    order = [("fused", fused), ("xla", xla)]
    for r in range(rounds):
        for key, fn in order if r % 2 == 0 else order[::-1]:
            runs[key].append(throughput(fn))
            lat[key].append(latency(fn))
            e2e[key].append(predict_graphs_per_s(key == "fused"))
    device = {
        key: device_time_per_call(lambda fn=fn: fn(*args))
        for key, fn in order
    }
    return {
        "device_per_call": device,
        "predict_graphs_per_s": e2e,
        "shape": name,
        "batch": B,
        "padded_nodes": int(batch.node_features.shape[1]),
        "hidden": hidden,
        "rel_err_fused_f32": err_f32,
        "rel_err_fused_tf32": err_tf32,
        "rel_err_xla_tf32": err_xla_tf32,
        "us_per_batch": {k: v for k, v in runs.items()},
        "latency_us": {k: v for k, v in lat.items()},
        "median_us_per_batch": {k: statistics.median(v) for k, v in runs.items()},
        "median_latency_us": {k: statistics.median(v) for k, v in lat.items()},
    }


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--iters", type=int, default=2000)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--shapes", default=",".join(SHAPES))
    args = p.parse_args()

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("fused_serving.py measures the GPU; none found")
    from connectome_gnn_jax.utils import enable_compile_cache

    enable_compile_cache()
    print(f"card: {card_line()}  device_kind: {jax.devices()[0].device_kind}")
    for name in args.shapes.split(","):
        family, B, regions, hidden = SHAPES[name]
        res = run_shape(name, family, B, regions, hidden, args.iters,
                        args.rounds)
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
