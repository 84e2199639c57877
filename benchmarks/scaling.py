#!/usr/bin/env python3
"""Scaling-efficiency harness: throughput vs device count.

Measures the north-star scaling metric (BASELINE.json: edges/s scaling
1 chip → 1 host → N hosts, target >80 % efficiency) for the three
parallel modes:

* ``dp``     — data-parallel training throughput (graphs/s) over the
               ``data`` axis at shard counts 1, 2, 4, ..., D;
* ``banded`` — halo-exchange sharded banded forward (edges/s) over the
               ``edge`` axis;
* ``hybrid`` — banded halo + all_to_all shortcut-remainder exchange
               (small-world giant graphs).

With ``--cpu`` the multi-device rows use virtual CPU devices (run with
``XLA_FLAGS=--xla_force_host_platform_device_count=8 ... --cpu``) —
exercising the exact sharding/collective program that several GPUs
would run, with CPU-grade absolute numbers.  On a multi-GPU host the
same harness reports per-device scaling.

Usage:
    python benchmarks/scaling.py --cpu --mode dp
    python benchmarks/scaling.py --cpu --mode banded
    python benchmarks/scaling.py --cpu --mode hybrid
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def sync(value) -> float:
    import jax.numpy as jnp

    return float(jnp.sum(value))


def _timed_pair(make, args, iters):
    """Full-vs-quarter-length on-device loops, value-fetch synced."""
    k_small = max(iters // 4, 1)
    c_full, c_small = make(iters), make(k_small)
    sync(c_full(*args))
    sync(c_small(*args))

    def timed(c):
        t0 = time.perf_counter()
        sync(c(*args))
        return time.perf_counter() - t0

    t_small = min(timed(c_small) for _ in range(2))
    t_full = min(timed(c_full) for _ in range(2))
    return max(t_full - t_small, 1e-12) / (iters - k_small)


def bench_dp(devices, graphs_per_shard=32, iters=20):
    import jax
    import jax.numpy as jnp
    import optax

    from connectome_gnn_jax.data import ConnectomeDataLoader, generate_dataset
    from connectome_gnn_jax.models import GCNConnectome
    from connectome_gnn_jax.parallel import create_mesh, make_dp_train_step, shard_batch

    results = {}
    d = 1
    while d <= len(devices):
        batch_size = graphs_per_shard * d
        dataset = generate_dataset(num_subjects=batch_size, num_regions=84, seed=0)
        loader = ConnectomeDataLoader(
            dataset, batch_size=batch_size, shuffle=False, num_shards=d
        )
        mesh = create_mesh(shape=(d,), devices=devices[:d])
        stacked = shard_batch(next(iter(loader)), mesh)

        model = GCNConnectome(in_channels=5, hidden_dim=64)
        params, state = model.init(jax.random.PRNGKey(0))
        opt = optax.adam(1e-3)
        opt_state = opt.init(params)
        step = make_dp_train_step(model, opt, mesh)

        # chain steps on-device (params carry creates the dependence);
        # timing per the suite methodology (fetch sync + differencing)
        def make(k, step=step, params=params, state=state, opt_state=opt_state,
                 stacked=stacked):
            def looped(params, state, opt_state, stacked):
                def body(i, carry):
                    p, s, o = carry
                    p, s, o, _, _ = step(p, s, o, jax.random.PRNGKey(0), stacked)
                    return (p, s, o)

                p, _, _ = jax.lax.fori_loop(
                    0, k, body, (params, state, opt_state)
                )
                return jnp.sum(p["head"]["fc2"]["bias"])

            return (
                jax.jit(looped)
                .lower(params, state, opt_state, stacked)
                .compile()
            )

        dt = _timed_pair(make, (params, state, opt_state, stacked), iters)
        results[d] = {
            "graphs_per_s": batch_size / dt,
            "per_device": batch_size / dt / d,
        }
        d *= 2

    base = results[1]["per_device"]
    for d, r in results.items():
        r["efficiency"] = r["per_device"] / base
    return results


def _bench_edge_sharded(devices, *, hybrid, nodes_per_shard=16384,
                        band=512, shortcut_frac=0.1, iters=10):
    """Shared weak-scaling loop for the edge-sharded giant-graph modes.

    ``hybrid=False``: pure band (halo ppermute only).  ``hybrid=True``:
    band + shortcut remainder (halo ppermute + static all_to_all).
    """
    import dataclasses
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from connectome_gnn_jax.data import generate_spatial_graph
    from connectome_gnn_jax.ops import to_banded, to_hybrid
    from connectome_gnn_jax.parallel import (
        ShardedBandedGCN,
        create_mesh,
        partition_banded,
        partition_hybrid,
    )

    results = {}
    d = 1
    while d <= len(devices):
        n = nodes_per_shard * d
        g = generate_spatial_graph(
            n, degree=12, band=band, seed=0,
            shortcut_frac=shortcut_frac if hybrid else 0.0,
        )
        edges = g.num_edges
        if hybrid:
            m = to_hybrid(g.edge_index[0], g.edge_index[1], g.edge_weight, n,
                          block=128, bandwidth=-(-band // 128))
            shard_input = partition_hybrid(m, g.node_features, d)

            def with_features(shard, v):
                return dataclasses.replace(
                    shard, banded=dataclasses.replace(
                        shard.banded, node_features=v
                    )
                )
        else:
            m = to_banded(g.edge_index[0], g.edge_index[1], g.edge_weight, n,
                          block=128)
            shard_input = partition_banded(m, g.node_features, d)

            def with_features(shard, v):
                return dataclasses.replace(shard, node_features=v)

        model = ShardedBandedGCN(in_channels=5, hidden_dim=64, num_layers=3)
        params, state = model.init(jax.random.PRNGKey(0))
        mesh = create_mesh(shape=(d,), axis_names=("edge",), devices=devices[:d])

        def make(k, model=model, mesh=mesh, params=params, state=state,
                 shard_input=shard_input, with_features=with_features):
            @jax.jit
            @partial(
                jax.shard_map,
                mesh=mesh,
                in_specs=(P(), P(), P("edge")),
                out_specs=P(),
            )
            def looped(params, state, stacked):
                shard = jax.tree_util.tree_map(lambda x: x[0], stacked)

                def body(_, v):
                    logits, _ = model.apply_shard(
                        params, state, with_features(shard, v),
                        axis_name="edge",
                    )
                    # nonlinear scalar feedback chains iterations without
                    # changing shapes (logit width != feature width)
                    scale = 1.0 + 1e-6 * jnp.tanh(jnp.mean(logits))
                    return v * scale

                out = jax.lax.fori_loop(0, k, body, shard.node_features)
                return jax.lax.psum(jnp.sum(out), "edge")

            return jax.jit(
                lambda p, s, b: looped(p, s, b)
            ).lower(params, state, shard_input).compile()

        dt = _timed_pair(make, (params, state, shard_input), iters)
        results[d] = {
            "edges_per_s": 3 * edges / dt,
            "per_device": 3 * edges / dt / d,
        }
        d *= 2

    base = results[1]["per_device"]
    for d, r in results.items():
        r["efficiency"] = r["per_device"] / base
    return results


def bench_banded(devices, **kw):
    return _bench_edge_sharded(devices, hybrid=False, **kw)


def bench_hybrid(devices, **kw):
    """Sharded hybrid (band halo + all_to_all remainder) forward scaling."""
    return _bench_edge_sharded(devices, hybrid=True, **kw)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--mode", choices=["dp", "banded", "hybrid"], default="dp")
    parser.add_argument("--json", action="store_true")
    args = parser.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    devices = jax.devices()
    print(f"devices: {len(devices)} × {devices[0].platform}", file=sys.stderr)
    if devices[0].platform == "cpu":
        print(
            "NOTE: virtual CPU devices share physical cores — these rows "
            "validate the sharded programs and expose collective overheads, "
            "but 'efficiency' here reflects core contention, NOT "
            "interconnect scaling. Run on a real slice for honest numbers.",
            file=sys.stderr,
        )

    bench = {"dp": bench_dp, "banded": bench_banded, "hybrid": bench_hybrid}
    results = bench[args.mode](devices)
    metric = "graphs_per_s" if args.mode == "dp" else "edges_per_s"
    if args.json:
        import json

        print(json.dumps({
            "mode": args.mode,
            "platform": devices[0].platform,
            "num_devices": len(devices),
            "caveat": (
                "virtual CPU devices share physical cores: rows validate the "
                "sharded program; 'efficiency' reflects core contention, not "
                "interconnect scaling"
            ) if devices[0].platform == "cpu" else None,
            "rows": {str(d): r for d, r in results.items()},
        }, indent=2))
        return
    print(f"{'devices':>8} {metric:>16} {'per-device':>14} {'efficiency':>11}")
    for d, r in results.items():
        print(
            f"{d:>8} {r[metric]:>16,.0f} {r['per_device']:>14,.0f} "
            f"{r['efficiency']:>10.1%}"
        )


if __name__ == "__main__":
    main()
