#!/usr/bin/env python3
"""Graph-sharded exchange payloads: COUNTED, then timed.

Round 4 justified "the compacted exchange is the required next kernel"
with a closed-form model (456 MB/step/device at 8 chips).  This harness
replaces the model with measurements:

1. **Counted payloads** — `count_collective_bytes` walks the jaxpr of
   the ACTUAL sampling program (abstract trace: no memory, no devices
   needed) at the projection shape (S=1024 seeds/device, fanout
   10x10, F=64) for D=4 and D=8, for the broadcast exchange and two
   compacted operating points.  The analytic model is asserted equal to
   the count (it is now validated, not just stated) and a link-time
   projection at NVLink's 450 GB/s each way is derived.
2. **Timed steps** — on the 8-virtual-device CPU mesh, a mid-size
   spatial graph (into which the CPU backend's memcpy collectives give
   payload-proportional cost) runs the full sampling program both ways:
   steady-state ms/step, measured speedup, and the compacted overflow
   counter (0 = the cheap exchange was also exact on real data).

Usage:  python benchmarks/sharded_exchange.py [--out SHARDED_EXCHANGE_r05.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

#: NVLink bandwidth each way between two H100s of one host (NVIDIA data sheet).
LINK_BYTES_PER_S = 450e9


def _abstract_csr(D, P, F, e_max, max_deg, num_nodes):
    """A ShardedGraphCSR of ShapeDtypeStructs — enough to trace."""
    from connectome_gnn_jax.parallel import ShardedGraphCSR

    sds = jax.ShapeDtypeStruct
    return ShardedGraphCSR(
        indptr=sds((D, P + 1), jnp.int32),
        sender_weight=sds((D, e_max, 2), jnp.int32),
        node_features=sds((D, P, F), jnp.float32),
        nodes_per_shard=P,
        max_in_degree=max_deg,
        num_nodes=num_nodes,
    )


def _sampling_fn(mesh, fanout, compaction):
    from functools import partial

    from jax.sharding import PartitionSpec as P

    from connectome_gnn_jax.parallel.sharded_sampling import (
        sharded_device_sample_with_stats,
    )

    @jax.jit
    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("data"), P("data"), P("data")),
        out_specs=(P("data"), P("data"), P("data")),
    )
    def run(gs, seeds, key_data):
        b, ovf = sharded_device_sample_with_stats(
            gs, seeds[0], jax.random.wrap_key_data(key_data[0]), fanout,
            compaction=compaction,
        )
        # reduce to scalars so the timed fetch is tiny, but keep every
        # output alive (checksum over features + weights)
        chk = jnp.sum(b.node_features) + jnp.sum(b.edge_weight)
        nvalid = jnp.sum(b.node_mask.astype(jnp.int32))
        return chk[None], nvalid[None], ovf[None]

    return run


def counted_projection(configs) -> dict:
    """Counted per-device payloads at the projection shape."""
    from connectome_gnn_jax.parallel import (
        count_collective_bytes,
        create_mesh,
        sharded_sampling_comm_model,
    )

    S, fanout, F, max_deg = 1024, (10, 10), 64, 100
    N = 1_000_000
    out = {}
    for D in (4, 8):
        mesh = create_mesh(devices=jax.devices()[:D])
        P_ = -(-N // D)
        csr = _abstract_csr(D, P_, F, 44_000_000 // D, max_deg, N)
        seeds = jax.ShapeDtypeStruct((D, S), jnp.int32)
        keys = jax.ShapeDtypeStruct((D, 2), jnp.uint32)
        rows = {}
        for name, comp in configs.items():
            fn = _sampling_fn(mesh, fanout, comp)
            counted = count_collective_bytes(fn, csr, seeds, keys)
            model = sharded_sampling_comm_model(
                D=D, S=S, fanout=fanout, F=F, max_deg=max_deg,
                compaction=comp,
            )
            assert counted["total"] == model["per_device_bytes_per_step"], (
                name, counted, model,
            )
            rows[name] = {
                "counted_bytes_per_device_per_step": counted["total"],
                "counted_by_primitive": {
                    k: v for k, v in counted.items() if k != "total"
                },
                "model_bytes": model["per_device_bytes_per_step"],
                "counted_equals_model": True,
                "link_ms_at_450GBps": counted["total"] / LINK_BYTES_PER_S * 1e3,
            }
        base = rows["broadcast"]["counted_bytes_per_device_per_step"]
        for name in rows:
            rows[name]["reduction_vs_broadcast"] = base / max(
                rows[name]["counted_bytes_per_device_per_step"], 1
            )
        out[f"D{D}"] = rows
    return out


def timed_virtual_mesh(configs, *, n=131_072, degree=24, S=256,
                       fanout=(10, 10), steps=8) -> dict:
    """Steady-state ms/step of the full sampling program, both
    exchanges, on the 8-virtual-device CPU mesh (collectives are
    memcpys — payload-proportional, not link-accurate; the COUNTED
    section carries the wire projection)."""
    from connectome_gnn_jax.data import generate_spatial_graph
    from connectome_gnn_jax.parallel import ShardedGraphCSR, create_mesh

    D = 8
    g = generate_spatial_graph(n, degree=degree, band=64, seed=7,
                               shortcut_frac=0.05)
    sg = ShardedGraphCSR.partition(g, D)
    mesh = create_mesh(devices=jax.devices()[:D])
    rng = np.random.default_rng(0)
    seeds = rng.permutation(n)[: D * S].reshape(D, S).astype(np.int32)
    keys = np.stack([
        np.asarray(jax.random.key_data(jax.random.PRNGKey(r)))
        for r in range(D)
    ])
    sj, kj = jnp.asarray(seeds), jnp.asarray(keys)

    out = {
        "graph": {"nodes": n, "edges": int(g.edge_index[0].shape[0]),
                  "degree": degree, "max_in_degree": sg.max_in_degree},
        "seeds_per_device": S, "fanout": list(fanout), "devices": D,
    }

    # probe-planned per-stage config on THIS graph's real frontiers
    from connectome_gnn_jax.parallel import (
        plan_compaction,
        sharded_sampling_comm_model,
    )

    planned, loads = plan_compaction(
        sg, mesh, np.broadcast_to(seeds, (3, D, S)),
        jax.random.PRNGKey(99), fanout, return_loads=True,
    )
    configs = dict(configs)
    configs["compacted_planned"] = planned
    out["planned_config"] = {
        "alpha": planned.alpha, "rounds": planned.rounds,
        "alpha_features": planned.alpha_features,
        "rounds_features": planned.rounds_features,
        "probed_loads": loads,
        "model_bytes_per_device_per_step": sharded_sampling_comm_model(
            D=D, S=S, fanout=fanout,
            F=int(g.node_features.shape[-1]),
            max_deg=max(sg.max_in_degree, max(fanout), 1),
            compaction=planned,
        )["per_device_bytes_per_step"],
    }

    for name, comp in configs.items():
        fn = _sampling_fn(mesh, fanout, comp)
        chk, nvalid, ovf = fn(sg, sj, kj)  # compile + warm
        float(jnp.sum(chk))
        t0 = time.perf_counter()
        for _ in range(steps):
            chk, nvalid, ovf = fn(sg, sj, kj)
        float(jnp.sum(chk))  # fetch-sync
        dt = (time.perf_counter() - t0) / steps
        out[name] = {
            "ms_per_step": dt * 1e3,
            "overflow_per_step": int(np.asarray(ovf).sum()),
            "valid_nodes_per_device": int(np.asarray(nvalid)[0]),
        }
    base = out["broadcast"]["ms_per_step"]
    for name in configs:
        out[name]["speedup_vs_broadcast"] = base / out[name]["ms_per_step"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="SHARDED_EXCHANGE_r05.json")
    args = ap.parse_args()

    from connectome_gnn_jax.parallel import CompactionConfig

    configs = {
        "broadcast": None,
        "compacted_a2_r2": CompactionConfig(alpha=2.0, rounds=2),
        "compacted_a1.25_r1": CompactionConfig(alpha=1.25, rounds=1),
        # same tight capacity WITHOUT unique-id feature requests: shows
        # what the dedup schedule buys (overflow at equal payload)
        "compacted_a1.25_r1_nodedup": CompactionConfig(
            alpha=1.25, rounds=1, dedup_features=False
        ),
        # per-stage split: generous draw stages (which can overflow but
        # are cheap), tight feature stage (which dominates payload but
        # dedups) — the shape plan_compaction picks automatically
        "compacted_split_d2.0_f1.25": CompactionConfig(
            alpha=2.0, rounds=2, alpha_features=1.25, rounds_features=1
        ),
    }
    artifact = {
        "what": "graph-sharded sampling exchange: counted payloads + "
                "timed virtual-mesh steps (broadcast vs compacted)",
        "counted_at_projection_shape": counted_projection(configs),
        "timed_8dev_cpu_mesh": timed_virtual_mesh(configs),
        "notes": [
            "counted = jaxpr-walked bytes RECEIVED per device per step "
            "of the actual program (parallel/comm_accounting.py); "
            "asserted equal to sharded_sampling_comm_model",
            "compacted semantics: exact (bitwise = broadcast) while no "
            "(requester,owner) pair exceeds rounds*C remote requests; "
            "overflow drops deterministically and is counted; "
            "dedup_features bounds UNIQUE remote ids instead of slots "
            "(the residual overflow of 3 at a1.25/r1 on this spatial "
            "fixture is the HOP stage, whose per-slot randomness "
            "cannot dedup)",
            "compacted_split / compacted_planned: per-stage capacities "
            "(alpha_features/rounds_features) — the feature stage "
            "carries ~97% of the payload but dedups, so it runs tight "
            "while the cheap draw stages stay generous; "
            "plan_compaction probes real frontiers and picks both "
            "(timed section: planned_config, exact on this fixture)",
            "CPU-mesh timings measure the COMPUTE side of compaction "
            "(sorts, schedule scatters, the dedup fan-out gather) plus "
            "memcpy collectives - NOT NVLink: a2/r2's extra rounds and "
            "dedup's sort show as CPU cost here while the wire payload "
            "(the counted section) is what a pod pays; use counted "
            "bytes + 45 GB/s for the pod projection",
        ],
    }
    s = json.dumps(artifact, indent=2)
    print(s)
    with open(args.out, "w") as f:
        f.write(s + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
