#!/usr/bin/env python3
"""Giant-graph node classification demo.

The voxel-level regime (BASELINE config 5): one large spatially-embedded
connectome, trained for node-level prediction with the banded matmul path:

  1. synthesize a spatially-local giant graph (voxel-like locality),
  2. scramble it and recover the band with Reverse-Cuthill-McKee,
  3. convert to banded block-dense form,
  4. train a BandedNodeGCN (single device), and
  5. run the same parameters through the halo-exchange sharded model on a
     device mesh, confirming identical predictions.

Usage:
    python examples/giant_graph_demo.py [--cpu] [--nodes 20000]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--nodes", type=int, default=20_000)
    parser.add_argument("--degree", type=int, default=12)
    parser.add_argument("--band", type=int, default=256)
    parser.add_argument("--steps", type=int, default=200)
    args = parser.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import numpy as np
    import optax

    from connectome_gnn_jax.data.reorder import (
        apply_ordering,
        bandwidth,
        reverse_cuthill_mckee,
    )
    from connectome_gnn_jax.models import BandedNodeGCN
    from connectome_gnn_jax.ops import to_banded
    from connectome_gnn_jax.utils import enable_compile_cache

    enable_compile_cache()
    print(f"JAX backend: {jax.default_backend()}")

    # ------------------------------------------------------------------
    # 1. Spatially-local giant graph (voxel-like: neighbors in index space)
    # ------------------------------------------------------------------
    n, deg, band = args.nodes, args.degree, args.band
    rng = np.random.default_rng(0)
    from connectome_gnn_jax.data import generate_spatial_graph

    graph = generate_spatial_graph(n, degree=deg, band=band, seed=0)
    print(f"graph: {n:,} nodes, {graph.num_edges:,} edges, band ±{band}")

    # labels: a 2-hop-smoothing task (needs message passing to solve)
    senders, receivers = graph.edge_index
    deg_w = graph.degree()
    smooth = np.zeros(n, np.float32)
    np.add.at(smooth, receivers, deg_w[senders] * graph.edge_weight)
    labels = (smooth > np.median(smooth)).astype(np.int32)

    # ------------------------------------------------------------------
    # 2. Scramble + recover locality with RCM
    # ------------------------------------------------------------------
    scramble = rng.permutation(n)
    scrambled = apply_ordering(graph, scramble)
    print(f"scrambled bandwidth: {bandwidth(scrambled.edge_index):,}")
    t0 = time.perf_counter()
    perm = reverse_cuthill_mckee(scrambled.edge_index, n)
    recovered = apply_ordering(scrambled, perm)
    print(
        f"RCM bandwidth: {bandwidth(recovered.edge_index):,} "
        f"({time.perf_counter() - t0:.1f}s host-side)"
    )
    labels_scrambled = labels[scramble]
    labels_rcm = labels_scrambled[perm]

    # ------------------------------------------------------------------
    # 3. Banded form
    # ------------------------------------------------------------------
    a = to_banded(
        recovered.edge_index[0],
        recovered.edge_index[1],
        recovered.edge_weight,
        n,
        block=128,
    )
    mb = a.band.size * 4 / 1e6
    print(
        f"banded: {a.num_blocks} row blocks × {2 * a.bandwidth + 1} diagonals "
        f"of 128² ({mb:.0f} MB)"
    )

    # ------------------------------------------------------------------
    # 4. Train single-chip
    # ------------------------------------------------------------------
    model = BandedNodeGCN(in_channels=5, hidden_dim=64, num_layers=3)
    params, state = model.init(jax.random.PRNGKey(0))
    opt = optax.adam(1e-2)
    opt_state = opt.init(params)
    x = jnp.asarray(recovered.node_features)
    y = jnp.asarray(labels_rcm)
    band_arr = a.band

    @jax.jit
    def train_step(params, state, opt_state, band_arr, key):
        adj = a._replace(band=band_arr)

        def loss_fn(p):
            logits, new_state = model.apply(p, state, adj, x, train=True, rng=key)
            ce = optax.softmax_cross_entropy_with_integer_labels(logits, y)
            return jnp.mean(ce), new_state

        (loss, new_state), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, new_opt = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_state, new_opt, loss

    key = jax.random.PRNGKey(1)
    t0 = time.perf_counter()
    for step_idx in range(args.steps):
        key, k = jax.random.split(key)
        params, state, opt_state, loss = train_step(
            params, state, opt_state, band_arr, k
        )
        if (step_idx + 1) % max(args.steps // 4, 1) == 0:
            logits, _ = model.apply(params, state, a, x)
            acc = float(jnp.mean(jnp.argmax(logits, 1) == y))
            print(
                f"  step {step_idx + 1:4d}: loss {float(loss):.4f}, "
                f"node acc {acc:.3f}"
            )
    print(f"trained {args.steps} steps in {time.perf_counter() - t0:.1f}s")

    # ------------------------------------------------------------------
    # 5. Same parameters through the halo-exchange sharded model
    # ------------------------------------------------------------------
    num_dev = len(jax.devices())
    # halo exchange needs bandwidth <= blocks-per-shard; clamp the shard
    # count for small graphs instead of crashing after training
    max_shards = max(a.num_blocks // max(a.bandwidth, 1), 1)
    num_dev = min(num_dev, max_shards)
    if num_dev > 1:
        from connectome_gnn_jax.parallel import (
            ShardedBandedGCN,
            create_mesh,
            partition_banded,
        )

        mesh = create_mesh(
            shape=(num_dev,), axis_names=("edge",), devices=jax.devices()[:num_dev]
        )
        sharded = ShardedBandedGCN(in_channels=5, hidden_dim=64, num_layers=3)
        pb = partition_banded(a, recovered.node_features, num_dev)
        out = sharded.forward(params, state, pb, mesh)
        flat = np.asarray(out).reshape(-1, out.shape[-1])[:n]
        single_logits, _ = model.apply(params, state, a, x)
        max_diff = float(np.abs(flat - np.asarray(single_logits)).max())
        print(
            f"sharded ({num_dev} devices, halo exchange) vs single-chip "
            f"max |Δlogit| = {max_diff:.2e}"
        )
    else:
        print("(single device — skipping the sharded cross-check; run with "
              "XLA_FLAGS=--xla_force_host_platform_device_count=8 and --cpu)")

    # ------------------------------------------------------------------
    # 6. Small-world variant: hybrid (band + shortcut remainder) sharding
    # ------------------------------------------------------------------
    from connectome_gnn_jax.ops import to_hybrid

    sw = generate_spatial_graph(n, degree=deg, band=band, seed=3,
                                shortcut_frac=0.1)
    h = to_hybrid(sw.edge_index[0], sw.edge_index[1], sw.edge_weight, n,
                  block=128, bandwidth=-(-band // 128))
    rem = int((np.asarray(h.remainder_weights) > 0).sum())
    print(
        f"small-world graph: {sw.num_edges:,} edges, {rem:,} long-range "
        f"shortcuts routed through the sparse remainder"
    )
    hx = jnp.asarray(sw.node_features)
    h_logits, _ = model.apply(params, state, h, hx)
    if num_dev > 1:
        from connectome_gnn_jax.parallel import partition_hybrid

        ph = partition_hybrid(h, sw.node_features, num_dev)
        out = sharded.forward(params, state, ph, mesh)
        flat = np.asarray(out).reshape(-1, out.shape[-1])[:n]
        max_diff = float(np.abs(flat - np.asarray(h_logits)).max())
        print(
            f"sharded hybrid ({num_dev} devices, halo ppermute + remainder "
            f"all_to_all) vs single-chip max |Δlogit| = {max_diff:.2e}"
        )

    # ------------------------------------------------------------------
    # 7. Minibatch sampling with the native NeighborSampler
    # ------------------------------------------------------------------
    from connectome_gnn_jax.data import NeighborSampler

    sampler = NeighborSampler(sw)
    t0 = time.perf_counter()
    sub, node_ids = sampler.sample(
        rng.integers(0, n, 512), fanout=[10, 10], seed=0
    )
    print(
        f"sampled 2-hop minibatch: {sub.num_nodes:,} nodes / "
        f"{sub.num_edges:,} edges in {(time.perf_counter() - t0) * 1e3:.0f} ms "
        f"(native sampler)"
    )

    # ------------------------------------------------------------------
    # 8. End-to-end sampled-minibatch training (seed-node supervision)
    # ------------------------------------------------------------------
    from connectome_gnn_jax.data import SampledNodeLoader
    from connectome_gnn_jax.models import NodeGCN
    from connectome_gnn_jax.train import Trainer

    src, dst = sw.edge_index
    msum = np.zeros(n)
    wsum = np.zeros(n)
    np.add.at(msum, dst, sw.edge_weight * sw.node_features[src, 0])
    np.add.at(wsum, dst, sw.edge_weight)
    labels = ((msum / (wsum + 1e-8)) > 0).astype(np.int32)

    order = np.random.default_rng(7).permutation(n)
    train_loader = SampledNodeLoader(
        sw, labels, seed_nodes=order[: int(0.8 * n)], batch_size=1024,
        fanout=(10, 10), seed=0, drop_last=True,
    )
    val_loader = SampledNodeLoader(
        sw, labels, seed_nodes=order[int(0.8 * n) :], batch_size=1024,
        fanout=(10, 10), shuffle=False,
    )
    trainer = Trainer(NodeGCN(in_channels=5, hidden_dim=64, num_layers=2))
    t0 = time.perf_counter()
    hist = trainer.fit(
        train_loader, val_loader, num_epochs=3, patience=10, verbose=False
    )
    dt = time.perf_counter() - t0
    steps = 3 * len(train_loader)
    print(
        f"sampled training on the {n:,}-node graph: val acc "
        f"{hist['val_acc'][-1]:.3f} after 3 epochs "
        f"({steps} sampled steps, {steps / dt:.1f} steps/s end-to-end)"
    )

    # ------------------------------------------------------------------
    # 9. DEVICE-side sampling, multiset mode, whole-epoch scan — the
    #    fastest full training path (suite configs SDM / SME): the graph
    #    lives in HBM, each step's fanout sample is drawn inside the
    #    jitted program, and scan_epochs dispatches ONE program per
    #    training epoch (~8 KB of seeds is all that crosses the link).
    # ------------------------------------------------------------------
    from connectome_gnn_jax.data import device_sampled_sage

    model = device_sampled_sage(
        sw, hidden_dim=64, fanout=(10, 10), dedup=False
    )
    tr = model.make_loader(
        order[: int(0.8 * n)], labels, batch_size=1024, seed=0,
        drop_last=True,
    )
    va = model.make_loader(
        order[int(0.8 * n):], labels, batch_size=1024, shuffle=False,
    )
    trainer = Trainer(model, scan_epochs=True)
    t0 = time.perf_counter()
    hist = trainer.fit(tr, va, num_epochs=3, patience=10, verbose=False)
    dt = time.perf_counter() - t0
    steps = 3 * (int(0.8 * n) // 1024)
    print(
        f"device-sampled multiset training (scanned epochs): val acc "
        f"{hist['val_acc'][-1]:.3f} after 3 epochs "
        f"({steps} steps, {steps / dt:.1f} steps/s end-to-end)"
    )

    # ------------------------------------------------------------------
    # 10. BEYOND REPLICATION: graph-SHARDED sampling with the compacted
    #     exchange — nodes partitioned across the mesh, NO device holds
    #     the whole graph; each hop's remote rows resolve through
    #     capacity-bounded all_to_all rounds (locally-owned requests
    #     never touch the wire).  overflow == 0 certifies the cheap
    #     exchange was EXACT (bitwise = the broadcast oracle) this run.
    # ------------------------------------------------------------------
    if num_dev >= 2:
        from connectome_gnn_jax.parallel import (
            CompactionConfig,
            create_mesh,
            graph_sharded_sage,
        )

        gs_dev = len(jax.devices())  # num_dev may be capped by max_shards
        gs = graph_sharded_sage(
            sw, num_shards=gs_dev, hidden_dim=64, fanout=(10, 10),
            compaction=CompactionConfig(alpha=2.0, rounds=2),
        )
        tr = gs.make_loader(
            order[: int(0.8 * n)], labels, batch_size=1024, seed=0,
            drop_last=True,
        )
        # val batch smaller than the pool (drop_last would otherwise
        # leave ZERO eval batches at small --nodes; divisible by shards)
        va = gs.make_loader(
            order[int(0.8 * n):], labels,
            batch_size=max(gs_dev, min(512, (len(order) - int(0.8 * n))
                                       // gs_dev * gs_dev)),
            shuffle=False, drop_last=True,
        )
        trainer = Trainer(gs, mesh=create_mesh())
        hist = trainer.fit(tr, va, num_epochs=2, patience=10,
                           verbose=False)
        print(
            f"graph-sharded sampled training ({gs_dev} node shards, "
            f"compacted exchange): val acc {hist['val_acc'][-1]:.3f}, "
            f"exchange overflow {trainer.last_sampling_overflow} "
            f"(0 = exact)"
        )

        # --------------------------------------------------------------
        # 11. Exchange auto-tuning + skew control.  plan_compaction
        #     probes real frontiers (the broadcast oracle instrumented
        #     to count each stage's peak bucket load) and returns
        #     per-stage capacities exact on the probed steps at
        #     near-minimal payload; in_degree_cap clamps the draw
        #     buffers a power-law hub would otherwise price for every
        #     step (benchmarks/degree_cap.py measures it).
        # --------------------------------------------------------------
        from connectome_gnn_jax.parallel import (
            plan_compaction,
            sharded_sampling_comm_model,
        )

        probe = rng.choice(
            order[: int(0.8 * n)], size=(3, gs_dev, 256)
        ).astype(np.int32)
        cfg, loads = plan_compaction(
            gs.csr, create_mesh(), probe, jax.random.PRNGKey(1),
            (10, 10), return_loads=True,
        )
        kw = dict(
            D=gs_dev, S=256, fanout=(10, 10),
            F=int(sw.node_features.shape[1]),
            max_deg=max(gs.csr.max_in_degree, 10),
        )

        def _mb(c):
            return sharded_sampling_comm_model(
                compaction=c, **kw
            )["per_device_bytes_per_step"] / 1e6

        print(
            f"plan_compaction: draw alpha {cfg.alpha:.2f}, feature "
            f"alpha {cfg.alpha_features:.2f} (probed peak loads "
            f"{loads['draw_loads']} / {loads['feature_load']}); "
            f"payload {_mb(cfg):.2f} MB/step/device planned vs "
            f"{_mb(CompactionConfig()):.2f} default vs {_mb(None):.2f} "
            f"broadcast"
        )

        capped = graph_sharded_sage(
            sw, num_shards=gs_dev, fanout=(10, 10), in_degree_cap=8
        )
        print(
            f"in_degree_cap=8: max_in_degree "
            f"{gs.csr.max_in_degree} -> {capped.csr.max_in_degree} "
            f"(every [*, max_deg] draw buffer shrinks with it; the "
            f"hub cliff is measured by benchmarks/degree_cap.py)"
        )
    else:
        print("(single device — skipping the graph-sharded sampling "
              "section; run with --cpu + XLA_FLAGS="
              "--xla_force_host_platform_device_count=8)")


if __name__ == "__main__":
    main()
