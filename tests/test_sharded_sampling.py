"""Graph-sharded device sampling (`parallel/sharded_sampling.py`).

Oracles:
* partition invariants — per-shard CSRs tile the global adjacency
  exactly (edge multiset, degrees, features);
* keep-all equivalence — with ``fanout >= max_in_degree`` the sharded
  sampler's eval-mode model outputs must match the single-device
  multiset sampler exactly up to reduction order (both keep EVERY
  in-edge per occurrence, so their sampling trees are the same
  unordered tree);
* structural — fanout bounds, weight-0 padding, global node ids valid;
* end-to-end — the graph-sharded train step learns the one-hop task on
  a virtual 4-device mesh.

Scales /root/reference/connectome_gnn/graph.py:87-94's single-device
residency model past one device's HBM (BASELINE configs[4]).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from connectome_gnn_jax.data import (
    ConnectomeGraph,
    device_sample,
    DeviceGraphCSR,
    generate_spatial_graph,
)
from connectome_gnn_jax.models.node_coo import BlockedNodeSAGE, NodeSAGE
from connectome_gnn_jax.parallel import (
    CompactionConfig,
    ShardedGraphCSR,
    count_collective_bytes,
    create_mesh,
    make_graph_sharded_sampled_forward,
    make_graph_sharded_train_step,
    sharded_sampling_comm_model,
)


def _graph(n=256, degree=5, band=24, seed=0, shortcut_frac=0.2):
    return generate_spatial_graph(
        n, degree=degree, band=band, seed=seed, shortcut_frac=shortcut_frac
    )


class TestPartition:
    def test_shards_tile_the_global_adjacency(self):
        g = _graph()
        sg = ShardedGraphCSR.partition(g, 4)
        assert sg.num_shards == 4
        P = sg.nodes_per_shard

        src, dst = g.edge_index
        want = sorted(
            (int(s), int(d), round(float(w), 6))
            for s, d, w in zip(src, dst, g.edge_weight)
        )
        got = []
        indptr = np.asarray(sg.indptr)
        sw = np.asarray(sg.sender_weight)
        for d in range(4):
            for v_loc in range(P):
                v = d * P + v_loc
                for e in range(indptr[d, v_loc], indptr[d, v_loc + 1]):
                    got.append(
                        (int(sw[d, e, 0]), v,
                         round(float(sw[d, e, 1].view(np.float32)), 6))
                    )
        assert sorted(got) == want

        feats = np.asarray(sg.node_features).reshape(4 * P, -1)
        np.testing.assert_array_equal(
            feats[: g.num_nodes], g.node_features
        )
        assert np.all(feats[g.num_nodes :] == 0)

    def test_max_degree_matches_dense(self):
        g = _graph(seed=3)
        sg = ShardedGraphCSR.partition(g, 8)
        deg = np.bincount(g.edge_index[1], minlength=g.num_nodes)
        assert sg.max_in_degree == int(deg.max())

    @pytest.mark.parametrize("chunk", [37, 1000, 10**9])
    def test_streamed_bitwise_equals_in_memory(self, chunk):
        """partition_streamed from a chunked COO stream == partition
        bitwise, at any chunk size (the stable-order contract)."""
        g = _graph(seed=5)
        want = ShardedGraphCSR.partition(g, 4)
        src, dst = g.edge_index
        w = g.edge_weight

        def chunks():
            for a in range(0, len(w), chunk):
                yield src[a : a + chunk], dst[a : a + chunk], w[a : a + chunk]

        got = ShardedGraphCSR.partition_streamed(
            chunks, g.node_features, g.num_nodes, 4
        )
        assert got.nodes_per_shard == want.nodes_per_shard
        assert got.max_in_degree == want.max_in_degree
        for a, b in zip(
            jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got)
        ):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    @staticmethod
    def _skewed_graph(seed=11, n=200, hub_extra=60):
        """A spatial graph plus two hub receivers (one with weight
        ties) — the power-law shape the in-degree cap exists for."""
        g = _graph(n=n, seed=seed)
        rng = np.random.default_rng(seed)
        hub_dst = np.concatenate([
            np.zeros(hub_extra, np.int64),  # hub 0: random weights
            np.full(hub_extra, 5, np.int64),  # hub 5: many tied weights
        ])
        hub_src = rng.integers(0, n, size=2 * hub_extra)
        hub_w = np.concatenate([
            rng.uniform(0.1, 1.0, hub_extra).astype(np.float32),
            np.full(hub_extra, 0.25, np.float32),  # exact ties
        ])
        src = np.concatenate([g.edge_index[0], hub_src])
        dst = np.concatenate([g.edge_index[1], hub_dst])
        w = np.concatenate([g.edge_weight, hub_w])
        return ConnectomeGraph(
            node_features=g.node_features,
            edge_index=np.stack([src, dst]),
            edge_weight=w,
        )

    def test_in_degree_cap_keeps_top_weight_edges(self):
        """cap < max_deg: per node, exactly the cap largest-|w|
        in-edges survive (ties → earliest in the stable receiver
        order), checked against an independent numpy oracle; cap ≥
        max_deg is a bitwise no-op."""
        g = self._skewed_graph()
        cap = 8
        sg = ShardedGraphCSR.partition(g, 4, in_degree_cap=cap)
        assert sg.max_in_degree == cap
        P = sg.nodes_per_shard

        src, dst, w = g.edge_index[0], g.edge_index[1], g.edge_weight
        for v in (0, 5, 17):  # hubs + a regular node
            e = np.flatnonzero(dst == v)  # stable receiver order
            want = e[
                sorted(range(len(e)), key=lambda i: (-abs(w[e[i]]), i))
            ][:cap]
            want_pairs = sorted(
                (int(src[i]), float(np.float32(w[i]))) for i in want
            )
            d, vl = v // P, v % P
            a, b = int(sg.indptr[d, vl]), int(sg.indptr[d, vl + 1])
            rows = np.asarray(sg.sender_weight[d, a:b])
            got_pairs = sorted(
                (int(r[0]), float(r[1:2].view(np.float32)[0]))
                for r in rows
            )
            assert got_pairs == want_pairs, v
            assert b - a == min(cap, len(e))

        # cap >= max_deg: no-op, bitwise
        want = ShardedGraphCSR.partition(g, 4)
        noop = ShardedGraphCSR.partition(
            g, 4, in_degree_cap=want.max_in_degree
        )
        for x, y in zip(
            jax.tree_util.tree_leaves(want),
            jax.tree_util.tree_leaves(noop),
        ):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    @pytest.mark.parametrize("chunk", [23, 10**9])
    def test_streamed_cap_bitwise_equals_in_memory(self, chunk):
        """The streamed threshold+tie-budget clamp reproduces the
        in-memory top-|w| rule bitwise, at any chunk size."""
        g = self._skewed_graph(seed=13)
        cap = 6
        want = ShardedGraphCSR.partition(g, 4, in_degree_cap=cap)
        src, dst = g.edge_index
        w = g.edge_weight

        def chunks():
            for a in range(0, len(w), chunk):
                yield (
                    src[a : a + chunk], dst[a : a + chunk],
                    w[a : a + chunk],
                )

        got = ShardedGraphCSR.partition_streamed(
            chunks, g.node_features, g.num_nodes, 4, in_degree_cap=cap
        )
        assert got.max_in_degree == want.max_in_degree == cap
        for a, b in zip(
            jax.tree_util.tree_leaves(want),
            jax.tree_util.tree_leaves(got),
        ):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_device_csr_cap_agrees_with_partition(self):
        """DeviceGraphCSR.from_graph(in_degree_cap=…) keeps the same
        per-node edge multiset as the sharded partition — the
        replicated and sharded samplers see the same capped graph."""
        g = self._skewed_graph(seed=17)
        cap = 7
        dc = DeviceGraphCSR.from_graph(g, in_degree_cap=cap)
        sg = ShardedGraphCSR.partition(g, 4, in_degree_cap=cap)
        assert dc.max_in_degree == sg.max_in_degree == cap
        P = sg.nodes_per_shard
        ip = np.asarray(dc.indptr)
        sw = np.asarray(dc.sender_weight)
        for v in range(g.num_nodes):
            d, vl = v // P, v % P
            a, b = int(sg.indptr[d, vl]), int(sg.indptr[d, vl + 1])
            rows_s = np.asarray(sg.sender_weight[d, a:b])
            rows_r = sw[ip[v] : ip[v + 1]]
            np.testing.assert_array_equal(rows_s, rows_r)

    def test_streamed_shard_range_and_callable_features(self):
        """A (lo, hi) range materializes exactly those shards' rows; a
        callable feature reader is only asked for owned rows."""
        g = _graph(seed=7)
        full = ShardedGraphCSR.partition(g, 4)
        src, dst = g.edge_index
        w = g.edge_weight

        def chunks():
            yield src, dst, w

        asked = []

        def feat_reader(a, b):
            asked.append((a, b))
            return g.node_features[a:b]

        part = ShardedGraphCSR.partition_streamed(
            chunks, feat_reader, g.num_nodes, 4, shard_range=(1, 3)
        )
        assert part.indptr.shape[0] == 2
        P = full.nodes_per_shard
        for name in ("indptr", "sender_weight", "node_features"):
            np.testing.assert_array_equal(
                np.asarray(getattr(full, name))[1:3],
                np.asarray(getattr(part, name)),
            )
        # static fields stay GLOBAL (same compiled program everywhere)
        assert part.max_in_degree == full.max_in_degree
        assert part.nodes_per_shard == P
        assert all(a >= P and b <= 3 * P for a, b in asked)


class TestKeepAllOracle:
    def test_matches_single_device_multiset(self, cpu_devices):
        """Eval logits per seed: sharded sampler over 4 devices ==
        single-device multiset sampler (keep-all fanout ⇒ identical
        unordered sampling trees)."""
        g = _graph()
        csr = DeviceGraphCSR.from_graph(g)
        F = csr.max_in_degree
        mesh = create_mesh(devices=cpu_devices[:4])
        sg = ShardedGraphCSR.partition(g, 4)

        model = BlockedNodeSAGE(in_channels=5, hidden_dim=16, num_layers=2)
        params, state = model.init(jax.random.PRNGKey(1))

        seeds = np.array(
            [[3, 17], [70, 140], [150, 200], [33, 255]], np.int32
        )
        keys = np.stack([
            np.asarray(jax.random.key_data(jax.random.PRNGKey(100 + r)))
            for r in range(4)
        ])
        fwd = make_graph_sharded_sampled_forward(model, mesh, (F, F))
        logits_sharded = np.asarray(
            fwd(params, state, sg, jnp.asarray(seeds), jnp.asarray(keys))
        )

        for r in range(4):
            single = device_sample(
                csr, jnp.asarray(seeds[r]), jax.random.PRNGKey(50 + r),
                (F, F), dedup=False,
            )
            want, _ = model.apply(params, state, single, train=False)
            np.testing.assert_allclose(
                logits_sharded[r], np.asarray(want), rtol=1e-4, atol=1e-5
            )

    def test_fanout_limited_structure(self, cpu_devices):
        """Fanout-limited draws: weight-0 padding is self-edges, real
        senders are valid global ids whose edges exist in the graph."""
        g = _graph(n=256, degree=8)
        mesh = create_mesh(devices=cpu_devices[:4])
        sg = ShardedGraphCSR.partition(g, 4)
        model = NodeSAGE(in_channels=5, hidden_dim=8, num_layers=2)
        params, state = model.init(jax.random.PRNGKey(0))

        from functools import partial

        from jax.sharding import PartitionSpec as P

        from connectome_gnn_jax.parallel.sharded_sampling import (
            sharded_device_sample,
        )

        @jax.jit
        @partial(
            jax.shard_map, mesh=mesh,
            in_specs=(P("data"), P("data"), P("data")),
            out_specs=P("data"),
        )
        def sample(gs, seeds, key_data):
            b = sharded_device_sample(
                gs, seeds[0], jax.random.wrap_key_data(key_data[0]), (3, 3)
            )
            return jax.tree_util.tree_map(lambda a: a[None], (
                b.node_ids, b.senders, b.receivers, b.edge_weight,
            ))

        seeds = np.arange(8, dtype=np.int32).reshape(4, 2) * 30
        keys = np.stack([
            np.asarray(jax.random.key_data(jax.random.PRNGKey(r)))
            for r in range(4)
        ])
        ids, snd, rcv, w = map(
            np.asarray, sample(sg, jnp.asarray(seeds), jnp.asarray(keys))
        )
        gs_, gd_ = g.edge_index
        eset = set(zip(gs_.tolist(), gd_.tolist()))
        for r in range(4):
            pad = w[r] == 0
            assert (snd[r][pad] == rcv[r][pad]).all()
            real = ~pad
            a = ids[r][snd[r][real]]
            b = ids[r][rcv[r][real]]
            assert ((a >= 0) & (a < g.num_nodes)).all()
            for aa, bb in zip(a.tolist(), b.tolist()):
                assert (aa, bb) in eset
            # fanout bound per receiver occurrence per hop
            hop0 = rcv[r][:6][real[:6]]
            assert np.bincount(hop0, minlength=2).max() <= 3

    def test_comm_model_shapes(self):
        m = sharded_sampling_comm_model(
            D=8, S=1024, fanout=(10, 10), F=64, max_deg=40
        )
        assert m["node_budget"] == 1024 * (1 + 10 + 100)
        mc = sharded_sampling_comm_model(
            D=8, S=1024, fanout=(10, 10), F=64, max_deg=40,
            compaction=CompactionConfig(alpha=2.0, rounds=2),
        )
        # compaction divides the payload by ~D/(alpha·rounds) = 2×
        assert mc["per_device_bytes_per_step"] < 0.6 * m[
            "per_device_bytes_per_step"
        ]
        mc1 = sharded_sampling_comm_model(
            D=8, S=1024, fanout=(10, 10), F=64, max_deg=40,
            compaction=CompactionConfig(alpha=1.25, rounds=1),
        )
        # tighter operating point: ~D/1.25 = 6.4×
        assert mc1["per_device_bytes_per_step"] < 0.2 * m[
            "per_device_bytes_per_step"
        ]


def _sample_all(mesh, sg, seeds, keys, fanout, compaction):
    """Run the sharded sampler under shard_map on ``mesh``; returns the
    per-device batch leaves + overflow counts (host numpy)."""
    from functools import partial

    from jax.sharding import PartitionSpec as P

    from connectome_gnn_jax.parallel.sharded_sampling import (
        sharded_device_sample_with_stats,
    )

    @jax.jit
    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("data"), P("data"), P("data")),
        out_specs=(P("data"), P("data")),
    )
    def run(gs, sd, key_data):
        b, ovf = sharded_device_sample_with_stats(
            gs, sd[0], jax.random.wrap_key_data(key_data[0]), fanout,
            compaction=compaction,
        )
        tree = (b.node_features, b.senders, b.receivers, b.edge_weight,
                b.node_mask, b.node_ids)
        return (
            jax.tree_util.tree_map(lambda a: a[None], tree),
            ovf[None],
        )

    tree, ovf = run(sg, jnp.asarray(seeds), jnp.asarray(keys))
    return tuple(np.asarray(x) for x in tree), np.asarray(ovf)


class TestCompactedExchange:
    """The compacted exchange (round 5): bitwise-exact vs the broadcast
    oracle under capacity, deterministic masked drops + a correct
    overflow counter beyond it, and counted (jaxpr-walked) payloads
    matching the analytic model exactly."""

    def _keys(self, n, base=100):
        return np.stack([
            np.asarray(jax.random.key_data(jax.random.PRNGKey(base + r)))
            for r in range(n)
        ])

    def test_bitwise_equals_broadcast_under_capacity(self, cpu_devices):
        g = _graph()
        mesh = create_mesh(devices=cpu_devices[:4])
        sg = ShardedGraphCSR.partition(g, 4)
        seeds = np.array(
            [[3, 17, 40], [70, 140, 90], [150, 200, -1], [33, 255, 8]],
            np.int32,
        )
        keys = self._keys(4)
        ref, ovf0 = _sample_all(mesh, sg, seeds, keys, (3, 3), None)
        # alpha=D makes every bucket frontier-sized: no pair can overflow
        got, ovf = _sample_all(
            mesh, sg, seeds, keys, (3, 3),
            CompactionConfig(alpha=4.0, rounds=1),
        )
        assert (ovf == 0).all() and (ovf0 == 0).all()
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(a, b)

    def test_multi_round_carry_over_stays_exact(self, cpu_devices):
        """rounds·C covers the load even when one round's C does not:
        the masked carry-over rounds reassemble the exact answer."""
        g = _graph()
        mesh = create_mesh(devices=cpu_devices[:4])
        sg = ShardedGraphCSR.partition(g, 4)
        seeds = np.array(
            [[3, 17, 40], [70, 140, 90], [150, 200, -1], [33, 255, 8]],
            np.int32,
        )
        keys = self._keys(4)
        ref, _ = _sample_all(mesh, sg, seeds, keys, (3, 3), None)
        got, ovf = _sample_all(
            mesh, sg, seeds, keys, (3, 3),
            CompactionConfig(alpha=1.0, rounds=4),  # C small, R covers
        )
        assert (ovf == 0).all()
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(a, b)

    def test_overflow_counts_and_masked_drops(self, cpu_devices):
        """Adversarial frontier beyond rounds·C: overflowing requests
        are DROPPED (zero draws / zero feature rows) at deterministic
        slots (stable owner sort, ascending slot) and counted."""
        g = _graph(n=64, degree=3, band=8, shortcut_frac=0.0)
        D, S = 4, 4
        mesh = create_mesh(devices=cpu_devices[:D])
        sg = ShardedGraphCSR.partition(g, D)
        P_ = sg.nodes_per_shard
        # device 0's seeds ALL owned by shard 1; others sample locally
        seeds = np.stack([
            np.arange(P_, P_ + S, dtype=np.int32),
            np.arange(P_ + 4, P_ + 4 + S, dtype=np.int32),
            np.arange(2 * P_, 2 * P_ + S, dtype=np.int32),
            np.arange(3 * P_, 3 * P_ + S, dtype=np.int32),
        ])
        keys = self._keys(D)
        md = max(sg.max_in_degree, 1)
        fanout = (md,)  # keep-all: drawn sets are deterministic
        # dedup off: this test's numpy emulation is the SLOT-wise
        # schedule (the dedup schedule is covered separately)
        comp = CompactionConfig(alpha=1.0, rounds=1,
                                dedup_features=False)  # C = S/D = 1
        ref, _ = _sample_all(mesh, sg, seeds, keys, fanout, None)
        got, ovf = _sample_all(mesh, sg, seeds, keys, fanout, comp)

        def served(ids, me, C, R):
            """Emulate the schedule: per remote owner, the R·C lowest
            slots are served."""
            n = len(ids)
            out = np.zeros(n, bool)
            owner = np.clip(np.maximum(ids, 0) // P_, 0, D - 1)
            remote = (ids >= 0) & (owner != me)
            for o in range(D):
                slots = np.where(remote & (owner == o))[0]
                out[slots[: R * C]] = True
            return out, int(np.sum(remote) - np.sum(out))

        ref_x, ref_snd, _, ref_w, _, ref_ids = ref
        got_x, got_snd, _, got_w, _, got_ids = got
        for r in range(D):
            # hop-0 seed requests: device 0 overflows 3 of 4
            C_hop = comp.capacity(S, D)
            srv_hop, ovf_hop = served(seeds[r], r, C_hop, comp.rounds)
            # dropped seeds draw nothing: their fanout rows are weight-0
            # self-edges; served remote + local seeds match broadcast
            w_rows = got_w[r].reshape(S, md)
            ref_rows = ref_w[r].reshape(S, md)
            owner = seeds[r] // P_
            for s in range(S):
                if owner[s] != r and not srv_hop[s]:
                    assert (w_rows[s] == 0).all()
                else:
                    np.testing.assert_array_equal(w_rows[s], ref_rows[s])
            # feature stage: compacted node ids, served per capacity
            NBud = got_ids.shape[1]
            C_f = comp.capacity(NBud, D)
            srv_f, ovf_f = served(got_ids[r], r, C_f, comp.rounds)
            owner_f = np.clip(np.maximum(got_ids[r], 0) // P_, 0, D - 1)
            for i in range(NBud):
                if got_ids[r, i] < 0:
                    continue
                if owner_f[i] != r and not srv_f[i]:
                    assert (got_x[r, i] == 0).all()
                else:
                    np.testing.assert_array_equal(
                        got_x[r, i],
                        np.asarray(g.node_features)[got_ids[r, i]],
                    )
            assert int(ovf[r]) == ovf_hop + ovf_f

    def test_feature_dedup_makes_tight_capacity_exact(self, cpu_devices):
        """Multiset sampling re-requests duplicate drawn nodes; with
        ``dedup_features`` the capacity bounds UNIQUE remote ids, so a
        tight alpha that overflows slot-wise becomes exact — and the
        result stays bitwise equal to the broadcast oracle."""
        g = _graph(n=128, degree=6, band=12, shortcut_frac=0.0)
        D = 4
        mesh = create_mesh(devices=cpu_devices[:D])
        sg = ShardedGraphCSR.partition(g, D)
        md = max(sg.max_in_degree, 1)
        P_ = sg.nodes_per_shard
        # LOCAL seeds at each shard's low boundary: the hop stage needs
        # no exchange, while keep-all draws reach into the previous
        # shard through overlapping band windows — duplicated remote ids
        seeds = np.stack([
            np.arange(d * P_, d * P_ + 3, dtype=np.int32)
            for d in range(D)
        ])
        keys = self._keys(D, base=40)
        ref, ovf_ref = _sample_all(mesh, sg, seeds, keys, (md,), None)
        assert (ovf_ref == 0).all()

        # pick the capacity from the ORACLE's duplicate structure: the
        # worst (requester, owner) pair's unique remote ids fit, its
        # slot-wise request count does not
        ids = ref[5]
        NBud = ids.shape[1]
        max_uniq = max_slots = 0
        for r in range(D):
            owner = np.clip(np.maximum(ids[r], 0) // P_, 0, D - 1)
            for o in range(D):
                sel = (ids[r] >= 0) & (owner == o) & (o != r)
                max_slots = max(max_slots, int(sel.sum()))
                max_uniq = max(
                    max_uniq, len(np.unique(ids[r][sel]))
                )
        assert max_slots > max_uniq > 0, (max_slots, max_uniq)
        alpha = (max_uniq * D) / NBud  # capacity == max_uniq exactly
        tight = dict(alpha=alpha, rounds=1)
        comp_slot = CompactionConfig(**tight, dedup_features=False)
        assert comp_slot.capacity(NBud, D) == max_uniq

        _, ovf_slot = _sample_all(mesh, sg, seeds, keys, (md,), comp_slot)
        got, ovf_dedup = _sample_all(
            mesh, sg, seeds, keys, (md,),
            CompactionConfig(**tight, dedup_features=True),
        )
        assert ovf_slot.sum() > 0  # slot-wise schedule overflows here
        assert ovf_dedup.sum() == 0  # unique-id schedule fits
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(a, b)

    def test_counted_payload_matches_analytic_model(self, cpu_devices):
        """count_collective_bytes (jaxpr walk of the ACTUAL program) ==
        sharded_sampling_comm_model, for both exchanges — the analytic
        projection is validated, not asserted."""
        from functools import partial

        from jax.sharding import PartitionSpec as P

        g = _graph()
        D = 4
        mesh = create_mesh(devices=cpu_devices[:D])
        sg = ShardedGraphCSR.partition(g, D)
        fanout = (3, 3)
        S = 3
        md = max(sg.max_in_degree, max(fanout), 1)
        seeds = jnp.zeros((D, S), jnp.int32)
        keys = jnp.zeros((D, 2), jnp.uint32)

        for comp in (
            None,
            CompactionConfig(alpha=1.5, rounds=2),
            CompactionConfig(alpha=1.0, rounds=1),
            CompactionConfig(  # per-stage: generous draws, tight features
                alpha=2.0, rounds=2,
                alpha_features=1.25, rounds_features=1,
            ),
        ):
            @jax.jit
            @partial(
                jax.shard_map, mesh=mesh,
                in_specs=(P("data"), P("data"), P("data")),
                out_specs=P("data"),
            )
            def run(gs, sd, key_data, _comp=comp):
                from connectome_gnn_jax.parallel.sharded_sampling import (
                    sharded_device_sample,
                )

                b = jax.tree_util.tree_leaves(
                    sharded_device_sample(
                        gs, sd[0], jax.random.wrap_key_data(key_data[0]),
                        fanout, compaction=_comp,
                    )
                )
                return jnp.sum(b[0])[None]

            counted = count_collective_bytes(run, sg, seeds, keys)
            model = sharded_sampling_comm_model(
                D=D, S=S, fanout=fanout, F=g.num_features,
                max_deg=md, compaction=comp,
            )
            assert counted["total"] == model["per_device_bytes_per_step"], (
                comp, counted, model,
            )

    def test_shard_count_mismatch_raises(self, cpu_devices):
        g = _graph()
        mesh = create_mesh(devices=cpu_devices[:4])
        sg = ShardedGraphCSR.partition(g, 8)  # wrong: 8 shards, 4 devices
        model = BlockedNodeSAGE(in_channels=5, hidden_dim=8, num_layers=2)
        params, state = model.init(jax.random.PRNGKey(0))
        fwd = make_graph_sharded_sampled_forward(model, mesh, (3, 3))
        seeds = jnp.zeros((8, 2), jnp.int32)
        keys = jnp.zeros((8, 2), jnp.uint32)
        with pytest.raises(ValueError, match="8 shards.*4 devices"):
            fwd(params, state, sg, seeds, keys)
        sg4 = ShardedGraphCSR.partition(g, 4)
        with pytest.raises(ValueError, match=r"stacked \[D, S\]"):
            fwd(params, state, sg4, seeds, keys)


class TestExchangeFuzz:
    """Seeded sweep: random graphs × random compaction configs through
    the broadcast-equality oracle — breadth beyond the hand-picked
    cases.  Whenever the capacity bound holds (overflow 0) the
    compacted exchange must be BITWISE equal to the broadcast oracle;
    when it doesn't, drops must be deterministic (same run twice)."""

    def test_random_configs_match_oracle_or_drop_deterministically(
        self, cpu_devices
    ):
        rng = np.random.default_rng(42)
        mesh = create_mesh(devices=cpu_devices[:4])
        for trial in range(4):
            g = generate_spatial_graph(
                192, degree=int(rng.integers(3, 7)),
                band=int(rng.integers(12, 40)),
                seed=int(rng.integers(0, 1000)),
                shortcut_frac=float(rng.uniform(0.0, 0.4)),
            )
            sg = ShardedGraphCSR.partition(g, 4)
            seeds = rng.integers(-1, 192, size=(4, 3)).astype(np.int32)
            keys = np.stack([
                np.asarray(jax.random.key_data(
                    jax.random.PRNGKey(int(rng.integers(0, 2**31)))
                ))
                for _ in range(4)
            ])
            fanout = (int(rng.integers(2, 4)), int(rng.integers(2, 4)))
            comp = CompactionConfig(
                alpha=float(rng.uniform(0.5, 4.0)),
                rounds=int(rng.integers(1, 4)),
                dedup_features=bool(rng.integers(0, 2)),
                alpha_features=float(rng.uniform(0.5, 4.0)),
                rounds_features=int(rng.integers(1, 3)),
            )
            ref, _ = _sample_all(mesh, sg, seeds, keys, fanout, None)
            got, ovf = _sample_all(mesh, sg, seeds, keys, fanout, comp)
            if int(np.asarray(ovf).sum()) == 0:
                for a, b in zip(ref, got):
                    np.testing.assert_array_equal(a, b, err_msg=str(
                        (trial, comp)
                    ))
            else:
                got2, ovf2 = _sample_all(
                    mesh, sg, seeds, keys, fanout, comp
                )
                np.testing.assert_array_equal(ovf, ovf2)
                for a, b in zip(got, got2):
                    np.testing.assert_array_equal(a, b, err_msg=str(
                        (trial, comp)
                    ))


class TestPerStageCompactionAndPlanner:
    """Per-stage capacities (`alpha_features`/`rounds_features`) and the
    probe-based planner (`plan_compaction`): the feature stage carries
    nearly all the payload but dedups, so it can run tight while the
    cheap draw stages stay generous — the planner measures both loads
    on real frontiers and picks the pair."""

    def _keys_for_plan(self, key, step, D):
        kt = jax.random.fold_in(key, step)
        return np.stack([
            np.asarray(jax.random.key_data(jax.random.fold_in(kt, d)))
            for d in range(D)
        ])

    def test_per_stage_override_stays_exact_and_shrinks_payload(
        self, cpu_devices
    ):
        g = _graph()
        D = 4
        mesh = create_mesh(devices=cpu_devices[:D])
        sg = ShardedGraphCSR.partition(g, D)
        seeds = np.array(
            [[3, 17, 40], [70, 140, 90], [150, 200, -1], [33, 255, 8]],
            np.int32,
        )
        keys = np.stack([
            np.asarray(jax.random.key_data(jax.random.PRNGKey(100 + r)))
            for r in range(D)
        ])
        fanout = (3, 3)
        ref, _ = _sample_all(mesh, sg, seeds, keys, fanout, None)
        split = CompactionConfig(
            alpha=4.0, rounds=1, alpha_features=4.0, rounds_features=1
        )
        got, ovf = _sample_all(mesh, sg, seeds, keys, fanout, split)
        assert (ovf == 0).all()
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(a, b)
        # the override is live in the payload model: feature bytes move
        # with alpha_features, hop bytes do not
        md = max(sg.max_in_degree, max(fanout), 1)
        base = CompactionConfig(alpha=2.0, rounds=2)
        tightf = CompactionConfig(
            alpha=2.0, rounds=2, alpha_features=1.0, rounds_features=1
        )
        m0 = sharded_sampling_comm_model(
            D=D, S=3, fanout=fanout, F=g.num_features, max_deg=md,
            compaction=base,
        )
        m1 = sharded_sampling_comm_model(
            D=D, S=3, fanout=fanout, F=g.num_features, max_deg=md,
            compaction=tightf,
        )
        assert m1["hop_exchange_bytes"] == m0["hop_exchange_bytes"]
        assert m1["feature_exchange_bytes"] < m0["feature_exchange_bytes"]

    def test_census_matches_numpy_rederivation(self, cpu_devices):
        """Census loads == a host recount over the broadcast batch's
        node ids (per-hop frontier slots, dedup'd feature ids)."""
        from functools import partial

        from jax.sharding import PartitionSpec as P

        from connectome_gnn_jax.parallel.sharded_sampling import (
            sharded_sampling_census,
        )

        g = _graph()
        D = 4
        mesh = create_mesh(devices=cpu_devices[:D])
        sg = ShardedGraphCSR.partition(g, D)
        seeds = np.array(
            [[3, 17, 40], [70, 140, 90], [150, 200, -1], [33, 255, 8]],
            np.int32,
        )
        keys = np.stack([
            np.asarray(jax.random.key_data(jax.random.PRNGKey(100 + r)))
            for r in range(D)
        ])
        fanout = (3, 3)

        @jax.jit
        @partial(
            jax.shard_map, mesh=mesh,
            in_specs=(P("data"), P("data"), P("data")),
            out_specs=(P("data"), P("data")),
        )
        def census(gs, sd, kd):
            dl, fl = sharded_sampling_census(
                gs, sd[0], jax.random.wrap_key_data(kd[0]), fanout
            )
            return dl[None], fl[None]

        dl, fl = census(sg, jnp.asarray(seeds), jnp.asarray(keys))
        dl, fl = np.asarray(dl), np.asarray(fl)
        # pmax ⇒ identical rows
        assert (dl == dl[0]).all() and (fl == fl[0]).all()

        # host recount from the broadcast oracle's node ids
        ref, _ = _sample_all(mesh, sg, seeds, keys, fanout, None)
        node_ids = ref[5]  # [D, NBud]
        P_sh = sg.nodes_per_shard
        md = max(sg.max_in_degree, max(fanout), 1)
        S = seeds.shape[1]
        want_draw = []
        start, seg = 0, S
        for f in fanout:
            best = 0
            for me in range(D):
                ids = node_ids[me, start:start + seg]
                own = np.clip(np.maximum(ids, 0) // P_sh, 0, D - 1)
                rem = (ids >= 0) & (own != me)
                if rem.any():
                    best = max(best, int(np.bincount(
                        own[rem], minlength=D
                    ).max()))
            want_draw.append(best)
            start += seg
            seg *= min(f, md)
        want_feat = 0
        for me in range(D):
            ids = node_ids[me]
            own = np.clip(np.maximum(ids, 0) // P_sh, 0, D - 1)
            rem = (ids >= 0) & (own != me)
            pairs = {(int(o), int(i)) for o, i in zip(own[rem], ids[rem])}
            cnt = np.zeros(D, int)
            for o, _ in pairs:
                cnt[o] += 1
            want_feat = max(want_feat, int(cnt.max()))
        np.testing.assert_array_equal(dl[0], want_draw)
        assert int(fl[0]) == want_feat

    def test_plan_compaction_exact_and_cheaper_than_default(
        self, cpu_devices
    ):
        from connectome_gnn_jax.parallel import plan_compaction

        g = _graph(n=512)
        D = 4
        mesh = create_mesh(devices=cpu_devices[:D])
        sg = ShardedGraphCSR.partition(g, D)
        rng = np.random.default_rng(0)
        S = 16
        seeds = rng.integers(0, 512, size=(3, D, S)).astype(np.int32)
        fanout = (3, 3)
        key = jax.random.PRNGKey(7)

        cfg, loads = plan_compaction(
            sg, mesh, seeds, key, fanout, return_loads=True
        )
        assert cfg.rounds == 1 and cfg.rounds_features == 1
        assert loads["feature_load"] > 0

        # exact (bitwise = broadcast, overflow 0) on a probed step
        keys0 = self._keys_for_plan(key, 0, D)
        ref, _ = _sample_all(mesh, sg, seeds[0], keys0, fanout, None)
        got, ovf = _sample_all(mesh, sg, seeds[0], keys0, fanout, cfg)
        assert (ovf == 0).all()
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(a, b)

        # and cheaper than the uniform default config
        md = max(sg.max_in_degree, max(fanout), 1)
        planned = sharded_sampling_comm_model(
            D=D, S=S, fanout=fanout, F=g.num_features, max_deg=md,
            compaction=cfg,
        )
        default = sharded_sampling_comm_model(
            D=D, S=S, fanout=fanout, F=g.num_features, max_deg=md,
            compaction=CompactionConfig(),
        )
        assert (
            planned["per_device_bytes_per_step"]
            < default["per_device_bytes_per_step"]
        )

    def test_model_level_replan_rekeys_trainer_steps(self, cpu_devices):
        """GraphShardedSampledModel.plan_compaction adopts the planned
        config, and the Trainer's cached steps re-key on it (stale
        steps built for the old capacities are not reused)."""
        from connectome_gnn_jax.parallel import graph_sharded_sage
        from connectome_gnn_jax.train import Trainer

        g = _graph(n=512)
        labels = np.zeros(512, np.int32)
        mesh = create_mesh(devices=cpu_devices[:4])
        model = graph_sharded_sage(
            g, num_shards=4, hidden_dim=8, fanout=(3, 3)
        )
        va = model.make_loader(
            np.arange(512), labels, batch_size=64, shuffle=False,
            drop_last=True,
        )
        trainer = Trainer(model, mesh=mesh, seed=0)
        m0 = trainer.evaluate(va)
        default_cfg = model.compaction
        rng = np.random.default_rng(0)
        seeds = rng.integers(0, 512, size=(2, 4, 16)).astype(np.int32)
        cfg = model.plan_compaction(mesh, seeds, jax.random.PRNGKey(3))
        assert cfg is model.compaction and cfg != default_cfg
        m1 = trainer.evaluate(va)
        assert m1["total"] == m0["total"]
        # fresh steps for the planned config; stale-config steps evicted
        keys = set(trainer._gs_cache)
        assert (False, cfg) in keys
        assert all(k[1] == cfg for k in keys)

    def test_plan_compaction_validates_seed_shape(self, cpu_devices):
        from connectome_gnn_jax.parallel import plan_compaction

        g = _graph()
        mesh = create_mesh(devices=cpu_devices[:4])
        sg = ShardedGraphCSR.partition(g, 4)
        with pytest.raises(ValueError, match="num_shards"):
            plan_compaction(
                sg, mesh, np.zeros((3, 5), np.int32),
                jax.random.PRNGKey(0), (3, 3),
            )


@pytest.mark.slow
class TestTraining:
    def test_graph_sharded_step_learns_one_hop_task(self, cpu_devices):
        import optax

        g = _graph(n=512, degree=8, band=32)
        src, dst = g.edge_index
        num = np.zeros(g.num_nodes)
        den = np.zeros(g.num_nodes)
        np.add.at(num, dst, g.edge_weight * g.node_features[src, 0])
        np.add.at(den, dst, g.edge_weight)
        agg = num / (den + 1e-8)
        labels = (agg > np.median(agg)).astype(np.int32)

        mesh = create_mesh(devices=cpu_devices[:4])
        sg = ShardedGraphCSR.partition(g, 4)
        model = BlockedNodeSAGE(in_channels=5, hidden_dim=32, num_layers=2)
        params, state = model.init(jax.random.PRNGKey(0))
        opt = optax.adam(3e-3)
        opt_state = opt.init(params)
        step = make_graph_sharded_train_step(model, opt, mesh, (8, 8))

        rng = np.random.default_rng(0)
        S = 32  # seeds per device
        losses = []
        for i in range(30):
            seeds = rng.permutation(g.num_nodes)[: 4 * S].reshape(4, S)
            keys = np.stack([
                np.asarray(jax.random.key_data(
                    jax.random.PRNGKey(1000 * i + r)
                ))
                for r in range(4)
            ])
            lab = labels[seeds]
            mask = np.ones_like(lab, bool)
            params, state, opt_state, loss, n = step(
                params, state, opt_state, jax.random.PRNGKey(i),
                sg, jnp.asarray(seeds.astype(np.int32)),
                jnp.asarray(keys), jnp.asarray(lab), jnp.asarray(mask),
            )
            losses.append(float(loss))
            assert float(n) == 4 * S
        assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05


@pytest.mark.slow
class TestTrainerGraphSharded:
    """Product-API reachability: Trainer(mesh=...) drives graph-sharded
    sampled training/eval through GraphShardedSampledModel exactly like
    the replicated device-sampled path."""

    def test_trainer_fit_learns_one_hop_task(self, cpu_devices):
        from connectome_gnn_jax.parallel import graph_sharded_sage
        from connectome_gnn_jax.train import Trainer

        g = _graph(n=512, degree=8, band=32)
        src, dst = g.edge_index
        num = np.zeros(g.num_nodes)
        den = np.zeros(g.num_nodes)
        np.add.at(num, dst, g.edge_weight * g.node_features[src, 0])
        np.add.at(den, dst, g.edge_weight)
        agg = num / (den + 1e-8)
        labels = (agg > np.median(agg)).astype(np.int32)

        mesh = create_mesh(devices=cpu_devices[:4])
        model = graph_sharded_sage(
            g, num_shards=4, hidden_dim=32, fanout=(8, 8)
        )
        tr = model.make_loader(
            np.arange(g.num_nodes), labels, batch_size=128, seed=0,
            drop_last=True,
        )
        va = model.make_loader(
            np.arange(g.num_nodes), labels, batch_size=128, seed=1,
            shuffle=False, drop_last=True,
        )
        trainer = Trainer(model, mesh=mesh, seed=0)
        hist = trainer.fit(tr, va, num_epochs=8, patience=20, verbose=False)
        assert hist["train_loss"][-1] < hist["train_loss"][0]
        m = trainer.evaluate(va)
        assert m["total"] == 512
        assert m["accuracy"] > 0.6

    def test_loader_defaults_to_partition_shards(self):
        from connectome_gnn_jax.parallel import graph_sharded_sage

        g = _graph()
        model = graph_sharded_sage(g, num_shards=4, fanout=(4, 4))
        lo = model.make_loader(np.arange(g.num_nodes), batch_size=64)
        assert lo.num_shards == 4
        b = next(iter(lo))
        assert b.stacked and b.packed.shape[0] == 4
        assert b.csr is None  # the graph rides as the step's argument

    def test_rejects_gcn_inner(self):
        from connectome_gnn_jax.models.node_coo import NodeGCN
        from connectome_gnn_jax.parallel import (
            GraphShardedSampledModel, ShardedGraphCSR,
        )

        g = _graph()
        csr = ShardedGraphCSR.partition(g, 4)
        with pytest.raises(ValueError, match="SAGE-family"):
            GraphShardedSampledModel(
                csr, NodeGCN(in_channels=5, hidden_dim=8), (4, 4)
            )
