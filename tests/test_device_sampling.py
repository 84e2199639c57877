"""Device-side neighbor sampling (`data/device_sampling.py`).

The strongest oracle is keep-all equivalence: with ``fanout >=
max_in_degree`` both the device sampler and the host sampler keep EVERY
in-edge of the expanded frontier, so node sets, global edge multisets,
and model outputs must agree exactly (the samplers' RNGs never matter).
Fanout-limited behavior is covered structurally (bounds, sortedness,
padding inertness, determinism) and end-to-end (training learns a
1-hop-computable task through the fused sample+step program).

Scales the reference's scatter aggregation
(/root/reference/connectome_gnn/models.py:45-54); the reference itself
has no sampling or device residency (SURVEY §0).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from connectome_gnn_jax.data import (
    DeviceGraphCSR,
    DeviceSeedLoader,
    SampledNodeLoader,
    device_sample,
    device_sampled_gcn,
    generate_spatial_graph,
    make_epoch_runner,
    make_seed_batch,
    pack_epoch,
)
from connectome_gnn_jax.data.sampled import collate_sampled
from connectome_gnn_jax.data.sampling import NeighborSampler
from connectome_gnn_jax.models import NodeGCN
from connectome_gnn_jax.train import Trainer


def _graph(n=500, degree=6, band=32, seed=0, shortcut_frac=0.2):
    return generate_spatial_graph(
        n, degree=degree, band=band, seed=seed, shortcut_frac=shortcut_frac
    )


def _global_edges(batch):
    ids = np.asarray(batch.node_ids)
    m = np.asarray(batch.edge_weight) != 0
    return sorted(
        zip(
            ids[np.asarray(batch.senders)[m]].tolist(),
            ids[np.asarray(batch.receivers)[m]].tolist(),
            np.round(np.asarray(batch.edge_weight)[m], 6).tolist(),
        )
    )


class TestKeepAllOracle:
    def test_matches_host_sampler_exactly(self):
        g = _graph()
        csr = DeviceGraphCSR.from_graph(g)
        F = csr.max_in_degree
        seeds = np.array([5, 9, 70, 401], np.int32)
        dev = device_sample(
            csr, jnp.asarray(seeds), jax.random.PRNGKey(0), (F, F)
        )
        sub, node_ids = NeighborSampler(g).sample(seeds, (F, F), seed=1)

        real = np.asarray(dev.node_mask)
        assert set(np.asarray(dev.node_ids)[real].tolist()) == set(
            node_ids.tolist()
        )
        assert np.asarray(dev.node_ids)[:4].tolist() == seeds.tolist()
        hs, hd = sub.edge_index
        host_edges = sorted(
            zip(
                node_ids[hs].tolist(),
                node_ids[hd].tolist(),
                np.round(sub.edge_weight, 6).tolist(),
            )
        )
        assert _global_edges(dev) == host_edges

    def test_model_logits_match_host_collate(self):
        g = _graph()
        csr = DeviceGraphCSR.from_graph(g)
        F = csr.max_in_degree
        seeds = np.array([5, 9, 70, 401], np.int32)
        dev = device_sample(
            csr, jnp.asarray(seeds), jax.random.PRNGKey(0), (F, F)
        )
        sub, node_ids = NeighborSampler(g).sample(seeds, (F, F), seed=1)
        host = collate_sampled(
            sub, node_ids, None, num_seeds=4, real_seeds=4,
            node_budget=dev.num_nodes,
            edge_budget=int(dev.senders.shape[0]),
        )
        model = NodeGCN(in_channels=5, hidden_dim=16, num_layers=2)
        params, state = model.init(jax.random.PRNGKey(1))
        ld, _ = model.apply(params, state, dev)
        lh, _ = model.apply(params, state, host)
        assert jnp.allclose(ld, lh, rtol=1e-5, atol=1e-6)


class TestStructure:
    @pytest.mark.slow
    def test_fanout_bounds_receivers_sorted_padding_inert(self):
        g = _graph(n=800, degree=10)
        csr = DeviceGraphCSR.from_graph(g)
        seeds = np.arange(16, dtype=np.int32) * 7
        b = device_sample(
            csr, jnp.asarray(seeds), jax.random.PRNGKey(3), (4, 4)
        )
        r = np.asarray(b.receivers)
        assert (np.diff(r) >= 0).all()
        w = np.asarray(b.edge_weight)
        s = np.asarray(b.senders)
        # real (weight>0) edges per receiver per hop <= fanout: hop blocks
        # are [16*4] then [64*4]
        hop0 = np.bincount(r[:64][w[:64] > 0], minlength=b.num_nodes)
        assert hop0.max() <= 4
        # padding edges are self-edges with weight 0
        pad = w == 0
        assert (s[pad] == r[pad]).all()
        # every real edge exists in the original graph
        ids = np.asarray(b.node_ids)
        real = w > 0
        gs, gd = g.edge_index
        eset = set(zip(gs.tolist(), gd.tolist()))
        for a, c in zip(ids[s[real]].tolist(), ids[r[real]].tolist()):
            assert (a, c) in eset

    def test_deterministic_by_key(self):
        g = _graph()
        csr = DeviceGraphCSR.from_graph(g)
        seeds = jnp.arange(8, dtype=jnp.int32)
        a = device_sample(csr, seeds, jax.random.PRNGKey(5), (3, 3))
        b = device_sample(csr, seeds, jax.random.PRNGKey(5), (3, 3))
        c = device_sample(csr, seeds, jax.random.PRNGKey(6), (3, 3))
        for la, lb in zip(
            jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
        ):
            assert jnp.array_equal(la, lb)
        assert not jnp.array_equal(a.senders, c.senders)

    def test_pad_seeds_keep_slots(self):
        """-1 seed slots stay masked but occupy their local id, so the
        head's ``x[:S]`` read stays aligned with the label slots."""
        g = _graph(n=300)
        csr = DeviceGraphCSR.from_graph(g)
        seeds = jnp.asarray(np.array([10, 20, -1, -1], np.int32))
        b = device_sample(csr, seeds, jax.random.PRNGKey(0), (3,))
        ids = np.asarray(b.node_ids)
        assert ids[0] == 10 and ids[1] == 20
        assert ids[2] == -1 and ids[3] == -1
        nm = np.asarray(b.node_mask)
        assert nm[0] and nm[1] and not nm[2] and not nm[3]
        assert np.allclose(np.asarray(b.node_features)[2:4], 0.0)


class TestSeedBatch:
    def test_packed_roundtrip(self):
        labels = np.arange(100, dtype=np.int32) % 2
        chunk = np.array([7, 3, 11], np.int64)
        sb = make_seed_batch(chunk, labels, 12345, num_seeds=5)
        assert np.asarray(sb.seeds).tolist() == [7, 3, 11, -1, -1]
        assert np.asarray(sb.labels).tolist() == [1, 1, 1, 0, 0]
        assert np.asarray(sb.seed_mask).tolist() == [1, 1, 1, 0, 0]
        assert np.asarray(sb.label_mask).tolist() == [1, 1, 1, 0, 0]
        key = jax.random.wrap_key_data(sb.key_data)
        ref = jax.random.PRNGKey(12345)
        assert jnp.array_equal(
            jax.random.key_data(key), jax.random.key_data(ref)
        )

    def test_unlabeled(self):
        sb = make_seed_batch(np.array([1, 2]), None, 0, num_seeds=2)
        assert not bool(sb.label_mask.any())
        assert bool(sb.seed_mask.all())

    def test_loader_epoch_streams(self):
        lo = DeviceSeedLoader(np.arange(64), np.zeros(64, np.int32),
                              batch_size=32, seed=0)
        e0 = [np.asarray(b.packed).copy() for b in lo]
        e1 = [np.asarray(b.packed).copy() for b in lo]
        assert not all(np.array_equal(a, b) for a, b in zip(e0, e1))
        lo.set_epoch(0)
        e0r = [np.asarray(b.packed).copy() for b in lo]
        assert all(np.array_equal(a, b) for a, b in zip(e0, e0r))


@pytest.mark.slow
class TestFeatureTableDtypes:
    """Reduced-precision device-resident feature tables (round 5): bf16
    halves and int8+scale quarters the residency that bounds how big a
    graph still REPLICATES per chip; values are exact up to the table
    rounding and training converges through them."""

    def _sample_x(self, csr, g, seeds, fanout):
        b = device_sample(
            csr, jnp.asarray(seeds, jnp.int32), jax.random.PRNGKey(3),
            fanout,
        )
        ids = np.asarray(b.node_ids)
        m = ids >= 0
        return np.asarray(b.node_features)[m], ids[m]

    def test_bf16_rows_are_exact_bf16_roundings(self):
        g = _graph()
        csr = DeviceGraphCSR.from_graph(g, feature_dtype="bfloat16")
        assert csr.node_features.dtype == jnp.bfloat16
        x, ids = self._sample_x(csr, g, np.arange(16), (4, 4))
        want = np.asarray(
            jnp.asarray(g.node_features[ids]).astype(jnp.bfloat16)
            .astype(jnp.float32)
        )
        np.testing.assert_array_equal(x, want)
        assert x.dtype == np.float32  # the batch stays f32 downstream

    def test_int8_dequant_error_bounded_by_half_scale(self):
        g = _graph(seed=4)
        csr = DeviceGraphCSR.from_graph(g, feature_dtype="int8")
        assert csr.node_features.dtype == jnp.int8
        scale = np.asarray(csr.feature_scale)
        x, ids = self._sample_x(csr, g, np.arange(16), (4, 4))
        err = np.abs(x - g.node_features[ids])
        assert (err <= scale[None, :] / 2 + 1e-6).all()

    def test_keep_all_logits_close_to_f32(self):
        g = _graph(n=200)
        f32 = DeviceGraphCSR.from_graph(g)
        md = f32.max_in_degree
        model = NodeGCN(in_channels=5, hidden_dim=16, num_layers=2)
        params, state = model.init(jax.random.PRNGKey(0))
        seeds = jnp.asarray(np.arange(8), jnp.int32)

        def logits(csr):
            b = device_sample(csr, seeds, jax.random.PRNGKey(5), (md, md))
            import dataclasses

            b = dataclasses.replace(
                b,
                labels=jnp.zeros(8, jnp.int32),
                label_mask=jnp.ones(8, bool),
                seed_mask=jnp.ones(8, bool),
            )
            out, _ = model.apply(params, state, b, train=False)
            return np.asarray(out)

        ref = logits(f32)
        for dt, tol in (("bfloat16", 2e-2), ("int8", 2e-2)):
            got = logits(DeviceGraphCSR.from_graph(g, feature_dtype=dt))
            np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)

    def test_bad_dtype_raises(self):
        with pytest.raises(ValueError, match="feature_dtype"):
            DeviceGraphCSR.from_graph(_graph(), feature_dtype="fp8")

    @pytest.mark.slow
    def test_bf16_table_converges(self):
        g = generate_spatial_graph(1024, degree=8, band=32, seed=0)
        src, dst = g.edge_index
        num = np.zeros(g.num_nodes)
        den = np.zeros(g.num_nodes)
        np.add.at(num, dst, g.edge_weight * g.node_features[src, 0])
        np.add.at(den, dst, g.edge_weight)
        agg = num / (den + 1e-8)
        labels = (agg > np.median(agg)).astype(np.int32)
        model = device_sampled_gcn(
            g, hidden_dim=32, fanout=(8, 8), feature_dtype="bfloat16"
        )
        tr = model.make_loader(
            np.arange(1024), labels, batch_size=128, seed=0, drop_last=True
        )
        va = model.make_loader(
            np.arange(1024), labels, batch_size=128, seed=1, shuffle=False
        )
        trainer = Trainer(model, seed=0)
        hist = trainer.fit(tr, va, num_epochs=4, patience=10, verbose=False)
        assert hist["train_loss"][-1] < hist["train_loss"][0]
        assert hist["val_acc"][-1] > 0.6


class TestTraining:
    def test_fit_learns_one_hop_task(self):
        g = generate_spatial_graph(1024, degree=8, band=32, seed=0)
        src, dst = g.edge_index
        num = np.zeros(g.num_nodes)
        den = np.zeros(g.num_nodes)
        np.add.at(num, dst, g.edge_weight * g.node_features[src, 0])
        np.add.at(den, dst, g.edge_weight)
        agg = num / (den + 1e-8)
        labels = (agg > np.median(agg)).astype(np.int32)

        model = device_sampled_gcn(g, hidden_dim=32, fanout=(8, 8))
        # make_loader attaches the CSR to every batch so the jitted step
        # takes it as an ARGUMENT (required at giant scale — remote
        # compile rejects 0.4GB closure constants)
        tr = model.make_loader(
            np.arange(1024), labels, batch_size=128, seed=0, drop_last=True
        )
        va = model.make_loader(
            np.arange(1024), labels, batch_size=128, seed=1, shuffle=False
        )
        assert tr.csr is model.csr
        trainer = Trainer(model, seed=0)
        hist = trainer.fit(tr, va, num_epochs=4, patience=10, verbose=False)
        assert hist["train_loss"][-1] < hist["train_loss"][0]
        assert hist["val_acc"][-1] > 0.6

    def test_epoch_scan_matches_stepwise(self):
        """make_epoch_runner's scanned epoch must equal the Trainer's
        step-by-step epoch to float precision (same rng split, same
        masked CE, same Adam update — only the dispatch granularity and
        XLA's fusion choices differ; observed deltas are last-ulp in the
        BN state)."""
        g = _graph(n=400, degree=6)
        labels = (np.arange(400) % 2).astype(np.int32)
        model = device_sampled_gcn(g, hidden_dim=16, fanout=(3, 3))

        trainer = Trainer(model, seed=0)
        run = make_epoch_runner(model, trainer.optimizer)
        packed = pack_epoch(
            model.make_loader(
                np.arange(400), labels, batch_size=100, seed=4,
                drop_last=True,
            )
        )
        p2, s2, o2, _, losses, ns = run(
            trainer.params, trainer.state, trainer.opt_state,
            trainer._rng, packed, model.csr,
        )

        loader = model.make_loader(
            np.arange(400), labels, batch_size=100, seed=4, drop_last=True
        )
        trainer.train_epoch(loader)
        for a, b in zip(
            jax.tree_util.tree_leaves(p2),
            jax.tree_util.tree_leaves(trainer.params),
        ):
            assert jnp.allclose(a, b, rtol=1e-6, atol=1e-7)
        for a, b in zip(
            jax.tree_util.tree_leaves(s2),
            jax.tree_util.tree_leaves(trainer.state),
        ):
            assert jnp.allclose(a, b, rtol=1e-6, atol=1e-7)
        assert losses.shape == (4,)
        assert bool(jnp.all(ns == 100))

    def test_fit_scan_epochs_matches_stepwise_fit(self):
        """Trainer(scan_epochs=True) must reproduce the step-by-step fit
        to float precision (VERDICT r3 #7: the zero-host-round-trip
        epoch reachable from the product API)."""
        g = _graph(n=400, degree=6)
        labels = (np.arange(400) % 2).astype(np.int32)
        model = device_sampled_gcn(g, hidden_dim=16, fanout=(3, 3))

        def loaders():
            tr = model.make_loader(
                np.arange(400), labels, batch_size=100, seed=4,
                drop_last=True,
            )
            va = model.make_loader(
                np.arange(400), labels, batch_size=100, seed=5,
                shuffle=False,
            )
            return tr, va

        t1 = Trainer(model, seed=0)
        h1 = t1.fit(*loaders(), num_epochs=3, patience=10, verbose=False)
        t2 = Trainer(model, seed=0, scan_epochs=True)
        h2 = t2.fit(*loaders(), num_epochs=3, patience=10, verbose=False)

        assert np.allclose(h1["train_loss"], h2["train_loss"], rtol=1e-5)
        assert np.allclose(h1["val_loss"], h2["val_loss"], rtol=1e-5)
        for a, b in zip(
            jax.tree_util.tree_leaves(t1.params),
            jax.tree_util.tree_leaves(t2.params),
        ):
            assert jnp.allclose(a, b, rtol=1e-5, atol=1e-6)

    def test_scan_epochs_rejects_sharded_loader(self):
        g = _graph(n=128, degree=4)
        model = device_sampled_gcn(g, hidden_dim=8, fanout=(2, 2))
        lo = model.make_loader(
            np.arange(128), (np.arange(128) % 2).astype(np.int32),
            batch_size=32, num_shards=4,
        )
        trainer = Trainer(model, seed=0, scan_epochs=True)
        with pytest.raises(ValueError, match="unsharded"):
            trainer.train_epoch(lo)

    def test_tracks_host_sampled_quality(self):
        """Device-sampled training must land in the host-sampled run's
        accuracy neighborhood (same task, same architecture)."""
        g = generate_spatial_graph(1024, degree=8, band=32, seed=0)
        src, dst = g.edge_index
        num = np.zeros(g.num_nodes)
        den = np.zeros(g.num_nodes)
        np.add.at(num, dst, g.edge_weight * g.node_features[src, 0])
        np.add.at(den, dst, g.edge_weight)
        agg = num / (den + 1e-8)
        labels = (agg > np.median(agg)).astype(np.int32)

        dev_model = device_sampled_gcn(g, hidden_dim=32, fanout=(8, 8))
        dev_tr = DeviceSeedLoader(
            np.arange(1024), labels, batch_size=128, seed=0, drop_last=True
        )
        dev_va = DeviceSeedLoader(
            np.arange(1024), labels, batch_size=128, seed=1, shuffle=False
        )
        dev = Trainer(dev_model, seed=0)
        dh = dev.fit(dev_tr, dev_va, num_epochs=6, patience=20, verbose=False)

        host_tr = SampledNodeLoader(
            g, labels, batch_size=128, fanout=(8, 8), seed=0, drop_last=True
        )
        host_va = SampledNodeLoader(
            g, labels, batch_size=128, fanout=(8, 8), seed=1, shuffle=False
        )
        host = Trainer(
            NodeGCN(in_channels=5, hidden_dim=32, num_layers=2), seed=0
        )
        hh = host.fit(
            host_tr, host_va, num_epochs=6, patience=20, verbose=False
        )
        assert abs(dh["val_acc"][-1] - hh["val_acc"][-1]) < 0.12


class TestMultisetMode:
    """dedup=False (node-wise sampling tree): every draw has its own
    slot, all locals arithmetic.  For SAGE (receiver-side weighted mean)
    the keep-all oracle is exact in eval mode; training semantics are
    the node-wise GraphSAGE estimator."""

    def test_keep_all_eval_logits_match_dedup(self):
        from connectome_gnn_jax.models import BlockedNodeSAGE, NodeSAGE

        g = _graph()
        csr = DeviceGraphCSR.from_graph(g)
        F = csr.max_in_degree
        seeds = jnp.asarray(np.array([5, 9, 70, 401], np.int32))
        bm = device_sample(
            csr, seeds, jax.random.PRNGKey(0), (F, F), dedup=False
        )
        bd = device_sample(
            csr, seeds, jax.random.PRNGKey(0), (F, F), dedup=True
        )
        for model in (
            NodeSAGE(in_channels=5, hidden_dim=16, num_layers=2),
            BlockedNodeSAGE(in_channels=5, hidden_dim=16, num_layers=2),
        ):
            params, state = model.init(jax.random.PRNGKey(1))
            lm, _ = model.apply(params, state, bm)
            ld, _ = model.apply(params, state, bd)
            assert jnp.allclose(lm, ld, rtol=1e-4, atol=1e-5)

    def test_structure(self):
        g = _graph(n=800, degree=10)
        csr = DeviceGraphCSR.from_graph(g)
        seeds = np.arange(16, dtype=np.int32) * 7
        b = device_sample(
            csr, jnp.asarray(seeds), jax.random.PRNGKey(3), (4, 4),
            dedup=False,
        )
        r = np.asarray(b.receivers)
        assert (np.diff(r) >= 0).all()
        w = np.asarray(b.edge_weight)
        s = np.asarray(b.senders)
        pad = w == 0
        assert (s[pad] == r[pad]).all()
        ids = np.asarray(b.node_ids)
        real = w > 0
        gs, gd = g.edge_index
        eset = set(zip(gs.tolist(), gd.tolist()))
        for a, c in zip(ids[s[real]].tolist(), ids[r[real]].tolist()):
            assert (a, c) in eset
        # sender slots are the draws' own slots: each real sender local
        # appears exactly once, and node slots beyond the seeds mirror
        # the draw emission order
        assert len(set(s[real].tolist())) == real.sum()

    def test_trainer_learns_multiset_sage(self):
        from connectome_gnn_jax.data import device_sampled_sage

        g = _graph(n=1024, degree=6, shortcut_frac=0.1)
        src, dst = g.edge_index
        num = np.zeros(1024)
        den = np.zeros(1024)
        np.add.at(num, dst, g.edge_weight * g.node_features[src, 0])
        np.add.at(den, dst, g.edge_weight)
        labels = ((num / (den + 1e-8)) > 0).astype(np.int32)
        model = device_sampled_sage(
            g, hidden_dim=32, fanout=(8, 8), dedup=False
        )
        tr = model.make_loader(
            np.arange(1024), labels, batch_size=128, seed=0, drop_last=True
        )
        va = model.make_loader(
            np.arange(1024), labels, batch_size=128, seed=1, shuffle=False
        )
        t = Trainer(model, seed=0)
        h = t.fit(tr, va, num_epochs=10, patience=20, verbose=False)
        assert h["val_acc"][-1] > 0.72

    def test_multiset_epoch_scan_matches_stepwise(self):
        """The multiset model must compose with make_epoch_runner
        unchanged (suite config SME = cheapest sampler x cheapest
        dispatch): scanned epoch == stepwise Trainer epoch."""
        from connectome_gnn_jax.data import device_sampled_sage

        g = _graph(n=400, degree=6)
        labels = (np.arange(400) % 2).astype(np.int32)
        model = device_sampled_sage(
            g, hidden_dim=16, fanout=(3, 3), dedup=False
        )

        trainer = Trainer(model, seed=0)
        run = make_epoch_runner(model, trainer.optimizer)
        packed = pack_epoch(
            model.make_loader(
                np.arange(400), labels, batch_size=100, seed=4,
                drop_last=True,
            )
        )
        p2, s2, o2, _, losses, ns = run(
            trainer.params, trainer.state, trainer.opt_state,
            trainer._rng, packed, model.csr,
        )

        loader = model.make_loader(
            np.arange(400), labels, batch_size=100, seed=4, drop_last=True
        )
        trainer.train_epoch(loader)
        for a, b in zip(
            jax.tree_util.tree_leaves(p2),
            jax.tree_util.tree_leaves(trainer.params),
        ):
            assert jnp.allclose(a, b, rtol=1e-6, atol=1e-7)
        assert losses.shape == (4,)
        assert bool(jnp.all(ns == 100))


@pytest.mark.slow
class TestBlockedAggregation:
    """gcn_layer_apply_blocked / BlockedNodeGCN vs the flat COO path.

    The blocked path is the SAME edges reshaped into the sampler's
    [frontier, fanout] emission blocks; logits and parameter gradients
    must match the flat NodeGCN to summation-order tolerance."""

    def _sampled(self, fanout=(5, 4)):
        g = _graph(n=800, degree=6)
        csr = DeviceGraphCSR.from_graph(g)
        seeds = jnp.asarray(np.arange(96, dtype=np.int32))
        return g, csr, jax.jit(
            lambda c, s: device_sample(c, s, jax.random.key(3), fanout)
        )(csr, seeds)

    def test_blocks_are_reshaped_views_of_flat_edges(self):
        _, _, b = self._sampled()
        assert b.hop_blocks is not None and len(b.hop_blocks) == 2
        snd = jnp.concatenate(
            [hb.senders.reshape(-1) for hb in b.hop_blocks]
        )
        w = jnp.concatenate([hb.weights.reshape(-1) for hb in b.hop_blocks])
        assert jnp.array_equal(snd, b.senders)
        assert jnp.array_equal(w, b.edge_weight)
        S = b.num_seeds
        assert jnp.array_equal(
            b.hop_blocks[0].recv, jnp.arange(S, dtype=jnp.int32)
        )
        # per-block receivers broadcast back to the flat receiver list
        rec = jnp.concatenate([
            jnp.broadcast_to(
                hb.recv[:, None], hb.senders.shape
            ).reshape(-1)
            for hb in b.hop_blocks
        ])
        assert jnp.array_equal(rec, b.receivers)

    def test_logits_and_grads_match_flat_path(self):
        import dataclasses

        import optax

        from connectome_gnn_jax.models import BlockedNodeGCN

        _, _, b = self._sampled()
        model = BlockedNodeGCN(in_channels=5, hidden_dim=16, num_layers=2)
        params, state = model.init(jax.random.key(0))
        S = b.num_seeds
        labels = jnp.asarray(np.random.default_rng(0).integers(0, 2, S))
        mask = jnp.ones(S, bool)
        b = dataclasses.replace(
            b, labels=labels, label_mask=mask, seed_mask=mask
        )
        flat = dataclasses.replace(b, hop_blocks=None)

        def loss(p, batch):
            logits, _ = model.apply(p, state, batch, train=False)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, batch.labels
            ).mean()

        lb, gb = jax.value_and_grad(loss)(params, b)
        lf, gf = jax.value_and_grad(loss)(params, flat)
        assert jnp.allclose(lb, lf, rtol=1e-5, atol=1e-6)
        for a, c in zip(jax.tree.leaves(gb), jax.tree.leaves(gf)):
            assert jnp.allclose(a, c, rtol=1e-4, atol=1e-5)

    def test_sage_logits_and_grads_match_flat_path(self):
        import dataclasses

        import optax

        from connectome_gnn_jax.models import BlockedNodeSAGE

        _, _, b = self._sampled()
        model = BlockedNodeSAGE(in_channels=5, hidden_dim=16, num_layers=2)
        params, state = model.init(jax.random.key(0))
        S = b.num_seeds
        labels = jnp.asarray(np.random.default_rng(0).integers(0, 2, S))
        mask = jnp.ones(S, bool)
        b = dataclasses.replace(
            b, labels=labels, label_mask=mask, seed_mask=mask
        )
        flat = dataclasses.replace(b, hop_blocks=None)

        def loss(p, batch):
            logits, _ = model.apply(p, state, batch, train=False)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, batch.labels
            ).mean()

        lb, gb = jax.value_and_grad(loss)(params, b)
        lf, gf = jax.value_and_grad(loss)(params, flat)
        assert jnp.allclose(lb, lf, rtol=1e-5, atol=1e-6)
        for a, c in zip(jax.tree.leaves(gb), jax.tree.leaves(gf)):
            assert jnp.allclose(a, c, rtol=1e-4, atol=1e-5)

    def test_sage_trainer_learns_through_blocked_path(self):
        from connectome_gnn_jax.data import device_sampled_sage

        g = _graph(n=1024, degree=6, shortcut_frac=0.1)
        src, dst = g.edge_index
        num = np.zeros(1024)
        den = np.zeros(1024)
        np.add.at(num, dst, g.edge_weight * g.node_features[src, 0])
        np.add.at(den, dst, g.edge_weight)
        labels = ((num / (den + 1e-8)) > 0).astype(np.int32)
        model = device_sampled_sage(g, hidden_dim=32, fanout=(8, 8))
        tr = model.make_loader(
            np.arange(1024), labels, batch_size=128, seed=0, drop_last=True
        )
        va = model.make_loader(
            np.arange(1024), labels, batch_size=128, seed=1, shuffle=False
        )
        t = Trainer(model, seed=0)
        h = t.fit(tr, va, num_epochs=10, patience=20, verbose=False)
        assert h["val_acc"][-1] > 0.72

    def test_trainer_convergence_through_blocked_path(self):
        # the fused Trainer path (device_sampled_gcn now returns a
        # BlockedNodeGCN inner) still learns the 1-hop task
        g = _graph(n=1024, degree=6, shortcut_frac=0.1)
        src, dst = g.edge_index
        num = np.zeros(1024)
        den = np.zeros(1024)
        np.add.at(num, dst, g.edge_weight * g.node_features[src, 0])
        np.add.at(den, dst, g.edge_weight)
        labels = ((num / (den + 1e-8)) > 0).astype(np.int32)
        model = device_sampled_gcn(g, hidden_dim=32, fanout=(8, 8))
        tr = model.make_loader(
            np.arange(1024), labels, batch_size=128, seed=0, drop_last=True
        )
        va = model.make_loader(
            np.arange(1024), labels, batch_size=128, seed=1, shuffle=False
        )
        t = Trainer(model, seed=0)
        h = t.fit(tr, va, num_epochs=10, patience=20, verbose=False)
        # equivalence to the flat path is asserted exactly above; this
        # is a smoke bound well above chance for the tiny 1024-node task
        assert h["val_acc"][-1] > 0.72
