"""Sampled-minibatch giant-graph training (BASELINE config 5 end-to-end).

Covers the static-shape sampled batch container, padding inertness, the
full-graph oracle batch, loader reproducibility, and the headline claim:
seed-supervised sampled training converges into the full-batch model's
accuracy neighborhood on a graph trained minibatch-wise.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from connectome_gnn_jax.data import (
    SampledNodeLoader,
    collate_sampled,
    fanout_budgets,
    full_graph_batch,
    generate_spatial_graph,
    sample_subgraph,
)
from connectome_gnn_jax.models import NodeGCN, NodeSAGE
from connectome_gnn_jax.train import Trainer


def _learnable_graph(num_nodes=1024, degree=8, band=32, seed=0):
    """Spatial graph whose labels are the sign of the weighted-mean
    neighbor feature 0 — exactly computable by one message-passing hop."""
    g = generate_spatial_graph(num_nodes, degree=degree, band=band, seed=seed)
    src, dst = g.edge_index
    num = np.zeros(g.num_nodes)
    den = np.zeros(g.num_nodes)
    np.add.at(num, dst, g.edge_weight * g.node_features[src, 0])
    np.add.at(den, dst, g.edge_weight)
    agg = num / (den + 1e-8)
    labels = (agg > np.median(agg)).astype(np.int32)
    return g, labels


class _OneBatchLoader:
    def __init__(self, batch):
        self.batch = batch

    def __iter__(self):
        return iter([self.batch])


class TestSampledBatch:
    def test_fanout_budgets(self):
        assert fanout_budgets(4, (3, 2)) == (4 + 12 + 24, 12 + 24)

    def test_collate_invariants(self):
        g, labels = _learnable_graph(128)
        seeds = np.array([5, 9, 70])
        sub, node_ids = sample_subgraph(
            g, seeds, (4, 4), np.random.default_rng(0)
        )
        batch = collate_sampled(
            sub, node_ids, labels[seeds], num_seeds=8, real_seeds=3,
            node_budget=256, edge_budget=512,
        )
        r = np.asarray(batch.receivers)
        assert (np.diff(r) >= 0).all()  # receiver-sorted incl. padding
        w = np.asarray(batch.edge_weight)
        assert (w[sub.num_edges:] == 0).all()
        assert np.asarray(batch.node_mask).sum() == sub.num_nodes
        assert np.asarray(batch.seed_mask).tolist() == [True] * 3 + [False] * 5
        assert np.asarray(batch.label_mask).sum() == 3
        np.testing.assert_array_equal(
            np.asarray(batch.node_ids)[: len(node_ids)], node_ids
        )
        # seeds-first contract survived collation
        np.testing.assert_array_equal(np.asarray(batch.node_ids)[:3], seeds)

    def test_budget_padding_is_inert(self):
        """Same sample, two different (node, edge) budgets → identical
        seed logits (masked BN + zero-weight edges keep padding invisible)."""
        g, labels = _learnable_graph(128)
        seeds = np.arange(16)
        sub, node_ids = sample_subgraph(
            g, seeds, (4, 4), np.random.default_rng(1)
        )
        model = NodeGCN(in_channels=5, hidden_dim=16, num_layers=2)
        params, state = model.init(jax.random.PRNGKey(0))
        outs = []
        for nb, eb in ((128, 512), (256, 1024)):
            batch = collate_sampled(
                sub, node_ids, labels[seeds], num_seeds=16, real_seeds=16,
                node_budget=nb, edge_budget=eb,
            )
            logits, _ = model.apply(params, state, batch, train=False)
            outs.append(np.asarray(logits))
        np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-6)

    def test_collate_overflow_raises(self):
        g, labels = _learnable_graph(128)
        sub, node_ids = sample_subgraph(
            g, np.arange(32), (8, 8), np.random.default_rng(0)
        )
        with pytest.raises(ValueError, match="node_budget"):
            collate_sampled(sub, node_ids, labels[:32], num_seeds=32,
                            real_seeds=32, node_budget=8, edge_budget=4096)
        with pytest.raises(ValueError, match="edge_budget"):
            collate_sampled(sub, node_ids, labels[:32], num_seeds=32,
                            real_seeds=32, node_budget=1024, edge_budget=128)


class TestFullGraphBatch:
    def test_full_batch_matches_plain_forward(self):
        """full_graph_batch is an identity sample: NodeGCN on it equals the
        COO layer stack run directly on the (un-reordered) graph."""
        from connectome_gnn_jax.models.layers import gcn_layer_apply
        from connectome_gnn_jax.nn.layers import batch_norm_apply, dense_apply

        g, labels = _learnable_graph(96)
        batch = full_graph_batch(g, labels)  # seeds = all nodes, order kept
        model = NodeGCN(in_channels=5, hidden_dim=16, num_layers=2)
        params, state = model.init(jax.random.PRNGKey(0))
        logits, _ = model.apply(params, state, batch, train=False)

        x = jnp.asarray(g.node_features)
        s = jnp.asarray(g.edge_index[0])
        r = jnp.asarray(g.edge_index[1])
        w = jnp.asarray(g.edge_weight)
        mask = jnp.ones(g.num_nodes, bool)
        for i in range(2):
            x = gcn_layer_apply(
                params["convs"][i], x, s, r, w, indices_are_sorted=False
            )
            x, _ = batch_norm_apply(
                params["norms"][i], state["norms"][i], x, mask, train=False
            )
            x = jax.nn.relu(x)
        expected = dense_apply(params["head"], x)
        np.testing.assert_allclose(
            np.asarray(logits), np.asarray(expected), rtol=1e-4, atol=1e-5
        )

    def test_seed_subset_reorders(self):
        g, labels = _learnable_graph(64)
        seeds = np.array([10, 3, 40])
        batch = full_graph_batch(g, labels, seed_nodes=seeds)
        assert batch.num_seeds == 3
        np.testing.assert_array_equal(np.asarray(batch.node_ids)[:3], seeds)
        np.testing.assert_array_equal(
            np.asarray(batch.labels), labels[seeds]
        )


class TestSampledNodeLoader:
    def test_epoch_reproducibility(self):
        g, labels = _learnable_graph(256)
        a = SampledNodeLoader(g, labels, batch_size=64, fanout=(4,), seed=5)
        b = SampledNodeLoader(g, labels, batch_size=64, fanout=(4,), seed=5)
        a.set_epoch(3)
        b.set_epoch(3)
        for ba, bb in zip(a, b):
            for la, lb in zip(
                jax.tree_util.tree_leaves(ba), jax.tree_util.tree_leaves(bb)
            ):
                np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))

    def test_static_shapes_across_epoch(self):
        g, labels = _learnable_graph(200)
        loader = SampledNodeLoader(
            g, labels, batch_size=64, fanout=(4, 4), seed=0
        )
        shapes = {
            tuple(np.asarray(l).shape)
            for b in loader
            for l in jax.tree_util.tree_leaves(b)
        }
        shapes2 = {
            tuple(np.asarray(l).shape)
            for b in loader
            for l in jax.tree_util.tree_leaves(b)
        }
        assert shapes == shapes2  # one compiled program for the whole run

    def test_predict_serves_seed_nodes(self):
        g, labels = _learnable_graph(256)
        loader = SampledNodeLoader(
            g, labels, batch_size=64, fanout=(4,), shuffle=False
        )
        model = NodeGCN(in_channels=5, hidden_dim=16, num_layers=1)
        trainer = Trainer(model, seed=0)
        logits = trainer.predict(loader, prefer_fused=False)
        assert logits.shape == (256, 2)


class TestShardedSampledLoader:
    def test_stacked_shapes(self):
        g, labels = _learnable_graph(512)
        loader = SampledNodeLoader(
            g, labels, batch_size=64, fanout=(4,), seed=0, num_shards=4
        )
        batch = next(iter(loader))
        assert batch.node_features.ndim == 3
        assert batch.node_features.shape[0] == 4  # leading device axis
        assert batch.labels.shape == (4, 16)  # per-shard seed slots
        assert batch.num_seeds == 16

    def test_indivisible_batch_raises(self):
        g, labels = _learnable_graph(128)
        with pytest.raises(ValueError, match="num_shards"):
            SampledNodeLoader(g, labels, batch_size=10, num_shards=4)

    def test_process_shards_partition_the_global_stack(self):
        """Two processes' local stacks concatenate to exactly the
        single-process global stack — per-shard sampling streams are a
        function of the GLOBAL shard index, no coordination needed."""
        g, labels = _learnable_graph(512)
        kw = dict(batch_size=64, fanout=(4, 4), seed=3, num_shards=4)
        full = SampledNodeLoader(g, labels, **kw)
        p0 = SampledNodeLoader(g, labels, **kw, process_index=0, process_count=2)
        p1 = SampledNodeLoader(g, labels, **kw, process_index=1, process_count=2)
        for bf, b0, b1 in zip(full, p0, p1):
            for lf, l0, l1 in zip(
                jax.tree_util.tree_leaves(bf),
                jax.tree_util.tree_leaves(b0),
                jax.tree_util.tree_leaves(b1),
            ):
                np.testing.assert_array_equal(
                    np.asarray(lf),
                    np.concatenate([np.asarray(l0), np.asarray(l1)]),
                )

    def test_final_partial_step_pads_trailing_shards(self):
        g, labels = _learnable_graph(256)
        # 200 seeds, global batch 128 over 4 shards → step 2 has 72 seeds:
        # shards get 32, 32, 8, 0 real seeds
        loader = SampledNodeLoader(
            g, labels, seed_nodes=np.arange(200), batch_size=128,
            fanout=(4,), shuffle=False, num_shards=4,
        )
        batches = list(loader)
        assert len(batches) == 2
        per_shard = np.asarray(batches[1].seed_mask).sum(axis=1)
        assert per_shard.tolist() == [32, 32, 8, 0]

    def test_unsharded_resamples_across_epochs_without_shuffle(self):
        """shuffle=False still advances the sampling streams per pass."""
        g, labels = _learnable_graph(256)
        loader = SampledNodeLoader(
            g, labels, batch_size=64, fanout=(4,), shuffle=False, seed=0
        )
        e0 = [np.asarray(b.senders) for b in loader]
        e1 = [np.asarray(b.senders) for b in loader]
        assert any((a != b).any() for a, b in zip(e0, e1))


@pytest.mark.slow
class TestSampledDataParallel:
    def test_dp_step_matches_single_device_on_identical_shards(self, cpu_devices):
        """8 identical shards through the DP step == one single-device
        step on that shard (psum-averaged grads, sync-BN, masked mean)."""
        import optax

        from connectome_gnn_jax.parallel import (
            create_mesh,
            make_dp_train_step,
            shard_batch,
            stack_batches,
        )

        g, labels = _learnable_graph(512)
        loader = SampledNodeLoader(
            g, labels, batch_size=64, fanout=(4, 4), seed=0, shuffle=False
        )
        shard = next(iter(loader))
        mesh = create_mesh()
        model = NodeGCN(in_channels=5, hidden_dim=16, num_layers=2)
        params, state = model.init(jax.random.PRNGKey(0))
        # SGD, not Adam: the parameter delta is then lr·grad, a faithful
        # image of the gradient (Adam's g/(|g|+eps) amplifies f32
        # reassociation noise on near-zero-gradient leaves into full-size
        # update disagreements)
        opt = optax.sgd(0.1)
        opt_state = opt.init(params)

        stacked = shard_batch(stack_batches([shard] * 8), mesh)
        dp_step = make_dp_train_step(model, opt, mesh)
        dp_params, dp_state, _, dp_loss, dp_n = dp_step(
            params, state, opt_state, jax.random.PRNGKey(1), stacked
        )

        def single_step(p, s, o, batch):
            def loss_fn(p):
                logits, new_s = model.apply(p, s, batch, train=True)
                ce = optax.softmax_cross_entropy_with_integer_labels(
                    logits, batch.labels
                )
                m = batch.label_mask.astype(np.float32)
                return (ce * m).sum() / m.sum(), new_s

            (loss, new_s), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
            updates, new_o = opt.update(grads, o, p)
            return optax.apply_updates(p, updates), new_s, loss

        sp, ss, sloss = single_step(params, state, opt_state, shard)
        assert int(dp_n) == 8 * int(np.asarray(shard.label_mask).sum())
        np.testing.assert_allclose(float(dp_loss), float(sloss), rtol=1e-5)
        for a, b in zip(
            jax.tree_util.tree_leaves(dp_params), jax.tree_util.tree_leaves(sp)
        ):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6
            )
        # BN state: means agree exactly; running VARs differ only by the
        # Bessel correction (sync-BN corrects with the GLOBAL count 8n —
        # the semantics of one big batch — vs the oracle's local n).
        n_loc = float(np.asarray(shard.node_mask).sum())
        n_glb = 8.0 * n_loc
        for dp_norm, s_norm in zip(dp_state["norms"], ss["norms"]):
            np.testing.assert_allclose(
                np.asarray(dp_norm["mean"]), np.asarray(s_norm["mean"]),
                rtol=1e-5, atol=1e-6,
            )
            # state["var"] = 0.9·1.0 + 0.1·var_b·(n/(n-1)); invert the
            # local correction and re-apply the global one
            var_b = (np.asarray(s_norm["var"]) - 0.9) / 0.1 / (
                n_loc / (n_loc - 1.0)
            )
            expected = 0.9 + 0.1 * var_b * (n_glb / (n_glb - 1.0))
            np.testing.assert_allclose(
                np.asarray(dp_norm["var"]), expected, rtol=1e-5, atol=1e-6
            )

    def test_dp_sampled_training_converges(self, cpu_devices):
        """BASELINE config 5 composed: sharded neighbor-sampled minibatch
        training over the mesh reaches the single-device sampled run's
        accuracy neighborhood."""
        from connectome_gnn_jax.parallel import create_mesh

        g, labels = _learnable_graph(1024)
        nodes = np.random.default_rng(0).permutation(g.num_nodes)
        train_nodes, val_nodes = nodes[:800], nodes[800:]
        kw = dict(batch_size=200, fanout=(8, 8), seed=1)

        single = Trainer(
            NodeGCN(in_channels=5, hidden_dim=32, num_layers=2), seed=0
        )
        h1 = single.fit(
            SampledNodeLoader(g, labels, seed_nodes=train_nodes, **kw),
            SampledNodeLoader(
                g, labels, seed_nodes=val_nodes, batch_size=224,
                fanout=(8, 8), shuffle=False,
            ),
            num_epochs=8, patience=20, verbose=False,
        )

        mesh = create_mesh()
        dp = Trainer(
            NodeGCN(in_channels=5, hidden_dim=32, num_layers=2),
            seed=0, mesh=mesh,
        )
        h2 = dp.fit(
            SampledNodeLoader(
                g, labels, seed_nodes=train_nodes, **kw, num_shards=8
            ),
            SampledNodeLoader(
                g, labels, seed_nodes=val_nodes, batch_size=224,
                fanout=(8, 8), shuffle=False, num_shards=8,
            ),
            num_epochs=8, patience=20, verbose=False,
        )
        assert h2["val_acc"][-1] > 0.7
        assert h2["val_acc"][-1] >= h1["val_acc"][-1] - 0.08


@pytest.mark.slow
class TestPrefetch:
    def test_prefetched_fit_is_deterministic(self):
        """prefetch_depth only overlaps host work — history is identical."""
        g, labels = _learnable_graph(256)

        def run(depth):
            tr = SampledNodeLoader(g, labels, batch_size=64, fanout=(4,), seed=1)
            va = SampledNodeLoader(
                g, labels, batch_size=64, fanout=(4,), shuffle=False
            )
            t = Trainer(
                NodeGCN(in_channels=5, hidden_dim=16, num_layers=1),
                seed=0, prefetch_depth=depth,
            )
            return t.fit(tr, va, num_epochs=3, patience=10, verbose=False)

        h0, h2 = run(0), run(2)
        np.testing.assert_array_equal(h0["train_loss"], h2["train_loss"])
        np.testing.assert_array_equal(h0["val_loss"], h2["val_loss"])


@pytest.mark.slow
class TestSampledConvergence:
    def test_sampled_training_reaches_fullbatch_neighborhood(self):
        """The headline: minibatch-sampled training lands within 0.08 val
        accuracy of the full-batch model on the same split."""
        g, labels = _learnable_graph(1024)
        nodes = np.random.default_rng(0).permutation(g.num_nodes)
        train_nodes, val_nodes = nodes[:800], nodes[800:]

        tr = SampledNodeLoader(
            g, labels, seed_nodes=train_nodes, batch_size=200,
            fanout=(8, 8), seed=1,
        )
        va = SampledNodeLoader(
            g, labels, seed_nodes=val_nodes, batch_size=224, fanout=(8, 8),
            shuffle=False,
        )
        sampled = Trainer(NodeGCN(in_channels=5, hidden_dim=32, num_layers=2), seed=0)
        hist = sampled.fit(tr, va, num_epochs=8, patience=20, verbose=False)

        fb = Trainer(NodeGCN(in_channels=5, hidden_dim=32, num_layers=2), seed=0)
        h2 = fb.fit(
            _OneBatchLoader(full_graph_batch(g, labels, seed_nodes=train_nodes)),
            _OneBatchLoader(full_graph_batch(g, labels, seed_nodes=val_nodes)),
            num_epochs=60, patience=60, verbose=False,
        )
        assert hist["val_acc"][-1] > 0.7
        assert hist["val_acc"][-1] >= max(h2["val_acc"]) - 0.08

    def test_sage_sampled_training_learns(self):
        g, labels = _learnable_graph(512)
        loader = SampledNodeLoader(
            g, labels, batch_size=128, fanout=(6, 6), seed=2
        )
        trainer = Trainer(NodeSAGE(in_channels=5, hidden_dim=32, num_layers=2), seed=0)
        hist = trainer.fit(loader, loader, num_epochs=6, patience=20, verbose=False)
        assert hist["val_acc"][-1] > 0.7
