"""Fused native sample→collate path (single-transfer minibatch ingest).

The fused path exists because end-to-end sampled training with a
host-built batch is host-bound (breakdown in
``benchmarks/profile_sampled.py``).
It must produce batches equivalent to the classic
``NeighborSampler.sample`` + ``collate_sampled`` pipeline: identical
sampled subgraph per seed (same splitmix64 stream), identical node order
and masks, identical per-receiver edge sets — only the intra-receiver
edge order may differ (draw order vs global-edge-id order).

The reference suite has no sampling (SURVEY §0); the loader these tests
guard feeds the scaled counterpart of the reference's scatter aggregation
(/root/reference/connectome_gnn/models.py:45-54).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from connectome_gnn_jax import native
from connectome_gnn_jax.data import SampledNodeLoader, generate_spatial_graph
from connectome_gnn_jax.data.sampling import NeighborSampler
from connectome_gnn_jax.models import NodeGCN
from connectome_gnn_jax.train import Trainer

pytestmark = pytest.mark.skipif(
    not native.AVAILABLE, reason="native library not built"
)


def _graph(n=2000, degree=8, band=64, seed=0, shortcut_frac=0.1):
    g = generate_spatial_graph(
        n, degree=degree, band=band, seed=seed, shortcut_frac=shortcut_frac
    )
    labels = (np.arange(n) % 2).astype(np.int32)
    return g, labels


def _loaders(g, labels, **kw):
    kw.setdefault("batch_size", 64)
    kw.setdefault("fanout", (5, 5))
    kw.setdefault("seed", 3)
    fused = SampledNodeLoader(g, labels, fused=True, **kw)
    classic = SampledNodeLoader(g, labels, fused=False, **kw)
    return fused, classic


def _real_edges(b):
    m = np.asarray(b.edge_weight) != 0
    return sorted(
        zip(
            np.asarray(b.senders)[m].tolist(),
            np.asarray(b.receivers)[m].tolist(),
            np.asarray(b.edge_weight)[m].tolist(),
        )
    )


class TestFusedEquivalence:
    def test_batches_match_classic(self):
        """Every batch of an epoch: same nodes/masks/labels, same edge
        multiset, per-receiver weighted sums allclose."""
        g, labels = _graph()
        fused, classic = _loaders(g, labels, drop_last=True)
        for bf, bc in zip(fused, classic):
            for a, b in zip(
                jax.tree_util.tree_leaves(bf), jax.tree_util.tree_leaves(bc)
            ):
                assert a.shape == b.shape and a.dtype == b.dtype
            assert jnp.array_equal(bf.node_ids, bc.node_ids)
            assert jnp.array_equal(bf.node_mask, bc.node_mask)
            assert jnp.array_equal(bf.seed_mask, bc.seed_mask)
            assert jnp.array_equal(bf.labels, bc.labels)
            assert jnp.array_equal(bf.label_mask, bc.label_mask)
            # features: on-device table gather vs host fill
            assert jnp.allclose(bf.node_features, bc.node_features)
            assert _real_edges(bf) == _real_edges(bc)
            wf = jax.ops.segment_sum(
                bf.edge_weight, bf.receivers, num_segments=bf.num_nodes
            )
            wc = jax.ops.segment_sum(
                bc.edge_weight, bc.receivers, num_segments=bc.num_nodes
            )
            assert jnp.allclose(wf, wc, rtol=1e-6, atol=1e-7)

    def test_receivers_sorted_padding_inert(self):
        g, labels = _graph()
        fused, _ = _loaders(g, labels)
        b = next(iter(fused))
        r = np.asarray(b.receivers)
        assert (np.diff(r) >= 0).all()  # receiver-sorted incl. padding
        pad = ~np.asarray(b.node_mask)[r]
        assert (np.asarray(b.edge_weight)[pad] == 0).all()

    def test_deterministic_per_seed(self):
        g, labels = _graph()
        a = SampledNodeLoader(g, labels, batch_size=64, seed=7, fused=True)
        b = SampledNodeLoader(g, labels, batch_size=64, seed=7, fused=True)
        for x, y in zip(a, b):
            for la, lb in zip(
                jax.tree_util.tree_leaves(x), jax.tree_util.tree_leaves(y)
            ):
                assert jnp.array_equal(la, lb)

    def test_sharded_stacked_mode(self):
        g, labels = _graph()
        fused, classic = _loaders(
            g, labels, batch_size=64, num_shards=4, drop_last=True
        )
        bf, bc = next(iter(fused)), next(iter(classic))
        assert bf.node_features.shape == bc.node_features.shape  # [D, ...]
        assert bf.node_features.shape[0] == 4
        assert jnp.array_equal(bf.node_ids, bc.node_ids)
        assert jnp.allclose(bf.node_features, bc.node_features)

    def test_unlabeled_serving(self):
        g, _ = _graph()
        loader = SampledNodeLoader(g, None, batch_size=64, fused=True)
        b = next(iter(loader))
        assert not bool(b.label_mask.any())
        assert bool(b.seed_mask[:64].all())

    def test_partial_final_chunk(self):
        g, labels = _graph(n=200)
        loader = SampledNodeLoader(
            g, labels, batch_size=64, fanout=(3,), fused=True
        )
        batches = list(loader)
        assert len(batches) == 4
        last = batches[-1]
        assert int(last.seed_mask.sum()) == 200 - 3 * 64


class TestFusedErrors:
    def test_duplicate_seed_raises(self):
        g, _ = _graph(n=200)
        s = NeighborSampler(g)
        nb, eb = 64, 256
        bufs = dict(
            out_senders=np.empty(eb, np.int32),
            out_receivers=np.empty(eb, np.int32),
            out_weights=np.empty(eb, np.float32),
            out_node_ids=np.empty(nb, np.int32),
        )
        with pytest.raises(ValueError, match="duplicate"):
            s.sample_collate_into(
                np.array([3, 3]), (2,), 0, node_budget=nb, edge_budget=eb,
                **bufs,
            )

    def test_budget_overflow_raises(self):
        g, _ = _graph(n=200)
        s = NeighborSampler(g)
        bufs = dict(
            out_senders=np.empty(4, np.int32),
            out_receivers=np.empty(4, np.int32),
            out_weights=np.empty(4, np.float32),
            out_node_ids=np.empty(4, np.int32),
        )
        with pytest.raises(ValueError, match="budget"):
            s.sample_collate_into(
                np.array([0, 1, 2, 3]), (8, 8), 0,
                node_budget=4, edge_budget=4, **bufs,
            )

    def test_handle_reuse_after_error(self):
        """The touched-only visited reset must hold across failed calls —
        a post-error sample must equal a fresh sampler's."""
        g, _ = _graph(n=500)
        s = NeighborSampler(g)
        nb, eb = 512, 512
        bufs = lambda: dict(  # noqa: E731
            out_senders=np.empty(eb, np.int32),
            out_receivers=np.empty(eb, np.int32),
            out_weights=np.empty(eb, np.float32),
            out_node_ids=np.empty(nb, np.int32),
        )
        small = dict(
            out_senders=np.empty(2, np.int32),
            out_receivers=np.empty(2, np.int32),
            out_weights=np.empty(2, np.float32),
            out_node_ids=np.empty(8, np.int32),
        )
        with pytest.raises(ValueError):
            s.sample_collate_into(
                np.arange(8), (5,), 1, node_budget=8, edge_budget=2, **small
            )
        a = bufs()
        s.sample_collate_into(
            np.arange(32), (4,), 9, node_budget=nb, edge_budget=eb, **a
        )
        b = bufs()
        NeighborSampler(g).sample_collate_into(
            np.arange(32), (4,), 9, node_budget=nb, edge_budget=eb, **b
        )
        for k in a:
            assert np.array_equal(a[k], b[k]), k


class TestFusedTraining:
    def test_trainer_fit_runs_and_learns(self):
        """End-to-end: fused loader under the standard Trainer; the loss
        must drop on a 1-hop-learnable task."""
        g = generate_spatial_graph(1024, degree=8, band=32, seed=0)
        src, dst = g.edge_index
        num = np.zeros(g.num_nodes)
        den = np.zeros(g.num_nodes)
        np.add.at(num, dst, g.edge_weight * g.node_features[src, 0])
        np.add.at(den, dst, g.edge_weight)
        agg = num / (den + 1e-8)
        labels = (agg > np.median(agg)).astype(np.int32)

        tr = SampledNodeLoader(
            g, labels, batch_size=128, fanout=(8, 8), seed=0,
            drop_last=True, fused=True,
        )
        va = SampledNodeLoader(
            g, labels, batch_size=128, fanout=(8, 8), seed=1,
            shuffle=False, fused=True,
        )
        trainer = Trainer(
            NodeGCN(in_channels=5, hidden_dim=32, num_layers=2), seed=0
        )
        hist = trainer.fit(tr, va, num_epochs=4, patience=10, verbose=False)
        assert hist["train_loss"][-1] < hist["train_loss"][0]
        assert hist["val_acc"][-1] > 0.6
