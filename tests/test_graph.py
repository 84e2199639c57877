"""Graph container and collation tests (modeled on reference tests/test_graph.py)."""

import numpy as np
import pytest

from connectome_gnn_jax.data import (
    ConnectomeBatch,
    ConnectomeDataLoader,
    ConnectomeGraph,
    collate_graphs,
)


def make_simple_graph(num_nodes=5, num_pairs=6, num_features=3, label=0, seed=0):
    """Random bidirectional graph with symmetric weights."""
    rng = np.random.default_rng(seed)
    features = rng.normal(size=(num_nodes, num_features)).astype(np.float32)
    all_pairs = [(u, v) for u in range(num_nodes) for v in range(u + 1, num_nodes)]
    chosen = rng.choice(len(all_pairs), size=min(num_pairs, len(all_pairs)), replace=False)
    src = np.array([all_pairs[i][0] for i in chosen])
    dst = np.array([all_pairs[i][1] for i in chosen])
    w = rng.random(len(chosen)).astype(np.float32)
    edge_index = np.array(
        [np.concatenate([src, dst]), np.concatenate([dst, src])], dtype=np.int32
    )
    edge_weight = np.concatenate([w, w])
    return ConnectomeGraph(
        node_features=features,
        edge_index=edge_index,
        edge_weight=edge_weight,
        label=label,
        subject_id=f"test-{seed}",
    )


class TestConnectomeGraph:
    def test_shape_properties(self):
        g = make_simple_graph(num_nodes=7, num_pairs=4, num_features=2)
        assert g.num_nodes == 7
        assert g.num_edges == 8
        assert g.num_features == 2

    def test_adjacency_symmetric(self):
        g = make_simple_graph(seed=1)
        A = g.adjacency_matrix()
        assert np.allclose(A, A.T)

    def test_degree_matches_adjacency(self):
        g = make_simple_graph(seed=2)
        # With duplicate random edges adjacency assignment overwrites, so
        # compare degree against an explicit sum over the edge list instead.
        deg = np.zeros(g.num_nodes, dtype=np.float32)
        np.add.at(deg, g.edge_index[0], g.edge_weight)
        assert np.allclose(g.degree(), deg)

    def test_validation(self):
        with pytest.raises(ValueError):
            ConnectomeGraph(
                node_features=np.zeros((3, 2), np.float32),
                edge_index=np.zeros((3, 4), np.int32),
                edge_weight=np.zeros(4, np.float32),
            )


class TestCollate:
    def test_packed_shapes(self):
        graphs = [make_simple_graph(num_nodes=5, seed=s, label=s % 2) for s in range(3)]
        batch = collate_graphs(graphs, node_multiple=1, edge_multiple=1)
        assert isinstance(batch, ConnectomeBatch)
        assert batch.num_graphs == 3
        assert batch.node_features.shape == (15, 3)
        assert int(batch.node_mask.sum()) == 15
        assert int(batch.edge_mask.sum()) == sum(g.num_edges for g in graphs)

    def test_graph_ids_in_range(self):
        graphs = [make_simple_graph(seed=s) for s in range(4)]
        batch = collate_graphs(graphs)
        gids = np.asarray(batch.node_graph_ids)
        mask = np.asarray(batch.node_mask)
        assert gids[mask].min() == 0
        assert gids[mask].max() == 3
        # padding rows carry the one-past-the-end id
        assert (gids[~mask] == 4).all()

    def test_ptr_cumulative(self):
        graphs = [make_simple_graph(num_nodes=n, seed=n) for n in (3, 5, 2)]
        batch = collate_graphs(graphs)
        assert np.asarray(batch.ptr).tolist() == [0, 3, 8, 10]

    def test_edge_offsetting(self):
        graphs = [make_simple_graph(num_nodes=5, seed=s) for s in range(2)]
        batch = collate_graphs(graphs, node_multiple=1, edge_multiple=1)
        senders = np.asarray(batch.senders)
        receivers = np.asarray(batch.receivers)
        gids = np.asarray(batch.node_graph_ids)
        mask = np.asarray(batch.edge_mask)
        # every real edge stays within its own graph's node block
        assert (gids[senders[mask]] == gids[receivers[mask]]).all()
        second_graph_edges = gids[receivers[mask]] == 1
        assert receivers[mask][second_graph_edges].min() >= 5

    def test_edges_sorted_by_receiver(self):
        graphs = [make_simple_graph(seed=s) for s in range(3)]
        batch = collate_graphs(graphs)
        receivers = np.asarray(batch.receivers)
        mask = np.asarray(batch.edge_mask)
        real = receivers[mask]
        assert (np.diff(real) >= 0).all()

    def test_row_ptr_is_csr_indptr(self):
        graphs = [make_simple_graph(seed=s) for s in range(2)]
        batch = collate_graphs(graphs)
        receivers = np.asarray(batch.receivers)
        mask = np.asarray(batch.edge_mask)
        row_ptr = np.asarray(batch.row_ptr)
        P = batch.num_nodes
        assert row_ptr.shape == (P + 1,)
        assert row_ptr[-1] == mask.sum()
        counts = np.bincount(receivers[mask], minlength=P)
        assert np.array_equal(np.diff(row_ptr), counts)

    def test_padding_is_inert(self):
        graphs = [make_simple_graph(seed=0)]
        batch = collate_graphs(graphs, node_budget=64, edge_budget=256)
        assert batch.num_nodes == 64
        assert batch.num_edges == 256
        w = np.asarray(batch.edge_weight)
        mask = np.asarray(batch.edge_mask)
        assert (w[~mask] == 0).all()
        feats = np.asarray(batch.node_features)
        nmask = np.asarray(batch.node_mask)
        assert (feats[~nmask] == 0).all()

    def test_labels_and_mask(self):
        graphs = [make_simple_graph(seed=s, label=s % 2) for s in range(3)]
        batch = collate_graphs(graphs, num_graphs=5)
        labels = np.asarray(batch.labels)
        lmask = np.asarray(batch.label_mask)
        assert labels[:3].tolist() == [0, 1, 0]
        assert lmask.tolist() == [True, True, True, False, False]


class TestLoader:
    def test_batch_count(self):
        graphs = [make_simple_graph(seed=s) for s in range(10)]
        loader = ConnectomeDataLoader(graphs, batch_size=4, shuffle=False)
        assert len(loader) == 3
        batches = list(loader)
        assert len(batches) == 3

    def test_fixed_shapes_across_batches(self):
        graphs = [make_simple_graph(num_nodes=3 + s % 4, seed=s) for s in range(10)]
        loader = ConnectomeDataLoader(graphs, batch_size=4, shuffle=False)
        shapes = {
            (b.num_nodes, b.num_edges, b.num_graphs) for b in loader
        }
        assert len(shapes) == 1  # one compiled shape for the whole epoch

    def test_graph_total_conserved(self):
        graphs = [make_simple_graph(seed=s) for s in range(10)]
        loader = ConnectomeDataLoader(graphs, batch_size=4, shuffle=True, seed=1)
        total = sum(int(np.asarray(b.label_mask).sum()) for b in loader)
        assert total == 10

    def test_shuffle_changes_order_between_epochs(self):
        graphs = [make_simple_graph(seed=s, label=s % 2) for s in range(16)]
        loader = ConnectomeDataLoader(graphs, batch_size=8, shuffle=True, seed=0)
        epoch1 = [np.asarray(b.labels).tolist() for b in loader]
        epoch2 = [np.asarray(b.labels).tolist() for b in loader]
        assert epoch1 != epoch2

    def test_drop_last(self):
        graphs = [make_simple_graph(seed=s) for s in range(10)]
        loader = ConnectomeDataLoader(graphs, batch_size=4, drop_last=True)
        assert len(loader) == 2
        assert len(list(loader)) == 2


class TestPrefetch:
    def test_prefetch_yields_same_batches(self):
        from connectome_gnn_jax.data.prefetch import PrefetchLoader

        graphs = [make_simple_graph(seed=s, label=s % 2) for s in range(12)]
        loader = ConnectomeDataLoader(graphs, batch_size=4, shuffle=False)
        plain = [np.asarray(b.labels).tolist() for b in loader]
        wrapped = PrefetchLoader(
            ConnectomeDataLoader(graphs, batch_size=4, shuffle=False), depth=2
        )
        assert len(wrapped) == 3
        prefetched = [np.asarray(b.labels).tolist() for b in wrapped]
        assert plain == prefetched
        # second epoch works (fresh producer per iter)
        assert [np.asarray(b.labels).tolist() for b in wrapped] == plain

    def test_prefetch_propagates_errors(self):
        from connectome_gnn_jax.data.prefetch import PrefetchIterator

        def bad():
            yield 1
            raise RuntimeError("boom")

        it = PrefetchIterator(bad(), depth=1)
        assert next(it) == 1
        import pytest as _pytest

        with _pytest.raises(RuntimeError, match="boom"):
            next(it)

    def test_prefetch_exhaustion_and_abandonment(self):
        from connectome_gnn_jax.data.prefetch import PrefetchIterator

        graphs = [make_simple_graph(seed=s) for s in range(4)]
        loader = ConnectomeDataLoader(graphs, batch_size=2, shuffle=False)
        it = PrefetchIterator(loader, depth=1)
        list(it)
        import pytest as _pytest

        with _pytest.raises(StopIteration):  # must not hang
            next(it)
        with _pytest.raises(StopIteration):
            next(it)

        # abandoning early must unblock the producer thread
        it2 = PrefetchIterator(ConnectomeDataLoader(graphs, batch_size=1, shuffle=False), depth=1)
        next(it2)
        it2.close()
        assert not it2._thread.is_alive()


class TestIO:
    def test_graph_from_adjacency(self):
        A = np.array([[0, 0.5, 0], [0.5, 0, 0.2], [0, 0.2, 0]], np.float32)
        from connectome_gnn_jax.data import graph_from_adjacency

        g = graph_from_adjacency(A, label=1, subject_id="s1")
        assert g.num_nodes == 3
        assert g.num_edges == 4  # two undirected pairs, both directions
        assert np.allclose(g.adjacency_matrix(), A)
        assert g.num_features == 1  # default degree feature
        assert g.label == 1

    def test_graph_from_adjacency_threshold(self):
        from connectome_gnn_jax.data import graph_from_adjacency

        A = np.array([[0, 0.5], [0.05, 0]], np.float32)
        g = graph_from_adjacency(A, threshold=0.1)
        assert g.num_edges == 1

    def test_dataset_roundtrip(self, tmp_path):
        from connectome_gnn_jax.data import load_dataset, save_dataset

        graphs = [make_simple_graph(num_nodes=4 + s, seed=s, label=s % 2) for s in range(3)]
        graphs[1].label = None
        path = str(tmp_path / "cohort")
        save_dataset(path, graphs)
        loaded = load_dataset(path)
        assert len(loaded) == 3
        for a, b in zip(graphs, loaded):
            assert np.allclose(a.node_features, b.node_features)
            assert np.array_equal(a.edge_index, b.edge_index)
            assert a.label == b.label
            assert a.subject_id == b.subject_id


class TestToDevice:
    def test_to_device_roundtrip(self):
        import jax
        from connectome_gnn_jax.data import to_device

        graphs = [make_simple_graph(seed=s) for s in range(2)]
        batch = collate_graphs(graphs)
        moved = to_device(batch, jax.devices()[0])
        assert moved.num_graphs == batch.num_graphs
        np.testing.assert_allclose(
            np.asarray(moved.node_features), np.asarray(batch.node_features)
        )
