"""Synthetic generator tests (modeled on reference tests/test_synthetic.py)."""

import numpy as np
import pytest

from connectome_gnn_jax.data import (
    NUM_REGIONS,
    REGION_NAMES,
    ConnectomeGraph,
    generate_connectome,
    generate_dataset,
    small_world_stats,
)


class TestGenerateConnectome:
    def test_returns_graph(self):
        g = generate_connectome(seed=0)
        assert isinstance(g, ConnectomeGraph)

    def test_shapes(self):
        g = generate_connectome(num_regions=50, k=6, seed=1)
        assert g.num_nodes == 50
        assert g.num_features == 5
        assert g.edge_index.shape == (2, g.num_edges)
        assert g.edge_weight.shape == (g.num_edges,)

    def test_edge_weights_in_unit_interval(self):
        g = generate_connectome(seed=2)
        assert g.edge_weight.min() >= 0.0
        assert g.edge_weight.max() <= 1.0

    def test_label_is_binary(self):
        for seed in range(5):
            g = generate_connectome(seed=seed)
            assert g.label in (0, 1)

    def test_same_seed_reproduces(self):
        a = generate_connectome(seed=123)
        b = generate_connectome(seed=123)
        assert np.array_equal(a.edge_index, b.edge_index)
        assert np.array_equal(a.edge_weight, b.edge_weight)
        assert np.allclose(a.node_features, b.node_features)
        assert a.label == b.label

    def test_different_seeds_differ(self):
        a = generate_connectome(seed=1)
        b = generate_connectome(seed=2)
        assert not np.allclose(a.node_features, b.node_features)

    def test_bidirectional_edges(self):
        g = generate_connectome(seed=3)
        pairs = set(zip(g.edge_index[0].tolist(), g.edge_index[1].tolist()))
        for u, v in list(pairs)[:50]:
            assert (v, u) in pairs

    def test_features_finite(self):
        g = generate_connectome(seed=4)
        assert np.isfinite(g.node_features).all()


class TestGenerateDataset:
    def test_size_and_type(self):
        graphs = generate_dataset(num_subjects=10, num_regions=30, seed=7)
        assert len(graphs) == 10
        assert all(isinstance(g, ConnectomeGraph) for g in graphs)

    def test_subject_ids(self):
        graphs = generate_dataset(num_subjects=3, num_regions=20, seed=7)
        assert [g.subject_id for g in graphs] == ["sub-0000", "sub-0001", "sub-0002"]

    def test_label_balance(self):
        graphs = generate_dataset(num_subjects=100, num_regions=30, seed=11)
        positives = sum(g.label for g in graphs)
        assert 5 < positives < 95

    def test_master_seed_reproduces(self):
        a = generate_dataset(num_subjects=5, num_regions=25, seed=3)
        b = generate_dataset(num_subjects=5, num_regions=25, seed=3)
        for ga, gb in zip(a, b):
            assert np.array_equal(ga.edge_index, gb.edge_index)
            assert np.allclose(ga.node_features, gb.node_features)


class TestSmallWorldStats:
    def test_keys_and_ranges(self):
        graphs = generate_dataset(num_subjects=5, num_regions=30, seed=5)
        stats = small_world_stats(graphs)
        assert set(stats) == {"mean_clustering", "mean_avg_path_length", "num_graphs"}
        assert 0.0 < stats["mean_clustering"] < 1.0
        assert stats["mean_avg_path_length"] > 1.0
        assert stats["num_graphs"] == 5


class TestAtlas:
    def test_atlas_consistent(self):
        assert len(REGION_NAMES) == NUM_REGIONS
        assert len(set(REGION_NAMES)) == NUM_REGIONS
