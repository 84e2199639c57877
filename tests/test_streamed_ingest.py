"""Streamed per-shard ingest: COO → shard slabs without a full band.

The contract is *bitwise equality* with the materialize-then-slice path
(``to_banded``/``to_hybrid`` → ``partition_banded``/``partition_hybrid``):
the native ``cgt_band_pack_range`` visits edges in the same order as the
full-band pack, so every slab cell accumulates identically.
"""

import numpy as np
import pytest

from connectome_gnn_jax.data import generate_spatial_graph
from connectome_gnn_jax.ops import to_banded, to_hybrid
from connectome_gnn_jax.parallel import (
    hybrid_remainder_capacities,
    partition_banded,
    partition_banded_from_coo,
    partition_hybrid,
    partition_hybrid_from_coo,
)


def _coo(seed=3, n=768, shortcut_frac=0.0):
    g = generate_spatial_graph(
        n, degree=6, band=40, seed=seed, shortcut_frac=shortcut_frac
    )
    labels = (g.degree() > np.median(g.degree())).astype(np.int32)
    return g, labels


def _assert_tree_equal(a, b):
    import jax

    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


class TestBandedFromCoo:
    def test_bitwise_vs_materialized(self, cpu_devices):
        g, labels = _coo()
        s, r, w = g.edge_index[0], g.edge_index[1], g.edge_weight
        a = to_banded(s, r, w, g.num_nodes, block=32)
        want = partition_banded(a, g.node_features, 8, labels=labels)
        got = partition_banded_from_coo(
            s, r, w, g.node_features, g.num_nodes, 8,
            block=32, labels=labels,
        )
        assert got.bandwidth == a.bandwidth
        _assert_tree_equal(got, want)

    def test_shard_range_slab_only(self, cpu_devices):
        """A (lo, hi) range materializes exactly those shards' slabs."""
        g, labels = _coo(seed=9)
        s, r, w = g.edge_index[0], g.edge_index[1], g.edge_weight
        a = to_banded(s, r, w, g.num_nodes, block=32)
        full = partition_banded(a, g.node_features, 8, labels=labels)
        part = partition_banded_from_coo(
            s, r, w, g.node_features, g.num_nodes, 8,
            block=32, labels=labels, shard_range=(2, 5),
        )
        assert part.band.shape[0] == 3
        np.testing.assert_array_equal(
            np.asarray(part.band), np.asarray(full.band)[2:5]
        )
        np.testing.assert_array_equal(
            np.asarray(part.node_features), np.asarray(full.node_features)[2:5]
        )

    def test_numpy_fallback_matches_native(self, cpu_devices, monkeypatch):
        from connectome_gnn_jax import native

        if not native.AVAILABLE:
            pytest.skip("no native library to compare against")
        g, labels = _coo(seed=5)
        s, r, w = g.edge_index[0], g.edge_index[1], g.edge_weight
        with_native = partition_banded_from_coo(
            s, r, w, g.node_features, g.num_nodes, 4, block=32
        )
        monkeypatch.setattr(native, "AVAILABLE", False)
        without = partition_banded_from_coo(
            s, r, w, g.node_features, g.num_nodes, 4, block=32
        )
        _assert_tree_equal(with_native, without)

    def test_explicit_bandwidth_validation(self, cpu_devices):
        g, _ = _coo(seed=5)
        s, r, w = g.edge_index[0], g.edge_index[1], g.edge_weight
        with pytest.raises(ValueError, match="outside band"):
            partition_banded_from_coo(
                s, r, w, g.node_features, g.num_nodes, 4,
                block=32, bandwidth=0,
            )


class TestHybridFromCoo:
    def test_bitwise_vs_materialized(self, cpu_devices):
        g, labels = _coo(seed=41, shortcut_frac=0.15)
        s, r, w = g.edge_index[0], g.edge_index[1], g.edge_weight
        h = to_hybrid(s, r, w, g.num_nodes, block=32, bandwidth=2)
        want = partition_hybrid(h, g.node_features, 8, labels=labels)
        got = partition_hybrid_from_coo(
            s, r, w, g.node_features, g.num_nodes, 8,
            block=32, bandwidth=2, labels=labels,
        )
        _assert_tree_equal(got, want)

    def test_shard_range(self, cpu_devices):
        g, labels = _coo(seed=13, shortcut_frac=0.15)
        s, r, w = g.edge_index[0], g.edge_index[1], g.edge_weight
        h = to_hybrid(s, r, w, g.num_nodes, block=32, bandwidth=2)
        full = partition_hybrid(h, g.node_features, 8, labels=labels)
        part = partition_hybrid_from_coo(
            s, r, w, g.node_features, g.num_nodes, 8,
            block=32, bandwidth=2, labels=labels, shard_range=(1, 3),
        )
        np.testing.assert_array_equal(
            np.asarray(part.rem_weights), np.asarray(full.rem_weights)[1:3]
        )
        np.testing.assert_array_equal(
            np.asarray(part.send_idx), np.asarray(full.send_idx)[1:3]
        )
        np.testing.assert_array_equal(
            np.asarray(part.band), np.asarray(full.band)[1:3]
        )

    def test_capacity_probe_matches_partition(self, cpu_devices):
        """The metadata-only probe predicts exactly the static shapes the
        full partition derives (what the cohort path relies on)."""
        for seed in (41, 13, 7):
            g, labels = _coo(seed=seed, shortcut_frac=0.15)
            h = to_hybrid(
                g.edge_index[0], g.edge_index[1], g.edge_weight,
                g.num_nodes, block=32, bandwidth=2,
            )
            ph = partition_hybrid(h, g.node_features, 8, labels=labels)
            e_cap, u_cap = hybrid_remainder_capacities(h, 8)
            assert e_cap == ph.rem_weights.shape[-1]
            assert u_cap == ph.send_idx.shape[-1]
