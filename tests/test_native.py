"""Native C++ host kernels: bitwise equivalence vs the numpy oracles.

Each native entry point replays its numpy reference's exact visit /
accumulation order, so the contract is *bitwise* identity — not allclose.
All tests skip when no toolchain built the library (CGT_NO_NATIVE=1 or
missing g++): the numpy paths are then the production code.
"""

import numpy as np
import pytest

from connectome_gnn_jax import native

pytestmark = pytest.mark.skipif(
    not native.AVAILABLE, reason="native library not built"
)


def _random_coo(n, e, seed, duplicates=True):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    if duplicates:  # force collisions so accumulation order matters
        src[: e // 10] = src[0]
        dst[: e // 10] = dst[0]
    w = rng.random(e, np.float32)
    return src, dst, w


class TestRCM:
    def _both(self, edge_index, n):
        from connectome_gnn_jax.data.reorder import (
            _rcm_numpy, reverse_cuthill_mckee)

        src = np.concatenate([edge_index[0], edge_index[1]]).astype(np.int64)
        dst = np.concatenate([edge_index[1], edge_index[0]]).astype(np.int64)
        order = np.argsort(dst, kind="stable")
        src_sorted = src[order]
        starts = np.searchsorted(dst[order], np.arange(n))
        ends = np.searchsorted(dst[order], np.arange(n), side="right")
        oracle = _rcm_numpy(n, src_sorted, starts, ends, ends - starts)
        return reverse_cuthill_mckee(edge_index, n), oracle

    def test_matches_numpy_random_graph(self):
        n = 500
        src, dst, _ = _random_coo(n, 3000, seed=0)
        got, oracle = self._both(np.stack([src, dst]), n)
        np.testing.assert_array_equal(got, oracle)

    def test_matches_numpy_disconnected_with_isolates(self):
        # two components + isolated nodes
        e1 = np.array([[0, 1, 2], [1, 2, 0]])
        e2 = np.array([[10, 11], [11, 12]])
        edge_index = np.concatenate([e1, e2], axis=1)
        got, oracle = self._both(edge_index, 20)
        np.testing.assert_array_equal(got, oracle)
        assert sorted(got) == list(range(20))

    def test_reduces_bandwidth(self):
        from connectome_gnn_jax.data.reorder import bandwidth

        rng = np.random.default_rng(3)
        # ring + a few chords, scrambled labels
        n = 256
        ring = np.stack([np.arange(n), (np.arange(n) + 1) % n])
        perm = rng.permutation(n)
        edge_index = perm[ring]
        from connectome_gnn_jax.data.reorder import reverse_cuthill_mckee

        p = reverse_cuthill_mckee(edge_index, n)
        inv = np.empty(n, np.int64)
        inv[p] = np.arange(n)
        assert bandwidth(inv[edge_index]) < bandwidth(edge_index)


class TestBandPack:
    def test_bitwise_vs_add_at(self):
        n, block, W = 512, 32, 3
        rng = np.random.default_rng(1)
        # edges confined to the band
        src = rng.integers(0, n, 5000)
        shift = rng.integers(-W * block, W * block + 1, 5000)
        dst = np.clip(src + shift, 0, n - 1)
        w = rng.random(5000, np.float32)

        nb = n // block
        rb = dst // block
        d = src // block - rb
        keep = np.abs(d) <= W
        src, dst, w, rb, d = src[keep], dst[keep], w[keep], rb[keep], d[keep]

        oracle = np.zeros((nb, 2 * W + 1, block, block), np.float32)
        np.add.at(oracle, (rb, d + W, dst % block, src % block), w)

        got = np.zeros_like(oracle)
        native.band_pack(src, dst, w, got, W)
        np.testing.assert_array_equal(got, oracle)

    def test_to_banded_uses_native(self):
        """End-to-end: to_banded output is identical regardless of path."""
        from connectome_gnn_jax.ops import to_banded

        n = 256
        rng = np.random.default_rng(2)
        src = rng.integers(0, n, 2000)
        dst = np.clip(src + rng.integers(-40, 41, 2000), 0, n - 1)
        w = rng.random(2000, np.float32)
        a = to_banded(src, dst, w, n, block=32)
        assert np.isclose(float(np.asarray(a.band).sum()), w.sum(), rtol=1e-5)


class TestDensePack:
    def test_bitwise_vs_add_at(self):
        n = 96
        src, dst, w = _random_coo(n, 4000, seed=4)
        oracle = np.zeros((n, n), np.float32)
        np.add.at(oracle, (dst, src), w)
        got = np.zeros((n, n), np.float32)
        native.dense_pack(src, dst, w, got)
        np.testing.assert_array_equal(got, oracle)

    def test_collate_dense_unchanged(self):
        """Dense collation (now native-packed) still matches per-graph
        dense adjacency built independently."""
        from connectome_gnn_jax.data import collate_dense, generate_dataset

        graphs = generate_dataset(num_subjects=4, num_regions=30, seed=5)
        batch = collate_dense(graphs)
        for b, g in enumerate(graphs):
            oracle = np.zeros((batch.adj.shape[1],) * 2, np.float32)
            np.add.at(oracle, (g.edge_index[1], g.edge_index[0]), g.edge_weight)
            np.testing.assert_array_equal(np.asarray(batch.adj[b]), oracle)


@pytest.mark.slow
class TestSpeed:
    def test_band_pack_speedup(self):
        """Native packing must beat np.add.at comfortably at giant scale."""
        import time

        n, block, W, e = 65536, 256, 2, 500_000
        rng = np.random.default_rng(6)
        src = rng.integers(0, n, e)
        dst = np.clip(src + rng.integers(-block, block + 1, e), 0, n - 1)
        keep = np.abs(src // block - dst // block) <= W
        src, dst = src[keep], dst[keep]
        w = rng.random(src.shape[0], np.float32)
        nb = n // block

        rb = dst // block
        d = src // block - rb
        # warm (pre-faulted) buffers + min-of-3 each: cold runs are
        # page-fault-bound for BOTH paths and single timings flake under
        # scheduler noise
        band = np.zeros((nb, 2 * W + 1, block, block), np.float32)
        oracle = np.zeros_like(band)

        def t_nat():
            band[:] = 0
            t0 = time.perf_counter()
            native.band_pack(src, dst, w, band, W)
            return time.perf_counter() - t0

        def t_np():
            oracle[:] = 0
            t0 = time.perf_counter()
            np.add.at(oracle, (rb, d + W, dst % block, src % block), w)
            return time.perf_counter() - t0

        t_native = min(t_nat() for _ in range(3))
        t_numpy = min(t_np() for _ in range(3))
        np.testing.assert_array_equal(band, oracle)
        # measured ~4-6× on this host; 1.5× margin absorbs noise
        assert t_native * 1.5 < t_numpy
