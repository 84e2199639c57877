"""Neighbor sampling tests."""

import numpy as np
import pytest

from connectome_gnn_jax.data import generate_connectome
from connectome_gnn_jax.data.sampling import sample_subgraph


@pytest.fixture(scope="module")
def graph():
    return generate_connectome(num_regions=100, k=10, seed=5)


class TestSampleSubgraph:
    def test_seeds_come_first(self, graph):
        sub, ids = sample_subgraph(graph, [3, 7, 11], fanout=[5, 5],
                                   rng=np.random.default_rng(0))
        assert ids[:3].tolist() == [3, 7, 11]

    def test_features_relabeled_consistently(self, graph):
        sub, ids = sample_subgraph(graph, [0, 1], fanout=[4],
                                   rng=np.random.default_rng(1))
        np.testing.assert_allclose(sub.node_features, graph.node_features[ids])

    def test_edges_exist_in_original(self, graph):
        sub, ids = sample_subgraph(graph, [2], fanout=[6, 6],
                                   rng=np.random.default_rng(2))
        orig = set(zip(graph.edge_index[0].tolist(), graph.edge_index[1].tolist()))
        for s, d in zip(sub.edge_index[0], sub.edge_index[1]):
            assert (int(ids[s]), int(ids[d])) in orig

    def test_fanout_bounds_edges_per_hop(self, graph):
        fanout = 3
        sub, ids = sample_subgraph(graph, [0], fanout=[fanout],
                                   rng=np.random.default_rng(3))
        # one hop from one seed → at most `fanout` sampled in-edges
        assert sub.num_edges <= fanout
        assert len(ids) <= 1 + fanout

    def test_zero_hop(self, graph):
        sub, ids = sample_subgraph(graph, [5], fanout=[],
                                   rng=np.random.default_rng(4))
        assert len(ids) == 1
        assert sub.num_edges == 0

    def test_duplicate_seeds_deduped(self, graph):
        sub, ids = sample_subgraph(graph, [5, 5, 5], fanout=[2],
                                   rng=np.random.default_rng(5))
        assert (ids == 5).sum() == 1


class TestProfiling:
    def test_trace_writes_profile(self, tmp_path):
        import jax.numpy as jnp

        from connectome_gnn_jax.utils.profiling import StepTimer, trace

        with trace(str(tmp_path)):
            x = jnp.ones((64, 64)) @ jnp.ones((64, 64))
            x.block_until_ready()
        import os

        produced = []
        for root, _, files in os.walk(tmp_path):
            produced += files
        assert produced  # a trace artifact was written

    def test_step_timer_summary(self):
        from connectome_gnn_jax.utils.profiling import StepTimer

        t = StepTimer()
        for _ in range(3):
            t.tic()
            t.toc()
        s = t.summary()
        assert s["steps"] == 3
        assert s["total_s"] >= 0
        import pytest as _pytest

        with _pytest.raises(RuntimeError):
            t.toc()


class TestNativeSampler:
    """sample_subgraph_fast: same contract as sample_subgraph, C++ loop."""

    def _graph(self, n=400, seed=21):
        from connectome_gnn_jax.data import generate_spatial_graph

        return generate_spatial_graph(n, degree=8, band=60, seed=seed,
                                      shortcut_frac=0.1)

    def test_structural_invariants(self):
        from connectome_gnn_jax.data import sample_subgraph_fast

        g = self._graph()
        seeds = [3, 17, 17, 250]  # duplicate collapses like the numpy path
        fanout = [4, 4]
        sub, node_ids = sample_subgraph_fast(g, seeds, fanout, seed=7)
        # seeds first, deduplicated, in order
        assert list(node_ids[:3]) == [3, 17, 250]
        assert len(set(node_ids.tolist())) == len(node_ids)
        assert sub.num_nodes == len(node_ids)
        # every edge valid and within the reached set
        assert sub.edge_index.min() >= 0
        assert sub.edge_index.max() < sub.num_nodes
        # per-receiver kept in-edges bounded by the uniform fanout
        counts = np.bincount(sub.edge_index[1], minlength=sub.num_nodes)
        assert counts.max() <= 4
        # kept edges carry the original weights
        assert np.isfinite(sub.edge_weight).all()

    def test_deterministic_by_seed(self):
        from connectome_gnn_jax.data import sample_subgraph_fast

        g = self._graph()
        a1, n1 = sample_subgraph_fast(g, [5, 9], [3, 3], seed=11)
        a2, n2 = sample_subgraph_fast(g, [5, 9], [3, 3], seed=11)
        np.testing.assert_array_equal(n1, n2)
        np.testing.assert_array_equal(a1.edge_index, a2.edge_index)
        b, _ = sample_subgraph_fast(g, [5, 9], [3, 3], seed=12)
        assert b.num_edges != a1.num_edges or not np.array_equal(
            b.edge_index, a1.edge_index
        )

    def test_small_fanout_subsets_full_expansion(self):
        """With fanout >= max degree, fast and numpy paths must reach the
        exact same subgraph (no sampling happens → no RNG dependence)."""
        from connectome_gnn_jax.data import sample_subgraph, sample_subgraph_fast

        g = self._graph(n=200)
        big = [100, 100]  # > max in-degree → keep everything reachable
        sub_np, ids_np = sample_subgraph(g, [0, 50], big)
        sub_c, ids_c = sample_subgraph_fast(g, [0, 50], big, seed=0)
        assert sorted(ids_np.tolist()) == sorted(ids_c.tolist())
        assert sub_np.num_edges == sub_c.num_edges

    def test_speedup_on_giant_graph(self):
        import time

        from connectome_gnn_jax import native

        if not native.AVAILABLE:
            pytest.skip("native library not built — fast path == numpy path")

        from connectome_gnn_jax.data import (
            generate_spatial_graph, sample_subgraph, sample_subgraph_fast)

        g = generate_spatial_graph(100_000, degree=12, band=200, seed=2)
        seeds = list(range(0, 100_000, 50))  # 2000 seeds
        fanout = [8, 8]

        def t_fast():
            t0 = time.perf_counter()
            sample_subgraph_fast(g, seeds, fanout, seed=1)
            return time.perf_counter() - t0

        def t_np():
            t0 = time.perf_counter()
            sample_subgraph(g, seeds, fanout, np.random.default_rng(1))
            return time.perf_counter() - t0

        fast = min(t_fast() for _ in range(2))
        slow = min(t_np() for _ in range(2))
        assert fast * 1.5 < slow  # typically ≫2×

    def test_neighbor_sampler_amortizes_and_matches_one_shot(self):
        from connectome_gnn_jax.data import NeighborSampler, sample_subgraph_fast

        g = self._graph()
        sampler = NeighborSampler(g)
        a, ids_a = sampler.sample([1, 2, 3], [4, 4], seed=9)
        b, ids_b = sample_subgraph_fast(g, [1, 2, 3], [4, 4], seed=9)
        np.testing.assert_array_equal(ids_a, ids_b)
        np.testing.assert_array_equal(a.edge_index, b.edge_index)
        # repeated samples from one sampler differ by seed
        c, _ = sampler.sample([1, 2, 3], [4, 4], seed=10)
        assert not np.array_equal(a.edge_index, c.edge_index) or a.num_edges != c.num_edges
