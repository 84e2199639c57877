"""Locality-recovery pipeline: plan_layout / build_layout / auto_layout.

The adversarial contract (VERDICT r2 #4): a giant graph arrives with
SCRAMBLED node ids; the pipeline must rediscover the latent band via RCM,
split band + remainder by the measured cost model, and the materialized
layout must be numerically identical to the COO oracle through the
permutation.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from connectome_gnn_jax.data import generate_spatial_graph
from connectome_gnn_jax.data.graph import ConnectomeGraph
from connectome_gnn_jax.data.layout import (
    auto_layout,
    build_layout,
    plan_layout,
)
from connectome_gnn_jax.data.reorder import apply_ordering
from connectome_gnn_jax.ops.banded import (
    BandedMatrix,
    HybridMatrix,
    banded_spmm,
    hybrid_spmm,
)
from connectome_gnn_jax.ops.segment import coo_spmm


def _scramble(graph: ConnectomeGraph, seed: int = 7) -> tuple[ConnectomeGraph, np.ndarray]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(graph.num_nodes)  # perm[new] = old
    return apply_ordering(graph, perm), perm


def _spmm_any(adj, x, num_nodes):
    if isinstance(adj, BandedMatrix):
        return banded_spmm(adj, x)
    if isinstance(adj, HybridMatrix):
        return hybrid_spmm(adj, x)
    s, r, w = adj
    return coo_spmm(w, s, r, x, num_nodes, indices_are_sorted=True)


def _coo_oracle(graph, x):
    s, r = graph.edge_index
    order = np.argsort(r, kind="stable")
    return coo_spmm(
        jnp.asarray(graph.edge_weight[order]),
        jnp.asarray(s[order].astype(np.int32)),
        jnp.asarray(r[order].astype(np.int32)),
        x, graph.num_nodes, indices_are_sorted=True,
    )


class TestPlanLayout:
    # Degree 16, as in the config-5 graphs: at degree 8 a 128-node block
    # band holds so few edges per tile that, at the default (measured)
    # costs, scattering them is as cheap as streaming the tiles, and the
    # planner rightly leaves edges in the remainder.
    def test_scrambled_band_recovers_locality(self):
        g = generate_spatial_graph(4096, degree=16, band=128, seed=0)
        gs, _ = _scramble(g)
        plan = plan_layout(
            gs.edge_index[0], gs.edge_index[1], gs.num_nodes, block=128
        )
        assert plan.format in ("banded", "hybrid")
        assert plan.reordered
        # RCM must crush the scrambled bandwidth back to near-band scale
        assert plan.bandwidth_after < plan.bandwidth_before / 4
        assert plan.remainder_frac < 0.05

    def test_small_world_picks_hybrid_and_reports_remainder(self):
        g = generate_spatial_graph(
            4096, degree=16, band=128, seed=1, shortcut_frac=0.1
        )
        gs, _ = _scramble(g)
        plan = plan_layout(
            gs.edge_index[0], gs.edge_index[1], gs.num_nodes, block=128
        )
        assert plan.format == "hybrid"
        # the ~10% uniform shortcuts cannot be banded; the band bulk can
        assert 0.0 < plan.remainder_frac < 0.35

    def test_uniform_random_graph_stays_coo(self):
        # NOTE the scale: at a few thousand nodes a near-dense band
        # legitimately beats scatter (426 us of edge latency vs ~250 us
        # of bandwidth — the same physics that makes config 3 dense).
        # COO only wins when the graph is big AND sparse enough that no
        # affordable band captures meaningful edge mass.
        rng = np.random.default_rng(3)
        n, e = 131072, 524288
        s = rng.integers(0, n, e)
        r = rng.integers(0, n, e)
        plan = plan_layout(s, r, n, block=128)
        assert plan.format == "coo"
        assert plan.remainder_frac == 1.0
        assert not plan.reordered
        np.testing.assert_array_equal(plan.perm, np.arange(n))

    def test_band_budget_is_respected(self):
        g = generate_spatial_graph(4096, degree=8, band=128, seed=0)
        gs, _ = _scramble(g)
        # a budget too small for even the diagonal blocks forces coo
        plan = plan_layout(
            gs.edge_index[0], gs.edge_index[1], gs.num_nodes, block=128,
            max_band_gb=1e-6,
        )
        assert plan.format == "coo"

    def test_quantized_pricing_still_valid(self):
        g = generate_spatial_graph(
            4096, degree=8, band=128, seed=2, shortcut_frac=0.05
        )
        gs, _ = _scramble(g)
        plan = plan_layout(
            gs.edge_index[0], gs.edge_index[1], gs.num_nodes, block=128,
            quantized=True,
        )
        assert plan.format in ("banded", "hybrid")
        # int8 pricing makes band traffic 4x cheaper: the chosen width
        # can only grow (weakly) vs f32 pricing
        plan_f32 = plan_layout(
            gs.edge_index[0], gs.edge_index[1], gs.num_nodes, block=128
        )
        assert plan.bandwidth >= plan_f32.bandwidth

    def test_already_ordered_graph_keeps_identity(self):
        g = generate_spatial_graph(2048, degree=8, band=128, seed=4)
        plan = plan_layout(
            g.edge_index[0], g.edge_index[1], g.num_nodes, block=128
        )
        assert plan.format in ("banded", "hybrid")
        # identity ordering is already optimal-ish; whatever wins, the
        # bandwidth must not blow up
        assert plan.bandwidth_after <= max(plan.bandwidth_before, 1)


class TestSpectralOrdering:
    def test_valid_permutation_and_beats_rcm_on_small_world(self):
        from connectome_gnn_jax.data.reorder import (
            reverse_cuthill_mckee,
            spectral_ordering,
        )

        g = generate_spatial_graph(
            8192, degree=8, band=256, seed=9, shortcut_frac=0.1
        )
        gs, _ = _scramble(g)
        ei = np.stack([gs.edge_index[0], gs.edge_index[1]])

        def rem_frac(perm, W=4, block=128):
            inv = np.empty_like(perm)
            inv[perm] = np.arange(gs.num_nodes)
            s, r = inv[gs.edge_index[0]], inv[gs.edge_index[1]]
            return float((np.abs(s // block - r // block) > W).mean())

        sp_perm = spectral_ordering(ei, gs.num_nodes, gs.edge_weight)
        assert sorted(sp_perm) == list(range(gs.num_nodes))
        rcm_perm = reverse_cuthill_mckee(ei, gs.num_nodes)
        # RCM's BFS is teleported by the shortcuts; the reweighted
        # spectral ordering must leave far less mass out of band
        assert rem_frac(sp_perm) < rem_frac(rcm_perm) / 2

    def test_components_stay_contiguous(self):
        from connectome_gnn_jax.data.reorder import spectral_ordering

        # two disjoint rings of 64
        n = 128
        ring = np.arange(64)
        s = np.concatenate([ring, ring + 64])
        r = np.concatenate([(ring + 1) % 64, (ring + 1) % 64 + 64])
        perm = spectral_ordering(np.stack([s, r]), n)
        assert sorted(perm) == list(range(n))
        first_half = set(perm[:64])
        assert first_half in (set(range(64)), set(range(64, 128)))

    def test_relax_solver_matches_lobpcg_oracle_quality(self):
        # the default fixed-budget relaxation must recover at least as
        # much bandable mass as the (7x slower) LOBPCG eigensolve it
        # replaced -- both judged by out-of-band fraction, the quantity
        # plan_layout's cost model prices
        from connectome_gnn_jax.data.reorder import spectral_ordering

        g = generate_spatial_graph(
            8192, degree=8, band=256, seed=9, shortcut_frac=0.1
        )
        gs, _ = _scramble(g)
        ei = np.stack([gs.edge_index[0], gs.edge_index[1]])

        def rem_frac(perm, W=4, block=128):
            inv = np.empty_like(perm)
            inv[perm] = np.arange(gs.num_nodes)
            s, r = inv[gs.edge_index[0]], inv[gs.edge_index[1]]
            return float((np.abs(s // block - r // block) > W).mean())

        relax = min(
            rem_frac(p)
            for p in spectral_ordering(
                ei, gs.num_nodes, gs.edge_weight, return_iterates=True
            )
        )
        lobpcg = min(
            rem_frac(p)
            for p in spectral_ordering(
                ei, gs.num_nodes, gs.edge_weight, return_iterates=True,
                solver="lobpcg",
            )
        )
        # small-scale gap accepted: at 8k the converged eigensolve can
        # edge out the fixed smoothing budget by a few points of
        # remainder; at the scale the solver exists for (262k+) relax
        # measured BETTER (0.509 vs 0.547).  Guard against regression to
        # RCM-level failure (~0.8), not against the last few points.
        assert relax <= lobpcg + 0.08

    def test_iterates_are_all_valid(self):
        from connectome_gnn_jax.data.reorder import spectral_ordering

        g = generate_spatial_graph(2048, degree=8, band=128, seed=10,
                                   shortcut_frac=0.1)
        gs, _ = _scramble(g)
        iterates = spectral_ordering(
            np.stack([gs.edge_index[0], gs.edge_index[1]]),
            gs.num_nodes, gs.edge_weight, return_iterates=True,
        )
        assert len(iterates) == 4  # plain fiedler + 3 IRLS rounds
        for p in iterates:
            assert sorted(p) == list(range(gs.num_nodes))


class TestBuildAndAutoLayout:
    @pytest.mark.parametrize("shortcut_frac", [0.0, 0.1])
    def test_layout_matches_coo_oracle_through_perm(self, shortcut_frac):
        g = generate_spatial_graph(
            2048, degree=8, band=128, seed=5, shortcut_frac=shortcut_frac
        )
        gs, _ = _scramble(g)
        x = jnp.asarray(
            np.random.default_rng(0).standard_normal((gs.num_nodes, 16)),
            jnp.float32,
        )
        ref = _coo_oracle(gs, x)

        adj, g2, plan = auto_layout(gs, block=128, feat=16)
        out = _spmm_any(adj, x[plan.perm], gs.num_nodes)
        np.testing.assert_allclose(
            np.asarray(out), np.asarray(ref)[plan.perm], rtol=2e-5, atol=2e-5
        )
        # reordered graph is consistent with the permutation
        np.testing.assert_allclose(
            g2.node_features, gs.node_features[plan.perm]
        )

    def test_build_layout_coo_roundtrip(self):
        rng = np.random.default_rng(6)
        n, e = 131072, 262144
        s = rng.integers(0, n, e)
        r = rng.integers(0, n, e)
        w = rng.random(e).astype(np.float32)
        plan = plan_layout(s, r, n, block=128)
        assert plan.format == "coo"
        ss, rr, ww = build_layout(plan, s, r, w, n)
        x = jnp.asarray(rng.standard_normal((n, 8)), jnp.float32)
        out = coo_spmm(
            jnp.asarray(ww), jnp.asarray(ss), jnp.asarray(rr), x, n,
            indices_are_sorted=True,
        )
        order = np.argsort(r, kind="stable")
        ref = coo_spmm(
            jnp.asarray(w[order]),
            jnp.asarray(s[order].astype(np.int32)),
            jnp.asarray(r[order].astype(np.int32)),
            x, n, indices_are_sorted=True,
        )
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-6)

    def test_est_us_table_present_and_ordered(self):
        g = generate_spatial_graph(2048, degree=8, band=128, seed=8)
        gs, _ = _scramble(g)
        plan = plan_layout(
            gs.edge_index[0], gs.edge_index[1], gs.num_nodes, block=128
        )
        assert plan.est_us["chosen"] <= plan.est_us["coo"] + 1e-9
        assert plan.est_us["chosen"] > 0
