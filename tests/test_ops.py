"""Kernel-level tests: segment ops and GCN normalization vs numpy oracles."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from connectome_gnn_jax.ops import (
    coo_spmm,
    gcn_normalize,
    graph_mean_pool,
    segment_mean,
    segment_sum,
)


def np_segment_sum(data, ids, num_segments):
    out = np.zeros((num_segments,) + data.shape[1:], dtype=data.dtype)
    np.add.at(out, ids, data)
    return out


class TestSegmentOps:
    def test_segment_sum_matches_numpy(self):
        rng = np.random.default_rng(0)
        data = rng.normal(size=(50, 8)).astype(np.float32)
        ids = np.sort(rng.integers(0, 10, size=50)).astype(np.int32)
        out = segment_sum(jnp.asarray(data), jnp.asarray(ids), 10, indices_are_sorted=True)
        assert np.allclose(out, np_segment_sum(data, ids, 10), atol=1e-5)

    def test_out_of_range_ids_dropped(self):
        data = jnp.ones((4, 2), jnp.float32)
        ids = jnp.array([0, 1, 2, 2], jnp.int32)  # segment id 2 == num_segments
        out = segment_sum(data, ids, 2)
        assert np.allclose(out, [[1, 1], [1, 1]])

    def test_segment_mean_epsilon_denominator(self):
        # empty segment → 0 / (0 + 1e-8) = 0, matching reference models.py:47
        data = jnp.ones((2, 3), jnp.float32)
        ids = jnp.array([0, 0], jnp.int32)
        out = segment_mean(data, ids, 2)
        assert np.allclose(out[0], 1.0, atol=1e-5)
        assert np.allclose(out[1], 0.0)

    def test_graph_mean_pool(self):
        rng = np.random.default_rng(1)
        x = rng.normal(size=(12, 4)).astype(np.float32)
        gids = np.repeat([0, 1, 2], 4).astype(np.int32)
        out = graph_mean_pool(jnp.asarray(x), jnp.asarray(gids), 3)
        expected = x.reshape(3, 4, 4).mean(axis=1)
        assert np.allclose(out, expected, atol=1e-5)

    def test_coo_spmm_matches_dense(self):
        rng = np.random.default_rng(2)
        n, e, f = 16, 60, 8
        senders = rng.integers(0, n, size=e).astype(np.int32)
        receivers = np.sort(rng.integers(0, n, size=e)).astype(np.int32)
        w = rng.random(e).astype(np.float32)
        x = rng.normal(size=(n, f)).astype(np.float32)
        out = coo_spmm(
            jnp.asarray(w), jnp.asarray(senders), jnp.asarray(receivers),
            jnp.asarray(x), n,
        )
        A = np.zeros((n, n), np.float32)
        for s, r, wi in zip(senders, receivers, w):
            A[r, s] += wi
        assert np.allclose(out, A @ x, atol=1e-4)

    def test_coo_spmm_chunked_matches_unchunked(self):
        """edge_chunk bounds the gathered-messages intermediate for giant
        edge lists; values must match the one-shot path (f32 accumulation
        order differs) — including with a non-divisor chunk (zero-padded
        tail), out-of-range padding ids, and jit."""
        import jax

        rng = np.random.default_rng(4)
        n, e, f = 64, 999, 8
        senders = rng.integers(0, n, size=e).astype(np.int32)
        receivers = np.sort(rng.integers(0, n, size=e)).astype(np.int32)
        w = rng.random(e).astype(np.float32)
        # padding tail: ids one-past-the-end with zero weight (the
        # batch/hybrid convention) must stay inert under chunking
        senders[-7:] = n
        receivers[-7:] = n
        w[-7:] = 0.0
        x = rng.normal(size=(n, f)).astype(np.float32)
        want = coo_spmm(
            jnp.asarray(w), jnp.asarray(senders), jnp.asarray(receivers),
            jnp.asarray(x), n,
        )
        for chunk in (128, 250, e, 2 * e):
            got = jax.jit(
                lambda wv, sv, rv, xv, c=chunk: coo_spmm(
                    wv, sv, rv, xv, n, edge_chunk=c
                )
            )(
                jnp.asarray(w), jnp.asarray(senders),
                jnp.asarray(receivers), jnp.asarray(x),
            )
            assert np.allclose(got, want, atol=1e-4), chunk


class TestGCNNormalize:
    def test_matches_dense_formula(self):
        rng = np.random.default_rng(3)
        n, pairs = 10, 18
        u = rng.integers(0, n, size=pairs)
        v = rng.integers(0, n, size=pairs)
        w = rng.random(pairs).astype(np.float32)
        senders = np.concatenate([u, v]).astype(np.int32)
        receivers = np.concatenate([v, u]).astype(np.int32)
        weights = np.concatenate([w, w])

        norm = gcn_normalize(
            jnp.asarray(senders), jnp.asarray(receivers), jnp.asarray(weights), n
        )
        deg = np_segment_sum(weights, senders, n) + 1.0
        dinv = 1.0 / np.sqrt(deg + 1e-8)
        expected_edge = dinv[senders] * weights * dinv[receivers]
        assert np.allclose(norm.edge_norm, expected_edge, atol=1e-6)
        assert np.allclose(norm.self_norm, dinv * dinv, atol=1e-6)

    def test_padded_slots_inert(self):
        # A padded slot (no incident edges) gets deg = self-loop only.
        senders = jnp.array([0, 1], jnp.int32)
        receivers = jnp.array([1, 0], jnp.int32)
        weights = jnp.array([0.5, 0.5], jnp.float32)
        norm = gcn_normalize(senders, receivers, weights, 4)
        assert np.allclose(norm.self_norm[2:], 1.0 / 1.00000001, atol=1e-6)

    def test_full_aggregation_matches_dense_reference(self):
        """End-to-end check of D^-1/2 (A+I) D^-1/2 X against dense math."""
        rng = np.random.default_rng(4)
        n, pairs, f = 12, 20, 6
        u = rng.integers(0, n, size=pairs)
        v = rng.integers(0, n, size=pairs)
        w = rng.random(pairs).astype(np.float32)
        senders = np.concatenate([u, v]).astype(np.int32)
        receivers = np.concatenate([v, u]).astype(np.int32)
        weights = np.concatenate([w, w])
        x = rng.normal(size=(n, f)).astype(np.float32)

        norm = gcn_normalize(
            jnp.asarray(senders), jnp.asarray(receivers), jnp.asarray(weights), n
        )
        out = coo_spmm(
            norm.edge_norm, jnp.asarray(senders), jnp.asarray(receivers),
            jnp.asarray(x), n, indices_are_sorted=False,
        ) + norm.self_norm[:, None] * x

        A = np.zeros((n, n), np.float32)
        for s, r, wi in zip(senders, receivers, weights):
            A[r, s] += wi
        A_hat = A + np.eye(n, dtype=np.float32)
        deg = np_segment_sum(weights, senders, n) + 1.0
        dinv = 1.0 / np.sqrt(deg + 1e-8)
        expected = (dinv[:, None] * A_hat * dinv[None, :]) @ x
        assert np.allclose(out, expected, atol=1e-4)


class TestSDDMM:
    def test_matches_dense(self):
        from connectome_gnn_jax.ops import sddmm

        rng = np.random.default_rng(5)
        n, e, f = 12, 30, 8
        x = rng.normal(size=(n, f)).astype(np.float32)
        y = rng.normal(size=(n, f)).astype(np.float32)
        s = rng.integers(0, n, e).astype(np.int32)
        r = rng.integers(0, n, e).astype(np.int32)
        out = sddmm(jnp.asarray(x), jnp.asarray(y), jnp.asarray(s), jnp.asarray(r))
        expected = (x @ y.T)[r, s]
        assert np.allclose(out, expected, atol=1e-5)

    def test_gcn_norm_is_rank1_sddmm(self):
        from connectome_gnn_jax.ops import gcn_normalize, sddmm

        rng = np.random.default_rng(6)
        n, pairs = 10, 15
        u = rng.integers(0, n, pairs); v = rng.integers(0, n, pairs)
        w = rng.random(pairs).astype(np.float32)
        senders = jnp.asarray(np.concatenate([u, v]).astype(np.int32))
        receivers = jnp.asarray(np.concatenate([v, u]).astype(np.int32))
        weights = jnp.asarray(np.concatenate([w, w]))
        norm = gcn_normalize(senders, receivers, weights, n)
        dinv_col = norm.deg_inv_sqrt[:, None]
        via_sddmm = sddmm(dinv_col, dinv_col, senders, receivers) * weights
        assert np.allclose(via_sddmm, norm.edge_norm, atol=1e-6)
