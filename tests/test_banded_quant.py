"""Int8-quantized banded SpMM: quantizer bounds + product equivalence.

The quantized products are checked against an independent numpy
*emulation* of their arithmetic (the dequantized band as a dense matrix
times bf16-rounded activations, in float64) — tight tolerance — and
against the f32 path within the analytic quantization bound (per-entry
error ≤ scale/2, bf16 cast ≤ 2⁻⁸·|x|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from connectome_gnn_jax.data import generate_spatial_graph
from connectome_gnn_jax.ops import (
    banded_spmm,
    banded_spmm_quant,
    banded_spmm_quant_xla,
    dequantize_band,
    quantize_band,
    to_banded,
)


def _banded(seed=0, n=640, block=64, degree=6, band=40, feat=16):
    g = generate_spatial_graph(
        n, degree=degree, band=band, num_features=feat, seed=seed
    )
    a = to_banded(
        g.edge_index[0], g.edge_index[1], g.edge_weight, n, block=block
    )
    return a, jnp.asarray(g.node_features)


#: (num_nodes, block) band geometries: block-multiple, ragged tail, and a
#: small block with a wider band in blocks.
GEOMETRIES = [(640, 64), (600, 64), (320, 32)]


def _dense_dequantized(q):
    """The dequantized band as a dense ``[num_nodes, num_nodes]`` float64
    matrix (tiles outside the node range dropped)."""
    block, nb, W, n = q.block, q.num_blocks, q.bandwidth, q.num_nodes
    band = np.asarray(q.band_q, np.float64) * np.asarray(
        q.scales, np.float64
    )[:, :, None, None]
    full = np.zeros((nb * block, (nb + 2 * W) * block))
    for rb in range(nb):
        for d in range(2 * W + 1):
            c0 = (rb + d) * block  # sender block rb + d - W, shifted by W
            full[rb * block:(rb + 1) * block, c0:c0 + block] = band[rb, d]
    return full[:n, W * block:W * block + n]


def _emulate(q, x):
    """Numpy model of the quantized product: dequantized band @
    bf16-rounded x, accumulated in float64."""
    xb = np.asarray(jnp.asarray(x[: q.num_nodes]).astype(jnp.bfloat16),
                    np.float64)
    return _dense_dequantized(q) @ xb


class TestQuantize:
    def test_roundtrip_error_bound(self, cpu_devices):
        a, _ = _banded()
        q = quantize_band(a)
        deq = np.asarray(dequantize_band(q).band)
        err = np.abs(deq - np.asarray(a.band))
        # round-to-nearest: |band - q·s| ≤ s/2 (+ float slack)
        bound = np.asarray(q.scales)[:, :, None, None] / 2 + 1e-6
        assert (err <= bound).all()

    def test_zero_tiles_stay_zero(self, cpu_devices):
        a, _ = _banded()
        q = quantize_band(a)
        band = np.asarray(a.band)
        zero_tiles = ~band.any(axis=(2, 3))
        assert (np.asarray(q.scales)[zero_tiles] == 1.0).all()
        assert (np.asarray(q.band_q)[zero_tiles] == 0).all()


class TestQuantKernel:
    @pytest.mark.parametrize("n,block", GEOMETRIES)
    def test_matches_emulation(self, cpu_devices, n, block):
        a, x = _banded(n=n, block=block)
        q = quantize_band(a)
        want = _emulate(q, x)
        got = np.asarray(banded_spmm_quant(q, x))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    def test_block_diagonal_band(self, cpu_devices):
        # every edge inside its own block: W = 0, one diagonal
        g = generate_spatial_graph(512, degree=6, band=40, num_features=16,
                                   seed=5)
        s, r = g.edge_index
        keep = s // 128 == r // 128
        a = to_banded(s[keep], r[keep], g.edge_weight[keep], 512, block=128)
        x = jnp.asarray(g.node_features)
        q = quantize_band(a)
        assert q.bandwidth == 0
        np.testing.assert_allclose(
            np.asarray(banded_spmm_quant(q, x)), _emulate(q, x),
            rtol=1e-5, atol=1e-5,
        )

    def test_ragged_tail(self, cpu_devices):
        # num_nodes not a block multiple: tail rows padded, output sliced
        a, x = _banded(n=600, block=64)
        q = quantize_band(a)
        assert q.num_nodes == 600
        got = np.asarray(banded_spmm_quant(q, x))
        assert got.shape == (600, x.shape[1])
        np.testing.assert_allclose(
            got, np.asarray(_emulate(q, x)), rtol=1e-5, atol=1e-5
        )

    def test_equivalence_bound_vs_f32(self, cpu_devices):
        """|quant − f32| within the analytic per-row bound: quantization
        contributes ≤ Σ_d scale[rb,d]/2·‖x_win‖₁ and the bf16 casts ≤
        ~2⁻⁸ of the f32 magnitudes."""
        a, x = _banded()
        q = quantize_band(a)
        f32 = np.asarray(banded_spmm(a, x))
        quant = np.asarray(banded_spmm_quant(q, x))

        rel = np.linalg.norm(quant - f32) / np.linalg.norm(f32)
        assert rel < 1e-2, f"relative error {rel:.2e}"

        # per-row analytic quantization bound (bf16 slack folded in at 2⁻⁸)
        block, nb, W = a.block, a.num_blocks, a.bandwidth
        xp = np.zeros(((nb + 2 * W) * block, x.shape[1]), np.float32)
        xp[W * block : W * block + a.num_nodes] = np.asarray(
            x[: a.num_nodes]
        )
        xb = np.abs(xp).reshape(nb + 2 * W, block, x.shape[1]).sum(1)
        scales = np.asarray(q.scales)
        qbound = np.zeros((nb, x.shape[1]), np.float32)
        for d in range(2 * W + 1):
            qbound += scales[:, d : d + 1] / 2 * xb[d : d + nb]
        absband = np.abs(np.asarray(a.band)).sum(3)  # [NB, D, block]
        bf16_slack = np.zeros((nb, block), np.float32)
        for d in range(2 * W + 1):
            bf16_slack += absband[:, d] * 2.0 ** (-8)
        bound = (
            np.repeat(qbound, block, axis=0)[: a.num_nodes]
            + (bf16_slack.reshape(-1, 1) * np.abs(xp).max())[: a.num_nodes]
            + 1e-4
        )
        assert (np.abs(quant - f32) <= bound).all()

    def test_quant_hybrid_spmm(self, cpu_devices):
        from connectome_gnn_jax.ops import to_hybrid
        from connectome_gnn_jax.ops.banded import hybrid_spmm
        from connectome_gnn_jax.ops.banded_quant import (
            hybrid_spmm_quant,
            quantize_hybrid,
        )

        g = generate_spatial_graph(
            640, degree=6, band=40, num_features=16, seed=3,
            shortcut_frac=0.15,
        )
        h = to_hybrid(
            g.edge_index[0], g.edge_index[1], g.edge_weight, 640,
            block=64, bandwidth=1,
        )
        x = jnp.asarray(g.node_features)
        hq = quantize_hybrid(h)
        got = np.asarray(hybrid_spmm_quant(hq, x))
        want = np.asarray(hybrid_spmm(h, x))
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < 1e-2, rel


class TestFeatureMajorKernel:
    """Feature-major product (banded_spmm_quant_fm): identical arithmetic
    to the row-major one, activations as [F, N]."""

    @pytest.mark.parametrize("n,block", GEOMETRIES)
    def test_matches_rowmajor(self, cpu_devices, n, block):
        from connectome_gnn_jax.ops import banded_spmm_quant_fm, to_feature_major

        a, x = _banded(n=n, block=block)
        q = quantize_band(a)
        want = np.asarray(banded_spmm_quant(q, x))
        got = np.asarray(banded_spmm_quant_fm(to_feature_major(q), x.T).T)
        # same quantized arithmetic; only f32 accumulation order differs
        # between the transposed and row-major contractions
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    def test_ragged_tail(self, cpu_devices):
        from connectome_gnn_jax.ops import banded_spmm_quant_fm, to_feature_major

        a, x = _banded(n=600, block=64)
        q = quantize_band(a)
        got = np.asarray(
            banded_spmm_quant_fm(to_feature_major(q), x.T)
        )
        assert got.shape == (x.shape[1], 600)
        np.testing.assert_allclose(
            got.T, np.asarray(_emulate(q, x)), rtol=1e-5, atol=1e-5
        )


class TestTransposeQuantized:
    def test_bitwise_equal_to_quantizing_the_f32_transpose(self, cpu_devices):
        """quantize∘transpose == transpose∘quantize, exactly: per-tile
        max-abs is transpose-invariant, so the int8 payloads and f32
        scales must match bit-for-bit (this identity is what lets
        training prep transpose the int8 band instead of the f32 one,
        ~4× less peak device memory)."""
        from connectome_gnn_jax.ops import transpose_quantized
        from connectome_gnn_jax.ops.banded import transpose_banded

        a, _ = _banded(n=520, block=64)
        via_f32 = quantize_band(transpose_banded(a))
        via_int8 = transpose_quantized(quantize_band(a))
        np.testing.assert_array_equal(
            np.asarray(via_f32.band_q), np.asarray(via_int8.band_q)
        )
        np.testing.assert_array_equal(
            np.asarray(via_f32.scales), np.asarray(via_int8.scales)
        )


class TestW8A8Kernel:
    """int8-band × int8-activation product (banded_spmm_quant_fm_w8a8).
    Adds a per-column-block activation rounding (~0.4% per entry) on top
    of the band quantization bound."""

    def test_matches_w8a8_emulation(self, cpu_devices):
        from connectome_gnn_jax.ops import (
            banded_spmm_quant_fm_w8a8,
            quantize_activations_fm,
            to_feature_major,
        )
        from connectome_gnn_jax.ops.banded import banded_spmm
        from connectome_gnn_jax.ops.banded_quant import dequantize_band

        a, x = _banded()
        q = quantize_band(a)
        q_fm = to_feature_major(q)
        nb, W, block = q.num_blocks, q.bandwidth, q.block

        # emulate: dequantized band @ dequantized per-block activations
        xT_pad = jnp.zeros((x.shape[1], (nb + 2 * W) * block), jnp.float32)
        xT_pad = xT_pad.at[:, W * block:W * block + a.num_nodes].set(
            jnp.asarray(x.T[:, : a.num_nodes])
        )
        xq, xs = quantize_activations_fm(xT_pad, block)
        x_deq = (
            xq.astype(jnp.float32).reshape(x.shape[1], -1, block)
            * xs[None, :, None]
        ).reshape(x.shape[1], -1)[:, W * block:W * block + a.num_nodes].T
        want = np.asarray(banded_spmm(dequantize_band(q), x_deq))

        got = np.asarray(
            banded_spmm_quant_fm_w8a8(q_fm, jnp.asarray(x.T))
        ).T
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    def test_close_to_f32_oracle(self, cpu_devices):
        from connectome_gnn_jax.ops import (
            banded_spmm_quant_fm_w8a8,
            to_feature_major,
        )
        from connectome_gnn_jax.ops.banded import banded_spmm

        a, x = _banded()
        q_fm = to_feature_major(quantize_band(a))
        want = np.asarray(banded_spmm(a, x))
        got = np.asarray(
            banded_spmm_quant_fm_w8a8(q_fm, jnp.asarray(x.T))
        ).T
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < 3e-2, rel

    def test_ragged_tail(self, cpu_devices):
        from connectome_gnn_jax.ops import (
            banded_spmm_quant_fm_w8a8,
            to_feature_major,
        )
        from connectome_gnn_jax.ops.banded import banded_spmm

        a, x = _banded(n=600, block=64)
        q_fm = to_feature_major(quantize_band(a))
        got = np.asarray(
            banded_spmm_quant_fm_w8a8(q_fm, jnp.asarray(x.T))
        )
        assert got.shape == (x.shape[1], 600)
        want = np.asarray(banded_spmm(a, x))
        rel = np.linalg.norm(got.T - want) / np.linalg.norm(want)
        assert rel < 3e-2, rel

    def test_model_w8a8_serving(self, cpu_devices):
        from connectome_gnn_jax.models import BandedNodeGCN

        g = generate_spatial_graph(640, degree=6, band=40, seed=12)
        a = to_banded(
            g.edge_index[0], g.edge_index[1], g.edge_weight, 640, block=64
        )
        x = jnp.asarray(g.node_features)
        model = BandedNodeGCN(in_channels=5, hidden_dim=32, num_layers=2)
        params, state = model.init(jax.random.PRNGKey(0))

        want, _ = model.apply(params, state, a, x, train=False)
        adj_q, dinv = model.prepare_quantized(a)
        got, _ = model.apply_quantized(
            params, state, adj_q, dinv, x, w8a8=True
        )
        rel = float(jnp.linalg.norm(got - want) / jnp.linalg.norm(want))
        assert rel < 8e-2, rel
        agree = float(jnp.mean(jnp.argmax(got, 1) == jnp.argmax(want, 1)))
        assert agree > 0.98, agree

    def test_w8a8_requires_feature_major(self, cpu_devices):
        from connectome_gnn_jax.models import BandedNodeGCN

        g = generate_spatial_graph(320, degree=6, band=40, seed=13)
        a = to_banded(
            g.edge_index[0], g.edge_index[1], g.edge_weight, 320, block=64
        )
        model = BandedNodeGCN(in_channels=5, hidden_dim=16, num_layers=1)
        params, state = model.init(jax.random.PRNGKey(0))
        adj_q, dinv = model.prepare_quantized(a, feature_major=False)
        with pytest.raises(ValueError):
            model.apply_quantized(
                params, state, adj_q, dinv,
                jnp.asarray(g.node_features), w8a8=True,
            )


class TestQuantizedServing:
    """Model-level int8 serving: prepare_quantized + apply_quantized."""

    @pytest.mark.parametrize("shortcut_frac", [0.0, 0.15])
    def test_node_gcn(self, cpu_devices, shortcut_frac):
        from connectome_gnn_jax.models import BandedNodeGCN
        from connectome_gnn_jax.ops import to_hybrid

        g = generate_spatial_graph(
            640, degree=6, band=40, seed=11, shortcut_frac=shortcut_frac
        )
        if shortcut_frac:
            a = to_hybrid(
                g.edge_index[0], g.edge_index[1], g.edge_weight, 640,
                block=64, bandwidth=1,
            )
        else:
            a = to_banded(
                g.edge_index[0], g.edge_index[1], g.edge_weight, 640,
                block=64,
            )
        x = jnp.asarray(g.node_features)
        model = BandedNodeGCN(in_channels=5, hidden_dim=32, num_layers=2)
        params, state = model.init(jax.random.PRNGKey(0))

        want, _ = model.apply(params, state, a, x, train=False)
        adj_q, dinv = model.prepare_quantized(a)
        got, _ = model.apply_quantized(
            params, state, adj_q, dinv, x
        )
        rel = float(jnp.linalg.norm(got - want) / jnp.linalg.norm(want))
        assert rel < 5e-2, rel
        # predictions should essentially agree
        agree = float(
            jnp.mean(jnp.argmax(got, 1) == jnp.argmax(want, 1))
        )
        assert agree > 0.99, agree

    def test_node_sage(self, cpu_devices):
        from connectome_gnn_jax.models import BandedNodeSAGE

        g = generate_spatial_graph(640, degree=6, band=40, seed=12)
        a = to_banded(
            g.edge_index[0], g.edge_index[1], g.edge_weight, 640, block=64
        )
        x = jnp.asarray(g.node_features)
        model = BandedNodeSAGE(in_channels=5, hidden_dim=32, num_layers=2)
        params, state = model.init(jax.random.PRNGKey(0))

        want, _ = model.apply(params, state, a, x, train=False)
        adj_q, w_sum = model.prepare_quantized(a)
        got, _ = model.apply_quantized(
            params, state, adj_q, w_sum, x
        )
        rel = float(jnp.linalg.norm(got - want) / jnp.linalg.norm(want))
        assert rel < 5e-2, rel
        agree = float(
            jnp.mean(jnp.argmax(got, 1) == jnp.argmax(want, 1))
        )
        assert agree > 0.99, agree

    def test_fm_and_rowmajor_serving_agree(self, cpu_devices):
        """feature_major=True (layout-persistent forward) vs the row-major
        serving path: same quantized operator, near-identical logits
        (contraction order differs through the transposed matmuls)."""
        from connectome_gnn_jax.models import BandedNodeGCN

        g = generate_spatial_graph(640, degree=6, band=40, seed=13)
        a = to_banded(
            g.edge_index[0], g.edge_index[1], g.edge_weight, 640, block=64
        )
        x = jnp.asarray(g.node_features)
        model = BandedNodeGCN(in_channels=5, hidden_dim=32, num_layers=2)
        params, state = model.init(jax.random.PRNGKey(0))

        q_fm, dinv = model.prepare_quantized(a)
        q_rm, _ = model.prepare_quantized(a, feature_major=False)
        got_fm, _ = model.apply_quantized(
            params, state, q_fm, dinv, x
        )
        got_rm, _ = model.apply_quantized(
            params, state, q_rm, dinv, x
        )
        np.testing.assert_allclose(
            np.asarray(got_fm), np.asarray(got_rm), rtol=1e-4, atol=1e-4
        )

    def test_xla_oracle_close(self, cpu_devices):
        a, x = _banded()
        q = quantize_band(a)
        xla = np.asarray(banded_spmm_quant_xla(q, x))
        ker = np.asarray(banded_spmm_quant(q, x))
        # differ only in activation precision (f32 vs bf16)
        np.testing.assert_allclose(ker, xla, rtol=2e-2, atol=2e-2)


@pytest.mark.slow
class TestQuantTrainable:
    """The int8-band TRAINING path: custom-VJP product + model gradients."""

    def _setup(self, n=640, block=64, feat=16):
        from connectome_gnn_jax.ops import gcn_normalize_banded

        a, x = _banded(seed=2, n=n, block=block, feat=feat)
        adj_norm, dinv = gcn_normalize_banded(a)
        return a, adj_norm, dinv, x

    def test_forward_is_the_fm_kernel(self, cpu_devices):
        from connectome_gnn_jax.ops import (
            banded_spmm_quant_fm,
            banded_spmm_quant_fm_grad,
            quantize_band,
            quantize_transposed_fm,
            to_feature_major,
        )

        _, adj_norm, _, x = self._setup()
        q = to_feature_major(quantize_band(adj_norm))
        qT = quantize_transposed_fm(adj_norm)
        xT = jnp.asarray(x).T
        out = banded_spmm_quant_fm_grad(q, qT, xT)
        ref = banded_spmm_quant_fm(q, xT)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))

    def test_gradient_matches_f32_oracle_within_quant_bound(self, cpu_devices):
        """d/dx of the trainable quant SpMM == f32 banded gradient to ~1%
        (the backward reads a separately-quantized Aᵀ)."""
        import jax
        from connectome_gnn_jax.ops import (
            banded_spmm,
            banded_spmm_quant_fm_grad,
            quantize_band,
            quantize_transposed_fm,
            to_feature_major,
        )

        _, adj_norm, _, x = self._setup()
        q = to_feature_major(quantize_band(adj_norm))
        qT = quantize_transposed_fm(adj_norm)
        xT = jnp.asarray(x).T
        cot = jnp.asarray(
            np.random.default_rng(3).standard_normal(xT.shape), jnp.float32
        )

        def loss_q(v):
            return jnp.sum(
                banded_spmm_quant_fm_grad(q, qT, v) * cot
            )

        def loss_f(v):
            return jnp.sum(banded_spmm(adj_norm, v.T).T * cot)

        g_q = np.asarray(jax.grad(loss_q)(xT))
        g_f = np.asarray(jax.grad(loss_f)(xT))
        rel = np.linalg.norm(g_q - g_f) / np.linalg.norm(g_f)
        assert rel < 2e-2, rel

    def test_model_gradients_match_f32_within_bound(self, cpu_devices):
        """Full BandedNodeGCN: int8-trainable param gradients track the
        f32 path at the quantization error scale."""
        import jax
        import optax
        from connectome_gnn_jax.models.node_gcn import BandedNodeGCN

        a, adj_norm, dinv, x = self._setup()
        model = BandedNodeGCN(in_channels=16, hidden_dim=16, num_layers=2)
        params, state = model.init(jax.random.PRNGKey(0))
        q, qT, dinv_q = model.prepare_quant_trainable(a)
        np.testing.assert_allclose(np.asarray(dinv_q), np.asarray(dinv))
        labels = jnp.asarray(
            np.random.default_rng(4).integers(0, 2, a.num_nodes), jnp.int32
        )

        def loss_quant(p):
            logits, _ = model.apply_quant_trainable(
                p, state, q, qT, dinv, jnp.asarray(x), train=True
            )
            return jnp.mean(
                optax.softmax_cross_entropy_with_integer_labels(logits, labels)
            )

        def loss_f32(p):
            logits, _ = model.apply_normalized(
                p, state, adj_norm, dinv, jnp.asarray(x), train=True
            )
            return jnp.mean(
                optax.softmax_cross_entropy_with_integer_labels(logits, labels)
            )

        lq, gq = jax.value_and_grad(loss_quant)(params)
        lf, gf = jax.value_and_grad(loss_f32)(params)
        assert abs(float(lq) - float(lf)) / abs(float(lf)) < 2e-2
        flat_q = np.concatenate(
            [np.asarray(g).ravel() for g in jax.tree_util.tree_leaves(gq)]
        )
        flat_f = np.concatenate(
            [np.asarray(g).ravel() for g in jax.tree_util.tree_leaves(gf)]
        )
        rel = np.linalg.norm(flat_q - flat_f) / np.linalg.norm(flat_f)
        assert rel < 5e-2, rel

    def test_eval_mode_matches_serving_forward(self, cpu_devices):
        """train=False through apply_quant_trainable == the serving
        apply_quantized fm path (same product, same eval BN)."""
        import jax
        from connectome_gnn_jax.models.node_gcn import BandedNodeGCN

        a, _, _, x = self._setup()
        model = BandedNodeGCN(in_channels=16, hidden_dim=16, num_layers=2)
        params, state = model.init(jax.random.PRNGKey(0))
        q, qT, dinv = model.prepare_quant_trainable(a)
        train_path, _ = model.apply_quant_trainable(
            params, state, q, qT, dinv, jnp.asarray(x), train=False,
                    )
        serve_path, _ = model.apply_quantized(
            params, state, q, dinv, jnp.asarray(x)
        )
        np.testing.assert_allclose(
            np.asarray(train_path), np.asarray(serve_path),
            rtol=1e-5, atol=1e-6,
        )

    def test_quantized_training_converges_like_f32(self, cpu_devices):
        """A few Adam steps through the int8 path track the f32 loss
        trajectory — quantization error does not compound destructively."""
        import jax
        import optax
        from connectome_gnn_jax.models.node_gcn import BandedNodeGCN

        a, adj_norm, dinv, x = self._setup(n=320, block=32)
        # learnable labels: sign of the aggregated first feature
        agg = np.asarray(banded_spmm_quant_xla(
            quantize_band(adj_norm), jnp.asarray(x)
        ))[:, 0]
        labels = jnp.asarray((agg > np.median(agg)).astype(np.int32))
        model = BandedNodeGCN(in_channels=16, hidden_dim=16, num_layers=2)
        q, qT, _ = model.prepare_quant_trainable(a)
        opt = optax.adam(1e-2)

        def run(apply_fn):
            params, state = model.init(jax.random.PRNGKey(0))
            opt_state = opt.init(params)
            losses = []
            for _ in range(8):
                def loss_fn(p, s):
                    logits, new_s = apply_fn(p, s)
                    ce = optax.softmax_cross_entropy_with_integer_labels(
                        logits, labels
                    )
                    return jnp.mean(ce), new_s

                (loss, state), grads = jax.value_and_grad(
                    loss_fn, has_aux=True
                )(params, state)
                updates, opt_state = opt.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                losses.append(float(loss))
            return losses

        l_q = run(lambda p, s: model.apply_quant_trainable(
            p, s, q, qT, dinv, jnp.asarray(x), train=True
        ))
        l_f = run(lambda p, s: model.apply_normalized(
            p, s, adj_norm, dinv, jnp.asarray(x), train=True
        ))
        assert l_q[-1] < l_q[0]  # learning
        assert abs(l_q[-1] - l_f[-1]) < 0.05, (l_q, l_f)
