"""Banded block-dense SpMM + RCM reordering tests."""

import numpy as np
import jax.numpy as jnp
import pytest

from connectome_gnn_jax.data import generate_connectome
from connectome_gnn_jax.data.reorder import (
    apply_ordering,
    bandwidth,
    reverse_cuthill_mckee,
)
from connectome_gnn_jax.ops import coo_spmm
from connectome_gnn_jax.ops.banded import BandedMatrix, banded_spmm, to_banded


def random_banded_graph(n=500, degree=6, band=40, seed=0):
    rng = np.random.default_rng(seed)
    receivers = np.repeat(np.arange(n), degree)
    offsets = rng.integers(-band, band + 1, receivers.shape[0])
    senders = np.clip(receivers + offsets, 0, n - 1)
    weights = rng.random(receivers.shape[0]).astype(np.float32)
    return senders.astype(np.int32), receivers.astype(np.int32), weights


class TestBandedSpmm:
    def test_matches_coo_spmm(self):
        n, f = 500, 16
        senders, receivers, weights = random_banded_graph(n)
        x = np.random.default_rng(1).standard_normal((n, f)).astype(np.float32)

        a = to_banded(senders, receivers, weights, n, block=64)
        out = banded_spmm(a, jnp.asarray(x))

        order = np.argsort(receivers, kind="stable")
        expected = coo_spmm(
            jnp.asarray(weights[order]),
            jnp.asarray(senders[order]),
            jnp.asarray(receivers[order]),
            jnp.asarray(x),
            n,
        )
        np.testing.assert_allclose(
            np.asarray(out), np.asarray(expected), rtol=1e-4, atol=1e-4
        )

    def test_duplicate_edges_accumulate(self):
        senders = np.array([0, 0], np.int32)
        receivers = np.array([1, 1], np.int32)
        weights = np.array([0.5, 0.25], np.float32)
        a = to_banded(senders, receivers, weights, 4, block=4)
        x = jnp.ones((4, 2), jnp.float32)
        out = banded_spmm(a, x)
        np.testing.assert_allclose(np.asarray(out)[1], 0.75, rtol=1e-6)

    def test_explicit_bandwidth_violation_raises(self):
        senders = np.array([0], np.int32)
        receivers = np.array([500], np.int32)
        with pytest.raises(ValueError, match="outside band"):
            to_banded(senders, receivers, np.ones(1, np.float32), 501,
                      block=64, bandwidth=1)

    def test_band_shape(self):
        senders, receivers, weights = random_banded_graph(n=300, band=30)
        a = to_banded(senders, receivers, weights, 300, block=64)
        assert isinstance(a, BandedMatrix)
        assert a.block == 64
        assert a.band.shape[0] == 5  # ceil(300/64) → 320/64
        assert a.band.shape[1] == 2 * a.bandwidth + 1


class TestRCM:
    def test_permutation_valid(self):
        g = generate_connectome(num_regions=80, seed=1)
        perm = reverse_cuthill_mckee(g.edge_index, g.num_nodes)
        assert sorted(perm.tolist()) == list(range(80))

    def test_reordering_preserves_spmm(self):
        g = generate_connectome(num_regions=60, seed=2)
        perm = reverse_cuthill_mckee(g.edge_index, g.num_nodes)
        rg = apply_ordering(g, perm)
        # degree (a permutation-equivariant quantity) must map through perm
        np.testing.assert_allclose(rg.degree(), g.degree()[perm], rtol=1e-5)
        np.testing.assert_allclose(rg.node_features, g.node_features[perm])

    def test_rcm_reduces_bandwidth_on_shuffled_band_graph(self):
        # a path-like band graph, randomly relabeled — RCM should recover
        # a narrow band
        n = 400
        rng = np.random.default_rng(3)
        base_s, base_r, w = random_banded_graph(n=n, degree=4, band=5, seed=3)
        shuffle = rng.permutation(n)
        edge_index = np.stack([shuffle[base_s], shuffle[base_r]])
        shuffled_bw = bandwidth(edge_index)
        perm = reverse_cuthill_mckee(edge_index, n)
        inverse = np.empty_like(perm)
        inverse[perm] = np.arange(n)
        rcm_bw = bandwidth(inverse[edge_index])
        assert rcm_bw < shuffled_bw / 4


class TestBandedNodeGCN:
    def test_matches_coo_oracle(self):
        """Banded node GCN ≡ the COO GCN layer stack on the same graph."""
        import jax
        from connectome_gnn_jax.models.layers import gcn_layer_apply
        from connectome_gnn_jax.models.node_gcn import BandedNodeGCN
        from connectome_gnn_jax.nn.layers import batch_norm_apply, dense_apply

        g = generate_connectome(num_regions=120, k=8, seed=7)
        model = BandedNodeGCN(in_channels=5, hidden_dim=32, num_layers=3)
        params, state = model.init(__import__("jax").random.PRNGKey(0))

        a = to_banded(g.edge_index[0], g.edge_index[1], g.edge_weight,
                      g.num_nodes, block=32)
        x = jnp.asarray(g.node_features)
        logits, _ = model.apply(params, state, a, x)

        # COO oracle
        order = np.argsort(g.edge_index[1], kind="stable")
        senders = jnp.asarray(g.edge_index[0][order])
        receivers = jnp.asarray(g.edge_index[1][order])
        weights = jnp.asarray(g.edge_weight[order])
        h = x
        mask = jnp.ones((g.num_nodes,), bool)
        for i in range(3):
            h = gcn_layer_apply(params["convs"][i], h, senders, receivers, weights)
            h, _ = batch_norm_apply(
                params["norms"][i], state["norms"][i], h, mask, train=False
            )
            h = jax.nn.relu(h)
        expected = dense_apply(params["head"], h)
        np.testing.assert_allclose(
            np.asarray(logits), np.asarray(expected), rtol=1e-3, atol=1e-4
        )

    def test_train_mode_updates_state(self):
        import jax
        from connectome_gnn_jax.models.node_gcn import BandedNodeGCN

        g = generate_connectome(num_regions=60, seed=8)
        model = BandedNodeGCN(in_channels=5, hidden_dim=16, num_layers=2,
                              dropout=0.1)
        params, state = model.init(jax.random.PRNGKey(0))
        a = to_banded(g.edge_index[0], g.edge_index[1], g.edge_weight,
                      g.num_nodes, block=16)
        logits, new_state = model.apply(
            params, state, a, jnp.asarray(g.node_features),
            train=True, rng=jax.random.PRNGKey(1),
        )
        assert logits.shape == (60, 2)
        before = np.asarray(state["norms"][0]["mean"])
        after = np.asarray(new_state["norms"][0]["mean"])
        assert not np.allclose(before, after)


class TestShardedBandedGCN:
    def _setup(self, num_shards, block=16):
        import jax
        from connectome_gnn_jax.models.node_gcn import BandedNodeGCN
        from connectome_gnn_jax.parallel import (
            ShardedBandedGCN, create_mesh, partition_banded)

        senders, receivers, weights = random_banded_graph(
            n=480, degree=6, band=24, seed=11)
        a = to_banded(senders, receivers, weights, 480, block=block)
        x = np.random.default_rng(12).standard_normal((480, 5)).astype(np.float32)

        model = ShardedBandedGCN(in_channels=5, hidden_dim=16, num_layers=3)
        params, state = model.init(jax.random.PRNGKey(0))

        single = BandedNodeGCN(in_channels=5, hidden_dim=16, num_layers=3)
        expected, _ = single.apply(params, state, a, jnp.asarray(x))

        mesh = create_mesh(axis_names=("edge",))
        pb = partition_banded(a, x, num_shards)
        return model, params, state, pb, mesh, expected, a

    def test_matches_single_device(self, cpu_devices):
        model, params, state, pb, mesh, expected, a = self._setup(8)
        logits = model.forward(params, state, pb, mesh)
        flat = np.asarray(logits).reshape(-1, 2)[: a.num_nodes]
        np.testing.assert_allclose(
            flat, np.asarray(expected), rtol=1e-3, atol=1e-4
        )

    def test_matches_with_nondividing_blocks(self, cpu_devices):
        # 480/16 = 30 blocks over 4 shards → 32 padded blocks, 8 per shard
        model, params, state, pb, mesh4, expected, a = self._setup(4)
        from connectome_gnn_jax.parallel import create_mesh
        mesh = create_mesh(shape=(4,), axis_names=("edge",),
                           devices=__import__("jax").devices()[:4])
        logits = model.forward(params, state, pb, mesh)
        flat = np.asarray(logits).reshape(-1, 2)[: a.num_nodes]
        np.testing.assert_allclose(
            flat, np.asarray(expected), rtol=1e-3, atol=1e-4
        )

    def test_bandwidth_exceeding_shard_raises(self):
        from connectome_gnn_jax.parallel import partition_banded

        senders, receivers, weights = random_banded_graph(
            n=128, degree=4, band=60, seed=13)
        a = to_banded(senders, receivers, weights, 128, block=16)
        x = np.zeros((128, 5), np.float32)
        with pytest.raises(ValueError, match="bandwidth"):
            partition_banded(a, x, 8)


class TestHybrid:
    def test_hybrid_spmm_matches_coo(self):
        """Small-world graph (shortcuts!) — the case pure banding rejects."""
        from connectome_gnn_jax.ops import hybrid_spmm, to_hybrid

        g = generate_connectome(num_regions=200, k=10, seed=17)
        x = np.random.default_rng(0).standard_normal((200, 8)).astype(np.float32)
        h = to_hybrid(g.edge_index[0], g.edge_index[1], g.edge_weight, 200,
                      block=32, bandwidth=2)
        out = hybrid_spmm(h, jnp.asarray(x))

        order = np.argsort(g.edge_index[1], kind="stable")
        expected = coo_spmm(
            jnp.asarray(g.edge_weight[order]),
            jnp.asarray(g.edge_index[0][order]),
            jnp.asarray(g.edge_index[1][order]),
            jnp.asarray(x), 200,
        )
        np.testing.assert_allclose(
            np.asarray(out)[:200], np.asarray(expected), rtol=1e-4, atol=1e-4
        )

    def test_edge_conservation(self):
        from connectome_gnn_jax.ops import to_hybrid

        g = generate_connectome(num_regions=150, seed=18)
        h = to_hybrid(g.edge_index[0], g.edge_index[1], g.edge_weight, 150,
                      block=32, bandwidth=1)
        total = float(np.asarray(h.band.band).sum()) + float(
            np.asarray(h.remainder_weights).sum()
        )
        assert np.isclose(total, g.edge_weight.sum(), rtol=1e-5)
        # the band captures the local bulk
        assert np.asarray(h.band.band).sum() > 0
        assert (np.asarray(h.remainder_weights) > 0).any()

    def test_node_gcn_on_hybrid_matches_coo_oracle(self):
        import jax
        from connectome_gnn_jax.models.layers import gcn_layer_apply
        from connectome_gnn_jax.models.node_gcn import BandedNodeGCN
        from connectome_gnn_jax.nn.layers import batch_norm_apply, dense_apply
        from connectome_gnn_jax.ops import to_hybrid

        g = generate_connectome(num_regions=160, k=8, seed=19)
        model = BandedNodeGCN(in_channels=5, hidden_dim=16, num_layers=2)
        params, state = model.init(jax.random.PRNGKey(0))
        h = to_hybrid(g.edge_index[0], g.edge_index[1], g.edge_weight,
                      g.num_nodes, block=32, bandwidth=1)
        logits, _ = model.apply(params, state, h, jnp.asarray(g.node_features))

        order = np.argsort(g.edge_index[1], kind="stable")
        senders = jnp.asarray(g.edge_index[0][order])
        receivers = jnp.asarray(g.edge_index[1][order])
        weights = jnp.asarray(g.edge_weight[order])
        z = jnp.asarray(g.node_features)
        mask = jnp.ones((g.num_nodes,), bool)
        for i in range(2):
            z = gcn_layer_apply(params["convs"][i], z, senders, receivers, weights)
            z, _ = batch_norm_apply(
                params["norms"][i], state["norms"][i], z, mask, train=False
            )
            z = jax.nn.relu(z)
        expected = dense_apply(params["head"], z)
        np.testing.assert_allclose(
            np.asarray(logits), np.asarray(expected), rtol=1e-3, atol=1e-4
        )


@pytest.mark.slow


class TestShardedBandedTraining:
    def _graph(self):
        from connectome_gnn_jax.data import generate_spatial_graph

        g = generate_spatial_graph(768, degree=6, band=40, seed=23)
        labels = (g.degree() > np.median(g.degree())).astype(np.int32)
        return g, labels

    def test_loss_decreases(self, cpu_devices):
        import jax
        import optax
        from connectome_gnn_jax.parallel import (
            ShardedBandedGCN, create_mesh, make_sharded_banded_train_step,
            partition_banded)

        g, labels = self._graph()
        a = to_banded(g.edge_index[0], g.edge_index[1], g.edge_weight,
                      g.num_nodes, block=32)
        model = ShardedBandedGCN(in_channels=5, hidden_dim=16, num_layers=2)
        params, state = model.init(jax.random.PRNGKey(0))
        mesh = create_mesh(axis_names=("edge",))
        pb = partition_banded(a, g.node_features, 8, labels=labels)
        opt = optax.adam(1e-2)
        step = make_sharded_banded_train_step(model, opt, mesh)
        opt_state = opt.init(params)
        losses = []
        for i in range(12):
            params, state, opt_state, loss, n = step(
                params, state, opt_state, jax.random.PRNGKey(i), pb
            )
            losses.append(float(loss))
        assert int(n) == g.num_nodes
        assert losses[-1] < losses[0]

    def test_grads_match_single_device_oracle(self, cpu_devices):
        """One sharded banded grad step == single-device BandedNodeGCN grad."""
        import jax
        import optax
        from connectome_gnn_jax.models import BandedNodeGCN
        from connectome_gnn_jax.parallel import (
            ShardedBandedGCN, create_mesh, make_sharded_banded_train_step,
            partition_banded)
        from connectome_gnn_jax.nn.layers import batch_norm_apply

        g, labels = self._graph()
        a = to_banded(g.edge_index[0], g.edge_index[1], g.edge_weight,
                      g.num_nodes, block=32)
        model = ShardedBandedGCN(in_channels=5, hidden_dim=16, num_layers=2,
                                 dropout=0.0)
        params, state = model.init(jax.random.PRNGKey(0))
        mesh = create_mesh(axis_names=("edge",))
        pb = partition_banded(a, g.node_features, 8, labels=labels)
        opt = optax.sgd(1e-1)
        step = make_sharded_banded_train_step(model, opt, mesh)
        new_params, _, _, loss, _ = step(
            params, state, opt.init(params), jax.random.PRNGKey(0), pb
        )

        # single-device oracle: BandedNodeGCN with train-mode BN
        single = BandedNodeGCN(in_channels=5, hidden_dim=16, num_layers=2,
                               dropout=0.0)
        x = jnp.asarray(g.node_features)
        y = jnp.asarray(labels)

        def loss_fn(p):
            logits, _ = single.apply(p, state, a, x, train=True)
            ce = optax.softmax_cross_entropy_with_integer_labels(logits, y)
            return jnp.mean(ce)

        oracle_loss, oracle_grads = jax.value_and_grad(loss_fn)(params)
        np.testing.assert_allclose(float(loss), float(oracle_loss), rtol=1e-4)
        expected = optax.apply_updates(
            params, opt.update(oracle_grads, opt.init(params), params)[0]
        )
        for p_new, p_exp in zip(
            jax.tree_util.tree_leaves(new_params),
            jax.tree_util.tree_leaves(expected),
        ):
            np.testing.assert_allclose(
                np.asarray(p_new), np.asarray(p_exp), rtol=1e-3, atol=1e-4
            )


class TestTransposeBanded:
    def test_matches_dense_transpose(self):
        """transpose_banded(A) @ I == (A @ I)ᵀ on a random non-symmetric
        band (the cotangent operator of banded_spmm)."""
        import jax
        from connectome_gnn_jax.ops import transpose_banded

        rng = np.random.default_rng(0)
        n, block, W = 96, 16, 2
        nb = n // block
        band = rng.standard_normal((nb, 2 * W + 1, block, block)).astype(
            np.float32
        )
        a = BandedMatrix(jnp.asarray(band), n, W)
        eye = jnp.eye(n, dtype=jnp.float32)
        dense = np.asarray(banded_spmm(a, eye))
        dense_t = np.asarray(banded_spmm(transpose_banded(a), eye))
        np.testing.assert_allclose(dense_t, dense.T, rtol=1e-6, atol=1e-6)

    def test_vjp_of_banded_spmm(self):
        """Aᵀ·ȳ through transpose_banded equals jax.vjp of banded_spmm."""
        import jax
        from connectome_gnn_jax.data import generate_spatial_graph
        from connectome_gnn_jax.ops import transpose_banded

        g = generate_spatial_graph(256, degree=5, band=24, num_features=8,
                                   seed=4)
        a = to_banded(g.edge_index[0], g.edge_index[1], g.edge_weight,
                      g.num_nodes, block=32)
        x = jnp.asarray(g.node_features)
        cot = jnp.asarray(
            np.random.default_rng(1).standard_normal(x.shape), jnp.float32
        )
        _, vjp = jax.vjp(lambda v: banded_spmm(a, v), x)
        (dx_auto,) = vjp(cot)
        dx_manual = banded_spmm(transpose_banded(a), cot)
        np.testing.assert_allclose(
            np.asarray(dx_manual), np.asarray(dx_auto), rtol=1e-4, atol=1e-5
        )


class TestApplyNormalized:
    def test_matches_apply(self):
        """prepare + apply_normalized == apply (training-step hoisting)."""
        import jax
        from connectome_gnn_jax.data import generate_spatial_graph
        from connectome_gnn_jax.models.node_gcn import BandedNodeGCN

        g = generate_spatial_graph(256, degree=5, band=24, seed=5)
        a = to_banded(g.edge_index[0], g.edge_index[1], g.edge_weight,
                      g.num_nodes, block=32)
        model = BandedNodeGCN(in_channels=5, hidden_dim=16, num_layers=2)
        params, state = model.init(jax.random.PRNGKey(0))
        x = jnp.asarray(g.node_features)
        ref, ref_state = model.apply(params, state, a, x, train=True)
        adj_norm, dinv = model.prepare(a)
        out, out_state = model.apply_normalized(
            params, state, adj_norm, dinv, x, train=True
        )
        np.testing.assert_allclose(
            np.asarray(out), np.asarray(ref), rtol=1e-6, atol=1e-6
        )
        for s1, s2 in zip(
            __import__("jax").tree_util.tree_leaves(ref_state),
            __import__("jax").tree_util.tree_leaves(out_state),
        ):
            np.testing.assert_allclose(np.asarray(s1), np.asarray(s2),
                                       rtol=1e-6, atol=1e-6)


class TestBf16Band:
    def test_bf16_stored_band_close_and_differentiable(self):
        """A bf16-stored band (half the residency) stays within bf16
        tolerance of the f32 band, forward and gradient."""
        import jax
        import jax.numpy as jnp

        from connectome_gnn_jax.data import generate_spatial_graph
        from connectome_gnn_jax.ops import to_banded
        from connectome_gnn_jax.ops.banded import banded_spmm

        g = generate_spatial_graph(256, degree=6, band=24, seed=2)
        a = to_banded(g.edge_index[0], g.edge_index[1], g.edge_weight,
                      g.num_nodes, block=32)
        a16 = a._replace(band=a.band.astype(jnp.bfloat16))
        x = jax.random.normal(jax.random.PRNGKey(0), (g.num_nodes, 8))

        y32 = banded_spmm(a, x)
        y16 = banded_spmm(a16, x)
        scale = float(jnp.max(jnp.abs(y32))) + 1e-9
        assert float(jnp.max(jnp.abs(y16 - y32))) / scale < 1e-2

        g32 = jax.grad(lambda v: jnp.sum(banded_spmm(a, v) ** 2))(x)
        g16 = jax.grad(lambda v: jnp.sum(banded_spmm(a16, v) ** 2))(x)
        gs = float(jnp.max(jnp.abs(g32))) + 1e-9
        assert float(jnp.max(jnp.abs(g16 - g32))) / gs < 2e-2

    def test_prepare_band_dtype_through_model(self):
        import jax
        import jax.numpy as jnp
        import numpy as np
        import pytest

        from connectome_gnn_jax.data import generate_spatial_graph
        from connectome_gnn_jax.models import BandedNodeGCN
        from connectome_gnn_jax.ops import to_banded, to_hybrid

        g = generate_spatial_graph(256, degree=6, band=24, seed=3)
        a = to_banded(g.edge_index[0], g.edge_index[1], g.edge_weight,
                      g.num_nodes, block=32)
        model = BandedNodeGCN(in_channels=5, hidden_dim=16, num_classes=2,
                              num_layers=2)
        params, state = model.init(jax.random.PRNGKey(0))
        x = jnp.asarray(g.node_features)

        adj32, dinv = model.prepare(a)
        adj16, dinv16 = model.prepare(a, band_dtype="bfloat16")
        assert adj16.band.dtype == jnp.bfloat16
        np.testing.assert_array_equal(np.asarray(dinv), np.asarray(dinv16))
        y32, _ = model.apply_normalized(params, state, adj32, dinv, x)
        y16, _ = model.apply_normalized(params, state, adj16, dinv16, x)
        scale = float(jnp.max(jnp.abs(y32))) + 1e-9
        assert float(jnp.max(jnp.abs(y16 - y32))) / scale < 2e-2

        h = to_hybrid(g.edge_index[0], g.edge_index[1], g.edge_weight,
                      g.num_nodes, block=32, bandwidth=0)
        with pytest.raises(ValueError, match="pure-band"):
            model.prepare(h, band_dtype="bfloat16")
        with pytest.raises(ValueError, match="band_dtype"):
            model.prepare(a, band_dtype="fp8")
