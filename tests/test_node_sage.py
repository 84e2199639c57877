"""Node-level GraphSAGE over banded giant graphs.

Equivalence chain (repo convention): COO SAGE layer oracle → banded/
hybrid single-device model → halo-sharded model → sharded training.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from connectome_gnn_jax.data import generate_connectome, generate_spatial_graph
from connectome_gnn_jax.models import BandedNodeSAGE
from connectome_gnn_jax.ops import to_banded, to_hybrid


def _coo_oracle(model, params, state, g, train=False):
    """Reference chain: sage_layer_apply → eval BN → (no extra ReLU)."""
    from connectome_gnn_jax.models.layers import sage_layer_apply
    from connectome_gnn_jax.nn.layers import batch_norm_apply, dense_apply

    order = np.argsort(g.edge_index[1], kind="stable")
    senders = jnp.asarray(g.edge_index[0][order])
    receivers = jnp.asarray(g.edge_index[1][order])
    weights = jnp.asarray(g.edge_weight[order])
    z = jnp.asarray(g.node_features)
    mask = jnp.ones((g.num_nodes,), bool)
    for i in range(model.num_layers):
        z = sage_layer_apply(params["convs"][i], z, senders, receivers, weights)
        z, _ = batch_norm_apply(
            params["norms"][i], state["norms"][i], z, mask, train=False
        )
    return dense_apply(params["head"], z)


class TestBandedNodeSAGE:
    def test_matches_coo_oracle_banded(self):
        g = generate_spatial_graph(512, degree=6, band=40, seed=31)
        model = BandedNodeSAGE(in_channels=5, hidden_dim=16, num_layers=2)
        params, state = model.init(jax.random.PRNGKey(0))
        a = to_banded(g.edge_index[0], g.edge_index[1], g.edge_weight,
                      g.num_nodes, block=32)
        logits, _ = model.apply(params, state, a, jnp.asarray(g.node_features))
        expected = _coo_oracle(model, params, state, g)
        np.testing.assert_allclose(
            np.asarray(logits), np.asarray(expected), rtol=1e-3, atol=1e-4
        )

    def test_matches_coo_oracle_hybrid(self):
        g = generate_connectome(num_regions=160, k=8, seed=32)
        model = BandedNodeSAGE(in_channels=5, hidden_dim=16, num_layers=2)
        params, state = model.init(jax.random.PRNGKey(1))
        h = to_hybrid(g.edge_index[0], g.edge_index[1], g.edge_weight,
                      g.num_nodes, block=32, bandwidth=1)
        logits, _ = model.apply(params, state, h, jnp.asarray(g.node_features))
        expected = _coo_oracle(model, params, state, g)
        np.testing.assert_allclose(
            np.asarray(logits), np.asarray(expected), rtol=1e-3, atol=1e-4
        )


class TestShardedBandedSAGE:
    def _setup(self):
        from connectome_gnn_jax.parallel import (
            ShardedBandedSAGE, create_mesh, partition_banded)

        g = generate_spatial_graph(768, degree=6, band=40, seed=33)
        labels = (g.degree() > np.median(g.degree())).astype(np.int32)
        a = to_banded(g.edge_index[0], g.edge_index[1], g.edge_weight,
                      g.num_nodes, block=32)
        model = ShardedBandedSAGE(in_channels=5, hidden_dim=16, num_layers=2,
                                  dropout=0.0)
        params, state = model.init(jax.random.PRNGKey(0))
        mesh = create_mesh(axis_names=("edge",))
        pb = partition_banded(a, g.node_features, 8, labels=labels)
        return g, labels, a, model, params, state, mesh, pb

    def test_forward_matches_single_device(self, cpu_devices):
        g, _, a, model, params, state, mesh, pb = self._setup()
        sharded = model.forward(params, state, pb, mesh)
        flat = np.asarray(sharded).reshape(-1, model.num_classes)[: g.num_nodes]

        single = BandedNodeSAGE(in_channels=5, hidden_dim=16, num_layers=2)
        expected, _ = single.apply(
            params, state, a, jnp.asarray(g.node_features)
        )
        np.testing.assert_allclose(
            flat, np.asarray(expected), rtol=1e-4, atol=1e-5
        )

    def test_training_matches_gradient_oracle(self, cpu_devices):
        from connectome_gnn_jax.parallel import make_sharded_banded_train_step

        g, labels, a, model, params, state, mesh, pb = self._setup()
        opt = optax.sgd(1e-1)
        step = make_sharded_banded_train_step(model, opt, mesh)
        new_params, _, _, loss, n = step(
            params, state, opt.init(params), jax.random.PRNGKey(0), pb
        )
        assert int(n) == g.num_nodes

        single = BandedNodeSAGE(in_channels=5, hidden_dim=16, num_layers=2,
                                dropout=0.0)

        def loss_fn(p):
            logits, _ = single.apply(
                p, state, a, jnp.asarray(g.node_features), train=True
            )
            ce = optax.softmax_cross_entropy_with_integer_labels(
                logits, jnp.asarray(labels)
            )
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

    def test_sharded_training_loss_decreases(self, cpu_devices):
        from connectome_gnn_jax.parallel import make_sharded_banded_train_step

        g, labels, a, model, params, state, mesh, pb = self._setup()
        opt = optax.adam(1e-2)
        step = make_sharded_banded_train_step(model, opt, mesh)
        opt_state = opt.init(params)
        losses = []
        for i in range(12):
            params, state, opt_state, loss, _ = step(
                params, state, opt_state, jax.random.PRNGKey(i), pb
            )
            losses.append(float(loss))
        assert losses[-1] < losses[0]

    def test_trained_params_reusable_single_device(self, cpu_devices):
        """Regression: shard_map-trained params must work in unsharded
        models (Explicit-typed meshes used to poison them with mesh
        shardings → ShardingTypeError in banded_spmm)."""
        from connectome_gnn_jax.parallel import make_sharded_banded_train_step

        g, labels, a, model, params, state, mesh, pb = self._setup()
        opt = optax.adam(1e-2)
        step = make_sharded_banded_train_step(model, opt, mesh)
        params, state, _, _, _ = step(
            params, state, opt.init(params), jax.random.PRNGKey(0), pb
        )
        single = BandedNodeSAGE(in_channels=5, hidden_dim=16, num_layers=2)
        logits, _ = single.apply(
            params, state, a, jnp.asarray(g.node_features)
        )
        assert np.isfinite(np.asarray(logits)).all()
