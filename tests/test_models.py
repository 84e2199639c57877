"""Model-level tests (modeled on reference tests/test_models.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from connectome_gnn_jax.data import collate_graphs, generate_dataset
from connectome_gnn_jax.models import GCNConnectome, GraphSAGEConnectome


@pytest.fixture(scope="module")
def small_batch():
    graphs = generate_dataset(num_subjects=8, num_regions=20, seed=0)
    return collate_graphs(graphs)


@pytest.fixture(scope="module")
def models():
    gcn = GCNConnectome(in_channels=5, hidden_dim=32, num_classes=2)
    sage = GraphSAGEConnectome(in_channels=5, hidden_dim=32, num_classes=2)
    return {"gcn": gcn, "sage": sage}


class TestForward:
    @pytest.mark.parametrize("name", ["gcn", "sage"])
    def test_logit_shape(self, models, small_batch, name):
        model = models[name]
        params, state = model.init(jax.random.PRNGKey(0))
        logits, _ = model.apply(params, state, small_batch)
        assert logits.shape == (8, 2)

    @pytest.mark.parametrize("name", ["gcn", "sage"])
    def test_encode_shape(self, models, small_batch, name):
        model = models[name]
        params, state = model.init(jax.random.PRNGKey(0))
        emb, _ = model.encode(params, state, small_batch)
        assert emb.shape == (8, 32)

    @pytest.mark.parametrize("name", ["gcn", "sage"])
    def test_outputs_finite(self, models, small_batch, name):
        model = models[name]
        params, state = model.init(jax.random.PRNGKey(1))
        logits, _ = model.apply(params, state, small_batch)
        assert np.isfinite(np.asarray(logits)).all()

    @pytest.mark.parametrize("name", ["gcn", "sage"])
    def test_train_eval_shape_consistency(self, models, small_batch, name):
        model = models[name]
        params, state = model.init(jax.random.PRNGKey(2))
        eval_logits, _ = model.apply(params, state, small_batch, train=False)
        train_logits, _ = model.apply(
            params, state, small_batch, train=True, rng=jax.random.PRNGKey(3)
        )
        assert eval_logits.shape == train_logits.shape

    def test_configurable_num_layers(self, small_batch):
        for L in (1, 2, 4):
            model = GCNConnectome(in_channels=5, hidden_dim=16, num_layers=L)
            params, state = model.init(jax.random.PRNGKey(0))
            assert len(params["convs"]) == L
            logits, _ = model.apply(params, state, small_batch)
            assert logits.shape == (8, 2)

    def test_parameter_counts_match_reference(self, small_batch):
        # measured reference counts at in=5, hidden=64, C=2, L=3
        gcn = GCNConnectome(in_channels=5, hidden_dim=64)
        params, _ = gcn.init(jax.random.PRNGKey(0))
        assert gcn.num_params(params) == 11_234
        sage = GraphSAGEConnectome(in_channels=5, hidden_dim=64)
        params, _ = sage.init(jax.random.PRNGKey(0))
        assert sage.num_params(params) == 19_746


class TestGradients:
    @pytest.mark.parametrize("name", ["gcn", "sage"])
    def test_gradient_flow(self, models, small_batch, name):
        model = models[name]
        params, state = model.init(jax.random.PRNGKey(0))

        def loss_fn(p):
            logits, _ = model.apply(
                p, state, small_batch, train=True, rng=jax.random.PRNGKey(4)
            )
            return jnp.sum(logits)

        grads = jax.grad(loss_fn)(params)
        norms = [float(jnp.abs(g).max()) for g in jax.tree_util.tree_leaves(grads)]
        assert any(n > 0 for n in norms)
        assert all(np.isfinite(n) for n in norms)

    @pytest.mark.slow

    def test_padding_does_not_leak_gradient(self, models):
        """Gradients must be identical whether a batch is padded or not."""
        graphs = generate_dataset(num_subjects=4, num_regions=15, seed=3)
        tight = collate_graphs(graphs, node_multiple=1, edge_multiple=1)
        padded = collate_graphs(graphs, node_budget=256, edge_budget=2048)
        model = models["gcn"]
        params, state = model.init(jax.random.PRNGKey(0))

        def loss(p, b):
            logits, _ = model.apply(p, state, b, train=False)
            return jnp.sum(logits ** 2)

        g1 = jax.grad(loss)(params, tight)
        g2 = jax.grad(loss)(params, padded)
        for a, b in zip(
            jax.tree_util.tree_leaves(g1), jax.tree_util.tree_leaves(g2)
        ):
            assert np.allclose(a, b, atol=1e-5)


class TestPaddingInvariance:
    @pytest.mark.parametrize("name", ["gcn", "sage"])
    def test_forward_invariant_to_padding(self, models, name):
        """Same graphs, different padding budgets → identical logits."""
        graphs = generate_dataset(num_subjects=4, num_regions=15, seed=2)
        tight = collate_graphs(graphs, node_multiple=1, edge_multiple=1)
        padded = collate_graphs(graphs, node_budget=512, edge_budget=4096)
        model = models[name]
        params, state = model.init(jax.random.PRNGKey(0))
        out_tight, _ = model.apply(params, state, tight)
        out_padded, _ = model.apply(params, state, padded)
        assert np.allclose(out_tight, out_padded, atol=1e-4)

    def test_batchnorm_state_invariant_to_padding(self):
        graphs = generate_dataset(num_subjects=4, num_regions=15, seed=2)
        tight = collate_graphs(graphs, node_multiple=1, edge_multiple=1)
        padded = collate_graphs(graphs, node_budget=512, edge_budget=4096)
        # dropout=0: dropout masks are shape-dependent, which would make the
        # comparison see RNG differences rather than padding leakage
        model = GCNConnectome(in_channels=5, hidden_dim=32, dropout=0.0)
        params, state = model.init(jax.random.PRNGKey(0))
        _, s1 = model.apply(params, state, tight, train=True, rng=jax.random.PRNGKey(1))
        _, s2 = model.apply(params, state, padded, train=True, rng=jax.random.PRNGKey(1))
        for a, b in zip(
            jax.tree_util.tree_leaves(s1), jax.tree_util.tree_leaves(s2)
        ):
            assert np.allclose(a, b, atol=1e-4)
