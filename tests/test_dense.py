"""Dense matmul-path tests: layout equivalence with the COO path."""

import numpy as np
import jax
import pytest

from connectome_gnn_jax.data import (
    ConnectomeDataLoader,
    collate_dense,
    collate_graphs,
    generate_dataset,
)
from connectome_gnn_jax.models import GCNConnectome, GraphSAGEConnectome
from connectome_gnn_jax.train import Trainer


@pytest.fixture(scope="module")
def graphs():
    return generate_dataset(num_subjects=8, num_regions=20, seed=0)


class TestDenseCollate:
    def test_shapes(self, graphs):
        batch = collate_dense(graphs)
        assert batch.num_graphs == 8
        assert batch.adj.shape == (8, 24, 24)  # 20 → 24 (multiple of 8)
        assert batch.node_features.shape == (8, 24, 5)
        assert int(batch.node_mask.sum()) == 8 * 20

    def test_adjacency_matches_graph(self, graphs):
        batch = collate_dense(graphs, node_multiple=1)
        g0 = graphs[0]
        A = np.asarray(batch.adj[0])
        # receiver-major: adj[i, j] = weight of j -> i
        assert np.allclose(A.T, g0.adjacency_matrix())

    def test_padding_rows_zero(self, graphs):
        batch = collate_dense(graphs, node_budget=32)
        A = np.asarray(batch.adj)
        assert (A[:, 20:, :] == 0).all()
        assert (A[:, :, 20:] == 0).all()


class TestDenseEquivalence:
    @pytest.mark.parametrize("model_cls", [GCNConnectome, GraphSAGEConnectome])
    def test_forward_matches_coo(self, graphs, model_cls):
        coo = collate_graphs(graphs)
        dense = collate_dense(graphs)
        model = model_cls(in_channels=5, hidden_dim=32)
        params, state = model.init(jax.random.PRNGKey(0))
        out_coo, _ = model.apply(params, state, coo)
        out_dense, _ = model.apply(params, state, dense)
        np.testing.assert_allclose(
            np.asarray(out_coo), np.asarray(out_dense), rtol=1e-4, atol=1e-5
        )

    def test_batchnorm_state_matches_coo(self, graphs):
        coo = collate_graphs(graphs)
        dense = collate_dense(graphs)
        model = GCNConnectome(in_channels=5, hidden_dim=32, dropout=0.0)
        params, state = model.init(jax.random.PRNGKey(0))
        _, s_coo = model.apply(params, state, coo, train=True, rng=jax.random.PRNGKey(1))
        _, s_dense = model.apply(
            params, state, dense, train=True, rng=jax.random.PRNGKey(1)
        )
        for a, b in zip(
            jax.tree_util.tree_leaves(s_coo), jax.tree_util.tree_leaves(s_dense)
        ):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-5)

    def test_dense_loader_trains(self, graphs):
        loader = ConnectomeDataLoader(
            graphs, batch_size=4, shuffle=False, layout="dense"
        )
        model = GCNConnectome(in_channels=5, hidden_dim=16, num_layers=2)
        trainer = Trainer(model, seed=0)
        history = trainer.fit(loader, loader, num_epochs=2, patience=5, verbose=False)
        assert len(history["train_loss"]) == 2
        assert all(np.isfinite(v) for v in history["train_loss"])

    def test_dense_training_matches_coo_training(self, graphs):
        model = GCNConnectome(in_channels=5, hidden_dim=16, num_layers=2, dropout=0.0)
        coo_loader = ConnectomeDataLoader(graphs, batch_size=4, shuffle=False)
        dense_loader = ConnectomeDataLoader(
            graphs, batch_size=4, shuffle=False, layout="dense"
        )
        t1 = Trainer(model, seed=0)
        h1 = t1.fit(coo_loader, coo_loader, num_epochs=3, patience=9, verbose=False)
        t2 = Trainer(model, seed=0)
        h2 = t2.fit(dense_loader, dense_loader, num_epochs=3, patience=9, verbose=False)
        np.testing.assert_allclose(h1["train_loss"], h2["train_loss"], rtol=2e-3)
        np.testing.assert_allclose(h1["val_acc"], h2["val_acc"])


class TestMixedPrecision:
    def test_bf16_close_to_f32(self, graphs):
        import jax.numpy as jnp

        dense = collate_dense(graphs)
        f32 = GCNConnectome(in_channels=5, hidden_dim=32)
        params, state = f32.init(jax.random.PRNGKey(0))
        bf16 = GCNConnectome(in_channels=5, hidden_dim=32, compute_dtype=jnp.bfloat16)
        a, _ = f32.apply(params, state, dense)
        b, _ = bf16.apply(params, state, dense)
        assert np.asarray(b).dtype == np.float32  # f32 accumulation/output
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0.05, atol=0.05)
        # class decisions should essentially agree
        agree = (np.asarray(a).argmax(1) == np.asarray(b).argmax(1)).mean()
        assert agree >= 0.9
