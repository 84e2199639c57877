"""Fused Triton-route kernels vs the XLA oracle (interpret mode on CPU),
and the choice of path in ``forward_auto``."""

import numpy as np
import jax
import pytest

from connectome_gnn_jax.data import collate_dense, generate_dataset
from connectome_gnn_jax.models import GCNConnectome
from connectome_gnn_jax.ops.fused_pallas import fused_gcn_forward


@pytest.fixture(scope="module")
def setup():
    graphs = generate_dataset(num_subjects=8, num_regions=20, seed=0)
    batch = collate_dense(graphs)
    model = GCNConnectome(in_channels=5, hidden_dim=32, num_classes=2, num_layers=3)
    params, state = model.init(jax.random.PRNGKey(0))
    return model, params, state, batch


class TestFusedGCN:
    def test_matches_xla_path(self, setup):
        model, params, state, batch = setup
        oracle, _ = model.apply(params, state, batch, train=False)
        fused = fused_gcn_forward(
            params,
            state,
            batch.node_features,
            batch.adj,
            batch.node_mask,
            num_layers=3,
            interpret=True,
        )
        np.testing.assert_allclose(
            np.asarray(fused), np.asarray(oracle), rtol=1e-4, atol=1e-5
        )

    def test_matches_after_bn_stats_update(self, setup):
        """Run a train-mode step first so BN stats are non-trivial."""
        model, params, state, batch = setup
        _, state2 = model.apply(
            params, state, batch, train=True, rng=jax.random.PRNGKey(1)
        )
        oracle, _ = model.apply(params, state2, batch, train=False)
        fused = fused_gcn_forward(
            params,
            state2,
            batch.node_features,
            batch.adj,
            batch.node_mask,
            num_layers=3,
            interpret=True,
        )
        np.testing.assert_allclose(
            np.asarray(fused), np.asarray(oracle), rtol=1e-4, atol=1e-5
        )

    def test_single_layer(self):
        graphs = generate_dataset(num_subjects=4, num_regions=16, seed=2)
        batch = collate_dense(graphs)
        model = GCNConnectome(in_channels=5, hidden_dim=16, num_layers=1)
        params, state = model.init(jax.random.PRNGKey(0))
        oracle, _ = model.apply(params, state, batch, train=False)
        fused = fused_gcn_forward(
            params, state, batch.node_features, batch.adj, batch.node_mask,
            num_layers=1, interpret=True,
        )
        np.testing.assert_allclose(
            np.asarray(fused), np.asarray(oracle), rtol=1e-4, atol=1e-5
        )

    def test_rejects_nonuniform_width(self):
        model = GCNConnectome(in_channels=5, hidden_dim=16, num_layers=2)
        params, state = model.init(jax.random.PRNGKey(0))
        params["convs"][1]["kernel"] = params["convs"][1]["kernel"][:, :8]
        graphs = generate_dataset(num_subjects=2, num_regions=16, seed=3)
        batch = collate_dense(graphs)
        with pytest.raises(ValueError):
            fused_gcn_forward(
                params, state, batch.node_features, batch.adj, batch.node_mask,
                num_layers=2, interpret=True,
            )


class TestFusedSAGE:
    def test_matches_xla_path(self):
        from connectome_gnn_jax.models import GraphSAGEConnectome
        from connectome_gnn_jax.ops.fused_pallas import fused_sage_forward

        graphs = generate_dataset(num_subjects=8, num_regions=20, seed=0)
        batch = collate_dense(graphs)
        model = GraphSAGEConnectome(in_channels=5, hidden_dim=32, num_layers=3)
        params, state = model.init(jax.random.PRNGKey(0))
        # non-trivial BN stats
        _, state = model.apply(params, state, batch, train=True, rng=jax.random.PRNGKey(1))
        oracle, _ = model.apply(params, state, batch, train=False)
        fused = fused_sage_forward(
            params, state, batch.node_features, batch.adj, batch.node_mask,
            num_layers=3, interpret=True,
        )
        np.testing.assert_allclose(
            np.asarray(fused), np.asarray(oracle), rtol=1e-4, atol=1e-5
        )

    def test_single_layer(self):
        from connectome_gnn_jax.models import GraphSAGEConnectome
        from connectome_gnn_jax.ops.fused_pallas import fused_sage_forward

        graphs = generate_dataset(num_subjects=4, num_regions=16, seed=2)
        batch = collate_dense(graphs)
        model = GraphSAGEConnectome(in_channels=5, hidden_dim=16, num_layers=1)
        params, state = model.init(jax.random.PRNGKey(0))
        oracle, _ = model.apply(params, state, batch, train=False)
        fused = fused_sage_forward(
            params, state, batch.node_features, batch.adj, batch.node_mask,
            num_layers=1, interpret=True,
        )
        np.testing.assert_allclose(
            np.asarray(fused), np.asarray(oracle), rtol=1e-4, atol=1e-5
        )


class TestPaddedShapes:
    """The serving shape: 84 regions, 5 features, 2 classes, none of them a
    power of two, so nodes, features and the head are padded inside the
    wrapper and sliced off again."""

    @pytest.mark.parametrize("family", ["gcn", "sage"])
    @pytest.mark.parametrize("num_layers", [1, 3])
    def test_matches_xla_at_serving_shape(self, family, num_layers):
        from connectome_gnn_jax.models import GraphSAGEConnectome
        from connectome_gnn_jax.ops.fused_pallas import fused_sage_forward

        cls, fn = (
            (GCNConnectome, fused_gcn_forward) if family == "gcn"
            else (GraphSAGEConnectome, fused_sage_forward)
        )
        batch = collate_dense(
            generate_dataset(num_subjects=3, num_regions=84, seed=4)
        )
        assert batch.node_features.shape[1:] == (88, 5)
        model = cls(in_channels=5, hidden_dim=64, num_layers=num_layers)
        params, state = model.init(jax.random.PRNGKey(1))
        _, state = model.apply(params, state, batch, train=True,
                               rng=jax.random.PRNGKey(2))
        oracle, _ = model.apply(params, state, batch, train=False)
        fused = fn(params, state, batch.node_features, batch.adj,
                   batch.node_mask, num_layers=num_layers, interpret=True)
        assert fused.shape == (3, 2)
        np.testing.assert_allclose(
            np.asarray(fused), np.asarray(oracle), rtol=1e-4, atol=1e-5
        )


class TestPathChoice:
    """``fused_kernel_for``: kernel by model family, dense layout, node
    count, dtype and width, and only on the GPU platform."""

    @staticmethod
    def _case(name):
        import jax.numpy as jnp

        from connectome_gnn_jax.data import collate_graphs
        from connectome_gnn_jax.models import GraphSAGEConnectome
        from connectome_gnn_jax.models.node_coo import NodeGCN

        graphs = generate_dataset(num_subjects=2, num_regions=20, seed=0)
        dense = collate_dense(graphs)
        model_cls, platform, batch, kw = GCNConnectome, "gpu", dense, {}
        if name == "sage":
            model_cls = GraphSAGEConnectome
        elif name == "cpu":
            platform = "cpu"
        elif name == "coo":
            batch = collate_graphs(graphs)
        elif name == "large":
            batch = collate_dense(
                generate_dataset(num_subjects=1, num_regions=130, seed=0)
            )
        elif name == "bf16":
            kw = {"compute_dtype": jnp.bfloat16}
        elif name == "other_family":
            model_cls = NodeGCN
        model = model_cls(in_channels=5, hidden_dim=16, num_layers=2, **kw)
        params, _ = model.init(jax.random.PRNGKey(0))
        return model, params, batch, platform

    @pytest.mark.parametrize(
        "name,want",
        [("gcn", "fused_gcn_forward"), ("sage", "fused_sage_forward"),
         ("cpu", None), ("coo", None), ("large", None), ("bf16", None),
         ("other_family", None)],
    )
    def test_choice(self, name, want):
        from connectome_gnn_jax.ops.fused_pallas import fused_kernel_for

        fn = fused_kernel_for(*self._case(name))
        assert (fn.__name__ if fn is not None else None) == want

    def test_nonuniform_width_takes_xla(self):
        from connectome_gnn_jax.ops.fused_pallas import fused_kernel_for

        model, params, batch, platform = self._case("gcn")
        params["convs"][1]["kernel"] = params["convs"][1]["kernel"][:, :8]
        assert fused_kernel_for(model, params, batch, platform) is None

    def test_forward_auto_off_gpu_is_the_plain_path(self):
        """Without ``interpret`` on a CPU backend ``forward_auto`` is
        exactly ``model.apply``."""
        from connectome_gnn_jax.ops.fused_pallas import forward_auto

        model, params, batch, _ = self._case("gcn")
        state = model.init(jax.random.PRNGKey(0))[1]
        want, _ = model.apply(params, state, batch, train=False)
        got = forward_auto(model, params, state, batch)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


class TestPrecision:
    def test_kernel_dots_follow_default_matmul_precision(self):
        from connectome_gnn_jax.ops.fused_pallas import _dot_precision

        assert _dot_precision() == jax.lax.Precision.DEFAULT
        with jax.default_matmul_precision("highest"):
            assert _dot_precision() == jax.lax.Precision.HIGHEST
        with jax.default_matmul_precision("float32"):
            assert _dot_precision() == jax.lax.Precision.HIGHEST
        with jax.default_matmul_precision("tensorfloat32"):
            assert _dot_precision() == jax.lax.Precision.DEFAULT


@pytest.mark.gpu
class TestCompiledOnGPU:
    """The kernels as compiled for the card (no interpreter), against
    the float32 reference; ``chip_smoke.py``'s serve phase runs the same
    check through ``Trainer.predict``."""

    @pytest.mark.parametrize("family", ["gcn", "sage"])
    def test_matches_highest_precision_reference(self, gpu, family):
        from connectome_gnn_jax.models import GraphSAGEConnectome
        from connectome_gnn_jax.ops.fused_pallas import forward_auto

        cls = GCNConnectome if family == "gcn" else GraphSAGEConnectome
        batch = collate_dense(
            generate_dataset(num_subjects=16, num_regions=84, seed=5)
        )
        model = cls(in_channels=5, hidden_dim=64, num_layers=3)
        params, state = model.init(jax.random.PRNGKey(0))
        with jax.default_matmul_precision("highest"):
            ref, _ = model.apply(params, state, batch, train=False)
            got = forward_auto(model, params, state, batch)
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(ref), rtol=1e-4, atol=1e-5
        )
