"""Edge-partitioned giant-graph mode: equivalence with the unpartitioned path."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from connectome_gnn_jax.data import generate_connectome
from connectome_gnn_jax.models.layers import gcn_layer_apply
from connectome_gnn_jax.nn.layers import batch_norm_apply, dense_apply
from connectome_gnn_jax.parallel import (
    EdgePartitionedGCN,
    create_mesh,
    partition_graph,
)


@pytest.fixture(scope="module")
def giant_graph():
    # "giant" at test scale: one 200-node connectome
    return generate_connectome(num_regions=200, k=10, seed=3)


def oracle_forward(model, params, state, graph):
    """Unpartitioned single-device forward with identical numerics."""
    # sort edges by receiver to match collate/CSR conventions
    order = np.argsort(graph.edge_index[1], kind="stable")
    senders = jnp.asarray(graph.edge_index[0][order])
    receivers = jnp.asarray(graph.edge_index[1][order])
    weights = jnp.asarray(graph.edge_weight[order])
    x = jnp.asarray(graph.node_features)
    mask = jnp.ones((graph.num_nodes,), bool)
    for i in range(model.num_layers):
        x = gcn_layer_apply(params["convs"][i], x, senders, receivers, weights)
        x, _ = batch_norm_apply(
            params["norms"][i], state["norms"][i], x, mask, train=False
        )
        x = jax.nn.relu(x)
    return dense_apply(params["head"], x)


class TestPartitionGraph:
    def test_partition_invariants(self, giant_graph):
        pg = partition_graph(giant_graph, 8)
        assert pg.num_shards == 8
        assert pg.total_nodes >= giant_graph.num_nodes
        # every real edge is preserved exactly once
        w = np.asarray(pg.edge_weight)
        assert np.isclose(w.sum(), giant_graph.edge_weight.sum(), rtol=1e-5)
        # node features land in the right shard rows
        flat = np.asarray(pg.node_features).reshape(pg.total_nodes, -1)
        assert np.allclose(flat[: giant_graph.num_nodes], giant_graph.node_features)

    def test_receivers_are_local_and_sorted(self, giant_graph):
        pg = partition_graph(giant_graph, 4)
        recv = np.asarray(pg.receivers)
        wts = np.asarray(pg.edge_weight)
        for d in range(4):
            real = wts[d] > 0
            assert (recv[d][real] >= 0).all()
            assert (recv[d][real] < pg.nodes_per_shard).all()
            assert (np.diff(recv[d][real]) >= 0).all()

    def test_node_labels(self, giant_graph):
        labels = np.arange(giant_graph.num_nodes) % 2
        pg = partition_graph(giant_graph, 4, node_labels=labels)
        flat = np.asarray(pg.labels).reshape(-1)
        np.testing.assert_array_equal(flat[: giant_graph.num_nodes], labels)
        assert int(np.asarray(pg.label_mask).sum()) == giant_graph.num_nodes


class TestEdgePartitionedGCN:
    def test_matches_unpartitioned_oracle(self, giant_graph, cpu_devices):
        mesh = create_mesh(axis_names=("edge",))
        model = EdgePartitionedGCN(
            in_channels=5, hidden_dim=32, num_classes=2, num_layers=3
        )
        params, state = model.init(jax.random.PRNGKey(0))
        pg = partition_graph(giant_graph, 8)

        logits = model.forward(params, state, pg, mesh)
        flat = np.asarray(logits).reshape(pg.total_nodes, -1)

        expected = np.asarray(oracle_forward(model, params, state, giant_graph))
        np.testing.assert_allclose(
            flat[: giant_graph.num_nodes], expected, rtol=1e-3, atol=1e-4
        )

    def test_padding_nodes_have_finite_logits(self, giant_graph, cpu_devices):
        mesh = create_mesh(axis_names=("edge",))
        model = EdgePartitionedGCN(in_channels=5, hidden_dim=16, num_layers=2)
        params, state = model.init(jax.random.PRNGKey(1))
        pg = partition_graph(giant_graph, 8)
        logits = model.forward(params, state, pg, mesh)
        assert np.isfinite(np.asarray(logits)).all()


@pytest.mark.slow


class TestPartitionedTraining:
    def test_train_step_reduces_loss(self, giant_graph, cpu_devices):
        import optax
        from connectome_gnn_jax.parallel import (
            create_mesh, make_partitioned_train_step, partition_graph)

        labels = (giant_graph.degree() > np.median(giant_graph.degree())).astype(np.int32)
        pg = partition_graph(giant_graph, 8, node_labels=labels)
        mesh = create_mesh(axis_names=("edge",))
        model = EdgePartitionedGCN(in_channels=5, hidden_dim=32, num_layers=2)
        params, state = model.init(jax.random.PRNGKey(0))
        opt = optax.adam(1e-2)
        opt_state = opt.init(params)
        step = make_partitioned_train_step(model, opt, mesh)

        losses = []
        key = jax.random.PRNGKey(1)
        for i in range(15):
            key, k = jax.random.split(key)
            params, state, opt_state, loss, n = step(params, state, opt_state, k, pg)
            losses.append(float(loss))
        assert int(n) == giant_graph.num_nodes
        assert losses[-1] < losses[0]

    def test_train_step_grads_match_single_device(self, giant_graph, cpu_devices):
        """One partitioned grad step == the equivalent unpartitioned grad."""
        import optax
        from connectome_gnn_jax.parallel import (
            create_mesh, make_partitioned_train_step, partition_graph)

        labels = np.arange(giant_graph.num_nodes) % 2
        pg = partition_graph(giant_graph, 8, node_labels=labels)
        mesh = create_mesh(axis_names=("edge",))
        model = EdgePartitionedGCN(
            in_channels=5, hidden_dim=16, num_layers=2, dropout=0.0
        )
        params, state = model.init(jax.random.PRNGKey(0))
        opt = optax.sgd(1e-1)
        step = make_partitioned_train_step(model, opt, mesh)
        new_params, _, _, loss, _ = step(
            params, state, opt.init(params), jax.random.PRNGKey(0), pg
        )

        # single-device oracle: same loss function over the whole graph,
        # train-mode BN (global stats == psummed shard stats)
        from connectome_gnn_jax.models.layers import gcn_layer_apply
        from connectome_gnn_jax.nn.layers import batch_norm_apply, dense_apply

        order = np.argsort(giant_graph.edge_index[1], kind="stable")
        senders = jnp.asarray(giant_graph.edge_index[0][order])
        receivers = jnp.asarray(giant_graph.edge_index[1][order])
        weights = jnp.asarray(giant_graph.edge_weight[order])
        x = jnp.asarray(giant_graph.node_features)
        y = jnp.asarray(labels.astype(np.int32))
        mask = jnp.ones((giant_graph.num_nodes,), bool)

        def loss_fn(p):
            h = x
            for i in range(2):
                h = gcn_layer_apply(p["convs"][i], h, senders, receivers, weights)
                h, _ = batch_norm_apply(
                    p["norms"][i], state["norms"][i], h, mask, train=True
                )
                h = jax.nn.relu(h)
            logits = dense_apply(p["head"], h)
            ce = -jax.nn.log_softmax(logits)[jnp.arange(y.shape[0]), y]
            return jnp.mean(ce)

        oracle_loss, oracle_grads = jax.value_and_grad(loss_fn)(params)
        np.testing.assert_allclose(float(loss), float(oracle_loss), rtol=1e-4)
        expected = optax.apply_updates(
            params, opt.update(oracle_grads, opt.init(params), params)[0]
        )
        for a, b in zip(
            jax.tree_util.tree_leaves(new_params),
            jax.tree_util.tree_leaves(expected),
        ):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-3, atol=1e-4
            )


def sage_oracle_forward(model, params, state, graph):
    """Unpartitioned single-device SAGE forward with identical numerics."""
    from connectome_gnn_jax.models.layers import sage_layer_apply

    order = np.argsort(graph.edge_index[1], kind="stable")
    senders = jnp.asarray(graph.edge_index[0][order])
    receivers = jnp.asarray(graph.edge_index[1][order])
    weights = jnp.asarray(graph.edge_weight[order])
    x = jnp.asarray(graph.node_features)
    mask = jnp.ones((graph.num_nodes,), bool)
    for i in range(model.num_layers):
        x = sage_layer_apply(params["convs"][i], x, senders, receivers, weights)
        x, _ = batch_norm_apply(
            params["norms"][i], state["norms"][i], x, mask, train=False
        )
    return dense_apply(params["head"], x)


class TestEdgePartitionedSAGE:
    """The irregular-partitioned family's SAGE twin (round-1 review #5)."""

    def test_matches_unpartitioned_oracle(self, giant_graph, cpu_devices):
        from connectome_gnn_jax.parallel import EdgePartitionedSAGE

        mesh = create_mesh(axis_names=("edge",))
        model = EdgePartitionedSAGE(
            in_channels=5, hidden_dim=32, num_classes=2, num_layers=3
        )
        params, state = model.init(jax.random.PRNGKey(0))
        pg = partition_graph(giant_graph, 8)
        logits = model.forward(params, state, pg, mesh)
        flat = np.asarray(logits).reshape(pg.total_nodes, -1)
        expected = np.asarray(sage_oracle_forward(model, params, state, giant_graph))
        np.testing.assert_allclose(
            flat[: giant_graph.num_nodes], expected, rtol=1e-3, atol=1e-4
        )

    def test_train_step_grads_match_single_device(self, giant_graph, cpu_devices):
        import optax

        from connectome_gnn_jax.models.layers import sage_layer_apply
        from connectome_gnn_jax.parallel import (
            EdgePartitionedSAGE, make_partitioned_train_step)

        labels = np.arange(giant_graph.num_nodes) % 2
        pg = partition_graph(giant_graph, 8, node_labels=labels)
        mesh = create_mesh(axis_names=("edge",))
        model = EdgePartitionedSAGE(
            in_channels=5, hidden_dim=16, num_layers=2, dropout=0.0
        )
        params, state = model.init(jax.random.PRNGKey(0))
        opt = optax.sgd(1e-1)
        step = make_partitioned_train_step(model, opt, mesh)
        new_params, _, _, loss, _ = step(
            params, state, opt.init(params), jax.random.PRNGKey(0), pg
        )

        order = np.argsort(giant_graph.edge_index[1], kind="stable")
        senders = jnp.asarray(giant_graph.edge_index[0][order])
        receivers = jnp.asarray(giant_graph.edge_index[1][order])
        weights = jnp.asarray(giant_graph.edge_weight[order])
        x = jnp.asarray(giant_graph.node_features)
        y = jnp.asarray(labels.astype(np.int32))
        mask = jnp.ones((giant_graph.num_nodes,), bool)

        def loss_fn(p):
            h = x
            for i in range(2):
                h = sage_layer_apply(p["convs"][i], h, senders, receivers, weights)
                h, _ = batch_norm_apply(
                    p["norms"][i], state["norms"][i], h, mask, train=True
                )
            logits = dense_apply(p["head"], h)
            ce = -jax.nn.log_softmax(logits)[jnp.arange(y.shape[0]), y]
            return jnp.mean(ce)

        oracle_loss, oracle_grads = jax.value_and_grad(loss_fn)(params)
        np.testing.assert_allclose(float(loss), float(oracle_loss), rtol=1e-4)
        expected = optax.apply_updates(
            params, opt.update(oracle_grads, opt.init(params), params)[0]
        )
        for a, b in zip(
            jax.tree_util.tree_leaves(new_params),
            jax.tree_util.tree_leaves(expected),
        ):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-3, atol=1e-4
            )


class TestExchangeVolume:
    def test_send_table_smaller_than_all_gather_on_local_graphs(self):
        """The point of the halo-ization: on a receiver-local graph the
        per-layer exchange volume D·D·U is far below the all-gather's
        D·(D-1)·P_local (documented traffic ratio, round-1 review #5)."""
        from connectome_gnn_jax.data import generate_spatial_graph

        g = generate_spatial_graph(4096, degree=8, band=64, seed=0)
        pg = partition_graph(g, 8)
        D, p_local, U = pg.num_shards, pg.nodes_per_shard, pg.borrowed_rows
        exchange_rows_volume = D * U          # per shard, per layer
        all_gather_volume = (D - 1) * p_local
        assert exchange_rows_volume * 4 < all_gather_volume, (
            f"exchange {exchange_rows_volume} rows vs all-gather "
            f"{all_gather_volume} rows"
        )
