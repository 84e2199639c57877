"""Sharded hybrid (band + long-range remainder) giant graphs.

Small-world giant graphs: the band bulk halo-exchanges between
neighbors, the remainder's cross-shard senders ride a static all_to_all.
Oracles: the single-device hybrid models (BandedNodeGCN / BandedNodeSAGE
on a HybridMatrix), which are themselves COO-oracle-verified.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from connectome_gnn_jax.data import generate_spatial_graph
from connectome_gnn_jax.models import BandedNodeGCN, BandedNodeSAGE
from connectome_gnn_jax.ops import to_hybrid
from connectome_gnn_jax.parallel import (
    ShardedBandedGCN,
    ShardedBandedSAGE,
    create_mesh,
    make_banded_train_step_2d,
    make_sharded_banded_train_step,
    partition_hybrid,
    stack_partitioned,
)


def _graph(seed=41, n=768, shortcut_frac=0.15):
    g = generate_spatial_graph(
        n, degree=6, band=40, seed=seed, shortcut_frac=shortcut_frac
    )
    labels = (g.degree() > np.median(g.degree())).astype(np.int32)
    h = to_hybrid(
        g.edge_index[0], g.edge_index[1], g.edge_weight, g.num_nodes,
        block=32, bandwidth=2,
    )
    return g, labels, h


class TestPartitionHybrid:
    def test_edge_conservation(self, cpu_devices):
        g, labels, h = _graph()
        ph = partition_hybrid(h, g.node_features, 8, labels=labels)
        total = float(np.asarray(ph.banded.band).sum()) + float(
            np.asarray(ph.rem_weights).sum()
        )
        assert np.isclose(total, g.edge_weight.sum(), rtol=1e-5)
        assert (np.asarray(ph.rem_weights) > 0).any()
        # some senders really are remote (slots beyond p_local)
        p_local = ph.banded.blocks_per_shard * ph.banded.block
        assert (np.asarray(ph.rem_src_slot) >= p_local).any()


class TestShardedHybridForward:
    @pytest.mark.parametrize("family", ["gcn", "sage"])
    def test_matches_single_device_hybrid(self, cpu_devices, family):
        g, labels, h = _graph()
        if family == "gcn":
            sharded_cls, single_cls = ShardedBandedGCN, BandedNodeGCN
        else:
            sharded_cls, single_cls = ShardedBandedSAGE, BandedNodeSAGE
        model = sharded_cls(in_channels=5, hidden_dim=16, num_layers=2)
        params, state = model.init(jax.random.PRNGKey(0))
        mesh = create_mesh(axis_names=("edge",))
        ph = partition_hybrid(h, g.node_features, 8, labels=labels)

        sharded = model.forward(params, state, ph, mesh)
        flat = np.asarray(sharded).reshape(-1, model.num_classes)[: g.num_nodes]

        single = single_cls(in_channels=5, hidden_dim=16, num_layers=2)
        expected, _ = single.apply(
            params, state, h, jnp.asarray(g.node_features)
        )
        np.testing.assert_allclose(
            flat, np.asarray(expected), rtol=1e-3, atol=1e-4
        )


@pytest.mark.slow
class TestShardedHybridTraining:
    @pytest.mark.parametrize("family", ["gcn", "sage"])
    def test_grads_match_single_device_oracle(self, cpu_devices, family):
        g, labels, h = _graph()
        if family == "gcn":
            sharded_cls, single_cls = ShardedBandedGCN, BandedNodeGCN
        else:
            sharded_cls, single_cls = ShardedBandedSAGE, BandedNodeSAGE
        model = sharded_cls(
            in_channels=5, hidden_dim=16, num_layers=2, dropout=0.0
        )
        params, state = model.init(jax.random.PRNGKey(0))
        mesh = create_mesh(axis_names=("edge",))
        ph = partition_hybrid(h, g.node_features, 8, labels=labels)
        opt = optax.sgd(1e-1)
        step = make_sharded_banded_train_step(model, opt, mesh)
        new_params, _, _, loss, n = step(
            params, state, opt.init(params), jax.random.PRNGKey(0), ph
        )
        assert int(n) == g.num_nodes

        single = single_cls(
            in_channels=5, hidden_dim=16, num_layers=2, dropout=0.0
        )

        def loss_fn(p):
            logits, _ = single.apply(
                p, state, h, jnp.asarray(g.node_features), train=True
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

    def test_training_loss_decreases(self, cpu_devices):
        g, labels, h = _graph()
        model = ShardedBandedGCN(in_channels=5, hidden_dim=16, num_layers=2)
        params, state = model.init(jax.random.PRNGKey(0))
        mesh = create_mesh(axis_names=("edge",))
        ph = partition_hybrid(h, g.node_features, 8, labels=labels)
        opt = optax.adam(1e-2)
        step = make_sharded_banded_train_step(model, opt, mesh)
        opt_state = opt.init(params)
        losses = []
        for i in range(12):
            params, state, opt_state, loss, _ = step(
                params, state, opt_state, jax.random.PRNGKey(i), ph
            )
            losses.append(float(loss))
        assert losses[-1] < losses[0]

    def test_2d_mesh_hybrid_cohort_matches_block_diag_oracle(self, cpu_devices):
        """The full 2-D × hybrid composition (data × edge psums + halo
        ppermute + remainder all_to_all in one program) must reproduce a
        single-device step on the block-diagonal hybrid cohort exactly —
        the equivalence-chain test the repo convention requires."""
        from connectome_gnn_jax.ops import hybrid_block_diag
        from connectome_gnn_jax.parallel import partition_hybrid_cohort

        mesh = create_mesh(shape=(2, 4), axis_names=("data", "edge"))
        model = ShardedBandedGCN(
            in_channels=5, hidden_dim=16, num_layers=2, dropout=0.0
        )
        params, state = model.init(jax.random.PRNGKey(0))
        subjects = [_graph(seed=50 + i) for i in range(2)]
        stacked = partition_hybrid_cohort(
            [s[2] for s in subjects],
            [s[0].node_features for s in subjects],
            4,
            labels=[s[1] for s in subjects],
        )
        opt = optax.sgd(1e-1)
        step = make_banded_train_step_2d(model, opt, mesh)
        new_params, _, _, loss, n = step(
            params, state, opt.init(params), jax.random.PRNGKey(0), stacked
        )
        assert int(n) == sum(s[0].num_nodes for s in subjects)

        combined, valid = hybrid_block_diag([s[2] for s in subjects])
        x = jnp.concatenate(
            [jnp.asarray(s[0].node_features, jnp.float32) for s in subjects]
        )
        y = jnp.concatenate([jnp.asarray(s[1]) for s in subjects])
        single = BandedNodeGCN(
            in_channels=5, hidden_dim=16, num_layers=2, dropout=0.0
        )

        def loss_fn(p):
            logits, _ = single.apply(
                p, state, combined, x, node_mask=valid, train=True
            )
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

    def test_cohort_capacity_unification(self, cpu_devices):
        """Subjects whose derived remainder paddings differ must still
        stack (capacities are probed and pinned to the worst case)."""
        from connectome_gnn_jax.parallel import partition_hybrid_cohort

        subjects = [
            _graph(seed=60, shortcut_frac=0.05),
            _graph(seed=61, shortcut_frac=0.35),  # far more shortcuts
        ]
        stacked = partition_hybrid_cohort(
            [s[2] for s in subjects],
            [s[0].node_features for s in subjects],
            4,
            labels=[s[1] for s in subjects],
        )
        assert stacked.rem_weights.shape[0] == 2  # data axis stacked
        # conservation per subject
        for i, (g, _, _) in enumerate(subjects):
            total = float(np.asarray(stacked.banded.band[i]).sum()) + float(
                np.asarray(stacked.rem_weights[i]).sum()
            )
            assert np.isclose(total, g.edge_weight.sum(), rtol=1e-5)
