"""2-D (data × edge) combined parallelism over giant banded graphs.

The 2-D step trains a cohort of giant graphs jointly: subjects sharded
over the ``data`` axis, each subject's row blocks sharded over the
``edge`` axis.  The single-device oracle is a plain BandedNodeGCN over the
block-diagonal concatenation of the cohort
(:func:`connectome_gnn_jax.ops.banded.banded_block_diag`) — the sharded
step must reproduce its loss AND its gradients exactly (sync-BN over both
axes, globally normalized masked loss).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from connectome_gnn_jax.data import generate_spatial_graph
from connectome_gnn_jax.ops import banded_block_diag, to_banded
from connectome_gnn_jax.parallel import (
    ShardedBandedGCN,
    create_mesh,
    make_banded_train_step_2d,
    partition_banded,
    stack_partitioned,
)

DATA, EDGE = 2, 4  # 2×4 over the 8 virtual CPU devices


def _cohort(num_subjects=2, n=768, block=32):
    """Same-shape spatial giant graphs with degree-median node labels."""
    subjects = []
    for i in range(num_subjects):
        g = generate_spatial_graph(n, degree=6, band=40, seed=100 + i)
        labels = (g.degree() > np.median(g.degree())).astype(np.int32)
        a = to_banded(
            g.edge_index[0], g.edge_index[1], g.edge_weight, g.num_nodes,
            block=block, bandwidth=2,
        )
        subjects.append((a, g.node_features, labels))
    return subjects


@pytest.fixture(scope="module")
def mesh2d(cpu_devices):
    return create_mesh(shape=(DATA, EDGE), axis_names=("data", "edge"))


class TestBlockDiag:
    def test_block_diag_is_exact(self):
        """Concat band == block-diagonal matrix: SpMM on the combined form
        equals per-part SpMMs stacked."""
        from connectome_gnn_jax.ops import banded_spmm

        subjects = _cohort()
        combined, valid = banded_block_diag([s[0] for s in subjects])
        x = jnp.concatenate([jnp.asarray(s[1]) for s in subjects])
        assert bool(valid.all())  # n divisible by block → no internal pad
        out = banded_spmm(combined, x)
        parts = [banded_spmm(s[0], jnp.asarray(s[1])) for s in subjects]
        np.testing.assert_allclose(
            np.asarray(out), np.asarray(jnp.concatenate(parts)),
            rtol=1e-5, atol=1e-5,
        )

    def test_block_diag_rejects_mixed_shapes(self):
        subjects = _cohort()
        other = to_banded(
            np.array([0]), np.array([1]), np.array([1.0]), 64,
            block=64, bandwidth=0,
        )
        with pytest.raises(ValueError):
            banded_block_diag([subjects[0][0], other])


class TestTrainStep2D:
    def _stacked(self, subjects):
        return stack_partitioned(
            [
                partition_banded(a, x, EDGE, labels=lab)
                for a, x, lab in subjects
            ]
        )

    def test_loss_decreases(self, mesh2d):
        subjects = _cohort()
        model = ShardedBandedGCN(in_channels=5, hidden_dim=16, num_layers=2)
        params, state = model.init(jax.random.PRNGKey(0))
        stacked = self._stacked(subjects)
        opt = optax.adam(1e-2)
        step = make_banded_train_step_2d(model, opt, mesh2d)
        opt_state = opt.init(params)
        losses = []
        for i in range(12):
            params, state, opt_state, loss, n = step(
                params, state, opt_state, jax.random.PRNGKey(i), stacked
            )
            losses.append(float(loss))
        assert int(n) == sum(s[0].num_nodes for s in subjects)
        assert losses[-1] < losses[0]

    def test_grads_match_block_diag_oracle(self, mesh2d):
        """One 2-D-sharded step == single-device step on the block-diagonal
        cohort (exact sync-BN over both mesh axes)."""
        from connectome_gnn_jax.models import BandedNodeGCN

        subjects = _cohort()
        model = ShardedBandedGCN(
            in_channels=5, hidden_dim=16, num_layers=2, dropout=0.0
        )
        params, state = model.init(jax.random.PRNGKey(0))
        stacked = self._stacked(subjects)
        opt = optax.sgd(1e-1)
        step = make_banded_train_step_2d(model, opt, mesh2d)
        new_params, new_state, _, loss, n = step(
            params, state, opt.init(params), jax.random.PRNGKey(0), stacked
        )
        assert int(n) == sum(s[0].num_nodes for s in subjects)

        combined, valid = banded_block_diag([s[0] for s in subjects])
        x = jnp.concatenate([jnp.asarray(s[1], jnp.float32) for s in subjects])
        y = jnp.concatenate([jnp.asarray(s[2]) for s in subjects])
        single = BandedNodeGCN(
            in_channels=5, hidden_dim=16, num_layers=2, dropout=0.0
        )

        def loss_fn(p):
            logits, new_st = single.apply(
                p, state, combined, x, node_mask=valid, train=True
            )
            ce = optax.softmax_cross_entropy_with_integer_labels(logits, y)
            return jnp.mean(ce), new_st

        (oracle_loss, oracle_state), oracle_grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(params)
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
        # BatchNorm running stats must match the cohort-wide oracle too.
        for s_new, s_exp in zip(
            jax.tree_util.tree_leaves(new_state),
            jax.tree_util.tree_leaves(oracle_state),
        ):
            np.testing.assert_allclose(
                np.asarray(s_new), np.asarray(s_exp), rtol=1e-4, atol=1e-5
            )

    def test_one_d_step_unchanged_by_stats_axes_default(self, cpu_devices):
        """Regression: the 1-D sharded step (stats_axes default) still
        matches its single-device oracle after the stats_axes refactor."""
        from connectome_gnn_jax.models import BandedNodeGCN
        from connectome_gnn_jax.parallel import make_sharded_banded_train_step

        a, x, labels = _cohort(num_subjects=1)[0]
        model = ShardedBandedGCN(
            in_channels=5, hidden_dim=16, num_layers=2, dropout=0.0
        )
        params, state = model.init(jax.random.PRNGKey(0))
        mesh = create_mesh(axis_names=("edge",))
        pb = partition_banded(a, x, 8, labels=labels)
        opt = optax.sgd(1e-1)
        step = make_sharded_banded_train_step(model, opt, mesh)
        _, _, _, loss, _ = step(
            params, state, opt.init(params), jax.random.PRNGKey(0), pb
        )

        single = BandedNodeGCN(
            in_channels=5, hidden_dim=16, num_layers=2, dropout=0.0
        )

        def loss_fn(p):
            logits, _ = single.apply(
                p, state, a, jnp.asarray(x, jnp.float32), train=True
            )
            ce = optax.softmax_cross_entropy_with_integer_labels(
                logits, jnp.asarray(labels)
            )
            return jnp.mean(ce)

        np.testing.assert_allclose(
            float(loss), float(loss_fn(params)), rtol=1e-4
        )
