"""Multi-device tests on the 8-way virtual CPU mesh.

The key invariant: data-parallel training over the mesh is numerically
equivalent to single-device training on the same batches (sync-BN psums +
globally masked loss), so scaling out never changes results.
"""

import numpy as np
import jax
import pytest

from connectome_gnn_jax.data import ConnectomeDataLoader, generate_dataset
from connectome_gnn_jax.models import GCNConnectome, GraphSAGEConnectome
from connectome_gnn_jax.parallel import create_mesh, stack_batches
from connectome_gnn_jax.train import Trainer, reference_adam


@pytest.fixture(scope="module")
def dataset():
    return generate_dataset(num_subjects=24, num_regions=20, seed=9)


def make_loaders(dataset, num_shards=None, batch_size=8):
    # dropout off so single-device and sharded runs see identical functions
    # (dropout RNG is shard-shaped by design)
    train = ConnectomeDataLoader(
        dataset[:16], batch_size=batch_size, shuffle=False, num_shards=num_shards
    )
    val = ConnectomeDataLoader(
        dataset[16:], batch_size=batch_size, shuffle=False, num_shards=num_shards
    )
    return train, val


class TestMesh:
    def test_create_mesh_all_devices(self, cpu_devices):
        mesh = create_mesh()
        assert mesh.shape["data"] == 8


@pytest.mark.slow
class TestDataParallel:
    def test_sharded_loader_shapes(self, dataset, cpu_devices):
        loader = ConnectomeDataLoader(
            dataset, batch_size=8, shuffle=False, num_shards=4
        )
        batch = next(iter(loader))
        assert batch.node_features.shape[0] == 4  # leading device axis
        assert batch.num_graphs == 2  # per-shard slots

    def test_indivisible_batch_raises(self, dataset):
        with pytest.raises(ValueError):
            ConnectomeDataLoader(dataset, batch_size=10, num_shards=4)

    def test_dp_matches_single_device(self, dataset, cpu_devices):
        """3 epochs of DP training == 3 epochs of single-device training."""
        mesh = create_mesh()
        model = GCNConnectome(in_channels=5, hidden_dim=16, num_layers=2, dropout=0.0)

        single_tr, single_va = make_loaders(dataset)
        t_single = Trainer(model, optimizer=reference_adam(1e-3), seed=0)
        h_single = t_single.fit(
            single_tr, single_va, num_epochs=3, patience=10, verbose=False
        )

        dp_tr, dp_va = make_loaders(dataset, num_shards=8)
        t_dp = Trainer(model, optimizer=reference_adam(1e-3), seed=0, mesh=mesh)
        h_dp = t_dp.fit(dp_tr, dp_va, num_epochs=3, patience=10, verbose=False)

        # f32 reduction order differs (per-shard sums + psum tree vs one
        # global sum) and drifts through Adam, so tolerances are loose
        # enough for associativity but far below any semantic error
        # (a wrong loss normalization or BN stat shows up at the % level).
        np.testing.assert_allclose(
            h_single["train_loss"], h_dp["train_loss"], rtol=5e-3, atol=1e-4
        )
        np.testing.assert_allclose(
            h_single["val_loss"], h_dp["val_loss"], rtol=5e-3, atol=1e-4
        )
        for a, b in zip(
            jax.tree_util.tree_leaves(t_single.params),
            jax.tree_util.tree_leaves(t_dp.params),
        ):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=5e-3, atol=5e-4)

    def test_dp_eval_with_ragged_final_batch(self, dataset, cpu_devices):
        """Final partial batch leaves some shards empty — metrics must still
        count exactly the real graphs."""
        mesh = create_mesh()
        model = GCNConnectome(in_channels=5, hidden_dim=16, num_layers=2)
        # 8 val graphs, batch 16 over 8 shards → shard size 2, half empty
        val = ConnectomeDataLoader(
            dataset[16:], batch_size=16, shuffle=False, num_shards=8
        )
        trainer = Trainer(model, seed=0, mesh=mesh)
        metrics = trainer.evaluate(val)
        assert metrics["total"] == 8

    def test_dp_sage_trains(self, dataset, cpu_devices):
        mesh = create_mesh()
        model = GraphSAGEConnectome(in_channels=5, hidden_dim=16, num_layers=2)
        tr, va = make_loaders(dataset, num_shards=8)
        trainer = Trainer(model, seed=0, mesh=mesh)
        history = trainer.fit(tr, va, num_epochs=2, patience=5, verbose=False)
        assert len(history["train_loss"]) == 2
        assert all(np.isfinite(v) for v in history["train_loss"])
