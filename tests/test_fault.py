"""Fault detection, preemption handling, elastic resume (SURVEY §5's
failure-recovery row — the subsystem the reference lacks entirely).

Three contracts:

* a non-finite step (NaN batch → NaN loss/grads) is rejected INSIDE the
  jitted step: parameters/state/optimizer keep their old values, the
  epoch loss stays finite, and the skip is counted;
* the guard is the bitwise identity on clean runs (so it is safe on by
  default);
* SIGTERM during ``fit`` checkpoints and exits cleanly, and a resumed
  run — even on a DIFFERENT device topology — reproduces the
  uninterrupted one.
"""

import signal

import numpy as np
import jax
import pytest

from connectome_gnn_jax.data import ConnectomeDataLoader, generate_dataset
from connectome_gnn_jax.models import GCNConnectome
from connectome_gnn_jax.train import PreemptionGuard, Trainer, reference_adam
from connectome_gnn_jax.train import fault


def make_graphs(poison=False):
    graphs = generate_dataset(num_subjects=40, num_regions=20, seed=7)
    if poison:
        # one bad subject: NaN features produce NaN loss AND NaN grads
        graphs[12].node_features[:] = np.nan
    return graphs


def make_loaders(graphs, num_shards=None, batch_size=10):
    train = ConnectomeDataLoader(
        graphs[:30], batch_size=batch_size, shuffle=False,
        num_shards=num_shards,
    )
    val = ConnectomeDataLoader(
        graphs[30:], batch_size=batch_size, shuffle=False,
        num_shards=num_shards,
    )
    return train, val


def make_trainer(seed=0, guard=True, mesh=None, dropout=None):
    kwargs = {} if dropout is None else {"dropout": dropout}
    model = GCNConnectome(
        in_channels=5, hidden_dim=32, num_classes=2, num_layers=2, **kwargs
    )
    return Trainer(
        model, optimizer=reference_adam(1e-3), seed=seed, mesh=mesh,
        skip_nonfinite=guard,
    )


class TestNonFiniteGuard:
    def test_clean_run_bitwise_identical_with_guard(self):
        graphs = make_graphs()
        h_on = make_trainer(guard=True).fit(
            *make_loaders(graphs), num_epochs=2, patience=10, verbose=False
        )
        t_off = make_trainer(guard=False)
        h_off = t_off.fit(
            *make_loaders(graphs), num_epochs=2, patience=10, verbose=False
        )
        assert h_on["train_loss"] == pytest.approx(h_off["train_loss"], abs=0)
        assert h_on["val_loss"] == pytest.approx(h_off["val_loss"], abs=0)
        assert h_on["skipped_steps"] == [0, 0]

    def test_poisoned_batch_is_skipped_and_training_survives(self):
        graphs = make_graphs(poison=True)
        trainer = make_trainer(guard=True)
        hist = trainer.fit(
            *make_loaders(graphs), num_epochs=2, patience=10, verbose=False
        )
        assert hist["skipped_steps"] == [1, 1]  # same bad batch each epoch
        assert all(np.isfinite(v) for v in hist["train_loss"])
        assert all(
            np.all(np.isfinite(np.asarray(leaf)))
            for leaf in jax.tree_util.tree_leaves(trainer.params)
        )

    def test_without_guard_poison_spreads(self):
        graphs = make_graphs(poison=True)
        trainer = make_trainer(guard=False)
        trainer.fit(
            *make_loaders(graphs), num_epochs=1, patience=10, verbose=False
        )
        assert any(
            not np.all(np.isfinite(np.asarray(leaf)))
            for leaf in jax.tree_util.tree_leaves(trainer.params)
        )

    def test_rejected_step_is_noop(self):
        graphs = make_graphs(poison=True)
        trainer = make_trainer(guard=True)
        train, _ = make_loaders(graphs)
        batches = list(train)
        bad = batches[1]  # subject 12 lives in the second batch of 10
        assert not np.all(np.isfinite(np.asarray(bad.node_features)))
        p0 = jax.tree_util.tree_leaves(trainer.params)
        _ = trainer._train_step  # built lazily in __init__ already
        (params, state, opt_state, _rng, loss, n, ok) = trainer._train_step(
            trainer.params, trainer.state, trainer.opt_state, trainer._rng,
            bad,
        )
        assert float(ok) == 0.0
        assert float(loss) == 0.0 and float(n) == 0.0
        for a, b in zip(p0, jax.tree_util.tree_leaves(params)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    @pytest.mark.slow

    def test_guard_on_dp_mesh(self, cpu_devices):
        from connectome_gnn_jax.parallel import create_mesh

        graphs = make_graphs(poison=True)
        trainer = make_trainer(guard=True, mesh=create_mesh(), dropout=0.0)
        train, val = make_loaders(graphs, num_shards=8, batch_size=8)
        hist = trainer.fit(train, val, num_epochs=1, patience=10, verbose=False)
        assert hist["skipped_steps"][0] >= 1
        assert all(np.isfinite(v) for v in hist["train_loss"])
        assert all(
            np.all(np.isfinite(np.asarray(leaf)))
            for leaf in jax.tree_util.tree_leaves(trainer.params)
        )


class _PreemptingLoader:
    """Delegating loader that raises SIGTERM while iterating a chosen
    epoch — simulating the cloud preemption signal arriving mid-epoch."""

    def __init__(self, inner, fire_at_epoch):
        self._inner = inner
        self._fire_at = fire_at_epoch
        self._epoch = 0

    def set_epoch(self, epoch):
        self._epoch = epoch
        self._inner.set_epoch(epoch)

    def __len__(self):
        return len(self._inner)

    def __iter__(self):
        for i, batch in enumerate(self._inner):
            if i == 0 and self._epoch == self._fire_at:
                signal.raise_signal(signal.SIGTERM)
            yield batch


@pytest.mark.slow
class TestPreemption:
    def test_guard_catches_and_restores(self):
        before = signal.getsignal(signal.SIGTERM)
        with PreemptionGuard() as guard:
            assert not guard.triggered
            signal.raise_signal(signal.SIGTERM)
            assert guard.triggered
        assert signal.getsignal(signal.SIGTERM) is before

    def test_preempted_fit_checkpoints_then_resumes_exactly(self, tmp_path):
        ckpt = str(tmp_path / "ckpt")

        graphs = make_graphs()
        ref = make_trainer(seed=3)
        h_ref = ref.fit(
            *make_loaders(graphs), num_epochs=5, patience=10, verbose=False
        )

        first = make_trainer(seed=3)
        train, val = make_loaders(graphs)
        h_first = first.fit(
            _PreemptingLoader(train, fire_at_epoch=2), val,
            num_epochs=5, patience=10, verbose=False, checkpoint_dir=ckpt,
        )
        # signal fired during epoch 3 (set_epoch is 0-based): that epoch
        # completes, is checkpointed, and fit returns
        assert len(h_first["train_loss"]) == 3

        second = make_trainer(seed=3)
        h_resumed = second.fit(
            *make_loaders(graphs), num_epochs=5, patience=10, verbose=False,
            checkpoint_dir=ckpt, resume=True,
        )
        assert h_resumed["train_loss"] == pytest.approx(
            h_ref["train_loss"], abs=0
        )
        for a, b in zip(
            jax.tree_util.tree_leaves(ref.params),
            jax.tree_util.tree_leaves(second.params),
        ):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.slow
class TestElasticResume:
    def test_resume_on_different_topology(self, tmp_path, cpu_devices):
        """Checkpoint on one device, resume on an 8-device mesh: the DP
        step's shard-count-invariant numerics make recovery exact (up to
        f32 reduction order) even when the slice comes back elastic."""
        from connectome_gnn_jax.parallel import create_mesh

        ckpt = str(tmp_path / "ckpt")
        graphs = make_graphs()

        ref = make_trainer(seed=3, dropout=0.0)
        h_ref = ref.fit(
            *make_loaders(graphs, batch_size=8), num_epochs=3, patience=10,
            verbose=False,
        )

        first = make_trainer(seed=3, dropout=0.0)
        first.fit(
            *make_loaders(graphs, batch_size=8), num_epochs=2, patience=10,
            verbose=False, checkpoint_dir=ckpt,
        )

        second = make_trainer(seed=3, dropout=0.0, mesh=create_mesh())
        h_el = second.fit(
            *make_loaders(graphs, num_shards=8, batch_size=8),
            num_epochs=3, patience=10, verbose=False,
            checkpoint_dir=ckpt, resume=True,
        )
        np.testing.assert_allclose(
            h_el["train_loss"][-1], h_ref["train_loss"][-1],
            rtol=5e-3, atol=1e-4,
        )
        for a, b in zip(
            jax.tree_util.tree_leaves(ref.params),
            jax.tree_util.tree_leaves(second.params),
        ):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=5e-3, atol=5e-4
            )


def _node_task(n=512, degree=8, band=32):
    from connectome_gnn_jax.data import generate_spatial_graph

    g = generate_spatial_graph(n, degree=degree, band=band, seed=0)
    src, dst = g.edge_index
    num = np.zeros(g.num_nodes)
    den = np.zeros(g.num_nodes)
    np.add.at(num, dst, g.edge_weight * g.node_features[src, 0])
    np.add.at(den, dst, g.edge_weight)
    agg = num / (den + 1e-8)
    return g, (agg > np.median(agg)).astype(np.int32)


@pytest.mark.slow
class TestRound4ModeResume:
    """Checkpoint/resume coverage for the round-4 training modes
    (VERDICT r4 #7): mesh-mode device-sampled DP resumes bitwise, and
    the graph-sharded mode resumes onto a DIFFERENT shard count
    (repartition + optimizer-state carry — parameters are
    partition-independent)."""

    def test_mesh_device_sampled_fit_resume_exact(self, tmp_path,
                                                  cpu_devices):
        from connectome_gnn_jax.data import device_sampled_gcn
        from connectome_gnn_jax.parallel import create_mesh

        ckpt = str(tmp_path / "ckpt")
        g, labels = _node_task()
        mesh = create_mesh(devices=cpu_devices[:4])

        def mk():
            model = device_sampled_gcn(g, hidden_dim=16, fanout=(4, 4))
            tr = model.make_loader(
                np.arange(512), labels, batch_size=64, seed=0,
                num_shards=4, drop_last=True,
            )
            va = model.make_loader(
                np.arange(512), labels, batch_size=64, seed=1,
                num_shards=4, shuffle=False,
            )
            return model, tr, va

        m, tr, va = mk()
        ref = Trainer(m, seed=3, mesh=mesh)
        h_ref = ref.fit(tr, va, num_epochs=4, patience=10, verbose=False)

        m, tr, va = mk()
        first = Trainer(m, seed=3, mesh=mesh)
        first.fit(tr, va, num_epochs=2, patience=10, verbose=False,
                  checkpoint_dir=ckpt)

        m, tr, va = mk()
        second = Trainer(m, seed=3, mesh=mesh)
        h_res = second.fit(tr, va, num_epochs=4, patience=10,
                           verbose=False, checkpoint_dir=ckpt, resume=True)
        # epoch-pinned shuffles + (seed, epoch, step, shard)-keyed
        # sampling streams make the resumed run an exact replay
        np.testing.assert_allclose(
            h_res["train_loss"], h_ref["train_loss"], rtol=1e-6
        )
        for a, b in zip(
            jax.tree_util.tree_leaves(ref.params),
            jax.tree_util.tree_leaves(second.params),
        ):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_graph_sharded_resume_at_different_shard_count(
        self, tmp_path, cpu_devices
    ):
        from connectome_gnn_jax.parallel import create_mesh, graph_sharded_sage

        ckpt = str(tmp_path / "ckpt")
        g, labels = _node_task()

        def mk(num_shards, n_dev):
            model = graph_sharded_sage(
                g, num_shards=num_shards, hidden_dim=16, fanout=(6, 6)
            )
            mesh = create_mesh(devices=cpu_devices[:n_dev])
            tr = model.make_loader(
                np.arange(512), labels, batch_size=64, seed=0,
                drop_last=True,
            )
            va = model.make_loader(
                np.arange(512), labels, batch_size=64, seed=1,
                shuffle=False, drop_last=True,
            )
            return Trainer(model, seed=0, mesh=mesh), tr, va

        t1, tr, va = mk(4, 4)
        t1.fit(tr, va, num_epochs=2, patience=20, verbose=False,
               checkpoint_dir=ckpt)

        # restore-only at D=2: the carried state is partition-independent
        t2, tr2, va2 = mk(2, 2)
        t2.fit(tr2, va2, num_epochs=2, patience=20, verbose=False,
               checkpoint_dir=ckpt, resume=True)  # already-done: no-op
        for a, b in zip(
            jax.tree_util.tree_leaves(t1.params),
            jax.tree_util.tree_leaves(t2.params),
        ):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

        # continue training at D=2 (repartitioned graph, carried Adam
        # state): epochs 3-4 run on the 2-device mesh and the task stays
        # learned; the compacted exchange stays exact
        t3, tr3, va3 = mk(2, 2)
        h = t3.fit(tr3, va3, num_epochs=4, patience=20, verbose=False,
                   checkpoint_dir=ckpt, resume=True)
        assert len(h["train_loss"]) == 4
        assert np.isfinite(h["train_loss"]).all()
        assert t3.evaluate(va3)["accuracy"] > 0.6
        assert t3.last_sampling_overflow == 0


class TestFaultPrimitives:
    def test_all_finite_and_select(self):
        import jax.numpy as jnp

        good = {"a": jnp.ones(3), "b": jnp.zeros(2)}
        bad = {"a": jnp.ones(3), "b": jnp.array([1.0, np.nan])}
        assert bool(fault.all_finite(good))
        assert not bool(fault.all_finite(good, bad))
        picked = fault.select_tree(fault.all_finite(bad), bad, good)
        np.testing.assert_array_equal(np.asarray(picked["b"]), [0.0, 0.0])
