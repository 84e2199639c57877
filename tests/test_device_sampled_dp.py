"""Device-sampled data parallelism (`parallel/sampled_dp.py`).

The composition VERDICT r3 #1 asked for: the device-side sampler's seed
payloads shard over the DP mesh while the CSR replicates.  Oracles:

* host-side: sharded / process-sharded loaders must tile the unsharded
  per-shard row stream exactly (same global sampling streams);
* step-level: the explicit-csr shard_map step must match the GENERIC
  ``make_dp_train_step`` run on the same stacked batch with the CSR
  captured by closure (mathematically identical programs — only the
  argument plumbing differs);
* end-to-end: mesh-mode ``Trainer.fit`` over sharded seed loaders learns
  the one-hop task, and the DP eval step equals the sum of per-shard
  single-device evals.

Reference op being scaled: /root/reference/connectome_gnn/models.py:45-54
(the reference has no sampling or parallelism, SURVEY §0).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from connectome_gnn_jax.data import (
    DeviceSeedLoader,
    device_sampled_gcn,
    generate_spatial_graph,
)
from connectome_gnn_jax.data.device_sampling import SeedBatch
from connectome_gnn_jax.parallel import (
    create_mesh,
    make_device_sampled_dp_eval_step,
    make_device_sampled_dp_step,
    make_dp_train_step,
    replicate_csr,
)
from connectome_gnn_jax.train import Trainer, reference_adam


def _task(n=512, degree=8, band=32, seed=0):
    g = generate_spatial_graph(n, degree=degree, band=band, seed=seed)
    src, dst = g.edge_index
    num = np.zeros(g.num_nodes)
    den = np.zeros(g.num_nodes)
    np.add.at(num, dst, g.edge_weight * g.node_features[src, 0])
    np.add.at(den, dst, g.edge_weight)
    agg = num / (den + 1e-8)
    labels = (agg > np.median(agg)).astype(np.int32)
    return g, labels


class TestShardedLoader:
    def test_sharded_rows_tile_process_shards(self):
        labels = (np.arange(64) % 2).astype(np.int32)
        full = DeviceSeedLoader(
            np.arange(64), labels, batch_size=32, seed=3, num_shards=8
        )
        stacks = [np.asarray(b.packed) for b in full]
        assert all(s.shape[0] == 8 for s in stacks)
        for p in range(4):
            lo = DeviceSeedLoader(
                np.arange(64), labels, batch_size=32, seed=3, num_shards=8,
                process_index=p, process_count=4,
            )
            lo.set_epoch(0)
            for got, want in zip(
                (np.asarray(b.packed) for b in lo), stacks
            ):
                np.testing.assert_array_equal(got, want[2 * p : 2 * p + 2])

    def test_stacked_batch_properties_broadcast(self):
        labels = (np.arange(64) % 2).astype(np.int32)
        lo = DeviceSeedLoader(
            np.arange(64), labels, batch_size=32, seed=0, num_shards=4
        )
        b = next(iter(lo))
        assert b.stacked and b.num_seeds == 8
        assert b.seeds.shape == (4, 8)
        assert b.labels.shape == (4, 8)
        assert b.label_mask.shape == (4, 8)
        assert bool(jnp.all(b.seed_mask))
        # all 32 global seeds appear exactly once across the shard rows
        assert sorted(np.asarray(b.seeds).ravel().tolist()) == sorted(
            set(np.asarray(b.seeds).ravel().tolist())
        )

    def test_final_partial_batch_pads_trailing_shards(self):
        lo = DeviceSeedLoader(
            np.arange(40), None, batch_size=32, seed=0, num_shards=4,
            shuffle=False,
        )
        batches = list(lo)
        assert len(batches) == 2
        last = np.asarray(batches[-1].packed)
        assert last[0, 0] == 8 and last[1, 0] == 0  # real-seed counts
        assert batches[-1].labeled is False

    def test_indivisible_batch_raises(self):
        with pytest.raises(ValueError):
            DeviceSeedLoader(np.arange(8), batch_size=10, num_shards=4)


class TestDPStep:
    @pytest.mark.slow
    def test_matches_generic_closure_path(self, cpu_devices):
        """Explicit-csr step == generic make_dp_train_step with the CSR
        captured by closure, on the same stacked batch (bit-level up to
        reduction order — assert tight allclose)."""
        g, labels = _task()
        model = device_sampled_gcn(g, hidden_dim=16, fanout=(4, 4))
        mesh = create_mesh(devices=cpu_devices[:4])
        opt = reference_adam()
        params, state = model.init(jax.random.PRNGKey(0))
        opt_state = opt.init(params)

        lo = model.make_loader(
            np.arange(g.num_nodes), labels, batch_size=64, seed=0,
            num_shards=4, drop_last=True,
        )
        batch = next(iter(lo))
        key = jax.random.PRNGKey(7)

        step = make_device_sampled_dp_step(model, opt, mesh)
        p1, s1, o1, loss1, n1 = step(
            params, state, opt_state, key, batch.packed,
            replicate_csr(model.csr, mesh),
        )

        generic = make_dp_train_step(model, opt, mesh)
        closure_batch = dataclasses.replace(batch, csr=None)
        p2, s2, o2, loss2, n2 = generic(
            params, state, opt_state, key, closure_batch
        )

        assert float(n1) == float(n2) == 64.0
        assert jnp.allclose(loss1, loss2, rtol=1e-6, atol=1e-7)
        for a, b in zip(
            jax.tree_util.tree_leaves(p1), jax.tree_util.tree_leaves(p2)
        ):
            assert jnp.allclose(a, b, rtol=1e-6, atol=1e-7)
        for a, b in zip(
            jax.tree_util.tree_leaves(s1), jax.tree_util.tree_leaves(s2)
        ):
            assert jnp.allclose(a, b, rtol=1e-6, atol=1e-7)

    def test_eval_equals_sum_of_per_shard_evals(self, cpu_devices):
        g, labels = _task(seed=1)
        model = device_sampled_gcn(g, hidden_dim=16, fanout=(4, 4))
        mesh = create_mesh(devices=cpu_devices[:4])
        params, state = model.init(jax.random.PRNGKey(0))

        lo = model.make_loader(
            np.arange(g.num_nodes), labels, batch_size=64, seed=2,
            num_shards=4, drop_last=True, shuffle=False,
        )
        batch = next(iter(lo))
        ev = make_device_sampled_dp_eval_step(model, mesh)
        loss_sum, correct, n = ev(
            params, state, batch.packed, replicate_csr(model.csr, mesh)
        )

        # per-shard single-device reference (eval: running BN, no psum)
        import optax

        tot_l, tot_c, tot_n = 0.0, 0, 0.0
        for row in np.asarray(batch.packed):
            rb = SeedBatch(
                packed=jnp.asarray(row), csr=model.csr,
                num_seeds=batch.num_seeds, labeled=True,
            )
            logits, _ = model.apply(params, state, rb, train=False)
            ce = optax.softmax_cross_entropy_with_integer_labels(
                logits, rb.labels
            )
            m = rb.label_mask.astype(jnp.float32)
            tot_l += float(jnp.sum(ce * m))
            tot_c += int(
                jnp.sum((jnp.argmax(logits, 1) == rb.labels) * rb.label_mask)
            )
            tot_n += float(jnp.sum(m))
        assert float(n) == tot_n == 64.0
        assert int(correct) == tot_c
        assert np.isclose(float(loss_sum), tot_l, rtol=1e-5)

    def test_multiset_step_matches_generic_closure_path(self, cpu_devices):
        """The multiset (dedup=False) SAGE model composes with the DP
        step unchanged: explicit-csr shard_map step == generic
        make_dp_train_step on the same stacked batch."""
        from connectome_gnn_jax.data import device_sampled_sage

        g, labels = _task()
        model = device_sampled_sage(
            g, hidden_dim=16, fanout=(4, 4), dedup=False
        )
        mesh = create_mesh(devices=cpu_devices[:4])
        opt = reference_adam()
        params, state = model.init(jax.random.PRNGKey(0))
        opt_state = opt.init(params)

        lo = model.make_loader(
            np.arange(g.num_nodes), labels, batch_size=64, seed=0,
            num_shards=4, drop_last=True,
        )
        batch = next(iter(lo))
        key = jax.random.PRNGKey(7)

        step = make_device_sampled_dp_step(model, opt, mesh)
        p1, s1, o1, loss1, n1 = step(
            params, state, opt_state, key, batch.packed,
            replicate_csr(model.csr, mesh),
        )

        generic = make_dp_train_step(model, opt, mesh)
        closure_batch = dataclasses.replace(batch, csr=None)
        p2, s2, o2, loss2, n2 = generic(
            params, state, opt_state, key, closure_batch
        )

        assert float(n1) == float(n2) == 64.0
        assert jnp.allclose(loss1, loss2, rtol=1e-6, atol=1e-7)
        for a, b in zip(
            jax.tree_util.tree_leaves(p1), jax.tree_util.tree_leaves(p2)
        ):
            assert jnp.allclose(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.slow
class TestTrainerMeshMode:
    def test_fit_learns_one_hop_task_sharded(self, cpu_devices):
        g, labels = _task(n=1024)
        model = device_sampled_gcn(g, hidden_dim=32, fanout=(8, 8))
        mesh = create_mesh(devices=cpu_devices[:4])
        tr = model.make_loader(
            np.arange(1024), labels, batch_size=128, seed=0,
            num_shards=4, drop_last=True,
        )
        va = model.make_loader(
            np.arange(1024), labels, batch_size=128, seed=1,
            num_shards=4, shuffle=False,
        )
        trainer = Trainer(model, seed=0, mesh=mesh)
        hist = trainer.fit(tr, va, num_epochs=4, patience=10, verbose=False)
        assert hist["train_loss"][-1] < hist["train_loss"][0]
        assert hist["val_acc"][-1] > 0.6

    def test_scanned_epoch_over_mesh_matches_stepwise(self, cpu_devices):
        """Trainer(scan_epochs=True, mesh=...) — the round-5 composition
        of the epoch scan with the shard_map DP step — must replicate
        the stepwise mesh loop bitwise on params (BN state to float
        precision), for TWO epochs (rng schedule advances identically)."""
        g, labels = _task(n=512)
        mesh = create_mesh(devices=cpu_devices[:4])

        def make():
            model = device_sampled_gcn(g, hidden_dim=16, fanout=(4, 4))
            loader = model.make_loader(
                np.arange(512), labels, batch_size=64, seed=0,
                num_shards=4, drop_last=True,
            )
            return model, loader

        m1, l1 = make()
        t_step = Trainer(m1, seed=0, mesh=mesh, prefetch_depth=0)
        m2, l2 = make()
        t_scan = Trainer(m2, seed=0, mesh=mesh, scan_epochs=True)

        for epoch in range(2):
            l1.set_epoch(epoch)
            l2.set_epoch(epoch)
            loss_step = t_step.train_epoch(l1)
            loss_scan = t_scan.train_epoch(l2)
            np.testing.assert_allclose(loss_scan, loss_step, rtol=1e-6)
        for a, b in zip(
            jax.tree_util.tree_leaves(t_step.params),
            jax.tree_util.tree_leaves(t_scan.params),
        ):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(
            jax.tree_util.tree_leaves(t_step.state),
            jax.tree_util.tree_leaves(t_scan.state),
        ):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7
            )

    def test_scanned_epoch_mesh_needs_sharded_loader(self, cpu_devices):
        g, labels = _task(n=128)
        model = device_sampled_gcn(g, hidden_dim=8, fanout=(2, 2))
        mesh = create_mesh(devices=cpu_devices[:2])
        lo = model.make_loader(np.arange(128), labels, batch_size=32)
        trainer = Trainer(model, seed=0, mesh=mesh, scan_epochs=True,
                          prefetch_depth=0)
        with pytest.raises(ValueError, match="num_shards=2"):
            trainer.train_epoch(lo)

    def test_unstacked_seed_batch_in_mesh_mode_raises(self, cpu_devices):
        g, labels = _task(n=128)
        model = device_sampled_gcn(g, hidden_dim=8, fanout=(2, 2))
        mesh = create_mesh(devices=cpu_devices[:2])
        lo = model.make_loader(
            np.arange(128), labels, batch_size=32, seed=0
        )
        trainer = Trainer(model, seed=0, mesh=mesh, prefetch_depth=0)
        with pytest.raises(ValueError, match="sharded DeviceSeedLoader"):
            trainer.train_epoch(lo)
