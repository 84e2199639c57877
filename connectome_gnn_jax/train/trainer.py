"""Training loop: jitted steps, early stopping, best-weights restore.

Mirrors the reference ``Trainer`` contract (reference
``connectome_gnn/train.py:19-127``): cross-entropy objective, per-epoch
train/eval with loss accumulation weighted by real graph count, early
stopping on validation loss with patience, best-state snapshot and restore.

Structure: the per-batch work is two jitted pure functions
(``train_step``: value_and_grad + optax update + BatchNorm state advance;
``eval_step``: logits → masked loss/accuracy sums) compiled once thanks to
the loader's fixed batch shapes.  The epoch driver stays on host and only
pulls scalars off device once per epoch.  Padded graph slots are excluded
from the loss and metrics via ``label_mask``, so numbers match the
reference's unpadded semantics exactly.

The default optimizer reproduces the reference recipe
``torch.optim.Adam(lr=1e-3, weight_decay=1e-4)``: in torch, Adam's
``weight_decay`` adds ``wd · θ`` to the *gradient* before the moment
updates (L2 regularization, not AdamW), which is
``optax.chain(optax.add_decayed_weights(wd), optax.adam(lr))``.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import optax

from connectome_gnn_jax.data.batch import ConnectomeBatch
from connectome_gnn_jax.data.loader import ConnectomeDataLoader
from connectome_gnn_jax.train import fault


def reference_adam(
    learning_rate: float = 1e-3, weight_decay: float = 1e-4
) -> optax.GradientTransformation:
    """torch.optim.Adam(lr, weight_decay) equivalent (L2-into-grad Adam)."""
    if weight_decay:
        return optax.chain(
            optax.add_decayed_weights(weight_decay),
            optax.adam(learning_rate),
        )
    return optax.adam(learning_rate)


class Trainer:
    """Training driver for connectome GNN classifiers.

    Parameters
    ----------
    model
        A :class:`GCNConnectome` / :class:`GraphSAGEConnectome` (or any
        object with the same ``init`` / ``apply`` protocol).
    optimizer
        An ``optax.GradientTransformation``; defaults to the reference
        recipe (Adam lr=1e-3 with L2 weight decay 1e-4).
    seed
        PRNG seed for parameter init and dropout streams.
    params / state
        Optional pre-built parameter/state pytrees (e.g. loaded from a
        checkpoint or converted from reference weights).
    mesh / axis_name
        When a ``jax.sharding.Mesh`` is given, training runs data-parallel
        via ``shard_map`` over ``axis_name``: loaders must then yield
        stacked batches (``ConnectomeDataLoader(..., num_shards=D)`` with
        ``D == mesh.shape[axis_name]``).  Numerics are exact vs
        single-device training (sync-BN, globally masked loss).
    skip_nonfinite
        In-run fault detection (on by default): a step whose loss,
        gradients, or BatchNorm update contain non-finite values is
        rejected inside the jitted step — parameters/state/optimizer keep
        their old values and the step counts toward
        ``last_skipped_steps`` (surfaced per-epoch in ``fit``'s history
        as ``skipped_steps``).  When every value is finite the guard is
        the identity, bitwise.  See ``train/fault.py``.
    prefetch_depth
        Background-thread batch prefetching (default 2): host-side work
        per batch — neighbor sampling, collation, padding, host→device
        transfer — runs ``prefetch_depth`` batches ahead of the device
        while the previous step executes, instead of serializing with it
        the way the reference's in-loop collation does (reference
        ``graph.py:190-197``).  Values are unchanged (prefetching
        reorders nothing); set 0 to iterate loaders synchronously.
    scan_epochs
        Device-sampled models only (single-device): run each TRAINING
        epoch as ONE ``lax.scan``-ed program over the packed seed buffer
        (:func:`~connectome_gnn_jax.data.device_sampling.
        make_epoch_runner`) — one host→device transfer and one dispatch
        per epoch instead of per step.  Step semantics replicate the
        step-by-step loop to float precision (same rng schedule, same
        masked CE/Adam), so ``fit``'s early stopping, best-restore, and
        checkpoint/resume work unchanged.  The non-finite step guard
        does NOT run inside the scanned epoch (``skipped_steps`` reports
        0); evaluation always runs step-by-step.
    """

    def __init__(
        self,
        model,
        optimizer: Optional[optax.GradientTransformation] = None,
        seed: int = 0,
        params: Optional[dict] = None,
        state: Optional[dict] = None,
        mesh=None,
        axis_name: str = "data",
        skip_nonfinite: bool = True,
        prefetch_depth: int = 2,
        scan_epochs: bool = False,
    ):
        self.model = model
        self.optimizer = optimizer if optimizer is not None else reference_adam()
        self.mesh = mesh
        self.axis_name = axis_name
        self.skip_nonfinite = skip_nonfinite
        self.prefetch_depth = int(prefetch_depth)
        self.scan_epochs = bool(scan_epochs)
        self._epoch_runner = None
        self.last_skipped_steps = 0
        #: graph-sharded compacted-exchange overflow (dropped request
        #: slots) summed over the last training epoch; 0 = exact
        self.last_sampling_overflow = 0

        key = jax.random.PRNGKey(seed)
        init_key, self._rng = jax.random.split(key)
        if params is None or state is None:
            init_params, init_state = model.init(init_key)
            params = params if params is not None else init_params
            state = state if state is not None else init_state
        self.params = params
        self.state = state
        self.opt_state = self.optimizer.init(self.params)
        if mesh is not None and jax.process_count() == 1:
            # commit the training state to the mesh (replicated) UP
            # FRONT: otherwise the first step compiles for uncommitted
            # inputs, its outputs come back committed, and the SECOND
            # call recompiles the whole program — one wasted compile
            # per jitted step family (worst for the one-dispatch-per-
            # epoch scanned path, where it doubled the first epochs)
            from jax.sharding import NamedSharding, PartitionSpec

            sh = NamedSharding(mesh, PartitionSpec())
            self.params, self.state, self.opt_state = jax.device_put(
                (self.params, self.state, self.opt_state), sh
            )
            self._rng = jax.device_put(self._rng, sh)

        if mesh is None:
            self._train_step = self._build_train_step()
            self._eval_step = self._build_eval_step()
        else:
            from connectome_gnn_jax.parallel.data_parallel import (
                make_dp_eval_step,
                make_dp_train_step,
            )

            self._dp_train_step = make_dp_train_step(
                model, self.optimizer, mesh, axis_name,
                guard=self.skip_nonfinite,
            )
            self._dp_eval_step = make_dp_eval_step(model, mesh, axis_name)

    # ------------------------------------------------------------------
    # Jitted step builders
    # ------------------------------------------------------------------

    def _build_train_step(self):
        model, optimizer = self.model, self.optimizer
        guard = self.skip_nonfinite

        @jax.jit
        def train_step(params, state, opt_state, rng, batch: ConnectomeBatch):
            rng, step_key = jax.random.split(rng)

            def loss_fn(p):
                logits, new_state = model.apply(
                    p, state, batch, train=True, rng=step_key
                )
                ce = optax.softmax_cross_entropy_with_integer_labels(
                    logits, batch.labels
                )
                mask = batch.label_mask.astype(jnp.float32)
                n = jnp.sum(mask)
                loss = jnp.sum(ce * mask) / jnp.maximum(n, 1.0)
                return loss, (new_state, n)

            (loss, (new_state, n)), grads = jax.value_and_grad(
                loss_fn, has_aux=True
            )(params)
            updates, new_opt_state = optimizer.update(grads, opt_state, params)
            new_params = optax.apply_updates(params, updates)
            if not guard:
                return new_params, new_state, new_opt_state, rng, loss, n, 1.0
            ok = fault.all_finite(loss, grads, new_state)
            trees, loss, n, ok_f = fault.guard_step_outputs(
                ok,
                (new_params, new_state, new_opt_state),
                (params, state, opt_state),
                loss, n,
            )
            return (*trees, rng, loss, n, ok_f)

        return train_step

    def _build_eval_step(self):
        model = self.model

        @jax.jit
        def eval_step(params, state, batch: ConnectomeBatch):
            logits, _ = model.apply(params, state, batch, train=False)
            ce = optax.softmax_cross_entropy_with_integer_labels(
                logits, batch.labels
            )
            mask = batch.label_mask.astype(jnp.float32)
            preds = jnp.argmax(logits, axis=1)
            correct = jnp.sum(
                (preds == batch.labels).astype(jnp.int32) * batch.label_mask
            )
            return jnp.sum(ce * mask), correct, jnp.sum(mask)

        return eval_step

    def _iterate(self, loader):
        """Iterate ``loader``, prefetching ``prefetch_depth`` batches in a
        background thread (sampling/collation overlap device compute)."""
        if self.prefetch_depth > 0:
            from connectome_gnn_jax.data.prefetch import PrefetchIterator

            return PrefetchIterator(loader, depth=self.prefetch_depth)
        return iter(loader)

    def _maybe_global(self, batch):
        """Multi-process mesh mode: lift the loader's process-local shard
        stack into a global sharded array (single-process: pass through —
        jit places host batches itself)."""
        if self.mesh is not None and jax.process_count() > 1:
            from connectome_gnn_jax.data.device_sampling import SeedBatch
            from connectome_gnn_jax.parallel.data_parallel import shard_batch

            if isinstance(batch, SeedBatch):
                # only the seed rows shard; the csr replicates separately
                # (see _replicated_csr) and must not be tree-mapped here
                import dataclasses

                from connectome_gnn_jax.parallel.distributed import (
                    assemble_global,
                )

                return dataclasses.replace(
                    batch,
                    packed=assemble_global(
                        batch.packed, self.mesh, self.axis_name
                    ),
                )
            return shard_batch(batch, self.mesh, self.axis_name)
        return batch

    # ------------------------------------------------------------------
    # Device-sampled DP dispatch (stacked SeedBatch through the mesh)
    # ------------------------------------------------------------------

    def _is_seed_batch(self, batch) -> bool:
        from connectome_gnn_jax.data.device_sampling import SeedBatch

        if not isinstance(batch, SeedBatch):
            return False
        if not batch.stacked:
            raise ValueError(
                "mesh-mode training needs a sharded DeviceSeedLoader "
                f"(num_shards={self.mesh.shape[self.axis_name]}) yielding "
                "stacked SeedBatches"
            )
        return True

    def _device_sampled_dp_step(self, labeled: bool, train: bool):
        """Cached shard_map step builders for stacked SeedBatches."""
        cache = self.__dict__.setdefault("_ds_dp_cache", {})
        key = (bool(labeled), bool(train))
        if key not in cache:
            from connectome_gnn_jax.parallel.sampled_dp import (
                make_device_sampled_dp_eval_step,
                make_device_sampled_dp_step,
            )

            if train:
                cache[key] = make_device_sampled_dp_step(
                    self.model, self.optimizer, self.mesh, self.axis_name,
                    labeled=labeled, guard=self.skip_nonfinite,
                )
            else:
                cache[key] = make_device_sampled_dp_eval_step(
                    self.model, self.mesh, self.axis_name, labeled=labeled
                )
        return cache[key]

    def _replicated_csr(self, batch):
        """The batch's (or model's) CSR placed fully-replicated over the
        mesh, cached by identity — a one-time broadcast, then free."""
        csr = batch.csr
        if csr is None:
            csr = getattr(self.model, "csr", None)
        if csr is None:
            raise ValueError(
                "stacked SeedBatch training needs a DeviceGraphCSR "
                "(build the loader via model.make_loader or pass csr=)"
            )
        return self._replicated_csr_value(csr)

    # ------------------------------------------------------------------
    # Graph-sharded sampled dispatch (no device holds the whole graph)
    # ------------------------------------------------------------------

    def _is_graph_sharded(self) -> bool:
        from connectome_gnn_jax.parallel.sharded_sampling import (
            GraphShardedSampledModel,
        )

        return isinstance(self.model, GraphShardedSampledModel)

    def _graph_sharded_step(self, train: bool):
        """Cached shard_map step builders for a
        :class:`~connectome_gnn_jax.parallel.sharded_sampling.
        GraphShardedSampledModel` (the beyond-replication mode: the
        partitioned graph rides sharded over the mesh axis)."""
        m = self.model
        # keyed by the (frozen, hashable) compaction config too: a
        # re-planned model (`GraphShardedSampledModel.plan_compaction`)
        # must not silently reuse steps built for the old capacities
        cache = self.__dict__.setdefault("_gs_cache", {})
        key = (train, m.compaction)
        if key not in cache:
            # evict steps built for superseded configs: periodic
            # re-planning must not accumulate dead compiled programs
            for stale in [k for k in cache if k[1] != m.compaction]:
                del cache[stale]
            from connectome_gnn_jax.parallel.sharded_sampling import (
                make_graph_sharded_eval_step,
                make_graph_sharded_train_step,
            )

            if train:
                cache[key] = make_graph_sharded_train_step(
                    m.inner, self.optimizer, self.mesh, m.fanout,
                    self.axis_name, guard=self.skip_nonfinite,
                    compaction=m.compaction,
                )
            else:
                cache[key] = make_graph_sharded_eval_step(
                    m.inner, self.mesh, m.fanout, self.axis_name,
                    compaction=m.compaction,
                )
        return cache[key]

    def _placed_sharded_csr(self):
        # keyed by the csr's identity, like _replicated_csr — a swapped
        # model/partition must not silently reuse the stale placement
        D = int(self.mesh.shape[self.axis_name])
        if self.model.csr.num_shards != D:
            raise ValueError(
                f"graph-sharded model has {self.model.csr.num_shards} "
                f"shards but the mesh axis '{self.axis_name}' has {D} "
                f"devices — repartition (graph_sharded_sage(graph, "
                f"num_shards={D}, ...)) or build a matching mesh"
            )
        cache = self.__dict__.setdefault("_gs_csr_cache", {})
        key = id(self.model.csr.indptr)
        if key not in cache:
            from connectome_gnn_jax.parallel.sharded_sampling import shard_csr

            cache[key] = shard_csr(
                self.model.csr, self.mesh, self.axis_name
            )
        return cache[key]

    # ------------------------------------------------------------------
    # Public API (mirrors reference train.py:41-127)
    # ------------------------------------------------------------------

    def train_epoch(self, loader: ConnectomeDataLoader) -> float:
        """One optimization pass over ``loader``; returns mean loss per graph.

        Loss/count accumulation stays ON DEVICE until the epoch ends — a
        per-batch ``float()`` would force a host round-trip every step
        and serialize dispatch, which dominates wall time on remote
        runtimes (the steps themselves are ~1 ms).  One sync per epoch.
        With ``scan_epochs`` and a :class:`~connectome_gnn_jax.data.
        device_sampling.DeviceSeedLoader`, the whole epoch runs as one
        scanned program instead (one transfer, one dispatch).
        """
        if self.scan_epochs and self._scannable(loader):
            return self._train_epoch_scanned(loader)
        losses, counts, oks, ovfs = [], [], [], []
        num_steps = 0
        for batch in self._iterate(loader):
            batch = self._maybe_global(batch)
            if self.mesh is None:
                (
                    self.params,
                    self.state,
                    self.opt_state,
                    self._rng,
                    loss,
                    n,
                    ok,
                ) = self._train_step(
                    self.params, self.state, self.opt_state, self._rng, batch
                )
            else:
                self._rng, step_key = jax.random.split(self._rng)
                if self._is_seed_batch(batch) and self._is_graph_sharded():
                    out = self._graph_sharded_step(train=True)(
                        self.params, self.state, self.opt_state, step_key,
                        self._placed_sharded_csr(), batch.seeds,
                        batch.key_data, batch.labels,
                        batch.label_mask,
                    )
                    if self.model.compaction is not None:
                        # overflow rides between n and ok; stays on
                        # device until the epoch-end sync
                        out = list(out)
                        ovfs.append(out.pop(5))
                        out = tuple(out)
                elif self._is_seed_batch(batch):
                    out = self._device_sampled_dp_step(
                        batch.labeled, train=True
                    )(
                        self.params, self.state, self.opt_state, step_key,
                        batch.packed, self._replicated_csr(batch),
                    )
                else:
                    out = self._dp_train_step(
                        self.params, self.state, self.opt_state, step_key,
                        batch,
                    )
                if self.skip_nonfinite:
                    (
                        self.params,
                        self.state,
                        self.opt_state,
                        loss,
                        n,
                        ok,
                    ) = out
                else:
                    self.params, self.state, self.opt_state, loss, n = out
                    ok = 1.0
            losses.append(loss)
            counts.append(n)
            oks.append(ok)
            num_steps += 1
        total = float(sum(l * c for l, c in zip(losses, counts)))
        graphs = float(sum(counts))
        self.last_skipped_steps = num_steps - int(round(float(sum(oks))))
        self.last_sampling_overflow = int(sum(ovfs)) if ovfs else 0
        return total / max(graphs, 1.0)

    def _scannable(self, loader) -> bool:
        from connectome_gnn_jax.data.device_sampling import DeviceSeedLoader

        if not isinstance(loader, DeviceSeedLoader):
            return False
        if self.mesh is None:
            if loader.num_shards is not None:
                raise ValueError(
                    "scan_epochs without a mesh needs an unsharded "
                    "DeviceSeedLoader"
                )
            return True
        if self._is_graph_sharded():
            raise ValueError(
                "scan_epochs is not supported for graph-sharded models "
                "(the scanned epoch composes with the replicated "
                "device-sampled DP path)"
            )
        D = int(self.mesh.shape[self.axis_name])
        if loader.num_shards != D:
            raise ValueError(
                "scan_epochs over a mesh needs a sharded "
                f"DeviceSeedLoader (num_shards={D})"
            )
        return True

    def _train_epoch_scanned(self, loader) -> float:
        """One-dispatch epoch via ``make_epoch_runner`` (single-device)
        or ``make_device_sampled_dp_epoch_runner`` (mesh mode: the
        whole scanned epoch runs as ONE shard_map program — one
        dispatch per epoch per device)."""
        from connectome_gnn_jax.data.device_sampling import (
            make_epoch_runner,
            pack_epoch,
            pack_epoch_sharded,
        )

        csr = loader.csr
        if csr is None:
            csr = getattr(self.model, "csr", None)
        if csr is None:
            raise ValueError(
                "scan_epochs needs a DeviceGraphCSR (build the loader via "
                "model.make_loader or pass csr=)"
            )
        labeled = loader.node_labels is not None
        if self.mesh is None:
            if self._epoch_runner is None:
                self._epoch_runner = make_epoch_runner(
                    self.model, self.optimizer
                )
            packed = pack_epoch(loader)  # advances the loader's epoch
            out = self._epoch_runner(
                self.params, self.state, self.opt_state, self._rng,
                packed, csr, labeled=labeled,
            )
        else:
            from connectome_gnn_jax.parallel.sampled_dp import (
                make_device_sampled_dp_epoch_runner,
            )

            cache = self.__dict__.setdefault("_mesh_epoch_runners", {})
            if labeled not in cache:
                cache[labeled] = make_device_sampled_dp_epoch_runner(
                    self.model, self.optimizer, self.mesh,
                    self.axis_name, labeled=labeled,
                )
            packed = self._lift_epoch(pack_epoch_sharded(loader))
            out = cache[labeled](
                self.params, self.state, self.opt_state, self._rng,
                packed, self._replicated_csr_value(csr),
            )
        (
            self.params,
            self.state,
            self.opt_state,
            self._rng,
            losses,
            ns,
        ) = out
        self.last_skipped_steps = 0  # no in-scan fault guard
        total = float(jnp.sum(losses * ns))
        n = float(jnp.sum(ns))
        return total / max(n, 1.0)

    def _lift_epoch(self, packed_local):
        """Place a ``[steps, D_local, row]`` packed epoch buffer as the
        global ``[steps, D, row]`` array sharded ``P(None, axis)``."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        sh = NamedSharding(self.mesh, P(None, self.axis_name))
        if jax.process_count() == 1:
            return jax.device_put(packed_local, sh)
        import numpy as np

        packed_local = np.asarray(packed_local)
        D = int(self.mesh.shape[self.axis_name])
        global_shape = (
            packed_local.shape[0], D, packed_local.shape[2]
        )
        return jax.make_array_from_process_local_data(
            sh, packed_local, global_shape
        )

    def _replicated_csr_value(self, csr):
        """As :meth:`_replicated_csr`, keyed on a csr value directly."""
        cache = self.__dict__.setdefault("_csr_cache", {})
        key = id(csr.indptr)
        if key not in cache:
            from connectome_gnn_jax.parallel.sampled_dp import replicate_csr

            cache[key] = replicate_csr(csr, self.mesh)
        return cache[key]

    def evaluate(self, loader: ConnectomeDataLoader) -> dict:
        """Masked accuracy / mean loss over ``loader`` (no grad, eval mode).

        Per-batch sums stay on device; one host sync at the end (see
        :meth:`train_epoch`).
        """
        sums = []
        for batch in self._iterate(loader):
            batch = self._maybe_global(batch)
            if self.mesh is None:
                sums.append(self._eval_step(self.params, self.state, batch))
            elif self._is_seed_batch(batch) and self._is_graph_sharded():
                sums.append(
                    self._graph_sharded_step(train=False)(
                        self.params, self.state,
                        self._placed_sharded_csr(), batch.seeds,
                        batch.key_data, batch.labels, batch.label_mask,
                    )
                )
            elif self._is_seed_batch(batch):
                sums.append(
                    self._device_sampled_dp_step(batch.labeled, train=False)(
                        self.params, self.state, batch.packed,
                        self._replicated_csr(batch),
                    )
                )
            else:
                sums.append(self._dp_eval_step(self.params, self.state, batch))
        total_loss = float(sum(s[0] for s in sums))
        correct = int(sum(s[1] for s in sums))
        total = int(sum(s[2] for s in sums))
        return {
            "accuracy": correct / max(total, 1),
            "loss": total_loss / max(total, 1),
            "correct": correct,
            "total": total,
        }

    def predict(
        self,
        loader: ConnectomeDataLoader,
        prefer_fused: bool = True,
        interpret: bool = False,
    ):
        """Per-graph logits over ``loader`` (eval mode), real graphs only.

        Returns a ``[num_real_graphs, num_classes]`` numpy array in loader
        order (use an unshuffled loader for stable alignment with the
        dataset).  Works in both single-device and mesh (stacked-batch)
        modes — this is the serving path, the analog of the reference's
        ``evaluate``-as-inference usage (reference train.py:56-74).

        With ``prefer_fused`` (default) dense-layout GCN **and GraphSAGE**
        batches go through
        :func:`~connectome_gnn_jax.ops.fused_pallas.forward_auto`
        — on a GPU, the whole forward in one Triton-route
        ``pallas_call`` for graphs of up to 128 nodes, verified
        equivalent to the XLA path; elsewhere the XLA path.  The
        kernel's operands are packed once per call.  When
        ``prefer_fused`` is requested but a batch's layout cannot fuse
        (COO layout has no
        dense adjacency), a ``UserWarning`` is emitted once and the XLA
        path is used.  In mesh mode, stacked batches run sharded over the
        mesh via ``shard_map`` with the same per-shard auto dispatch
        (serving gets both sharding and fusion).  ``interpret`` forces
        the Pallas interpreter so CPU tests can exercise the fused path.
        """
        import numpy as np

        from connectome_gnn_jax.ops.fused_pallas import (
            forward_auto,
            pack_fused_weights,
        )

        cache = self.__dict__.setdefault("_predict_cache", {})
        key = (prefer_fused, interpret)
        if key not in cache:
            model = self.model

            def _forward(params, state, weights, batch):
                if prefer_fused:
                    return forward_auto(
                        model, params, state, batch, interpret=interpret,
                        weights=weights,
                    )
                logits, _ = model.apply(params, state, batch, train=False)
                return logits

            predict_step = jax.jit(_forward)

            if self.mesh is not None:
                from functools import partial

                from jax.sharding import PartitionSpec as P

                # sharded serving: each device runs the auto-dispatched
                # (fused where it wins) forward on its own sub-batch
                @jax.jit
                @partial(
                    jax.shard_map,
                    mesh=self.mesh,
                    in_specs=(P(), P(), P(), P(self.axis_name)),
                    out_specs=P(self.axis_name),
                    # pallas_call outputs carry no vma annotation; this is
                    # a forward-only map with no collectives to validate
                    check_vma=False,
                )
                def predict_step_stacked(params, state, weights, stacked):
                    batch = jax.tree_util.tree_map(lambda a: a[0], stacked)
                    return _forward(params, state, weights, batch)[None]

            else:
                # stacked batches without a mesh: vmap over the device axis
                # (XLA path — vmapping a pallas_call adds a grid dimension
                # the fused kernels' scratch layout is not written for)
                predict_step_stacked = jax.jit(
                    jax.vmap(
                        lambda p, s, w, b: model.apply(p, s, b, train=False)[0],
                        in_axes=(None, None, None, 0),
                    )
                )
            cache[key] = (predict_step, predict_step_stacked)

        # kernel operands are prepared once per call, not per batch
        weights = (
            pack_fused_weights(self.model, self.params, self.state)
            if prefer_fused else None
        )
        chunks = []
        for batch in self._iterate(loader):
            if prefer_fused and not hasattr(batch, "adj"):
                if not self.__dict__.get("_warned_unfusable"):
                    import warnings

                    warnings.warn(
                        "predict(prefer_fused=True) got a COO-layout batch; "
                        "using the XLA path (build the loader with "
                        "layout='dense' for fused serving)",
                        UserWarning,
                        stacklevel=2,
                    )
                    self._warned_unfusable = True
            stacked = batch.label_mask.ndim == 2
            step = cache[key][1] if stacked else cache[key][0]
            logits = np.asarray(step(self.params, self.state, weights, batch))
            # real-graph mask, NOT label_mask: unlabeled graphs are the
            # core serving case and must still get predictions
            mask = np.asarray(batch.graph_mask)
            if stacked:  # [D, B, C] → flat
                logits = logits.reshape(-1, logits.shape[-1])
                mask = mask.reshape(-1)
            chunks.append(logits[mask])
        return np.concatenate(chunks, axis=0)

    def fit(
        self,
        train_loader: ConnectomeDataLoader,
        val_loader: ConnectomeDataLoader,
        num_epochs: int = 50,
        patience: int = 10,
        verbose: bool = True,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 1,
        resume: bool = False,
    ) -> dict:
        """Train with early stopping on validation loss.

        Semantics match reference train.py:76-127: snapshot the best
        parameters whenever val loss improves, stop after ``patience``
        epochs without improvement, restore the best snapshot at the end.
        Returns a history dict with ``train_loss`` / ``val_loss`` /
        ``val_acc`` lists.

        Preemption safety (the failure-recovery subsystem the reference
        lacks, SURVEY §5): with ``checkpoint_dir`` set, the full training
        state — params, BatchNorm state, optimizer state, PRNG key, the
        best-so-far snapshot, and the history/early-stop bookkeeping — is
        written atomically every ``checkpoint_every`` epochs and at exit.
        ``resume=True`` restores it and continues; because the loader's
        shuffle is pinned per epoch (``set_epoch``), a resumed run replays
        the exact batch order of an uninterrupted one.
        """
        history: dict = {
            "train_loss": [], "val_loss": [], "val_acc": [],
            "skipped_steps": [],
        }
        best_val_loss = float("inf")
        best_epoch = 0
        best_snapshot = None
        start_epoch = 1

        if checkpoint_dir and resume:
            meta = self._restore_fit_checkpoint(checkpoint_dir)
            if meta is not None:
                history = meta["history"]
                best_val_loss = meta["best_val_loss"]
                best_epoch = meta["best_epoch"]
                best_snapshot = (self._best_params, self._best_state)
                if meta.get("stopped_early"):
                    # the run already finished: re-invoking the same job
                    # script must not train extra epochs
                    if verbose:
                        print(
                            f"Run in {checkpoint_dir} already early-stopped "
                            f"at epoch {meta['epoch']} (best={best_epoch})"
                        )
                    self.params, self.state = best_snapshot
                    return history
                start_epoch = meta["epoch"] + 1
                if verbose:
                    print(
                        f"Resumed from {checkpoint_dir} at epoch "
                        f"{meta['epoch']} (best={best_epoch})"
                    )

        from connectome_gnn_jax.train.fault import PreemptionGuard

        with PreemptionGuard() as preemption:
            for epoch in range(start_epoch, num_epochs + 1):
                if hasattr(train_loader, "set_epoch"):
                    train_loader.set_epoch(epoch - 1)
                if hasattr(val_loader, "set_epoch"):
                    # pin the EVAL stream to the epoch too: a resumed run
                    # must replay validation exactly (a fresh loader would
                    # restart its sampling streams at epoch 0, shifting
                    # val losses and flipping near-tie best-epoch picks)
                    val_loader.set_epoch(epoch - 1)
                train_loss = self.train_epoch(train_loader)
                val_metrics = self.evaluate(val_loader)

                history["train_loss"].append(train_loss)
                history["val_loss"].append(val_metrics["loss"])
                history["val_acc"].append(val_metrics["accuracy"])
                history.setdefault("skipped_steps", []).append(
                    self.last_skipped_steps
                )

                if verbose:
                    skipped = self.last_skipped_steps
                    print(
                        f"Epoch {epoch:3d} | "
                        f"train_loss={train_loss:.4f} | "
                        f"val_loss={val_metrics['loss']:.4f} | "
                        f"val_acc={val_metrics['accuracy']:.3f}"
                        + (f" | skipped={skipped}" if skipped else "")
                    )

                if val_metrics["loss"] < best_val_loss:
                    best_val_loss = val_metrics["loss"]
                    best_epoch = epoch
                    # jax arrays are immutable — holding the references IS
                    # the snapshot (the reference needs per-tensor .clone(),
                    # train.py:116).
                    best_snapshot = (self.params, self.state)

                stop = epoch - best_epoch >= patience
                preempted = preemption.triggered
                if checkpoint_dir and (
                    stop or preempted or epoch == num_epochs
                    or epoch % checkpoint_every == 0
                ):
                    self._save_fit_checkpoint(
                        checkpoint_dir, epoch, best_epoch, best_val_loss,
                        best_snapshot, history, stop,
                    )
                if stop:
                    if verbose:
                        print(
                            f"Early stop at epoch {epoch} (best={best_epoch})"
                        )
                    break
                if preempted:
                    # SIGTERM/SIGINT arrived mid-epoch: state is saved
                    # (if checkpointing), exit cleanly; resume=True
                    # continues from here.
                    if verbose:
                        print(
                            f"Preempted at epoch {epoch} — checkpoint "
                            + ("written" if checkpoint_dir else "NOT enabled")
                        )
                    break

        if best_snapshot is not None:
            self.params, self.state = best_snapshot
        return history

    # ------------------------------------------------------------------
    # Preemption-safe fit checkpointing
    # ------------------------------------------------------------------

    def _fit_ckpt_path(self, directory: str) -> str:
        import os

        return os.path.join(directory, "fit_state.npz")

    def _save_fit_checkpoint(
        self, directory, epoch, best_epoch, best_val_loss, best_snapshot,
        history, stopped_early,
    ) -> None:
        """One atomic file: arrays AND bookkeeping (a meta-in-sidecar split
        would leave state/meta from different epochs after a preemption
        between the two writes — resume would silently re-apply an epoch)."""
        import json

        import numpy as np

        from connectome_gnn_jax.train.checkpoint import save_checkpoint

        best_params, best_state = (
            best_snapshot if best_snapshot is not None else (self.params, self.state)
        )
        meta = {
            "epoch": epoch,
            "best_epoch": best_epoch,
            "best_val_loss": best_val_loss,
            "history": history,
            "stopped_early": stopped_early,
        }
        save_checkpoint(
            self._fit_ckpt_path(directory),
            {
                "params": self.params,
                "state": self.state,
                "opt_state": self.opt_state,
                "rng": self._rng,
                "best_params": best_params,
                "best_state": best_state,
                "meta": np.frombuffer(
                    json.dumps(meta).encode(), dtype=np.uint8
                ),
            },
        )

    def _restore_fit_checkpoint(self, directory) -> Optional[dict]:
        """Restore fit state from ``directory``; returns the meta dict, or
        ``None`` when no checkpoint exists (fresh start)."""
        import json
        import os

        from connectome_gnn_jax.train.checkpoint import restore_checkpoint

        path = self._fit_ckpt_path(directory)
        if not os.path.exists(path):
            return None
        template = {
            "params": self.params,
            "state": self.state,
            "opt_state": self.opt_state,
            "rng": self._rng,
            "best_params": self.params,
            "best_state": self.state,
            "meta": 0,  # shape-free scalar leaf: restored verbatim
                        # (None would be an empty subtree, not a leaf)
        }
        tree = restore_checkpoint(path, template)
        self.params = tree["params"]
        self.state = tree["state"]
        self.opt_state = tree["opt_state"]
        self._rng = tree["rng"]
        self._best_params = tree["best_params"]
        self._best_state = tree["best_state"]
        import numpy as np

        return json.loads(np.asarray(tree["meta"]).tobytes().decode())
