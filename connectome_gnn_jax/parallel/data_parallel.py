"""Exact data parallelism over a named mesh via ``shard_map``.

Batched small-graph training parallelizes over graphs: each device owns a
shard of the packed batch (a full :class:`ConnectomeBatch` of its own) and
the step is a ``shard_map`` over the ``"data"`` mesh axis.  Collectives:

* BatchNorm moment sums are psummed inside the model (``axis_name``
  threading) → sharded batches reproduce single-device batch statistics
  exactly (sync-BN);
* the loss is the globally masked mean: per-device *sums* are differentiated
  and gradients psummed, then normalized by the global real-graph count —
  exact even when devices hold unequal numbers of real (non-padded) graphs,
  which happens on the final partial batch of an epoch;
* parameters and optimizer state stay replicated; identical psummed grads
  keep replicas bit-identical without a broadcast.

Batches are sharded as *stacked* pytrees: leaves carry a leading device
axis of size ``mesh.shape[axis_name]`` with sharding ``P(axis_name)``, so
each device's block is exactly its shard (built host-side by
:func:`stack_batches` — no cross-device resharding on dispatch).
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from connectome_gnn_jax.data.batch import ConnectomeBatch
from connectome_gnn_jax.parallel.shard_forward import apply_global_update


def stack_batches(batches: Sequence[ConnectomeBatch]) -> ConnectomeBatch:
    """Stack per-shard batches leaf-wise into a leading device axis.

    All shards must have identical static shapes (the sharded loader
    guarantees this).  The result is still a :class:`ConnectomeBatch`
    pytree; array leaves are ``[D, ...]``.
    """
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *batches)


def shard_batch(
    stacked: ConnectomeBatch, mesh: Mesh, axis_name: str = "data"
) -> ConnectomeBatch:
    """Place a stacked batch so each device holds its own shard.

    Multi-process: ``stacked`` carries only this process's shards on the
    leading axis and is lifted to a global array
    (:func:`~connectome_gnn_jax.parallel.distributed.assemble_global`);
    single-process it is a plain sharded ``device_put``.
    """
    from connectome_gnn_jax.parallel.distributed import assemble_global

    return assemble_global(stacked, mesh, axis_name)


def _local_shard(stacked: ConnectomeBatch) -> ConnectomeBatch:
    """Inside shard_map: drop the (size-1) leading device axis."""
    return jax.tree_util.tree_map(lambda x: x[0], stacked)


def make_dp_train_step(
    model, optimizer, mesh: Mesh, axis_name: str = "data",
    guard: bool = False,
):
    """Build a jitted data-parallel train step.

    Signature: ``(params, state, opt_state, step_key, stacked_batch) ->
    (params, state, opt_state, loss, n_real)`` with params/state/opt_state
    replicated and the batch sharded over ``axis_name``.

    With ``guard=True`` the step additionally detects non-finite loss or
    gradients and becomes a no-op for that batch (old params/state/opt
    kept, loss/n reported as 0) — the signature gains a trailing ``ok``
    float (1.0 = applied, 0.0 = rejected).  The gradients are already
    global (psummed by shard_map's autodiff), so the verdict is identical
    on every device and replicas stay bit-identical.
    """

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(axis_name)),
        out_specs=(P(), P(), P(), P(), P()) + ((P(),) if guard else ()),
    )
    def _sharded_step(params, state, opt_state, step_key, stacked):
        batch = _local_shard(stacked)
        # Decorrelate dropout across shards while keeping the host-visible
        # key schedule identical to single-device training.
        key = jax.random.fold_in(step_key, jax.lax.axis_index(axis_name))

        def loss_sum_fn(p):
            logits, new_state = model.apply(
                p, state, batch, train=True, rng=key, axis_name=axis_name
            )
            ce = optax.softmax_cross_entropy_with_integer_labels(
                logits, batch.labels
            )
            mask = batch.label_mask.astype(jnp.float32)
            return jnp.sum(ce * mask), (new_state, jnp.sum(mask))

        (local_sum, (new_state, local_n)), grads = jax.value_and_grad(
            loss_sum_fn, has_aux=True
        )(params)
        new_params, new_opt_state, loss, n = apply_global_update(
            optimizer, axis_name, params, opt_state, local_sum, local_n, grads
        )
        # BN state was psummed inside apply → already replicated.
        if not guard:
            return new_params, new_state, new_opt_state, loss, n

        from connectome_gnn_jax.train import fault

        # grads/loss are global (autodiff psums replicated-input
        # cotangents), and new_state is psummed sync-BN state — every
        # device computes the same ok, keeping replicas identical.
        ok = fault.all_finite(loss, grads, new_state)
        trees, loss, n, ok_f = fault.guard_step_outputs(
            ok,
            (new_params, new_state, new_opt_state),
            (params, state, opt_state),
            loss, n,
        )
        return (*trees, loss, n, ok_f)

    return jax.jit(_sharded_step)


def make_dp_eval_step(model, mesh: Mesh, axis_name: str = "data"):
    """Build a jitted data-parallel eval step returning global
    ``(loss_sum, correct, n_real)``."""

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(axis_name)),
        out_specs=(P(), P(), P()),
    )
    def _sharded_eval(params, state, stacked):
        batch = _local_shard(stacked)
        logits, _ = model.apply(params, state, batch, train=False)
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits, batch.labels
        )
        mask = batch.label_mask.astype(jnp.float32)
        preds = jnp.argmax(logits, axis=1)
        correct = jnp.sum(
            (preds == batch.labels).astype(jnp.int32) * batch.label_mask
        )
        return (
            jax.lax.psum(jnp.sum(ce * mask), axis_name),
            jax.lax.psum(correct, axis_name),
            jax.lax.psum(jnp.sum(mask), axis_name),
        )

    return jax.jit(_sharded_eval)
