"""Data-parallel device-side sampled training over a named mesh.

Composes the two fastest subsystems in the framework: device-side
neighbor sampling (`data/device_sampling.py` — graph resident in HBM,
~8 KB seed payload per step) and exact shard_map data parallelism
(`parallel/data_parallel.py` — psummed gradients, sync-BN).  The
composition is seed-level: the :class:`~connectome_gnn_jax.data.
device_sampling.DeviceGraphCSR` REPLICATES per device (its arrays are
already device-resident; replication is a one-time ``device_put`` with a
fully-replicated sharding), and only the stacked ``[D, 3+2S]`` packed
seed buffer is sharded over the ``"data"`` axis.  Each device samples
its own fanout subgraph inside the jitted step (its packed row carries
its own PRNG key, streamed by GLOBAL shard index so multi-process runs
agree with single-process ones without coordination).

Exactness mirrors ``make_dp_train_step``: BatchNorm moments psum across
shards (sync-BN), the loss is the globally masked mean, gradients arrive
globally psummed through shard_map's varying-manual-axes autodiff, and
parameters stay replicated.  The CSR enters as an ARGUMENT with a
replicated spec — a closure-captured CSR would be serialized into the
compile payload, which this rig's remote-compile endpoint rejects at
giant scale (HTTP 413; see ``SeedBatch``).

The reference has no sampling or parallelism of any kind (SURVEY §0);
this scales `/root/reference/connectome_gnn/models.py:45-54`'s scatter
aggregation across devices per BASELINE configs[4].
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from connectome_gnn_jax.data.device_sampling import DeviceGraphCSR, SeedBatch
from connectome_gnn_jax.parallel.shard_forward import apply_global_update


def replicate_csr(csr: DeviceGraphCSR, mesh: Mesh) -> DeviceGraphCSR:
    """Place the CSR fully-replicated over ``mesh`` (one-time cost).

    Single-process: a plain replicated ``device_put``.  Multi-process:
    every process already holds the full arrays, so each leaf lifts via
    ``jax.make_array_from_process_local_data`` with a replicated
    sharding — no data moves across processes.
    """
    sharding = NamedSharding(mesh, P())
    if jax.process_count() == 1:

        def put(x):
            if hasattr(x, "sharding") and x.sharding == sharding:
                return x
            return jax.device_put(x, sharding)

        return jax.tree_util.tree_map(put, csr)

    import numpy as np

    def lift(x):
        if hasattr(x, "sharding") and x.sharding == sharding:
            return x
        x = np.asarray(x)
        return jax.make_array_from_process_local_data(sharding, x, x.shape)

    return jax.tree_util.tree_map(lift, csr)


def make_device_sampled_dp_step(
    model,
    optimizer,
    mesh: Mesh,
    axis_name: str = "data",
    *,
    labeled: bool = True,
    guard: bool = False,
):
    """Build a jitted data-parallel device-sampled train step.

    Signature: ``(params, state, opt_state, step_key, packed, csr) ->
    (params, state, opt_state, loss, n_real)`` where ``packed`` is the
    stacked ``[D, 3+2S]`` int32 seed buffer (sharded ``P(axis_name)``),
    ``csr`` the replicated :class:`DeviceGraphCSR`, and ``model`` a
    :class:`~connectome_gnn_jax.data.device_sampling.DeviceSampledModel`.
    ``S`` is read from the packed shape, so one builder serves any seed
    count (each compiles once).

    ``guard=True`` appends the non-finite-rejection semantics of
    ``make_dp_train_step`` (trailing ``ok`` output; rejected steps keep
    old params/state/opt bitwise on every replica).
    """

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(axis_name), P()),
        out_specs=(P(), P(), P(), P(), P()) + ((P(),) if guard else ()),
    )
    def _sharded_step(params, state, opt_state, step_key, packed, csr):
        row = packed[0]  # this device's shard
        S = (int(row.shape[0]) - 3) // 2
        batch = SeedBatch(packed=row, csr=csr, num_seeds=S, labeled=labeled)
        # Decorrelate dropout across shards while keeping the host-visible
        # key schedule identical to single-device training (sampling keys
        # ride in the packed rows and need no folding).
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
            optimizer, axis_name, params, opt_state, local_sum, local_n,
            grads,
        )
        if not guard:
            return new_params, new_state, new_opt_state, loss, n

        from connectome_gnn_jax.train import fault

        ok = fault.all_finite(loss, grads, new_state)
        trees, loss, n, ok_f = fault.guard_step_outputs(
            ok,
            (new_params, new_state, new_opt_state),
            (params, state, opt_state),
            loss, n,
        )
        return (*trees, loss, n, ok_f)

    return jax.jit(_sharded_step)


def make_device_sampled_dp_epoch_runner(
    model,
    optimizer,
    mesh: Mesh,
    axis_name: str = "data",
    *,
    labeled: bool = True,
):
    """Whole-epoch-on-device training OVER THE MESH: ``lax.scan`` of the
    data-parallel device-sampled step inside ONE ``shard_map`` program —
    one dispatch per epoch per device (round-5 composition of
    :func:`~connectome_gnn_jax.data.device_sampling.make_epoch_runner`
    with :func:`make_device_sampled_dp_step`; on a real pod this is
    exactly what DCN dispatch latency wants).

    Step semantics replicate the stepwise DP loop bitwise: the same
    per-step ``rng`` split schedule (the split moves inside the scan),
    the same ``fold_in(step_key, axis_index)`` dropout decorrelation,
    sync-BN psums, globally-masked loss, psummed grads.  The non-finite
    step guard does NOT run inside the scanned epoch (as in the
    single-device runner).

    Returns ``run(params, state, opt_state, rng, packed_all, csr) ->
    (params, state, opt_state, rng, losses, ns)`` with ``packed_all``
    a ``[steps, D, 3+2S]`` int32 buffer sharded ``P(None, axis_name)``;
    build it with :func:`~connectome_gnn_jax.data.device_sampling.
    pack_epoch_sharded`.
    """

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(None, axis_name), P()),
        out_specs=(P(), P(), P(), P(), P(), P()),
    )
    def _run(params, state, opt_state, rng, packed_all, csr):
        def body(carry, row):
            p, s, o, r = carry
            r, step_key = jax.random.split(r)
            row0 = row[0]  # this device's shard of the step
            S = (int(row0.shape[0]) - 3) // 2
            batch = SeedBatch(
                packed=row0, csr=csr, num_seeds=S, labeled=labeled
            )
            key = jax.random.fold_in(
                step_key, jax.lax.axis_index(axis_name)
            )

            def loss_sum_fn(pp):
                logits, new_state = model.apply(
                    pp, s, batch, train=True, rng=key,
                    axis_name=axis_name,
                )
                ce = optax.softmax_cross_entropy_with_integer_labels(
                    logits, batch.labels
                )
                mask = batch.label_mask.astype(jnp.float32)
                return jnp.sum(ce * mask), (new_state, jnp.sum(mask))

            (local_sum, (new_state, local_n)), grads = jax.value_and_grad(
                loss_sum_fn, has_aux=True
            )(p)
            new_params, new_opt_state, loss, n = apply_global_update(
                optimizer, axis_name, p, o, local_sum, local_n, grads
            )
            return (new_params, new_state, new_opt_state, r), (loss, n)

        (params, state, opt_state, rng), (losses, ns) = jax.lax.scan(
            body, (params, state, opt_state, rng), packed_all
        )
        return params, state, opt_state, rng, losses, ns

    return jax.jit(_run)


def make_device_sampled_dp_eval_step(
    model, mesh: Mesh, axis_name: str = "data", *, labeled: bool = True
):
    """Jitted data-parallel device-sampled eval step returning global
    ``(loss_sum, correct, n_real)``.  Eval mode samples with each row's
    own key (fresh subgraphs per epoch — the loader advances streams)
    and uses running BN statistics, so shards are independent up to the
    final psums."""

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(axis_name), P()),
        out_specs=(P(), P(), P()),
    )
    def _sharded_eval(params, state, packed, csr):
        row = packed[0]
        S = (int(row.shape[0]) - 3) // 2
        batch = SeedBatch(packed=row, csr=csr, num_seeds=S, labeled=labeled)
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
