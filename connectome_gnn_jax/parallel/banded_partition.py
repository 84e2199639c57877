"""Halo-exchange parallelism for banded giant graphs.

The interconnect-efficient multi-device design for spatially-local giant connectomes
(BASELINE config 5): shard the block band by **contiguous row blocks**
across devices.  Because every edge lives within ``W`` blocks of the
diagonal, a device needs only the ``W`` boundary blocks of each neighbor —
so the per-layer exchange is two neighbor ``ppermute``s of ``W·block·H``
activations instead of an ``all_gather`` of the full feature matrix
(volume ``2·W·block·H`` vs ``(D-1)·P_local·H``; for a ±1024-node band on
8 shards of a 1M-node graph that is ~60× less exchange traffic).  XLA overlaps
the ppermute with the local batched matmuls.

Everything else matches the single-device banded path bit-for-bit up to
reduction order: exact sender degrees (partial block sums halo-reduced to
their owners), the same symmetric normalization, sync-BatchNorm psums.

Use :func:`partition_banded` (host side) to shard a
:class:`~connectome_gnn_jax.ops.banded.BandedMatrix` + features, and
:class:`ShardedBandedGCN` (same parameter pytrees as
:class:`~connectome_gnn_jax.models.node_gcn.BandedNodeGCN`) to run it.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from connectome_gnn_jax.models.node_gcn import BandedNodeGCN
from connectome_gnn_jax.models.node_sage import BandedNodeSAGE
from connectome_gnn_jax.parallel.shard_forward import ShardMapForwardMixin
from connectome_gnn_jax.nn.layers import batch_norm_apply, dense_apply, dropout
from connectome_gnn_jax.ops.banded import BandedMatrix
from connectome_gnn_jax.utils.pytree import pytree_dataclass, static_field

EPS = 1e-8


@pytree_dataclass
class PartitionedBanded:
    """A banded giant graph sharded by contiguous row blocks.

    Leaves carry the leading shard axis ``D``.

    Attributes
    ----------
    band : float32 [D, NB_local, 2W+1, block, block]
    node_features : float32 [D, NB_local·block, F]
    node_mask : bool [D, NB_local·block]
    labels : int32 [D, NB_local·block]
    label_mask : bool [D, NB_local·block]
    num_shards / bandwidth : static ints
    """

    band: jnp.ndarray
    node_features: jnp.ndarray
    node_mask: jnp.ndarray
    labels: jnp.ndarray
    label_mask: jnp.ndarray
    num_shards: int = static_field(default=1)
    bandwidth: int = static_field(default=0)

    @property
    def block(self) -> int:
        return int(self.band.shape[3])

    @property
    def blocks_per_shard(self) -> int:
        return int(self.band.shape[1])


def _shard_geometry(
    nb: int, W: int, num_shards: int,
    shard_range: Optional[tuple[int, int]],
) -> tuple[int, int, int]:
    """Validate and resolve ``(nb_local, lo, hi)`` for a row-block shard."""
    nb_pad = -(-nb // num_shards) * num_shards
    nb_local = nb_pad // num_shards
    if W > nb_local:
        raise ValueError(
            f"bandwidth {W} blocks exceeds blocks-per-shard {nb_local}; "
            "use fewer shards or a narrower band"
        )
    lo, hi = shard_range if shard_range is not None else (0, num_shards)
    if not 0 <= lo < hi <= num_shards:
        raise ValueError(f"bad shard_range {(lo, hi)} for D={num_shards}")
    return nb_local, lo, hi


def _assemble_partition(
    band_p: np.ndarray,
    x: np.ndarray,
    node_mask: Optional[np.ndarray],
    labels: Optional[np.ndarray],
    num_nodes: int,
    num_shards: int,
    W: int,
    nb_local: int,
    lo: int,
    hi: int,
) -> PartitionedBanded:
    """Pack node arrays for rows ``[lo·nb_local·block, hi·nb_local·block)``
    of the conceptual padded node-id space and build the pytree."""
    d_here = hi - lo
    block = band_p.shape[2]
    n0, n1 = lo * nb_local * block, hi * nb_local * block

    def pad_nodes(arr, fill, dtype):
        out = np.full((n1 - n0,) + arr.shape[1:], fill, dtype)
        if n0 < arr.shape[0]:
            out[: min(n1, arr.shape[0]) - n0] = arr[n0 : min(n1, arr.shape[0])]
        return out

    x = np.asarray(x, np.float32)[:num_nodes]
    x_p = pad_nodes(x, 0.0, np.float32)
    mask = (
        np.asarray(node_mask, bool)[:num_nodes]
        if node_mask is not None
        else np.ones(num_nodes, bool)
    )
    mask_p = pad_nodes(mask, False, bool)
    lab = (
        np.asarray(labels, np.int32)[:num_nodes]
        if labels is not None
        else np.zeros(num_nodes, np.int32)
    )
    lab_p = pad_nodes(lab, 0, np.int32)
    lab_mask_p = mask_p if labels is not None else np.zeros(n1 - n0, bool)

    dcount = band_p.shape[1]
    return PartitionedBanded(
        band=jnp.asarray(band_p.reshape(d_here, nb_local, dcount, block, block)),
        node_features=jnp.asarray(x_p.reshape(d_here, nb_local * block, -1)),
        node_mask=jnp.asarray(mask_p.reshape(d_here, nb_local * block)),
        labels=jnp.asarray(lab_p.reshape(d_here, nb_local * block)),
        label_mask=jnp.asarray(lab_mask_p.reshape(d_here, nb_local * block)),
        num_shards=num_shards,
        bandwidth=W,
    )


def partition_banded(
    a: BandedMatrix,
    x: np.ndarray,
    num_shards: int,
    *,
    node_mask: Optional[np.ndarray] = None,
    labels: Optional[np.ndarray] = None,
    shard_range: Optional[tuple[int, int]] = None,
) -> PartitionedBanded:
    """Shard a banded matrix + node features by row blocks (host side).

    The block count is padded to a multiple of ``num_shards`` with zero
    blocks; requires ``W <= blocks_per_shard`` (halo exchange only talks to
    immediate neighbors).

    ``shard_range=(lo, hi)`` materializes only shards ``[lo, hi)`` — the
    multi-process path: each process packs just its own row blocks (no
    full-band zero-padded copy), keeping host memory per process at
    ``1/P`` of the graph; lift with
    :func:`~connectome_gnn_jax.parallel.distributed.assemble_global`.
    When even the full band is too big for one host, skip the
    :class:`BandedMatrix` entirely with :func:`partition_banded_from_coo`.
    """
    band = np.asarray(a.band)
    nb, dcount, block, _ = band.shape
    W = a.bandwidth
    nb_local, lo, hi = _shard_geometry(nb, W, num_shards, shard_range)

    # local block rows [lo·nb_local, hi·nb_local), zero-padded past nb —
    # only this slice is ever allocated (no nb_pad-sized copy)
    b0, b1 = lo * nb_local, hi * nb_local
    band_p = np.zeros((b1 - b0, dcount, block, block), np.float32)
    if b0 < nb:
        band_p[: min(b1, nb) - b0] = band[b0 : min(b1, nb)]

    return _assemble_partition(
        band_p, x, node_mask, labels, a.num_nodes,
        num_shards, W, nb_local, lo, hi,
    )


def partition_banded_from_coo(
    senders: np.ndarray,
    receivers: np.ndarray,
    weights: np.ndarray,
    x: np.ndarray,
    num_nodes: int,
    num_shards: int,
    *,
    block: int = 256,
    bandwidth: Optional[int] = None,
    node_mask: Optional[np.ndarray] = None,
    labels: Optional[np.ndarray] = None,
    shard_range: Optional[tuple[int, int]] = None,
) -> PartitionedBanded:
    """Streamed ingest: shard a COO edge list straight into per-shard band
    slabs, never materializing the full band.

    Bitwise-equal to ``partition_banded(to_banded(...), ...)`` (the
    native/``np.add.at`` accumulation visits edges in the same order),
    but peak host memory is the COO arrays + ONE shard-range slab instead
    of the whole band — at the 1M-node north-star config that is the
    difference between ~0.7 GB/process and ~11 GB/process (band built,
    pulled back, and re-sliced).  ``bandwidth`` (in blocks) defaults to
    the smallest band containing every edge; pass it explicitly when the
    COO is pre-filtered per process (the derivation needs every edge).
    """
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    weights = np.asarray(weights, np.float32)

    from connectome_gnn_jax.data.batch import round_up

    padded = round_up(num_nodes, block)
    nb = padded // block
    rb = receivers // block
    d = senders // block - rb
    if bandwidth is None:
        bandwidth = int(np.abs(d).max()) if d.size else 0
    elif d.size and np.abs(d).max() > bandwidth:
        raise ValueError(
            f"edge outside band: |block distance| {int(np.abs(d).max())} > "
            f"bandwidth {bandwidth}; reorder the graph (e.g. RCM) first"
        )
    W = int(bandwidth)
    nb_local, lo, hi = _shard_geometry(nb, W, num_shards, shard_range)

    b0 = lo * nb_local
    rows = (hi - lo) * nb_local
    band_p = np.zeros((rows, 2 * W + 1, block, block), np.float32)
    from connectome_gnn_jax import native

    if native.AVAILABLE:
        native.band_pack_range(senders, receivers, weights, band_p, W, b0)
    else:
        sel = (rb >= b0) & (rb < b0 + rows)
        np.add.at(
            band_p,
            (rb[sel] - b0, d[sel] + W,
             receivers[sel] % block, senders[sel] % block),
            weights[sel],
        )
    return _assemble_partition(
        band_p, x, node_mask, labels, num_nodes,
        num_shards, W, nb_local, lo, hi,
    )


def _layer_drop_keys(rng, stats_axes, train: bool, num_layers: int):
    """Per-layer dropout keys, decorrelated across every mesh axis BN
    statistics span (shared by both sharded model families)."""
    if train and rng is not None:
        for ax in (
            stats_axes if isinstance(stats_axes, tuple) else (stats_axes,)
        ):
            rng = jax.random.fold_in(rng, jax.lax.axis_index(ax))
        return jax.random.split(rng, num_layers)
    return [None] * num_layers


def _neighbor_perms(num_shards: int):
    to_right = [(i, i + 1) for i in range(num_shards - 1)]
    to_left = [(i + 1, i) for i in range(num_shards - 1)]
    return to_right, to_left


def halo_exchange(
    blocks: jnp.ndarray, W: int, axis_name: str
) -> jnp.ndarray:
    """Extend ``blocks [NBl, block, F]`` with ``W`` halo blocks per side.

    Boundary shards receive zero halos (the band is zero there anyway).
    """
    if W == 0:
        return blocks
    num_shards = jax.lax.axis_size(axis_name)
    to_right, to_left = _neighbor_perms(num_shards)
    from_left = jax.lax.ppermute(blocks[-W:], axis_name, to_right)
    from_right = jax.lax.ppermute(blocks[:W], axis_name, to_left)
    return jnp.concatenate([from_left, blocks, from_right], axis=0)


def _halo_reduce_degrees(
    deg_ext: jnp.ndarray, nb_local: int, W: int, axis_name: str
) -> jnp.ndarray:
    """Fold extended-range partial degree sums back to their owners."""
    own = deg_ext[W : W + nb_local]
    if W == 0:
        return own
    num_shards = jax.lax.axis_size(axis_name)
    to_right, to_left = _neighbor_perms(num_shards)
    # my head overflow belongs to my left neighbor's tail, and vice versa
    from_right = jax.lax.ppermute(deg_ext[:W], axis_name, to_left)
    from_left = jax.lax.ppermute(deg_ext[W + nb_local :], axis_name, to_right)
    own = own.at[-W:].add(from_right)
    own = own.at[:W].add(from_left)
    return own


class ShardedBandedGCN(ShardMapForwardMixin, BandedNodeGCN):
    """Halo-exchange sharded variant of :class:`BandedNodeGCN`.

    Parameter pytrees are identical to the single-device model — the same
    ``init`` applies; only the forward is distributed.
    """

    def apply_shard(
        self,
        params: dict,
        state: dict,
        shard: PartitionedBanded,
        *,
        axis_name: str,
        stats_axes=None,
        train: bool = False,
        rng: Optional[jax.Array] = None,
    ) -> tuple[jnp.ndarray, dict]:
        """Forward for one shard — must run inside ``shard_map``.

        ``axis_name`` is the mesh axis the graph's row blocks are sharded
        over (halo ppermutes ride it).  ``stats_axes`` — a mesh axis name or
        tuple of them — controls which axes BatchNorm statistics psum over;
        it defaults to ``axis_name`` and is widened to ``(data, edge)`` by
        the 2-D combined-parallel step so batch statistics span every
        subject on the mesh (sync-BN across both axes).
        """
        if stats_axes is None:
            stats_axes = axis_name
        # local view: the mixin drops the leading shard axis on every leaf
        band = shard.band
        nb_local, dcount, block, _ = band.shape
        W = shard.bandwidth
        p_local = nb_local * block
        x = shard.node_features
        mask = shard.node_mask
        is_hybrid = hasattr(shard, "rem_weights")
        if is_hybrid:
            from connectome_gnn_jax.parallel.hybrid_partition import (
                remainder_aggregate, remainder_table, reverse_scatter)

        # --- exact sender degrees with halo reduction ---
        col_sums = jnp.sum(band, axis=2)  # [NBl, 2W+1, block]
        rb = jnp.arange(nb_local)[:, None]
        dd = jnp.arange(dcount)[None, :]
        target = (rb + dd).reshape(-1)  # extended block index
        deg_ext = jax.ops.segment_sum(
            col_sums.reshape(-1, block), target, num_segments=nb_local + 2 * W
        )
        deg = _halo_reduce_degrees(deg_ext, nb_local, W, axis_name).reshape(
            p_local
        )
        if is_hybrid:
            # remainder sender degrees: local slots add in place, borrowed
            # slots are partial sums returned to their owner shards
            n_slots = p_local + shard.send_idx.size
            contrib = jax.ops.segment_sum(
                shard.rem_weights, shard.rem_src_slot, num_segments=n_slots
            )
            deg = deg + contrib[:p_local] + reverse_scatter(
                contrib[p_local:].reshape(shard.send_idx.shape),
                shard.send_idx, p_local, axis_name,
            )
        deg = deg + 1.0
        dinv = jax.lax.rsqrt(deg + EPS)  # [p_local]
        self_norm = (dinv * dinv)[:, None]

        if is_hybrid:
            dinv_table = remainder_table(dinv, shard, axis_name)
            safe_r = jnp.minimum(shard.rem_receivers, p_local - 1)
            rem_norm = (
                dinv[safe_r] * shard.rem_weights
                * dinv_table[shard.rem_src_slot]
            )

        # sender-side dinv needs the halo too
        dinv_ext = halo_exchange(
            dinv.reshape(nb_local, block, 1), W, axis_name
        )[..., 0]  # [NBl+2W, block]
        idx = jnp.arange(nb_local)[:, None] + jnp.arange(dcount)[None, :]
        dinv_windows = jnp.take(dinv_ext, idx, axis=0)  # [NBl, 2W+1, block]
        band_norm = (
            dinv.reshape(nb_local, 1, block, 1)
            * band
            * dinv_windows[:, :, None, :]
        )

        new_norms = []
        drop_keys = _layer_drop_keys(rng, stats_axes, train, self.num_layers)

        h = x
        for i in range(self.num_layers):
            hw = jnp.dot(
                h, params["convs"][i]["kernel"],
                preferred_element_type=jnp.float32,
            )
            hw_ext = halo_exchange(
                hw.reshape(nb_local, block, -1), W, axis_name
            )
            windows = jnp.take(hw_ext, idx, axis=0)  # [NBl, 2W+1, block, H]
            agg = jnp.einsum(
                "ndrc,ndcf->nrf",
                band_norm,
                windows,
                preferred_element_type=jnp.float32,
            ).reshape(p_local, -1)
            if is_hybrid:
                agg = agg + remainder_aggregate(
                    hw, rem_norm, shard, axis_name, p_local
                )
            h = agg + self_norm * hw + params["convs"][i]["bias"]
            h, bn_state = batch_norm_apply(
                params["norms"][i],
                state["norms"][i],
                h,
                mask,
                train=train,
                axis_name=stats_axes,
            )
            new_norms.append(bn_state)
            h = jax.nn.relu(h)
            h = dropout(drop_keys[i], h, self.dropout, train=train)
        logits = dense_apply(params["head"], h)
        return logits, {"norms": new_norms}


class ShardedBandedSAGE(ShardMapForwardMixin, BandedNodeSAGE):
    """Halo-exchange sharded variant of :class:`BandedNodeSAGE`.

    Simpler than the GCN: SAGE's mean normalizer is the *row* (receiver)
    weight sum, which every shard owns locally — the only exchange is the
    per-layer ``W``-block activation halo.  Parameter pytrees are shared
    with the single-device model; the 1-D and 2-D train-step factories
    work unchanged (they only call ``apply_shard``).
    """

    def apply_shard(
        self,
        params: dict,
        state: dict,
        shard: PartitionedBanded,
        *,
        axis_name: str,
        stats_axes=None,
        train: bool = False,
        rng: Optional[jax.Array] = None,
    ) -> tuple[jnp.ndarray, dict]:
        if stats_axes is None:
            stats_axes = axis_name
        band = shard.band
        nb_local, dcount, block, _ = band.shape
        W = shard.bandwidth
        p_local = nb_local * block
        mask = shard.node_mask
        is_hybrid = hasattr(shard, "rem_weights")
        if is_hybrid:
            from connectome_gnn_jax.parallel.hybrid_partition import (
                remainder_aggregate)

        w_sum = jnp.sum(band, axis=(1, 3)).reshape(p_local)
        if is_hybrid:
            # SAGE's mean normalizer is receiver-side → remainder weights
            # add locally, no cross-shard reduction needed
            w_sum = w_sum + jax.ops.segment_sum(
                shard.rem_weights, shard.rem_receivers, num_segments=p_local
            )
        w_sum = w_sum[:, None]
        idx = jnp.arange(nb_local)[:, None] + jnp.arange(dcount)[None, :]

        new_norms = []
        drop_keys = _layer_drop_keys(rng, stats_axes, train, self.num_layers)

        h = shard.node_features
        for i in range(self.num_layers):
            h_ext = halo_exchange(h.reshape(nb_local, block, -1), W, axis_name)
            windows = jnp.take(h_ext, idx, axis=0)  # [NBl, 2W+1, block, H]
            msg = jnp.einsum(
                "ndrc,ndcf->nrf", band, windows,
                preferred_element_type=jnp.float32,
            ).reshape(p_local, -1)
            if is_hybrid:
                msg = msg + remainder_aggregate(
                    h, shard.rem_weights, shard, axis_name, p_local
                )
            agg = msg / (w_sum + EPS)
            h = jax.nn.relu(
                dense_apply(
                    params["convs"][i], jnp.concatenate([h, agg], axis=1)
                )
            )
            h, bn_state = batch_norm_apply(
                params["norms"][i], state["norms"][i], h, mask,
                train=train, axis_name=stats_axes,
            )
            new_norms.append(bn_state)
            h = dropout(drop_keys[i], h, self.dropout, train=train)
        logits = dense_apply(params["head"], h)
        return logits, {"norms": new_norms}


def make_sharded_banded_train_step(
    model: ShardedBandedGCN,
    optimizer,
    mesh,
    axis_name: str = "edge",
):
    """Jitted node-classification train step over a sharded banded graph.

    Signature: ``(params, state, opt_state, step_key, pbanded) ->
    (params, state, opt_state, loss, n_real)``.  Loss is the masked mean
    cross-entropy over labeled nodes across all shards; gradient exactness
    follows :func:`~connectome_gnn_jax.parallel.shard_forward.apply_global_update`
    (halo-exchange ppermutes and psums differentiate correctly under
    shard_map's vma autodiff).  Exactness vs a single-device step holds
    for ``dropout == 0``; with dropout the per-shard mask streams are
    decorrelated by mesh position and differ from any unsharded run.
    """
    from functools import partial

    import optax
    from jax.sharding import PartitionSpec as P

    from connectome_gnn_jax.parallel.shard_forward import apply_global_update

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(axis_name)),
        out_specs=(P(), P(), P(), P(), P()),
    )
    def _step(params, state, opt_state, step_key, stacked):
        shard = jax.tree_util.tree_map(lambda a: a[0], stacked)

        def loss_sum_fn(p):
            logits, new_state = model.apply_shard(
                p, state, shard, axis_name=axis_name, train=True, rng=step_key
            )
            ce = optax.softmax_cross_entropy_with_integer_labels(
                logits, shard.labels
            )
            mask = shard.label_mask.astype(jnp.float32)
            return jnp.sum(ce * mask), (new_state, jnp.sum(mask))

        (local_sum, (new_state, local_n)), grads = jax.value_and_grad(
            loss_sum_fn, has_aux=True
        )(params)
        new_params, new_opt_state, loss, n = apply_global_update(
            optimizer, axis_name, params, opt_state, local_sum, local_n, grads
        )
        return new_params, new_state, new_opt_state, loss, n

    return _step


def stack_partitioned(shards) -> PartitionedBanded:
    """Stack per-subject :class:`PartitionedBanded` pytrees for a 2-D mesh.

    Each input carries a leading edge-shard axis ``[De, ...]`` (from
    :func:`partition_banded`); the result's leaves are ``[Dd, De, ...]``
    ready for ``P(data_axis, edge_axis)`` placement.  All subjects must
    share static shapes (same block/bandwidth/padded node count).
    """
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *shards)


def make_banded_train_step_2d(
    model: ShardedBandedGCN,
    optimizer,
    mesh,
    data_axis: str = "data",
    edge_axis: str = "edge",
):
    """Combined data × edge parallelism over a 2-D mesh.

    A cohort of giant banded graphs trains jointly: each mesh row (size
    ``Dd``) owns a subset of subjects, and within a row each subject's row
    blocks are sharded over the ``edge`` axis (size ``De``) with halo
    ppermutes exactly as in the 1-D step.  BatchNorm statistics and the
    loss normalization psum over BOTH axes, so with ``dropout == 0`` the
    step is numerically identical to single-device training on the
    block-diagonal concatenation of the whole cohort
    (:func:`connectome_gnn_jax.ops.banded.banded_block_diag`) — the
    gradient-oracle test in ``tests/test_mesh2d.py`` proves it.  With
    dropout enabled the per-shard mask streams are decorrelated by mesh
    position (by design) and no single-device run reproduces them.

    Signature: ``(params, state, opt_state, step_key, stacked) ->
    (params, state, opt_state, loss, n_real)`` where ``stacked`` comes
    from :func:`stack_partitioned`.
    """
    from functools import partial

    import optax
    from jax.sharding import PartitionSpec as P

    from connectome_gnn_jax.parallel.shard_forward import apply_global_update

    axes = (data_axis, edge_axis)

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(data_axis, edge_axis)),
        out_specs=(P(), P(), P(), P(), P()),
    )
    def _step(params, state, opt_state, step_key, stacked):
        shard = jax.tree_util.tree_map(lambda a: a[0, 0], stacked)

        def loss_sum_fn(p):
            logits, new_state = model.apply_shard(
                p, state, shard, axis_name=edge_axis, stats_axes=axes,
                train=True, rng=step_key,
            )
            ce = optax.softmax_cross_entropy_with_integer_labels(
                logits, shard.labels
            )
            mask = shard.label_mask.astype(jnp.float32)
            return jnp.sum(ce * mask), (new_state, jnp.sum(mask))

        (local_sum, (new_state, local_n)), grads = jax.value_and_grad(
            loss_sum_fn, has_aux=True
        )(params)
        new_params, new_opt_state, loss, n = apply_global_update(
            optimizer, axes, params, opt_state, local_sum, local_n, grads
        )
        return new_params, new_state, new_opt_state, loss, n

    return _step
