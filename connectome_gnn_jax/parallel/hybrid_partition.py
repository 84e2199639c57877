"""Sharded hybrid (band + remainder) giant graphs.

Real giant connectomes are mostly-local with a few long-range shortcuts
(small-world).  The banded sharding (:mod:`banded_partition`) moves only
halo blocks between neighbors, but its pure-band form cannot carry the
shortcuts.  This module shards the :class:`~connectome_gnn_jax.ops.banded.
HybridMatrix` form: the band bulk keeps the cheap neighbor ``ppermute``
halo exchange, and the sparse remainder's cross-shard senders are served
by a **static all-to-all row exchange** between devices:

* host side (:func:`partition_hybrid`): every remainder edge is owned by
  its receiver's shard; for each ordered shard pair ``(i → j)`` the
  unique sender rows shard ``j`` needs from shard ``i`` are precomputed
  into a padded ``send_idx [D, D, U]`` table (static shapes — XLA
  compiles one program);
* device side: one ``all_to_all`` ships the needed activation rows each
  layer (:func:`exchange_rows`); remainder edges then index a
  concatenated ``[local rows ‖ received rows]`` table.  GCN's sender
  degrees need the reverse path — partial degree sums computed at the
  borrowing shard are ``all_to_all``-ed back and scatter-added into
  their owners (:func:`reverse_scatter`).

Traffic per layer is ``2·D·U·H`` instead of the full-feature-matrix
all-gather — for sparse shortcut sets ``U ≪ P_local``, this rides the
same interconnect budget as the halo exchange.  Everything is differentiable
under ``shard_map``'s vma autodiff; gradient-oracle tests in
``tests/test_hybrid_partition.py`` prove exactness against the
single-device hybrid models.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from connectome_gnn_jax.ops.banded import HybridMatrix
from connectome_gnn_jax.parallel.banded_partition import (
    PartitionedBanded,
    partition_banded,
    partition_banded_from_coo,
)
from connectome_gnn_jax.utils.pytree import pytree_dataclass, static_field


@pytree_dataclass
class PartitionedHybrid:
    """A hybrid giant graph sharded by contiguous row blocks.

    ``banded`` carries the band bulk + features/masks/labels (leading
    shard axis ``D``, see :class:`PartitionedBanded`).  Remainder edges
    are receiver-owned and reference senders through ``src_slot``: an
    index into the per-shard concatenated ``[p_local local rows ‖ D·U
    received rows]`` table.  ``send_idx[i, j, u]`` is the local row
    (on shard ``i``) of the ``u``-th row shard ``j`` borrows from it;
    padding slots hold the sentinel ``p_local`` (dropped by segment_sum,
    clamped on gather).
    """

    banded: PartitionedBanded
    rem_weights: jnp.ndarray  # [D, E_loc] f32, 0 on padding
    rem_receivers: jnp.ndarray  # [D, E_loc] i32 local row, sentinel p_local
    rem_src_slot: jnp.ndarray  # [D, E_loc] i32 into the concat table
    send_idx: jnp.ndarray  # [D, D, U] i32 local rows, sentinel p_local
    num_shards: int = static_field(default=1)
    bandwidth: int = static_field(default=0)

    # PartitionedBanded surface so the model/step code can treat both
    # shard types uniformly.
    @property
    def band(self):
        return self.banded.band

    @property
    def node_features(self):
        return self.banded.node_features

    @property
    def node_mask(self):
        return self.banded.node_mask

    @property
    def labels(self):
        return self.banded.labels

    @property
    def label_mask(self):
        return self.banded.label_mask

    @property
    def block(self) -> int:
        return int(self.banded.band.shape[-1])


def _remainder_metadata(s, r, w, D: int, p_local: int):
    """Group the remainder COO by ordered shard pair in ONE lexsort pass.

    Replaces per-pair full-array boolean masks (O(D²·E) host work) with an
    O(E log E) sort: edges are ordered by ``(receiver shard, sender shard,
    sender local row)``; unique borrowed rows per pair are adjacent-dedups
    of the sorted slices.  Returns the shard/local decompositions, the
    pair grouping ``(order, pair_ids, starts, ends)``, the per-pair unique
    borrowed-row arrays, and the raw ``(max_u, e_loc)`` capacities.
    """
    d_r, r_loc = r // p_local, r % p_local
    d_s, s_loc = s // p_local, s % p_local
    key = d_r * D + d_s
    order = np.lexsort((s_loc, key))
    k_sorted = key[order]
    pair_ids, starts = np.unique(k_sorted, return_index=True)
    ends = np.append(starts[1:], k_sorted.size)
    uniques: dict[tuple[int, int], np.ndarray] = {}
    max_u = 0
    for pid, a0, a1 in zip(pair_ids.tolist(), starts.tolist(), ends.tolist()):
        j, i = divmod(pid, D)  # key = d_r·D + d_s
        if i == j:
            continue
        rows = s_loc[order[a0:a1]]  # sorted ascending by construction
        keep = np.empty(rows.size, bool)
        keep[0] = True
        np.not_equal(rows[1:], rows[:-1], out=keep[1:])
        u = rows[keep]
        uniques[(i, j)] = u
        max_u = max(max_u, u.size)
    e_loc = int(np.bincount(d_r, minlength=D).max()) if d_r.size else 0
    return (d_r, r_loc, d_s, s_loc), (order, pair_ids, starts, ends), \
        uniques, max_u, e_loc


def _round_capacities(
    max_u: int, e_loc: int, edge_multiple: int, slot_multiple: int,
    edge_capacity: Optional[int], slot_capacity: Optional[int],
) -> tuple[int, int]:
    """Static paddings from raw maxima (+ explicit-capacity validation)."""
    U = max(slot_multiple, -(-max_u // slot_multiple) * slot_multiple)
    if slot_capacity is not None:
        if slot_capacity < max_u:
            raise ValueError(
                f"slot_capacity={slot_capacity} < required {max_u} borrowed "
                "rows on some shard pair"
            )
        U = int(slot_capacity)
    E_loc = max(
        edge_multiple, -(-max(e_loc, 1) // edge_multiple) * edge_multiple
    )
    if edge_capacity is not None:
        if edge_capacity < e_loc:
            raise ValueError(
                f"edge_capacity={edge_capacity} < required {e_loc} remainder "
                "edges on some shard"
            )
        E_loc = int(edge_capacity)
    return E_loc, U


def _real_remainder(h: HybridMatrix):
    """Remainder COO with the static padding slots dropped (int64/f32)."""
    s = np.asarray(h.remainder_senders, np.int64)
    r = np.asarray(h.remainder_receivers, np.int64)
    w = np.asarray(h.remainder_weights, np.float32)
    real = r < h.band.num_blocks * h.band.block
    return s[real], r[real], w[real]


def hybrid_remainder_capacities(
    h: HybridMatrix,
    num_shards: int,
    *,
    edge_multiple: int = 128,
    slot_multiple: int = 8,
) -> tuple[int, int]:
    """The ``(edge_capacity, slot_capacity)`` :func:`partition_hybrid`
    would derive for this graph — a metadata-only probe (no band packing,
    no feature copies), used by :func:`partition_hybrid_cohort` to unify
    static paddings without partitioning anything twice."""
    nb_local = -(-h.band.num_blocks // num_shards)
    p_local = nb_local * h.band.block
    s, r, w = _real_remainder(h)
    _, _, _, max_u, e_loc = _remainder_metadata(s, r, w, num_shards, p_local)
    return _round_capacities(
        max_u, e_loc, edge_multiple, slot_multiple, None, None
    )


def _partition_remainder(
    s: np.ndarray,
    r: np.ndarray,
    w: np.ndarray,
    D: int,
    p_local: int,
    lo: int,
    hi: int,
    edge_multiple: int,
    slot_multiple: int,
    edge_capacity: Optional[int],
    slot_capacity: Optional[int],
):
    """Receiver-owned remainder shard arrays + send tables from real
    remainder COO (host side, one lexsort — see :func:`_remainder_metadata`).
    """
    (d_r, r_loc, d_s, s_loc), (order, pair_ids, starts, ends), uniques, \
        max_u, e_loc = _remainder_metadata(s, r, w, D, p_local)
    E_loc, U = _round_capacities(
        max_u, e_loc, edge_multiple, slot_multiple,
        edge_capacity, slot_capacity,
    )

    send_idx = np.full((hi - lo, D, U), p_local, np.int32)
    for (i, j), rows in uniques.items():
        if lo <= i < hi:
            send_idx[i - lo, j, : rows.size] = rows

    # table slots for every edge in one vectorized pass over pair groups
    slot = np.empty(s.size, np.int64)
    local = d_s == d_r
    slot[local] = s_loc[local]
    for pid, a0, a1 in zip(pair_ids.tolist(), starts.tolist(), ends.tolist()):
        j, i = divmod(pid, D)
        if i == j:
            continue
        sel = order[a0:a1]
        slot[sel] = p_local + i * U + np.searchsorted(
            uniques[(i, j)], s_loc[sel]
        )

    # receiver-sorted per dst shard (stable lexsort == the per-shard
    # stable argsort of the masked form, so outputs match it exactly)
    order_r = np.lexsort((r_loc, d_r))
    bounds = np.searchsorted(d_r[order_r], np.arange(D + 1))
    rem_w = np.zeros((hi - lo, E_loc), np.float32)
    rem_r = np.full((hi - lo, E_loc), p_local, np.int32)
    rem_slot = np.zeros((hi - lo, E_loc), np.int32)
    for j in range(lo, hi):
        sel = order_r[bounds[j] : bounds[j + 1]]
        k = sel.size
        rem_w[j - lo, :k] = w[sel]
        rem_r[j - lo, :k] = r_loc[sel]
        rem_slot[j - lo, :k] = slot[sel]
    return rem_w, rem_r, rem_slot, send_idx


def partition_hybrid(
    h: HybridMatrix,
    x: np.ndarray,
    num_shards: int,
    *,
    node_mask: Optional[np.ndarray] = None,
    labels: Optional[np.ndarray] = None,
    edge_multiple: int = 128,
    slot_multiple: int = 8,
    edge_capacity: Optional[int] = None,
    slot_capacity: Optional[int] = None,
    shard_range: Optional[tuple[int, int]] = None,
) -> PartitionedHybrid:
    """Shard a hybrid matrix + features by row blocks (host side).

    ``edge_capacity`` / ``slot_capacity`` pin the static remainder-edge
    and borrowed-row paddings instead of deriving them from this graph —
    REQUIRED when multiple subjects are stacked into a 2-D cohort
    (:func:`~connectome_gnn_jax.parallel.banded_partition.stack_partitioned`
    needs identical static shapes across subjects; per-subject derived
    paddings differ whenever shortcut counts do).  Raises if a capacity
    is too small for this graph.

    ``shard_range=(lo, hi)`` materializes only shards ``[lo, hi)`` for
    multi-process runs (send tables and paddings stay globally derived so
    every process produces the same static shapes; the cross-pair unique
    index metadata is computed everywhere — it is tiny next to the data).
    """
    pb = partition_banded(
        h.band, x, num_shards, node_mask=node_mask, labels=labels,
        shard_range=shard_range,
    )
    D = num_shards
    lo, hi = shard_range if shard_range is not None else (0, D)
    p_local = pb.blocks_per_shard * pb.block

    s, r, w = _real_remainder(h)
    rem_w, rem_r, rem_slot, send_idx = _partition_remainder(
        s, r, w, D, p_local, lo, hi,
        edge_multiple, slot_multiple, edge_capacity, slot_capacity,
    )
    return PartitionedHybrid(
        banded=pb,
        rem_weights=jnp.asarray(rem_w),
        rem_receivers=jnp.asarray(rem_r),
        rem_src_slot=jnp.asarray(rem_slot),
        send_idx=jnp.asarray(send_idx),
        num_shards=D,
        bandwidth=pb.bandwidth,
    )


def partition_hybrid_from_coo(
    senders: np.ndarray,
    receivers: np.ndarray,
    weights: np.ndarray,
    x: np.ndarray,
    num_nodes: int,
    num_shards: int,
    *,
    block: int = 256,
    bandwidth: int = 4,
    node_mask: Optional[np.ndarray] = None,
    labels: Optional[np.ndarray] = None,
    edge_multiple: int = 128,
    slot_multiple: int = 8,
    edge_capacity: Optional[int] = None,
    slot_capacity: Optional[int] = None,
    shard_range: Optional[tuple[int, int]] = None,
) -> PartitionedHybrid:
    """Streamed hybrid ingest: COO → sharded band slabs + remainder tables
    without ever materializing the full :class:`HybridMatrix`.

    Splits edges by block distance exactly like
    :func:`~connectome_gnn_jax.ops.banded.to_hybrid` (``|sender_block −
    receiver_block| ≤ bandwidth``), packs the in-band bulk per shard via
    :func:`~connectome_gnn_jax.parallel.banded_partition.partition_banded_from_coo`
    (bitwise-equal slabs), and routes the rest through the same
    receiver-owned remainder partition as :func:`partition_hybrid`.  The
    remainder metadata stays globally derived so every process in a
    ``shard_range`` run produces identical static shapes.
    """
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    weights = np.asarray(weights, np.float32)

    d = senders // block - receivers // block
    in_band = np.abs(d) <= bandwidth
    pb = partition_banded_from_coo(
        senders[in_band], receivers[in_band], weights[in_band], x,
        num_nodes, num_shards, block=block, bandwidth=bandwidth,
        node_mask=node_mask, labels=labels, shard_range=shard_range,
    )
    D = num_shards
    lo, hi = shard_range if shard_range is not None else (0, D)
    p_local = pb.blocks_per_shard * pb.block

    rem_w, rem_r, rem_slot, send_idx = _partition_remainder(
        senders[~in_band], receivers[~in_band], weights[~in_band],
        D, p_local, lo, hi,
        edge_multiple, slot_multiple, edge_capacity, slot_capacity,
    )
    return PartitionedHybrid(
        banded=pb,
        rem_weights=jnp.asarray(rem_w),
        rem_receivers=jnp.asarray(rem_r),
        rem_src_slot=jnp.asarray(rem_slot),
        send_idx=jnp.asarray(send_idx),
        num_shards=D,
        bandwidth=pb.bandwidth,
    )


def partition_hybrid_cohort(
    hybrids,
    features,
    num_shards: int,
    *,
    labels=None,
    **kwargs,
) -> PartitionedHybrid:
    """Partition a cohort of hybrid subjects with UNIFIED static paddings
    and stack them for the 2-D ``("data", "edge")`` mesh.

    Per-subject derived remainder paddings differ whenever shortcut
    counts do, which would break ``stack_partitioned``; worst-case
    capacities come from the metadata-only probe
    (:func:`hybrid_remainder_capacities`), so each subject's data is
    partitioned exactly ONCE with the unified capacities pinned.  Returns
    the stacked pytree (leaves ``[Dd, De, ...]``).
    """
    from connectome_gnn_jax.parallel.banded_partition import stack_partitioned

    labels = labels if labels is not None else [None] * len(hybrids)
    probe_kw = {
        k: kwargs[k]
        for k in ("edge_multiple", "slot_multiple")
        if k in kwargs
    }
    caps = [
        hybrid_remainder_capacities(h, num_shards, **probe_kw)
        for h in hybrids
    ]
    e_cap = max((c[0] for c in caps), default=128)
    u_cap = max((c[1] for c in caps), default=8)
    # explicit capacities (if any) take precedence — validated per subject
    kwargs.setdefault("edge_capacity", e_cap)
    kwargs.setdefault("slot_capacity", u_cap)
    return stack_partitioned(
        [
            partition_hybrid(h, x, num_shards, labels=lab, **kwargs)
            for h, x, lab in zip(hybrids, features, labels)
        ]
    )


# ---------------------------------------------------------------------------
# Device-side exchange primitives (run inside shard_map)
# ---------------------------------------------------------------------------


def _a2a(x: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    return jax.lax.all_to_all(x, axis_name, split_axis=0, concat_axis=0)


def exchange_rows(
    values: jnp.ndarray, send_idx: jnp.ndarray, axis_name: str
) -> jnp.ndarray:
    """Ship borrowed rows to their borrowers.

    ``values [p_local, ...]`` are this shard's rows; ``send_idx [D, U]``
    names the rows each destination shard needs (sentinel = p_local).
    Returns ``recv [D, U, ...]`` where block ``i`` holds the rows this
    shard borrows *from* shard ``i`` — aligned with table slots
    ``p_local + i·U + u``.
    """
    safe = jnp.minimum(send_idx, values.shape[0] - 1)
    return _a2a(values[safe], axis_name)


def remainder_table(
    values: jnp.ndarray, shard: PartitionedHybrid, axis_name: str
) -> jnp.ndarray:
    """``[p_local local rows ‖ D·U borrowed rows]`` — the table
    ``rem_src_slot`` indexes.  One all_to_all per call."""
    recv = exchange_rows(values, shard.send_idx, axis_name)
    if values.ndim == 1:
        return jnp.concatenate([values, recv.reshape(-1)])
    return jnp.concatenate(
        [values, recv.reshape(-1, values.shape[-1])], axis=0
    )


def remainder_aggregate(
    values: jnp.ndarray,
    edge_weights: jnp.ndarray,
    shard: PartitionedHybrid,
    axis_name: str,
    p_local: int,
) -> jnp.ndarray:
    """Weighted remainder-edge aggregation into local receiver rows —
    the shared per-layer step of both sharded model families."""
    table = remainder_table(values, shard, axis_name)
    msgs = table[shard.rem_src_slot] * edge_weights[:, None]
    return jax.ops.segment_sum(
        msgs, shard.rem_receivers, num_segments=p_local
    )


def reverse_scatter(
    partials: jnp.ndarray,
    send_idx: jnp.ndarray,
    p_local: int,
    axis_name: str,
) -> jnp.ndarray:
    """Return borrowed-row partial sums to their owners.

    ``partials [D, U, ...]``: block ``i`` = sums this shard computed for
    rows borrowed from shard ``i``.  After the all_to_all, block ``j``
    holds sums shard ``j`` computed for OUR rows ``send_idx[j]``; they are
    scatter-added into a local ``[p_local, ...]`` buffer (sentinel slots
    drop out of range).
    """
    back = _a2a(partials, axis_name)
    flat_idx = send_idx.reshape(-1)
    return jax.ops.segment_sum(
        back.reshape((flat_idx.shape[0],) + partials.shape[2:]),
        flat_idx,
        num_segments=p_local,
    )
