"""Edge-partitioned giant-graph mode: one big graph sharded across devices.

The batched small-graph path scales by data parallelism; a single giant
connectome (voxel-level, ~10⁶ nodes / ~10⁷ edges) instead scales by
**partitioning the graph itself** — the GNN counterpart of sequence
parallelism (SURVEY §5).  Layout:

* **Nodes are sharded contiguously**: the node id space is padded to
  ``D · P_local`` and device ``d`` owns rows ``[d·P_local, (d+1)·P_local)``
  of the feature matrix.
* **Edges are partitioned by receiver block**: device ``d`` owns every edge
  whose receiver lives in its node block, receiver-sorted (CSR within the
  shard).  Aggregation is therefore entirely local once sender rows are
  visible.
* **Boundary exchange is a static send-table all_to_all, not an
  all_gather**: for each ordered shard pair ``(i → j)``, the unique sender
  rows ``j`` needs from ``i`` are precomputed host-side into a padded
  ``send_idx [D, D, U]`` table; every layer ships exactly those rows
  (``exchange_rows``) and edges index a ``[local rows ‖ received rows]``
  table through ``src_slot``.  Traffic per layer is ``D·U·H`` (``U`` =
  max borrowed rows per pair) instead of the full-feature all-gather's
  ``(D-1)·P_local·H`` — for receiver-local graphs ``U ≪ P_local``; in the
  worst case (every row borrowed by every shard) it degrades to the
  all-gather volume, never worse.  This is the same machinery the hybrid
  banded path uses for its shortcut remainder
  (:mod:`~connectome_gnn_jax.parallel.hybrid_partition`), applied to the
  whole irregular edge set.
* **Degrees are exact**: sender-degree contributions accumulate in slot
  space; partial sums for borrowed rows are returned to their owner shard
  by the reverse ``all_to_all`` (``reverse_scatter``) — normalization
  matches the unpartitioned computation for arbitrary edge sets.

``EdgePartitionedGCN`` / ``EdgePartitionedSAGE`` are the node-level models
for this mode (L convolutions + sync-BatchNorm + per-node linear head —
no pooling), the framework's irregular-giant-graph classification family.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from connectome_gnn_jax.data.batch import round_up
from connectome_gnn_jax.data.graph import ConnectomeGraph
from connectome_gnn_jax.models.node_gcn import init_node_gcn_params
from connectome_gnn_jax.models.node_sage import init_node_sage_params
from connectome_gnn_jax.parallel.shard_forward import (
    ShardMapForwardMixin,
    apply_global_update,
)
from connectome_gnn_jax.nn.layers import batch_norm_apply, dense_apply, dropout
from connectome_gnn_jax.utils.pytree import pytree_dataclass, static_field

EPS = 1e-8


@pytree_dataclass
class PartitionedGraph:
    """A single giant graph, node/edge-partitioned over ``D`` shards.

    All array leaves carry the leading shard axis (sharded ``P(axis)``
    under ``shard_map``).  Senders are addressed through ``src_slot``: an
    index into the per-shard concatenated ``[P_local local rows ‖ D·U
    received rows]`` table (slot ``p_local + i·U + u`` = the ``u``-th row
    borrowed from shard ``i``).  ``send_idx[i, j, u]`` is the local row
    (on shard ``i``) of the ``u``-th row shard ``j`` borrows from it;
    padding slots hold the sentinel ``P_local``.

    Attributes
    ----------
    node_features : float32 [D, P_local, F]
    src_slot : int32 [D, E_local]      slot-table sender index
    receivers : int32 [D, E_local]     local receiver ids (within shard)
    edge_weight : float32 [D, E_local] 0 for padding
    send_idx : int32 [D, D, U]
    node_mask : bool [D, P_local]
    labels : int32 [D, P_local]        per-node labels (0 where unlabeled)
    label_mask : bool [D, P_local]
    num_shards : int (static)
    """

    node_features: jnp.ndarray
    src_slot: jnp.ndarray
    receivers: jnp.ndarray
    edge_weight: jnp.ndarray
    send_idx: jnp.ndarray
    node_mask: jnp.ndarray
    labels: jnp.ndarray
    label_mask: jnp.ndarray
    num_shards: int = static_field(default=1)

    @property
    def nodes_per_shard(self) -> int:
        return int(self.node_features.shape[1])

    @property
    def total_nodes(self) -> int:
        return self.num_shards * self.nodes_per_shard

    @property
    def borrowed_rows(self) -> int:
        """Static per-pair borrowed-row budget ``U``."""
        return int(self.send_idx.shape[-1])


def partition_graph(
    graph: ConnectomeGraph,
    num_shards: int,
    *,
    node_labels: Optional[np.ndarray] = None,
    node_multiple: int = 8,
    edge_multiple: int = 128,
    slot_multiple: int = 8,
    shard_range: Optional[tuple[int, int]] = None,
) -> PartitionedGraph:
    """Partition one graph into a :class:`PartitionedGraph` (host side).

    Nodes are split into ``num_shards`` contiguous blocks (pad the id space
    first); edges go to the shard owning their receiver, with senders
    resolved to slot-table indices and the per-pair unique borrowed rows
    packed into the static ``send_idx`` exchange table.  ``node_labels``
    enables node-level supervision.

    ``shard_range=(lo, hi)`` materializes only shards ``[lo, hi)`` (the
    multi-process path; static paddings and the exchange metadata stay
    GLOBAL so every process produces one shape).
    """
    n = graph.num_nodes
    p_local = round_up(-(-n // num_shards), node_multiple)
    D = num_shards
    lo, hi = shard_range if shard_range is not None else (0, D)
    if not 0 <= lo < hi <= D:
        raise ValueError(f"bad shard_range {(lo, hi)} for D={D}")
    d_here = hi - lo

    src = graph.edge_index[0].astype(np.int64)
    dst = graph.edge_index[1].astype(np.int64)
    w = graph.edge_weight
    d_r, r_loc = dst // p_local, dst % p_local
    d_s, s_loc = src // p_local, src % p_local

    counts = np.bincount(d_r, minlength=D)
    e_local = round_up(int(counts.max()) if counts.size else 1, edge_multiple)

    # pass 1: unique borrowed rows per ordered shard pair (i → j), global —
    # every process needs the full table to resolve its own slots
    uniques: list[list[np.ndarray]] = [
        [np.empty(0, np.int64)] * D for _ in range(D)
    ]
    for j in range(D):
        mask_j = d_r == j
        for i in range(D):
            if i == j:
                continue
            uniques[i][j] = np.unique(s_loc[mask_j & (d_s == i)])
    max_u = max((len(u) for row in uniques for u in row), default=0)
    U = max(slot_multiple, -(-max_u // slot_multiple) * slot_multiple)

    send_idx = np.full((d_here, D, U), p_local, np.int32)
    for i in range(lo, hi):
        for j in range(D):
            rows = uniques[i][j]
            send_idx[i - lo, j, : len(rows)] = rows

    # pass 2: per-shard edge arrays with slot-resolved senders
    F = graph.num_features
    x = np.zeros((d_here, p_local, F), np.float32)
    src_slot = np.zeros((d_here, e_local), np.int32)
    receivers = np.zeros((d_here, e_local), np.int32)
    weights = np.zeros((d_here, e_local), np.float32)
    node_mask = np.zeros((d_here, p_local), bool)
    labels = np.zeros((d_here, p_local), np.int32)
    label_mask = np.zeros((d_here, p_local), bool)

    def slab(flat):
        """Rows ``[lo·p_local, hi·p_local)`` of the padded node space."""
        a, b = lo * p_local, hi * p_local
        out = np.zeros((b - a,) + flat.shape[1:], flat.dtype)
        if a < n:
            out[: min(b, n) - a] = flat[a : min(b, n)]
        return out.reshape((d_here, p_local) + flat.shape[1:])

    x[:] = slab(np.asarray(graph.node_features, np.float32))
    node_mask[:] = slab(np.ones(n, bool))
    if node_labels is not None:
        labels[:] = slab(np.asarray(node_labels, np.int32))
        label_mask[:] = node_mask

    for j in range(lo, hi):
        mask_j = d_r == j
        rj, wj = r_loc[mask_j], w[mask_j]
        sj_shard, sj_loc = d_s[mask_j], s_loc[mask_j]
        slot = np.empty(len(rj), np.int64)
        local = sj_shard == j
        slot[local] = sj_loc[local]
        for i in range(D):
            if i == j:
                continue
            m = sj_shard == i
            if not m.any():
                continue
            pos = np.searchsorted(uniques[i][j], sj_loc[m])
            slot[m] = p_local + i * U + pos
        # receiver-sorted within the shard (stable → deterministic)
        order = np.argsort(rj, kind="stable")
        e = len(rj)
        src_slot[j - lo, :e] = slot[order]
        receivers[j - lo, :e] = rj[order].astype(np.int32)
        weights[j - lo, :e] = wj[order]

    return PartitionedGraph(
        node_features=jnp.asarray(x),
        src_slot=jnp.asarray(src_slot),
        receivers=jnp.asarray(receivers),
        edge_weight=jnp.asarray(weights),
        send_idx=jnp.asarray(send_idx),
        node_mask=jnp.asarray(node_mask),
        labels=jnp.asarray(labels),
        label_mask=jnp.asarray(label_mask),
        num_shards=D,
    )


def _partitioned_normalization(shard: PartitionedGraph, axis_name: str):
    """Exact GCN symmetric normalization over the partitioned layout.

    Layer-invariant — computed once per forward.  Returns
    ``(w_norm [E_local], self_norm [P_local])``: per-edge and self-loop
    scale factors matching :func:`~connectome_gnn_jax.ops.gcn_norm.
    gcn_normalize` (self-loop weight 1.0, reference epsilons).
    """
    from connectome_gnn_jax.parallel.hybrid_partition import (
        exchange_rows,
        reverse_scatter,
    )

    p_local = shard.node_features.shape[0]
    n_slots = p_local + shard.send_idx.size

    # sender degrees in slot space; borrowed partials go home via the
    # reverse all_to_all
    contrib = jax.ops.segment_sum(
        shard.edge_weight, shard.src_slot, num_segments=n_slots
    )
    deg = contrib[:p_local] + reverse_scatter(
        contrib[p_local:].reshape(shard.send_idx.shape),
        shard.send_idx, p_local, axis_name,
    )
    deg = deg + 1.0  # self-loop weight 1.0
    dinv = jax.lax.rsqrt(deg + EPS)

    dinv_table = jnp.concatenate(
        [dinv, exchange_rows(dinv, shard.send_idx, axis_name).reshape(-1)]
    )
    w_norm = dinv_table[shard.src_slot] * shard.edge_weight * dinv[shard.receivers]
    return w_norm, dinv * dinv


def partitioned_gcn_layer(
    params: dict,
    x_local: jnp.ndarray,        # [P_local, F]
    shard: PartitionedGraph,     # local (leading-axis-dropped) view
    axis_name: str,
    *,
    w_norm: Optional[jnp.ndarray] = None,
    self_norm: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """One GCN convolution over the partitioned layout (inside shard_map).

    Same numerics as :func:`gcn_layer_apply`; boundary exchange is one
    ``all_to_all`` of the transformed activations' borrowed rows
    (transform-then-exchange: the dense ``xW`` runs on local rows first,
    so the exchange moves width-``H`` rows, never raw features).
    """
    from connectome_gnn_jax.parallel.hybrid_partition import remainder_table

    if w_norm is None or self_norm is None:
        w_norm, self_norm = _partitioned_normalization(shard, axis_name)
    p_local = x_local.shape[0]
    xw = jnp.dot(x_local, params["kernel"], preferred_element_type=jnp.float32)
    table = remainder_table(xw, shard, axis_name)  # [P_local + D·U, H]
    msg = table[shard.src_slot] * w_norm[:, None]
    out = jax.ops.segment_sum(
        msg, shard.receivers, num_segments=p_local, indices_are_sorted=True
    )
    out = out + self_norm[:, None] * xw
    return out + params["bias"]


def partitioned_sage_layer(
    params: dict,
    x_local: jnp.ndarray,
    shard: PartitionedGraph,
    axis_name: str,
) -> jnp.ndarray:
    """One SAGE convolution over the partitioned layout (inside shard_map).

    SAGE's mean normalizer is the receiver-side weight sum — entirely
    local; the only exchange is the borrowed activation rows (raw
    features/hidden state here: SAGE concatenates pre-transform, reference
    models.py:146-152).
    """
    from connectome_gnn_jax.parallel.hybrid_partition import remainder_table

    p_local = x_local.shape[0]
    w_sum = jax.ops.segment_sum(
        shard.edge_weight, shard.receivers, num_segments=p_local,
        indices_are_sorted=True,
    )
    table = remainder_table(x_local, shard, axis_name)
    msg = table[shard.src_slot] * shard.edge_weight[:, None]
    agg = jax.ops.segment_sum(
        msg, shard.receivers, num_segments=p_local, indices_are_sorted=True
    ) / (w_sum + EPS)[:, None]
    return jax.nn.relu(
        dense_apply(params, jnp.concatenate([x_local, agg], axis=1))
    )


class _EdgePartitionedModel(ShardMapForwardMixin):
    """Shared skeleton: L partitioned convolutions + cross-shard sync-BN +
    per-node linear head."""

    def __init__(
        self,
        in_channels: int,
        hidden_dim: int = 64,
        num_classes: int = 2,
        num_layers: int = 3,
        dropout: float = 0.0,
    ):
        self.in_channels = int(in_channels)
        self.hidden_dim = int(hidden_dim)
        self.num_classes = int(num_classes)
        self.num_layers = int(num_layers)
        self.dropout = float(dropout)

    def apply_shard(
        self,
        params: dict,
        state: dict,
        pgraph_shard: PartitionedGraph,
        *,
        axis_name: str,
        stats_axes=None,
        train: bool = False,
        rng: Optional[jax.Array] = None,
    ) -> tuple[jnp.ndarray, dict]:
        """Forward for one shard — must run inside ``shard_map``.

        ``pgraph_shard`` is the local view (leading shard axis dropped).
        Returns per-node logits ``[P_local, C]`` and updated BN state.
        """
        if stats_axes is None:
            stats_axes = axis_name
        x = pgraph_shard.node_features
        new_norms = []
        if train and rng is not None:
            # decorrelate dropout masks across shards
            rng = jax.random.fold_in(rng, jax.lax.axis_index(axis_name))
            drop_keys = jax.random.split(rng, self.num_layers)
        else:
            drop_keys = [None] * self.num_layers
        norm = (
            _partitioned_normalization(pgraph_shard, axis_name)
            if self._needs_norm
            else None
        )
        for i in range(self.num_layers):
            x = self._layer(params["convs"][i], x, pgraph_shard, axis_name, norm)
            x, bn_state = batch_norm_apply(
                params["norms"][i],
                state["norms"][i],
                x,
                pgraph_shard.node_mask,
                train=train,
                axis_name=stats_axes,
            )
            new_norms.append(bn_state)
            if self._relu_after_norm:
                x = jax.nn.relu(x)
            x = dropout(drop_keys[i], x, self.dropout, train=train)
        logits = dense_apply(params["head"], x)
        return logits, {"norms": new_norms}


class EdgePartitionedGCN(_EdgePartitionedModel):
    """Node-level GCN over an edge-partitioned giant graph."""

    _needs_norm = True
    _relu_after_norm = True

    def init(self, key: jax.Array) -> tuple[dict, dict]:
        return init_node_gcn_params(
            key, self.in_channels, self.hidden_dim, self.num_classes,
            self.num_layers,
        )

    def _layer(self, conv_params, x, shard, axis_name, norm):
        w_norm, self_norm = norm
        return partitioned_gcn_layer(
            conv_params, x, shard, axis_name,
            w_norm=w_norm, self_norm=self_norm,
        )


class EdgePartitionedSAGE(_EdgePartitionedModel):
    """Node-level GraphSAGE over an edge-partitioned giant graph (ReLU
    inside the layer, none after BN — the reference asymmetry)."""

    _needs_norm = False
    _relu_after_norm = False

    def init(self, key: jax.Array) -> tuple[dict, dict]:
        return init_node_sage_params(
            key, self.in_channels, self.hidden_dim, self.num_classes,
            self.num_layers,
        )

    def _layer(self, conv_params, x, shard, axis_name, norm):
        return partitioned_sage_layer(conv_params, x, shard, axis_name)


def make_partitioned_train_step(
    model: _EdgePartitionedModel,
    optimizer,
    mesh: Mesh,
    axis_name: str = "edge",
):
    """Jitted node-classification train step over a partitioned graph.

    Signature: ``(params, state, opt_state, step_key, pgraph) ->
    (params, state, opt_state, loss, n_real)``.  The loss is the masked
    mean cross-entropy over labeled nodes across ALL shards; gradients
    follow the same exactness rules as the data-parallel step (shard_map's
    vma autodiff delivers cotangents of replicated params already psummed —
    only the global-count normalization is applied here).
    """
    import optax

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

    return jax.jit(_step)
