"""Padded, statically-shaped batch container (device side).

The reference packs ragged graphs into block-diagonal tensors whose shapes
change batch to batch (reference ``connectome_gnn/graph.py:143-167``).  XLA
compiles one program per shape, so ragged packing would recompile every step.
This module is the static-shape redesign of that contract:

* Nodes and edges of a batch are concatenated block-diagonally exactly like
  the reference, then **padded to static budgets** (rounded to hardware
  friendly multiples) with explicit masks.  A loader with fixed budgets
  yields identically-shaped batches forever → exactly one XLA compilation.
* Edges are **sorted by receiver** (CSR order).  Segment sums over sorted
  ids lower to sorted-segment reductions; the
  accompanying ``row_ptr`` (CSR indptr over receivers) is carried for
  CSR-consuming kernels.
* Padding is inert by construction: padded edges have weight 0 and point
  one-past-the-end (dropped by segment ops, clamped by gathers); padded
  nodes have zero features and graph id ``num_graphs`` (one past the last
  real segment, so segment ops drop them); padded graphs are masked out of
  loss/metrics via ``label_mask``.

The whole container is a pytree, so it flows through ``jit`` / ``grad`` /
``shard_map``; ``num_graphs`` is static metadata (part of the jit key).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax.numpy as jnp
import numpy as np

from connectome_gnn_jax.data.graph import ConnectomeGraph
from connectome_gnn_jax.utils.pytree import pytree_dataclass, static_field


def round_up(value: int, multiple: int) -> int:
    """Round ``value`` up to the nearest positive multiple of ``multiple``."""
    if multiple <= 1:
        return max(value, 1)
    return max(((value + multiple - 1) // multiple) * multiple, multiple)


@pytree_dataclass
class ConnectomeBatch:
    """A device-resident, padded block-diagonal batch of connectome graphs.

    Shapes (all static): ``P`` = padded node count, ``Q`` = padded edge
    count, ``B`` = graph slots (including padded graph slots).

    Attributes
    ----------
    node_features : float32 [P, F]
        Packed node features; zero rows for padding.
    senders / receivers : int32 [Q]
        COO edge endpoints, offset per graph, sorted by receiver (CSR
        order).  Padded edges point one-past-the-end (id ``P``) with
        weight 0 — dropped by segment ops, clamped by gathers, and
        keeping the receiver order globally non-decreasing.
    edge_weight : float32 [Q]
    node_graph_ids : int32 [P]
        Graph index per node; padding rows hold ``num_graphs`` so that
        segment ops with ``num_segments == num_graphs`` drop them.
    node_mask : bool [P]
    edge_mask : bool [Q]
    labels : int32 [B]
        Graph labels; 0 for padded or unlabeled slots.
    label_mask : bool [B]
        True for real, labeled graphs.
    ptr : int32 [B + 1]
        Cumulative real-node counts per graph (reference graph.py:158,166).
    row_ptr : int32 [P + 1]
        CSR indptr over receivers: edges ``row_ptr[i]:row_ptr[i+1]`` have
        receiver ``i``.  Not consumed by the current compute paths (the
        dense/banded layouts serve those); carried for CSR-consuming
        kernels and external tooling.
    num_graphs : int (static)
        Number of graph slots ``B``.
    """

    node_features: jnp.ndarray
    senders: jnp.ndarray
    receivers: jnp.ndarray
    edge_weight: jnp.ndarray
    node_graph_ids: jnp.ndarray
    node_mask: jnp.ndarray
    edge_mask: jnp.ndarray
    labels: jnp.ndarray
    label_mask: jnp.ndarray
    ptr: jnp.ndarray
    row_ptr: jnp.ndarray
    num_graphs: int = static_field(default=0)

    # ------------------------------------------------------------------
    # Shape properties
    # ------------------------------------------------------------------

    @property
    def num_nodes(self) -> int:
        """Padded node count ``P`` (static)."""
        return int(self.node_features.shape[0])

    @property
    def num_edges(self) -> int:
        """Padded edge count ``Q`` (static)."""
        return int(self.senders.shape[0])

    @property
    def num_features(self) -> int:
        return int(self.node_features.shape[1])

    @property
    def edge_index(self) -> jnp.ndarray:
        """COO [2, Q] view, mirroring the reference field layout."""
        return jnp.stack([self.senders, self.receivers], axis=0)

    @property
    def graph_mask(self) -> jnp.ndarray:
        """bool [B]: True for real graph slots (labeled or not) — real
        graphs always contain at least one node, padded slots none."""
        return jnp.diff(self.ptr) > 0


def collate_graphs(
    graphs: Sequence[ConnectomeGraph],
    *,
    num_graphs: Optional[int] = None,
    node_budget: Optional[int] = None,
    edge_budget: Optional[int] = None,
    node_multiple: int = 8,
    edge_multiple: int = 128,
    num_features: Optional[int] = None,
) -> ConnectomeBatch:
    """Pack graphs into a padded block-diagonal :class:`ConnectomeBatch`.

    Semantics mirror the reference ``collate_graphs`` (graph.py:143-167):
    per-graph node-index offsets, concatenated features/weights, per-node
    graph ids, cumulative ``ptr`` — plus padding to static budgets and CSR
    edge sorting.

    Parameters
    ----------
    num_graphs
        Graph-slot count ``B``; defaults to ``len(graphs)``.  Extra slots
        are empty padded graphs (for fixed-shape final batches).
    node_budget / edge_budget
        Static padded sizes.  Default: total counts rounded up to
        ``node_multiple`` / ``edge_multiple``.
    num_features
        Feature width; required only when ``graphs`` is empty (an
        all-padding batch, e.g. the tail shard of a sharded epoch).
    """
    if len(graphs) == 0 and (num_graphs is None or num_features is None):
        raise ValueError(
            "collating an empty graph list requires num_graphs and num_features"
        )
    B = num_graphs if num_graphs is not None else len(graphs)
    if B < len(graphs):
        raise ValueError(f"num_graphs={B} < len(graphs)={len(graphs)}")

    total_nodes = sum(g.num_nodes for g in graphs)
    total_edges = sum(g.num_edges for g in graphs)
    P = node_budget if node_budget is not None else round_up(total_nodes, node_multiple)
    Q = edge_budget if edge_budget is not None else round_up(total_edges, edge_multiple)
    if P < total_nodes:
        raise ValueError(f"node_budget={P} < total nodes {total_nodes}")
    if Q < total_edges:
        raise ValueError(f"edge_budget={Q} < total edges {total_edges}")

    F = graphs[0].num_features if graphs else int(num_features)
    node_features = np.zeros((P, F), dtype=np.float32)
    # Padded edges point one-past-the-end: segment ops drop id P, gathers
    # clamp it (and the weight is 0), and — crucially — the receiver array
    # stays genuinely non-decreasing after the CSR sort, so the
    # indices_are_sorted=True promise downstream is honest.
    senders = np.full(Q, P, dtype=np.int32)
    receivers = np.full(Q, P, dtype=np.int32)
    edge_weight = np.zeros(Q, dtype=np.float32)
    # Padding nodes carry segment id B → dropped by num_segments=B ops.
    node_graph_ids = np.full(P, B, dtype=np.int32)
    node_mask = np.zeros(P, dtype=bool)
    edge_mask = np.zeros(Q, dtype=bool)
    labels = np.zeros(B, dtype=np.int32)
    label_mask = np.zeros(B, dtype=bool)
    ptr = np.zeros(B + 1, dtype=np.int32)

    node_off = 0
    edge_off = 0
    for g_idx, g in enumerate(graphs):
        n, e = g.num_nodes, g.num_edges
        node_features[node_off : node_off + n] = g.node_features
        senders[edge_off : edge_off + e] = g.edge_index[0] + node_off
        receivers[edge_off : edge_off + e] = g.edge_index[1] + node_off
        edge_weight[edge_off : edge_off + e] = g.edge_weight
        node_graph_ids[node_off : node_off + n] = g_idx
        node_mask[node_off : node_off + n] = True
        edge_mask[edge_off : edge_off + e] = True
        if g.label is not None:
            labels[g_idx] = int(g.label)
            label_mask[g_idx] = True
        node_off += n
        edge_off += e
        ptr[g_idx + 1] = node_off
    # Padded graph slots keep the final cumulative count.
    ptr[len(graphs) + 1 :] = node_off

    # CSR sort: real edges ordered by receiver; padded edges (receiver P,
    # weight 0) sort to the *end*, keeping the real CSR structure contiguous
    # and the full receivers array non-decreasing.
    order = np.argsort(receivers, kind="stable")
    senders = senders[order]
    receivers = receivers[order]
    edge_weight = edge_weight[order]
    edge_mask = edge_mask[order]

    # CSR indptr over receivers (real edges only; padded tail excluded).
    counts = np.bincount(receivers[edge_mask], minlength=P)
    row_ptr = np.zeros(P + 1, dtype=np.int32)
    row_ptr[1:] = np.cumsum(counts)

    return ConnectomeBatch(
        node_features=jnp.asarray(node_features),
        senders=jnp.asarray(senders),
        receivers=jnp.asarray(receivers),
        edge_weight=jnp.asarray(edge_weight),
        node_graph_ids=jnp.asarray(node_graph_ids),
        node_mask=jnp.asarray(node_mask),
        edge_mask=jnp.asarray(edge_mask),
        labels=jnp.asarray(labels),
        label_mask=jnp.asarray(label_mask),
        ptr=jnp.asarray(ptr),
        row_ptr=jnp.asarray(row_ptr),
        num_graphs=B,
    )


def to_device(batch, device=None):
    """Place a batch pytree on a device (default: the first accelerator).

    The analog of the reference containers' ``.to(device)``
    (reference graph.py:87-94, 132-140): arrays in a
    :class:`ConnectomeBatch` / :class:`DenseConnectomeBatch` (or any
    pytree) are transferred with ``jax.device_put``.  Usually unnecessary —
    jitted steps move operands automatically — but explicit placement
    helps pipelining and multi-process setups.
    """
    import jax

    if device is None:
        device = jax.devices()[0]
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, device), batch)
