"""Dense block-diagonal batch layout — the batched-matmul fast path.

Connectome graphs are small (83-360 nodes) and moderately dense (~10% of
pairs).  At those sizes the fast aggregation is not scatter at all:
pack the batch as a dense ``[B, n, n]`` weighted adjacency and aggregate
with a batched matmul on the matrix units.  A 16×84-node batch costs
~14 MFLOPs/layer — microseconds on the tensor cores — while the equivalent
gather/scatter path is latency-bound on memory ops.  The COO/CSR layout
(:mod:`connectome_gnn_jax.data.batch`) remains the general path for ragged
or giant graphs; this layout is the throughput path for equal-size
small-graph cohorts (BASELINE.json configs 1-4).

Adjacency is stored **receiver-major**: ``adj[b, i, j]`` is the weight of
edge ``j → i``, so aggregation is ``adj @ x`` with no transposes.  Node
padding (to a lane-friendly ``n``) is masked via ``node_mask [B, n]``;
padded rows/cols carry zero weight and zero features, so they are inert
through convolution, masked BatchNorm, and masked mean-pool.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax.numpy as jnp
import numpy as np

from connectome_gnn_jax.data.batch import round_up
from connectome_gnn_jax.data.graph import ConnectomeGraph
from connectome_gnn_jax.utils.pytree import pytree_dataclass, static_field


@pytree_dataclass
class DenseConnectomeBatch:
    """A batch of equal-size graphs in dense adjacency form.

    Attributes
    ----------
    node_features : float32 [B, n, F]
    adj : float32 [B, n, n]
        Receiver-major weighted adjacency (``adj[b, i, j]`` = weight of
        edge j→i).  No self-loops; layers add their own, mirroring the
        reference semantics.
    node_mask : bool [B, n]
        True for real nodes (False for node-padding rows).
    labels : int32 [B]
    label_mask : bool [B]
    num_graphs : int (static)
    """

    node_features: jnp.ndarray
    adj: jnp.ndarray
    node_mask: jnp.ndarray
    labels: jnp.ndarray
    label_mask: jnp.ndarray
    num_graphs: int = static_field(default=0)

    @property
    def num_nodes(self) -> int:
        """Padded nodes per graph ``n`` (static)."""
        return int(self.node_features.shape[1])

    @property
    def num_features(self) -> int:
        return int(self.node_features.shape[2])

    @property
    def graph_mask(self) -> jnp.ndarray:
        """bool [B]: True for real graph slots (labeled or not)."""
        return jnp.any(self.node_mask, axis=-1)


def collate_dense(
    graphs: Sequence[ConnectomeGraph],
    *,
    num_graphs: Optional[int] = None,
    node_budget: Optional[int] = None,
    node_multiple: int = 8,
    num_features: Optional[int] = None,
) -> DenseConnectomeBatch:
    """Pack graphs into a :class:`DenseConnectomeBatch`.

    All graphs share one per-graph node budget (max graph size rounded to
    ``node_multiple``).  Duplicate edges accumulate additively, matching
    COO scatter semantics.
    """
    if len(graphs) == 0 and (num_graphs is None or num_features is None):
        raise ValueError(
            "collating an empty graph list requires num_graphs and num_features"
        )
    B = num_graphs if num_graphs is not None else len(graphs)
    if B < len(graphs):
        raise ValueError(f"num_graphs={B} < len(graphs)={len(graphs)}")

    max_nodes = max((g.num_nodes for g in graphs), default=0)
    n = node_budget if node_budget is not None else round_up(max_nodes, node_multiple)
    if n < max_nodes:
        raise ValueError(f"node_budget={n} < largest graph {max_nodes}")
    F = graphs[0].num_features if graphs else int(num_features)

    x = np.zeros((B, n, F), dtype=np.float32)
    adj = np.zeros((B, n, n), dtype=np.float32)
    node_mask = np.zeros((B, n), dtype=bool)
    labels = np.zeros(B, dtype=np.int32)
    label_mask = np.zeros(B, dtype=bool)

    from connectome_gnn_jax import native

    for b, g in enumerate(graphs):
        ng = g.num_nodes
        x[b, :ng] = g.node_features
        src, dst = g.edge_index
        if native.AVAILABLE:  # receiver-major; bitwise == np.add.at
            native.dense_pack(src, dst, g.edge_weight, adj[b])
        else:
            np.add.at(adj[b], (dst, src), g.edge_weight)
        node_mask[b, :ng] = True
        if g.label is not None:
            labels[b] = int(g.label)
            label_mask[b] = True

    return DenseConnectomeBatch(
        node_features=jnp.asarray(x),
        adj=jnp.asarray(adj),
        node_mask=jnp.asarray(node_mask),
        labels=jnp.asarray(labels),
        label_mask=jnp.asarray(label_mask),
        num_graphs=B,
    )
