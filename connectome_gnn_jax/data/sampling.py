"""Host-side neighbor sampling for giant-graph training.

GraphSAGE-style k-hop fanout sampling (Hamilton et al., 2017): starting
from seed nodes, sample up to ``fanout[h]`` incoming neighbors per node at
hop ``h``, and induce the subgraph over every reached node.  Runs on host
numpy (data-prep work that feeds the device pipeline) and returns a
relabeled :class:`ConnectomeGraph` plus the original node ids, so sampled
minibatches flow through the standard collate → padded batch path.

The reference suite has no sampling (its graphs are whole-brain small);
this exists for the giant voxel-level regime (BASELINE.json config 5) where
full-graph training per step is not desirable.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from connectome_gnn_jax.data.graph import ConnectomeGraph


def sample_subgraph(
    graph: ConnectomeGraph,
    seed_nodes: Sequence[int],
    fanout: Sequence[int],
    rng: Optional[np.random.Generator] = None,
) -> tuple[ConnectomeGraph, np.ndarray]:
    """Sample a k-hop neighborhood subgraph.

    Parameters
    ----------
    graph
        Source graph (edges interpreted receiver-ward: hop expansion
        follows edges *into* the frontier, matching message flow).
    seed_nodes
        Nodes whose representations are needed (e.g. a training minibatch).
    fanout
        Max sampled in-neighbors per node per hop; ``len(fanout)`` hops.
    rng
        Numpy generator (default: fresh unseeded).

    Returns
    -------
    (subgraph, node_ids)
        ``subgraph`` — relabeled :class:`ConnectomeGraph` over the reached
        nodes, containing every original edge among them whose receiver was
        expanded; ``node_ids`` — original id per subgraph node, with the
        seeds first (``node_ids[:len(seed_nodes)]`` are the seeds in order).
    """
    if rng is None:
        rng = np.random.default_rng()
    src, dst = graph.edge_index
    order, starts, ends = _in_edge_index(graph)
    seeds = _dedup_seeds(seed_nodes, graph.num_nodes)
    visited = dict((int(s), i) for i, s in enumerate(seeds))
    frontier = list(seeds)
    kept_edges: list[int] = []

    for hop_fanout in fanout:
        next_frontier: list[int] = []
        for node in frontier:
            lo, hi = int(starts[node]), int(ends[node])
            incident = order[lo:hi]
            if len(incident) > hop_fanout:
                incident = rng.choice(incident, size=hop_fanout, replace=False)
            for e in incident:
                kept_edges.append(int(e))
                nbr = int(src[e])
                if nbr not in visited:
                    visited[nbr] = len(visited)
                    next_frontier.append(nbr)
        frontier = next_frontier
        if not frontier:
            break

    node_ids = np.fromiter(visited.keys(), np.int64, len(visited))
    relabel = np.full(graph.num_nodes, -1, np.int64)
    relabel[node_ids] = np.arange(len(node_ids))

    kept = np.asarray(sorted(set(kept_edges)), np.int64)
    sub_src = relabel[src[kept]]
    sub_dst = relabel[dst[kept]]

    subgraph = ConnectomeGraph(
        node_features=graph.node_features[node_ids],
        edge_index=np.stack([sub_src, sub_dst]).astype(np.int32),
        edge_weight=graph.edge_weight[kept],
        label=graph.label,
        subject_id=f"{graph.subject_id}-sub{len(node_ids)}",
    )
    return subgraph, node_ids


def _in_edge_index(graph: ConnectomeGraph):
    """Receiver-grouped edge index: ``order[starts[v]:ends[v]]`` are the
    edge ids whose receiver is ``v``.  Shared by the numpy and native
    samplers so the traversal contract cannot drift between them."""
    dst = graph.edge_index[1]
    order = np.argsort(dst, kind="stable").astype(np.int64)
    dst_sorted = dst[order]
    starts = np.searchsorted(dst_sorted, np.arange(graph.num_nodes))
    ends = np.searchsorted(dst_sorted, np.arange(graph.num_nodes), side="right")
    return order, starts, ends


def _dedup_seeds(seed_nodes, num_nodes: int) -> np.ndarray:
    """Order-preserving dedup + range validation (both sampler paths must
    reject bad seeds identically — numpy fancy indexing would silently
    wrap negatives)."""
    seeds = np.asarray(
        list(dict.fromkeys(int(s) for s in seed_nodes)), np.int64
    )
    if seeds.size and (seeds.min() < 0 or seeds.max() >= num_nodes):
        raise ValueError("seed node out of range")
    return seeds


class NeighborSampler:
    """Reusable k-hop fanout sampler over one giant graph.

    Builds the receiver-grouped edge index ONCE (the dominant cost of a
    single :func:`sample_subgraph_fast` call at giant scale is re-sorting
    the edge list), then every :meth:`sample` runs just the native C++
    traversal — the per-step minibatch producer for giant-graph training.

    Same traversal semantics and return contract as
    :func:`sample_subgraph` (frontier expansion over in-edges, seeds-first
    node order, kept edges), but draws come from a splitmix64 stream —
    uniform-without-replacement yet NOT numpy's ``Generator.choice``
    stream.  Use :func:`sample_subgraph` when numpy-seed reproducibility
    matters.  Deterministic for a given ``seed``; falls back to the numpy
    path when the native library is unavailable.
    """

    def __init__(self, graph: ConnectomeGraph):
        self.graph = graph
        self._src = graph.edge_index[0].astype(np.int64)
        self._order, self._starts, self._ends = _in_edge_index(graph)
        self._weights = np.ascontiguousarray(graph.edge_weight, np.float32)
        self._handle = None  # lazy persistent fused-sampler scratch

    def __del__(self):
        try:
            if self._handle:
                from connectome_gnn_jax import native

                native.sampler_free(self._handle)
        except Exception:
            pass

    def sample(
        self, seed_nodes: Sequence[int], fanout: Sequence[int], seed: int = 0
    ) -> tuple[ConnectomeGraph, np.ndarray]:
        from connectome_gnn_jax import native

        graph = self.graph
        seeds = _dedup_seeds(seed_nodes, graph.num_nodes)
        if not native.AVAILABLE:
            return sample_subgraph(
                graph, seeds, fanout, np.random.default_rng(seed)
            )
        node_ids, kept = native.sample_subgraph(
            self._order, self._starts, self._ends, self._src,
            graph.num_nodes, graph.num_edges,
            seeds, np.asarray(fanout, np.int64), seed,
        )

        src, dst = graph.edge_index
        relabel = np.full(graph.num_nodes, -1, np.int64)
        relabel[node_ids] = np.arange(len(node_ids))
        subgraph = ConnectomeGraph(
            node_features=graph.node_features[node_ids],
            edge_index=np.stack(
                [relabel[src[kept]], relabel[dst[kept]]]
            ).astype(np.int32),
            edge_weight=graph.edge_weight[kept],
            label=graph.label,
            subject_id=f"{graph.subject_id}-sub{len(node_ids)}",
        )
        return subgraph, node_ids


    def sample_collate_into(
        self,
        seed_nodes: np.ndarray,
        fanout: Sequence[int],
        seed: int,
        *,
        node_budget: int,
        edge_budget: int,
        out_senders: np.ndarray,
        out_receivers: np.ndarray,
        out_weights: np.ndarray,
        out_node_ids: np.ndarray,
    ) -> tuple[int, int]:
        """Fused sample → padded collate arrays, written in place.

        One native traversal emits the locally-relabeled, receiver-sorted,
        budget-padded ``senders/receivers/weights/node_ids`` a
        :class:`~connectome_gnn_jax.data.sampled.SampledNodeBatch` wants —
        the per-step producer for giant-graph sampled training (the
        classic ``sample`` + host ``collate_sampled`` pipeline costs
        O(num_nodes) per step in relabel maps alone; this path scales
        with the sample).  Same splitmix64 stream as :meth:`sample`: the
        sampled subgraph is identical for identical ``seed`` (only the
        intra-receiver edge order differs from the classic collate, which
        sub-sorts by global edge id).  Requires the native library;
        callers dispatch on ``native.AVAILABLE``.  Not thread-safe per
        sampler instance (the handle's scratch is reused across calls).
        """
        from connectome_gnn_jax import native

        if not native.AVAILABLE:
            raise RuntimeError("native library unavailable")
        if self._handle is None:
            self._handle = native.sampler_new(self.graph.num_nodes)
        seeds = np.ascontiguousarray(seed_nodes, np.int64)
        return native.sampler_sample_collate(
            self._handle,
            self._order, self._starts, self._ends, self._src,
            self._weights,
            seeds, np.asarray(fanout, np.int64), seed,
            node_budget, edge_budget,
            out_senders, out_receivers, out_weights, out_node_ids,
        )


def sample_subgraph_fast(
    graph: ConnectomeGraph,
    seed_nodes: Sequence[int],
    fanout: Sequence[int],
    seed: int = 0,
) -> tuple[ConnectomeGraph, np.ndarray]:
    """One-shot native k-hop sampling (see :class:`NeighborSampler`,
    which amortizes the index build across repeated samples)."""
    return NeighborSampler(graph).sample(seed_nodes, fanout, seed)
