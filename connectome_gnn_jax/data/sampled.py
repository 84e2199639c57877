"""Sampled-minibatch giant-graph training: batches, collate, loader.

The end-to-end path for BASELINE config 5's "edge-partitioned giant graph
with neighbor sampling": per step, a GraphSAGE-style fanout sample around a
minibatch of seed nodes (:class:`~connectome_gnn_jax.data.sampling.
NeighborSampler`, native C++ traversal) is packed into a **static-shape**
:class:`SampledNodeBatch` — node/edge budgets are the fanout-tree worst
case, so the jitted train step compiles exactly once — and supervision is
seed-node-only (the sampler puts seeds first; the model's head reads the
first ``num_seeds`` rows).

The container intentionally exposes the same ``labels`` / ``label_mask`` /
``graph_mask`` surface as :class:`~connectome_gnn_jax.data.batch.
ConnectomeBatch`, so the standard :class:`~connectome_gnn_jax.train.
Trainer` (fit / evaluate / predict / checkpointing) drives sampled
node-level training unchanged — with a model whose ``apply`` returns
per-seed logits (:class:`~connectome_gnn_jax.models.node_coo.NodeGCN` /
``NodeSAGE``).

The reference suite has no sampling or node-level training (SURVEY §0);
this is north-star scope.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Iterator, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from connectome_gnn_jax.data.batch import round_up
from connectome_gnn_jax.data.graph import ConnectomeGraph
from connectome_gnn_jax.data.sampling import NeighborSampler
from connectome_gnn_jax.utils.pytree import pytree_dataclass, static_field
from typing import NamedTuple


class HopBlock(NamedTuple):
    """One hop's edges in the sampler's [frontier, fanout] emission
    layout.  Row b holds frontier slot b's draws: ``senders[b, :]``
    (local node ids; invalid draws point at the receiver itself with
    ``weights[b, :] == 0``), all received by local node ``recv[b]``.
    Hop 0's ``recv`` is always ``arange(num_seeds)``.

    In the MULTISET sampling mode (``device_sample(..., dedup=False)``)
    locals are arithmetic: real senders are their own draw slots
    (``sender_start + arange(Fb*f)``) and receivers the frontier's slots
    (``recv_start + arange(Fb)``).  The static ints let blocked layers
    turn per-edge gathers/scatters into contiguous slices (weight-0
    invalid draws make the slice read numerically inert).  ``None`` for
    dedup-mode blocks — and ``None`` pytree nodes are EMPTY, so the
    dedup-mode pytree structure is unchanged.  The ints survive as
    statics only while the batch stays inside one jitted program (the
    product path); consumers must treat traced values as absent."""

    senders: jnp.ndarray  # int32 [Fb, f]
    weights: jnp.ndarray  # float32 [Fb, f]
    recv: jnp.ndarray  # int32 [Fb]
    sender_start: "int | None" = None
    recv_start: "int | None" = None


@pytree_dataclass
class SampledNodeBatch:
    """A padded k-hop sampled subgraph with seed-node supervision.

    Nodes are relabeled sampler-locally with the ``num_seeds`` seed slots
    FIRST; edges are receiver-sorted (padding edges carry weight 0 and
    point at the last node slot, keeping them inert and the sort valid).

    Attributes
    ----------
    node_features : float32 [N_budget, F]
    senders / receivers : int32 [E_budget]
    edge_weight : float32 [E_budget]   0 on padding
    node_mask : bool [N_budget]        True for real sampled nodes
    labels : int32 [S]                 per-seed labels (0 where unlabeled)
    label_mask : bool [S]              real AND labeled seed slots
    seed_mask : bool [S]               real seed slots (labeled or not)
    node_ids : int32 [N_budget]        original giant-graph node id per
                                       slot (-1 padding) — for writing
                                       predictions back
    num_seeds : int (static)
    """

    node_features: jnp.ndarray
    senders: jnp.ndarray
    receivers: jnp.ndarray
    edge_weight: jnp.ndarray
    node_mask: jnp.ndarray
    labels: jnp.ndarray
    label_mask: jnp.ndarray
    seed_mask: jnp.ndarray
    node_ids: jnp.ndarray
    num_seeds: int = static_field(default=0)
    # Optional per-hop blocked adjacency (device-side sampler only):
    # tuple of HopBlock, one per hop, exposing the [frontier, fanout]
    # emission layout so layers can aggregate by reshape-sum + a small
    # per-frontier scatter instead of an edge-count scatter (every
    # random-access pass over the edges costs a memory round trip per
    # row).  Flat senders/receivers/edge_weight
    # above remain the same edges (blocks are reshaped views); None for
    # host-built batches.
    hop_blocks: "tuple[HopBlock, ...] | None" = None

    @property
    def num_nodes(self) -> int:
        return int(self.node_features.shape[0])

    @property
    def graph_mask(self) -> jnp.ndarray:
        """Real seed slots — lets ``Trainer.predict`` serve unlabeled
        seeds (mirrors ``ConnectomeBatch.graph_mask``)."""
        return self.seed_mask


def collate_sampled(
    subgraph: ConnectomeGraph,
    node_ids: np.ndarray,
    seed_labels: Optional[np.ndarray],
    *,
    num_seeds: int,
    real_seeds: int,
    node_budget: int,
    edge_budget: int,
) -> SampledNodeBatch:
    """Pack one sampled subgraph (seeds-first, as the samplers return it)
    into a :class:`SampledNodeBatch`.

    ``seed_labels`` are the labels of the REAL seeds (length
    ``real_seeds``); remaining seed slots are masked padding.
    """
    n, e = subgraph.num_nodes, subgraph.num_edges
    if n > node_budget:
        raise ValueError(f"sampled {n} nodes > node_budget {node_budget}")
    if e > edge_budget:
        raise ValueError(f"sampled {e} edges > edge_budget {edge_budget}")
    if real_seeds > num_seeds:
        raise ValueError(f"{real_seeds} seeds > seed slots {num_seeds}")

    F = subgraph.num_features
    x = np.zeros((node_budget, F), np.float32)
    x[:n] = subgraph.node_features
    node_mask = np.zeros(node_budget, bool)
    node_mask[:n] = True
    ids = np.full(node_budget, -1, np.int32)
    ids[:n] = node_ids

    # receiver-sort for segment_sum's indices_are_sorted fast path;
    # padding edges target the LAST slot with weight 0 (inert, sorted)
    src, dst = subgraph.edge_index
    order = np.argsort(dst, kind="stable")
    senders = np.full(edge_budget, node_budget - 1, np.int32)
    receivers = np.full(edge_budget, node_budget - 1, np.int32)
    weights = np.zeros(edge_budget, np.float32)
    senders[:e] = src[order]
    receivers[:e] = dst[order]
    weights[:e] = subgraph.edge_weight[order]

    labels = np.zeros(num_seeds, np.int32)
    label_mask = np.zeros(num_seeds, bool)
    seed_mask = np.zeros(num_seeds, bool)
    seed_mask[:real_seeds] = True
    if seed_labels is not None:
        labels[:real_seeds] = np.asarray(seed_labels, np.int32)
        label_mask[:real_seeds] = True

    return SampledNodeBatch(
        node_features=jnp.asarray(x),
        senders=jnp.asarray(senders),
        receivers=jnp.asarray(receivers),
        edge_weight=jnp.asarray(weights),
        node_mask=jnp.asarray(node_mask),
        labels=jnp.asarray(labels),
        label_mask=jnp.asarray(label_mask),
        seed_mask=jnp.asarray(seed_mask),
        node_ids=jnp.asarray(ids),
        num_seeds=int(num_seeds),
    )


@partial(
    jax.jit,
    static_argnames=("node_budget", "edge_budget", "num_seeds", "labeled"),
)
def _build_sampled_batch(
    feat_tab: jnp.ndarray,
    ints: jnp.ndarray,
    weights: jnp.ndarray,
    *,
    node_budget: int,
    edge_budget: int,
    num_seeds: int,
    labeled: bool,
) -> SampledNodeBatch:
    """Unpack the single-transfer ingest buffer into a batch, ON DEVICE.

    ``ints`` (int32) is ``[n_nodes, real_seeds, node_ids(node_budget),
    senders(edge_budget), receivers(edge_budget), labels(num_seeds)]`` —
    the fused native collate writes straight into slices of it, so one
    int32 array and one float32 array cross the host→device link per
    sampled step instead of nine (at 1M nodes the per-array transfer
    latency plus shipping gathered features dominated the step; see
    ``benchmarks/profile_sampled.py``).  Node features never cross at
    all: they are gathered here from the device-resident giant-graph
    feature table (padding ids are -1 → clipped to row 0 and zeroed by
    the mask, matching the host collate's zero-fill bitwise).
    """
    n_nodes, real_seeds = ints[0], ints[1]
    o = 2
    ids = ints[o : o + node_budget]
    o += node_budget
    senders = ints[o : o + edge_budget]
    o += edge_budget
    receivers = ints[o : o + edge_budget]
    o += edge_budget
    labels = ints[o : o + num_seeds]

    node_mask = jnp.arange(node_budget, dtype=jnp.int32) < n_nodes
    x = jnp.where(
        node_mask[:, None],
        feat_tab[jnp.clip(ids, 0, feat_tab.shape[0] - 1)],
        jnp.zeros((), feat_tab.dtype),
    )
    seed_mask = jnp.arange(num_seeds, dtype=jnp.int32) < real_seeds
    label_mask = seed_mask if labeled else jnp.zeros(num_seeds, bool)
    labels = jnp.where(label_mask, labels, 0)
    return SampledNodeBatch(
        node_features=x,
        senders=senders,
        receivers=receivers,
        edge_weight=weights,
        node_mask=node_mask,
        labels=labels,
        label_mask=label_mask,
        seed_mask=seed_mask,
        node_ids=ids,
        num_seeds=int(num_seeds),
    )


def full_graph_batch(
    graph: ConnectomeGraph,
    node_labels: Optional[np.ndarray] = None,
    *,
    seed_nodes: Optional[Sequence[int]] = None,
    node_multiple: int = 8,
    edge_multiple: int = 128,
) -> SampledNodeBatch:
    """The whole graph as one :class:`SampledNodeBatch` (identity sample).

    The full-batch oracle for sampled training: every node is present,
    ``seed_nodes`` (default: all nodes) are the supervised slots.  Seeds
    must be a prefix-permutation-free arbitrary subset — the node space is
    REORDERED seeds-first to honor the container contract.
    """
    n = graph.num_nodes
    seeds = (
        np.arange(n, dtype=np.int64)
        if seed_nodes is None
        else np.asarray(list(dict.fromkeys(int(s) for s in seed_nodes)), np.int64)
    )
    rest = np.setdiff1d(np.arange(n, dtype=np.int64), seeds, assume_unique=False)
    order = np.concatenate([seeds, rest])  # order[new] = old
    relabel = np.empty(n, np.int64)
    relabel[order] = np.arange(n)

    src, dst = graph.edge_index
    reordered = ConnectomeGraph(
        node_features=graph.node_features[order],
        edge_index=np.stack([relabel[src], relabel[dst]]).astype(np.int32),
        edge_weight=graph.edge_weight,
        label=graph.label,
        subject_id=graph.subject_id,
    )
    labels = (
        np.asarray(node_labels)[seeds] if node_labels is not None else None
    )
    return collate_sampled(
        reordered,
        node_ids=order,
        seed_labels=labels,
        num_seeds=len(seeds),
        real_seeds=len(seeds),
        node_budget=round_up(n, node_multiple),
        edge_budget=round_up(graph.num_edges, edge_multiple),
    )


def fanout_budgets(
    batch_size: int, fanout: Sequence[int], num_features: int = 0
) -> tuple[int, int]:
    """Worst-case (node, edge) budgets for a ``batch_size``-seed sample:
    every hop expands fully, nothing deduplicates."""
    nodes = batch_size
    edges = 0
    frontier = batch_size
    for f in fanout:
        frontier *= f
        edges += frontier
        nodes += frontier
    return nodes, edges


def _sample_seed(base: int, epoch: int, step: int, shard: int = -1) -> int:
    """Deterministic, platform-stable per-(epoch, step, shard) sampling
    seed.  Mixing through ``np.random.SeedSequence`` avoids leaning on
    CPython's ``hash()`` being stable (it is today, but that's an
    implementation detail) and decorrelates streams across epochs, steps,
    and global shard indices — so every process derives the same stream
    for a given global shard without coordination."""
    return int(
        np.random.SeedSequence([base, epoch, step, shard + 1]).generate_state(1)[0]
        & 0x7FFFFFFF
    )


class SampledNodeLoader:
    """Per-step neighbor-sampled minibatches over ONE giant graph.

    Each iteration shuffles the seed-node pool (labeled nodes by default),
    chunks it into ``batch_size`` seed minibatches, fanout-samples each
    (native C++ traversal, amortized index build) and yields static-shape
    :class:`SampledNodeBatch` es.  Drives the standard :class:`Trainer`.

    Parameters
    ----------
    graph
        The giant host-side graph.
    node_labels
        int labels per node (or None for unlabeled serving).
    seed_nodes
        The supervised node pool (default: all nodes).
    batch_size
        Seed nodes per step (static seed-slot count).
    fanout
        Per-hop in-neighbor cap; depth = len(fanout) (match the model's
        ``num_layers`` — deeper models would read zero-padded context).
    node_budget / edge_budget
        Static paddings; default = the no-dedup worst case
        (:func:`fanout_budgets`) capped at the full graph size.
    shuffle / seed
        Epoch shuffling of the seed pool, pinned per epoch like
        :class:`~connectome_gnn_jax.data.loader.ConnectomeDataLoader`
        (``set_epoch`` replays a resumed run exactly).  The per-step
        *sampling* streams advance with the epoch counter even when
        ``shuffle=False``, so an eval-with-sampling loop draws fresh
        subgraphs each pass.
    drop_last
        Drop the final partial seed chunk instead of padding it.
    num_shards
        When set, ``batch_size`` is the GLOBAL seed count per step and
        each yielded batch is a *stacked* pytree with a leading device
        axis of size ``num_shards`` (per-shard sub-batches of
        ``batch_size / num_shards`` seeds, each fanout-sampled
        independently) for ``shard_map`` data parallelism — the
        distributed half of BASELINE config 5.  Budgets apply per shard.
    fused
        Use the fused native sample→collate path (default: whenever the
        native library is available): one C++ traversal with persistent
        scratch writes the padded batch arrays into a single ingest
        buffer, features are gathered on device from a resident table,
        and only two arrays cross the host→device link per step.  Same
        sampling stream as the classic path (identical subgraphs per
        seed); only the intra-receiver edge order differs (draw order vs
        global-edge-id order), which perturbs segment-sum accumulation
        at the last ulp.  ``False`` forces the classic
        ``NeighborSampler.sample`` + :func:`collate_sampled` pipeline.
    process_index / process_count
        Multi-process data sharding: with both set, each yielded batch
        stacks only this process's contiguous
        ``num_shards / process_count`` shards; seed shuffling and the
        per-shard sampling streams are functions of the GLOBAL shard
        index, so all processes agree on the global batch without
        coordination.  Lift the local stack with
        :func:`~connectome_gnn_jax.parallel.distributed.assemble_global`
        (``Trainer`` does this automatically in mesh mode).
    """

    def __init__(
        self,
        graph: ConnectomeGraph,
        node_labels: Optional[np.ndarray] = None,
        *,
        seed_nodes: Optional[Sequence[int]] = None,
        batch_size: int = 512,
        fanout: Sequence[int] = (10, 10),
        node_budget: Optional[int] = None,
        edge_budget: Optional[int] = None,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        node_multiple: int = 8,
        edge_multiple: int = 128,
        num_shards: Optional[int] = None,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        fused: Optional[bool] = None,
    ):
        self.graph = graph
        self.node_labels = (
            np.asarray(node_labels, np.int32) if node_labels is not None else None
        )
        self.seeds = (
            np.arange(graph.num_nodes, dtype=np.int64)
            if seed_nodes is None
            else np.asarray(seed_nodes, np.int64)
        )
        self.batch_size = int(batch_size)
        self.fanout = tuple(int(f) for f in fanout)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.drop_last = bool(drop_last)
        self._epoch = 0
        self._sampler = NeighborSampler(graph)

        self.num_shards = int(num_shards) if num_shards is not None else None
        if self.num_shards is not None and self.batch_size % self.num_shards:
            raise ValueError(
                f"batch_size={self.batch_size} not divisible by "
                f"num_shards={self.num_shards}"
            )
        self._shard_size = (
            self.batch_size // self.num_shards
            if self.num_shards is not None
            else self.batch_size
        )
        if (process_index is None) != (process_count is None):
            raise ValueError(
                "process_index and process_count must be given together"
            )
        if process_count is not None:
            if self.num_shards is None:
                raise ValueError("process sharding requires num_shards")
            if self.num_shards % process_count:
                raise ValueError(
                    f"num_shards={self.num_shards} not divisible by "
                    f"process_count={process_count}"
                )
            if not 0 <= process_index < process_count:
                raise ValueError(
                    f"process_index={process_index} out of range "
                    f"[0, {process_count})"
                )
            per = self.num_shards // process_count
            self._shard_lo, self._shard_hi = (
                process_index * per,
                (process_index + 1) * per,
            )
        else:
            self._shard_lo, self._shard_hi = 0, self.num_shards or 0

        worst_n, worst_e = fanout_budgets(self._shard_size, self.fanout)
        if node_budget is None:
            node_budget = min(worst_n, graph.num_nodes)
        if edge_budget is None:
            edge_budget = min(worst_e, graph.num_edges)
        self.node_budget = round_up(int(node_budget), node_multiple)
        self.edge_budget = round_up(int(edge_budget), edge_multiple)

        from connectome_gnn_jax import native

        self.fused = bool(native.AVAILABLE) if fused is None else bool(fused)
        if self.fused and not native.AVAILABLE:
            raise RuntimeError("fused=True requires the native library")
        # device-resident feature table for the fused path's on-device
        # gather (the giant graph's features are uploaded ONCE; per step
        # only ids/edges cross the link)
        self._feat_tab = (
            jnp.asarray(graph.node_features, jnp.float32)
            if self.fused
            else None
        )

    def __len__(self) -> int:
        n = len(self.seeds)
        if self.drop_last:
            return n // self.batch_size
        return math.ceil(n / self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle stream AND the per-step sampling streams to
        ``epoch`` (see ``ConnectomeDataLoader.set_epoch``)."""
        self._epoch = int(epoch)

    def _sample_and_collate_fused(
        self, chunk: np.ndarray, sample_seed: int, num_seeds: int
    ) -> SampledNodeBatch:
        """One native traversal → single-transfer ingest buffer →
        on-device unpack/gather (see :func:`_build_sampled_batch`)."""
        nb, eb = self.node_budget, self.edge_budget
        ints = np.empty(2 + nb + 2 * eb + num_seeds, np.int32)
        weights = np.empty(eb, np.float32)
        ids = ints[2 : 2 + nb]
        senders = ints[2 + nb : 2 + nb + eb]
        receivers = ints[2 + nb + eb : 2 + nb + 2 * eb]
        labels = ints[2 + nb + 2 * eb :]
        if len(chunk) == 0:
            n_nodes = 0
            ids.fill(-1)
            senders.fill(nb - 1)
            receivers.fill(nb - 1)
            weights.fill(0.0)
        else:
            n_nodes, _ = self._sampler.sample_collate_into(
                chunk, self.fanout, sample_seed,
                node_budget=nb, edge_budget=eb,
                out_senders=senders, out_receivers=receivers,
                out_weights=weights, out_node_ids=ids,
            )
        ints[0] = n_nodes
        ints[1] = len(chunk)
        labels.fill(0)
        if self.node_labels is not None and len(chunk):
            labels[: len(chunk)] = self.node_labels[chunk]
        return _build_sampled_batch(
            self._feat_tab, jnp.asarray(ints), jnp.asarray(weights),
            node_budget=nb, edge_budget=eb, num_seeds=num_seeds,
            labeled=self.node_labels is not None,
        )

    def _sample_and_collate(
        self, chunk: np.ndarray, sample_seed: int, num_seeds: int
    ) -> SampledNodeBatch:
        if self.fused:
            return self._sample_and_collate_fused(chunk, sample_seed, num_seeds)
        if len(chunk) == 0:
            # empty shard slot on a final partial step: all-padding batch
            sub = ConnectomeGraph(
                node_features=np.zeros((0, self.graph.num_features), np.float32),
                edge_index=np.zeros((2, 0), np.int32),
                edge_weight=np.zeros(0, np.float32),
            )
            node_ids = np.zeros(0, np.int64)
        else:
            sub, node_ids = self._sampler.sample(
                chunk, self.fanout, seed=sample_seed
            )
        return collate_sampled(
            sub,
            node_ids,
            self.node_labels[chunk] if self.node_labels is not None else None,
            num_seeds=num_seeds,
            real_seeds=len(chunk),
            node_budget=self.node_budget,
            edge_budget=self.edge_budget,
        )

    def __iter__(self) -> Iterator[SampledNodeBatch]:
        seeds = self.seeds
        epoch = self._epoch
        # advance regardless of shuffle so repeated passes draw fresh
        # subgraphs (an eval-with-sampling loop must not resample
        # bit-identical neighborhoods every epoch)
        self._epoch += 1
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch)
            seeds = seeds[rng.permutation(len(seeds))]
        for b, start in enumerate(range(0, len(seeds), self.batch_size)):
            chunk = seeds[start : start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            if self.num_shards is None:
                yield self._sample_and_collate(
                    chunk, _sample_seed(self.seed, epoch, b), self.batch_size
                )
            else:
                ss = self._shard_size
                shards = [
                    self._sample_and_collate(
                        chunk[s * ss : (s + 1) * ss],
                        _sample_seed(self.seed, epoch, b, s),
                        ss,
                    )
                    for s in range(self._shard_lo, self._shard_hi)
                ]
                from connectome_gnn_jax.parallel.data_parallel import (
                    stack_batches,
                )

                yield stack_batches(shards)
