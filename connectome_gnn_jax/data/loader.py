"""Batch loader with jit-stable shapes.

Mirrors the reference ``ConnectomeDataLoader`` (reference
``connectome_gnn/graph.py:174-197``: shuffle, slice, collate) but is designed
for XLA's compile-once model: every batch a loader yields has **identical
static shapes** — fixed graph-slot count, fixed node/edge budgets — so the
jitted train step compiles exactly once.  The final partial batch is padded
with empty graph slots and masked via ``label_mask`` instead of being
shape-ragged.

Shuffling uses an explicit numpy Generator seeded per epoch (the reference
leans on torch's global RNG, graph.py:193; explicit seeding is the JAX-native
equivalent and keeps epochs reproducible).
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Sequence

from connectome_gnn_jax.data.batch import ConnectomeBatch, collate_graphs, round_up
from connectome_gnn_jax.data.graph import ConnectomeGraph

import numpy as np


class ConnectomeDataLoader:
    """Minimal loader that packs ``ConnectomeGraph`` objects into padded
    fixed-shape :class:`ConnectomeBatch` mini-batches.

    Parameters
    ----------
    dataset
        Sequence of host-side graphs.
    batch_size
        Graph slots per batch (every batch, including the last, has exactly
        this many slots).
    shuffle
        Reshuffle indices each epoch.
    seed
        Base RNG seed for shuffling; epoch ``t`` uses ``seed + t``.
    node_budget / edge_budget
        Static per-batch padding budgets.  Default: the worst-case batch
        (sum of the ``batch_size`` largest graphs), rounded to hardware
        multiples — guaranteeing a single compiled shape for any epoch.
    drop_last
        Drop the final partial batch instead of padding it.
    num_shards
        When set, each yielded batch is a *stacked* pytree with a leading
        device axis of size ``num_shards`` (``batch_size`` graphs split
        evenly into per-shard sub-batches) for ``shard_map`` data
        parallelism.  Budgets then apply per shard.
    process_index / process_count
        Multi-process data sharding: with both set, ``num_shards`` is the
        GLOBAL shard count and each yielded batch stacks only this
        process's contiguous ``num_shards / process_count`` shards (the
        rest are never collated or materialized here).  All processes
        must use identical ``seed``/``set_epoch`` so the global shuffle
        order agrees; lift the local stack to a global array with
        :func:`~connectome_gnn_jax.parallel.distributed.assemble_global`
        (``Trainer`` does this automatically in mesh mode).
    layout
        ``"coo"`` (default) yields padded :class:`ConnectomeBatch`;
        ``"dense"`` yields :class:`DenseConnectomeBatch` (batched dense
        adjacency, the batched-matmul path for equal-size small graphs).
    """

    def __init__(
        self,
        dataset: Sequence[ConnectomeGraph],
        batch_size: int = 16,
        shuffle: bool = True,
        seed: int = 0,
        node_budget: Optional[int] = None,
        edge_budget: Optional[int] = None,
        node_multiple: int = 8,
        edge_multiple: int = 128,
        drop_last: bool = False,
        num_shards: Optional[int] = None,
        layout: str = "coo",
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
    ):
        if len(dataset) == 0:
            raise ValueError("dataset is empty")
        if layout not in ("coo", "dense"):
            raise ValueError(f"unknown layout {layout!r}; expected 'coo' or 'dense'")
        self.layout = layout
        self.dataset = list(dataset)
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.drop_last = bool(drop_last)
        self.num_shards = int(num_shards) if num_shards is not None else None
        self._epoch = 0

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

        if node_budget is None or edge_budget is None:
            nodes = sorted((g.num_nodes for g in self.dataset), reverse=True)
            edges = sorted((g.num_edges for g in self.dataset), reverse=True)
            k = min(self._shard_size, len(self.dataset))
            worst_nodes = sum(nodes[:k])
            worst_edges = sum(edges[:k])
            if node_budget is None:
                node_budget = round_up(worst_nodes, node_multiple)
            if edge_budget is None:
                edge_budget = round_up(worst_edges, edge_multiple)
        self.node_budget = int(node_budget)
        self.edge_budget = int(edge_budget)
        self._num_features = self.dataset[0].num_features
        # dense layout: one shared per-graph node budget
        self._dense_node_budget = round_up(
            max(g.num_nodes for g in self.dataset), node_multiple
        )

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return math.ceil(n / self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle stream: the next iteration uses ``seed + epoch``.

        Epoch ``t`` shuffles with ``seed + t`` either way; calling this
        makes the order an explicit function of ``epoch`` rather than of
        how many times the loader has been iterated — which is what lets
        a resumed :meth:`Trainer.fit` replay the exact batch order of an
        uninterrupted run.
        """
        self._epoch = int(epoch)

    def __iter__(self) -> Iterator[ConnectomeBatch]:
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(indices)
            self._epoch += 1
        for start in range(0, len(indices), self.batch_size):
            chunk = indices[start : start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            if self.num_shards is None:
                yield self._collate([self.dataset[i] for i in chunk])
            else:
                shards = [
                    self._collate(
                        [
                            self.dataset[i]
                            for i in chunk[
                                s * self._shard_size : (s + 1) * self._shard_size
                            ]
                        ]
                    )
                    for s in range(self._shard_lo, self._shard_hi)
                ]
                from connectome_gnn_jax.parallel.data_parallel import stack_batches

                yield stack_batches(shards)

    def _collate(self, graphs: list):
        if self.layout == "dense":
            from connectome_gnn_jax.data.dense import collate_dense

            return collate_dense(
                graphs,
                num_graphs=self._shard_size,
                node_budget=self._dense_node_budget,
                num_features=self._num_features,
            )
        return collate_graphs(
            graphs,
            num_graphs=self._shard_size,
            node_budget=self.node_budget,
            edge_budget=self.edge_budget,
            num_features=self._num_features,
        )
