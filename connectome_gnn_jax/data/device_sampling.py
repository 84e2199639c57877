"""Device-side neighbor sampling: the giant graph lives in HBM and every
step's fanout sample is drawn INSIDE the jitted program.

Why this exists: a host-built sampled batch is ~1.8 MB per step that
the host must build and ship before the device does anything (see
``benchmarks/profile_sampled.py``).  The answer is to stop shipping
batches: the CSR adjacency, features, and weights are uploaded ONCE
(:class:`DeviceGraphCSR`, ~0.61 GB at 1M nodes / 44M edges), and each
training step receives only a ~8 KB :class:`SeedBatch` (seed ids + PRNG
key + labels, packed into a single int32 buffer = one transfer, one
dispatch).  Sampling, dedup, relabeling, feature gather, and the train
step all fuse into one XLA program.  Resident bytes at 1M nodes / 44M
edges: indptr 4 MB + packed (sender, weight) pairs 352 MB + features
256 MB ≈ 0.61 GB (the flat senders/edge_weight arrays are NOT kept when
the packed pairs are — they would nearly double edge storage).

Data parallelism composes at the SEED level: the CSR replicates per
device (it is already device-resident), and only the ~8 KB seed payload
is sharded — :class:`DeviceSeedLoader` takes the same ``num_shards`` /
``process_index``/``process_count`` modes as
:class:`~connectome_gnn_jax.data.sampled.SampledNodeLoader`, yielding
stacked ``[D, 3+2S]`` packed buffers for the shard_map DP step
(:func:`~connectome_gnn_jax.parallel.sampled_dp.
make_device_sampled_dp_step`); the :class:`~connectome_gnn_jax.train.
Trainer` in mesh mode dispatches these automatically.

Sampling semantics match the host samplers (``data/sampling.py``):
GraphSAGE-style hop expansion over in-edges, up to ``fanout[h]`` sampled
in-neighbors per frontier node, uniform WITHOUT replacement (here via
Gumbel-style top-k over masked uniforms — taking the top-f of iid
uniforms over a node's edge slots is exactly a uniform f-subset), seeds
first.  Node discovery order differs from the host traversal (per hop,
new nodes are appended in ascending global id rather than draw order) and
the PRNG stream is ``jax.random``, not splitmix64 — so device and host
samples are distributionally equal but not bitwise.  With ``fanout[h] >=
max_in_degree`` both keep EVERY in-edge, and the resulting model outputs
must agree exactly — that keep-all oracle is the equivalence test
(``tests/test_device_sampling.py``).

Static shapes throughout: frontier/edge buffers are the no-dedup fanout
worst case, so the whole train step compiles once.  Receiver-sortedness
(which ``segment_sum(indices_are_sorted=True)`` relies on) holds by
construction: local ids are assigned in emission order and each hop
expands its frontier in ascending local id; invalid draw slots become
weight-0 self-edges on a forward-filled receiver, keeping the index
monotone and the padding inert.

The reference has no sampling or device residency at all (SURVEY §0);
this scales the scatter aggregation of
`/root/reference/connectome_gnn/models.py:45-54` to graphs that cannot
leave the device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from connectome_gnn_jax.data.graph import ConnectomeGraph
from connectome_gnn_jax.data.sampled import (HopBlock, SampledNodeBatch,
                                             fanout_budgets)
from connectome_gnn_jax.utils.pytree import pytree_dataclass, static_field


def cap_in_degree_mask(
    dst: np.ndarray, w: np.ndarray, cap: int
) -> np.ndarray:
    """Boolean keep-mask (original edge order) keeping, per receiver,
    the ``cap`` largest-``|weight|`` in-edges; ties break to the
    earliest edge in the stable receiver order.

    This is the documented mitigation for the samplers' skewed-degree
    memory cliff: every uniform-draw buffer is sized by the GLOBAL
    ``max_in_degree`` (``[Fb, max_deg]`` replicated, ``[D, C, max_deg]``
    sharded — see ``parallel/sharded_sampling.py``), so one power-law
    hub prices the whole buffer.  Pre-clamping keeps the strongest
    connections (kNN-style sparsification) and bounds the buffers at
    ``cap``.  The rule is deterministic and shared by
    :meth:`DeviceGraphCSR.from_graph`, ``ShardedGraphCSR.partition``
    and ``partition_streamed`` (bitwise-identical results, tested).
    """
    cap = int(cap)
    if cap < 1:
        raise ValueError(f"in_degree_cap must be >= 1, got {cap}")
    E = int(len(dst))
    if E == 0:
        return np.ones(0, bool)
    order = np.argsort(dst, kind="stable")  # the stable receiver sort
    absw = np.abs(np.asarray(w, np.float32)[order])
    pos = np.arange(E)
    o2 = np.lexsort((pos, -absw, dst[order]))  # dst, |w| desc, pos asc
    dst2 = dst[order][o2]
    rank = np.arange(E) - np.searchsorted(dst2, dst2, side="left")
    keep = np.ones(E, bool)
    keep[order[o2[rank >= cap]]] = False
    return keep


@pytree_dataclass
class DeviceGraphCSR:
    """Receiver-grouped CSR adjacency resident on device.

    Adjacency is held EITHER as packed ``sender_weight`` [E, 2] rows of
    (sender id, bitcast f32 weight) — the default: the sampler is bound
    by random row accesses, so one 8-byte access pass replaces two
    4-byte ones — OR as flat ``senders`` /
    ``edge_weight`` arrays (``from_graph(packed=False)``).  Keeping both
    would nearly double edge storage (+~350 MB at 44M edges) for no
    reader.  ``max_in_degree`` bounds the per-node uniform-draw buffer
    (static).
    """

    indptr: jnp.ndarray  # int32 [N+1]
    node_features: jnp.ndarray  # f32 / bf16 / int8 [N, F] (see below)
    senders: Optional[jnp.ndarray] = None  # int32 [E], grouped by recv
    edge_weight: Optional[jnp.ndarray] = None  # float32 [E]
    sender_weight: Optional[jnp.ndarray] = None  # int32 [E, 2] packed
    feature_scale: Optional[jnp.ndarray] = None  # f32 [F], int8 mode
    max_in_degree: int = static_field(default=0)

    @property
    def num_nodes(self) -> int:
        return int(self.indptr.shape[0]) - 1

    @property
    def num_edges(self) -> int:
        if self.senders is not None:
            return int(self.senders.shape[0])
        return int(self.sender_weight.shape[0])

    def gather_features(self, idx: jnp.ndarray) -> jnp.ndarray:
        """Feature-table gather, always returning float32 rows.

        With a reduced-precision table (``from_graph(feature_dtype=
        "bfloat16"/"int8")``) the gather moves 2×/4× fewer HBM bytes
        and residency halves/quarters; the cast (and int8 per-column
        dequant ``q · scale``) fuses into the consumer.  Do NOT expect
        a gather-latency win: random row access is bounded by the
        512-B DMA tile granularity, not row bytes (GATHER_DMA_r04) —
        the dtype option buys RESIDENCY (a ~10× bigger graph still
        replicates per chip), verified in benchmarks/table_dtype.py.
        """
        x = self.node_features[idx]
        if self.feature_scale is not None:
            return x.astype(jnp.float32) * self.feature_scale
        return x.astype(jnp.float32)

    @classmethod
    def from_graph(
        cls, graph: ConnectomeGraph, *, packed: bool = True,
        feature_dtype: str = "float32",
        in_degree_cap: Optional[int] = None,
    ) -> "DeviceGraphCSR":
        """One-time host prep (receiver sort) + upload.

        ``feature_dtype``: ``"float32"`` (default), ``"bfloat16"``
        (table stored bf16, read back as f32 — one rounding), or
        ``"int8"`` (symmetric per-COLUMN quantization ``q = round(x /
        s)``, ``s = absmax/127`` per feature column; dequant error
        ≤ s/2 per element, tested).

        ``in_degree_cap``: keep only each node's ``cap``
        largest-``|weight|`` in-edges (:func:`cap_in_degree_mask`) —
        bounds ``max_in_degree`` and with it every per-draw uniform
        buffer, the skewed-degree (power-law hub) mitigation.
        """
        src, dst = graph.edge_index
        ew = graph.edge_weight
        if in_degree_cap is not None:
            keep = cap_in_degree_mask(dst, ew, in_degree_cap)
            src, dst, ew = src[keep], dst[keep], ew[keep]
        order = np.argsort(dst, kind="stable")
        dst_sorted = dst[order]
        counts = np.bincount(dst_sorted, minlength=graph.num_nodes)
        indptr = np.zeros(graph.num_nodes + 1, np.int32)
        np.cumsum(counts, out=indptr[1:])
        snd = src[order].astype(np.int32)
        w = ew[order].astype(np.float32)
        adjacency = (
            dict(sender_weight=jnp.asarray(
                np.stack([snd, w.view(np.int32)], axis=1)
            ))
            if packed
            else dict(senders=jnp.asarray(snd), edge_weight=jnp.asarray(w))
        )
        x = graph.node_features.astype(np.float32)
        scale = None
        if feature_dtype == "float32":
            feats = jnp.asarray(x)
        elif feature_dtype == "bfloat16":
            feats = jnp.asarray(x).astype(jnp.bfloat16)
        elif feature_dtype == "int8":
            s = np.abs(x).max(axis=0) / 127.0
            s = np.where(s > 0, s, 1.0).astype(np.float32)
            q = np.clip(np.round(x / s), -127, 127).astype(np.int8)
            feats = jnp.asarray(q)
            scale = jnp.asarray(s)
        else:
            raise ValueError(
                f"feature_dtype must be float32/bfloat16/int8, got "
                f"{feature_dtype!r}"
            )
        return cls(
            indptr=jnp.asarray(indptr),
            node_features=feats,
            feature_scale=scale,
            max_in_degree=int(counts.max()) if counts.size else 0,
            **adjacency,
        )


@pytree_dataclass
class SeedBatch:
    """One sampled-training step's host→device payload: a single int32
    buffer ``[real_seeds, key_hi, key_lo, seeds(S), labels(S)]`` (~8 KB).

    Seed slots beyond ``real_seeds`` carry -1.  Exposes the
    ``labels`` / ``label_mask`` / ``graph_mask`` surface the standard
    :class:`~connectome_gnn_jax.train.Trainer` reads, so sampled
    training through a :class:`DeviceSampledModel` drives it unchanged.

    ``csr`` (optional) carries the device-resident graph as pytree
    LEAVES of the batch.  This matters on remote runtimes: a jitted step
    that merely closed over the CSR would embed ~0.6 GB of constants in
    the program — this rig's remote-compile endpoint rejects that with
    HTTP 413 at the 1M-node scale.  As arguments the arrays cost nothing
    per call (they already live on device).

    A STACKED batch (sharded :class:`DeviceSeedLoader`) carries a
    ``[D, 3 + 2·num_seeds]`` packed buffer — one row per mesh shard,
    each with its own sampling key; the ``csr`` stays un-stacked
    (replicated, not one copy per shard).  All properties broadcast over
    the leading axis via ``...`` indexing.
    """

    packed: jnp.ndarray  # int32 [3 + 2 * num_seeds] (or [D, ...] stacked)
    csr: Optional["DeviceGraphCSR"] = None
    num_seeds: int = static_field(default=0)
    labeled: bool = static_field(default=True)

    @property
    def stacked(self) -> bool:
        return self.packed.ndim == 2

    @property
    def seeds(self) -> jnp.ndarray:
        return self.packed[..., 3 : 3 + self.num_seeds]

    @property
    def key_data(self) -> jnp.ndarray:
        return jax.lax.bitcast_convert_type(
            self.packed[..., 1:3], jnp.uint32
        )

    @property
    def seed_mask(self) -> jnp.ndarray:
        return (
            jnp.arange(self.num_seeds, dtype=jnp.int32)
            < self.packed[..., 0:1]
        )

    @property
    def label_mask(self) -> jnp.ndarray:
        if not self.labeled:
            return jnp.zeros(self.seed_mask.shape, bool)
        return self.seed_mask

    @property
    def labels(self) -> jnp.ndarray:
        raw = self.packed[..., 3 + self.num_seeds : 3 + 2 * self.num_seeds]
        return jnp.where(self.label_mask, raw, 0)

    @property
    def graph_mask(self) -> jnp.ndarray:
        return self.seed_mask


def _pack_seed_row(
    chunk: np.ndarray,
    labels: Optional[np.ndarray],
    sample_seed: int,
    num_seeds: int,
) -> np.ndarray:
    packed = np.empty(3 + 2 * num_seeds, np.int32)
    packed[0] = len(chunk)
    packed[1:3] = np.array([0, sample_seed], np.uint32).view(np.int32)
    packed[3 : 3 + num_seeds] = -1
    packed[3 : 3 + len(chunk)] = chunk
    lab = packed[3 + num_seeds :]
    lab[:] = 0
    if labels is not None and len(chunk):
        lab[: len(chunk)] = labels[chunk]
    return packed


def make_seed_batch(
    chunk: np.ndarray,
    labels: Optional[np.ndarray],
    sample_seed: int,
    num_seeds: int,
    csr: Optional[DeviceGraphCSR] = None,
) -> SeedBatch:
    """Host-side constructor (numpy fills + ONE jnp.asarray)."""
    return SeedBatch(
        packed=jnp.asarray(
            _pack_seed_row(chunk, labels, sample_seed, num_seeds)
        ),
        csr=csr,
        num_seeds=int(num_seeds),
        labeled=labels is not None,
    )


def device_sample(
    csr: DeviceGraphCSR,
    seeds: jnp.ndarray,
    key: jax.Array,
    fanout: Sequence[int],
    *,
    dedup: bool = True,
) -> SampledNodeBatch:
    """k-hop fanout sample as a pure jittable function (labels unset —
    :class:`DeviceSampledModel` splices them from the :class:`SeedBatch`).

    ``seeds``: int32 ``[S]``, -1 for padding slots (they keep their local
    id so the head still reads ``x[:S]``, but have degree 0 and masked
    features).

    ``dedup=False`` selects the MULTISET (node-wise sampling tree) mode:
    every draw gets its own node slot, so there is no relabel table, no
    known-check gather, and no dedup sort — the cheapest possible
    sampling program at the same static budgets (the dedup buffers are
    already sized for the no-dedup worst case).  Semantics follow the
    node-wise GraphSAGE estimator: re-encountered nodes sample their
    in-neighborhoods independently per occurrence, and BatchNorm batch
    statistics weight nodes by occurrence count.  With ``fanout >=
    max_in_degree`` every occurrence keeps every in-edge, so eval-mode
    model outputs match the dedup mode exactly (tested).
    """
    if not dedup:
        return _device_sample_multiset(csr, seeds, key, fanout)
    N = csr.num_nodes
    E = csr.num_edges
    S = int(seeds.shape[0])
    fanout = tuple(int(f) for f in fanout)
    node_budget, _ = fanout_budgets(S, fanout)
    max_deg = max(csr.max_in_degree, max(fanout) if fanout else 1, 1)

    i32 = jnp.int32
    relabel = jnp.full(N, -1, i32)
    svalid = seeds >= 0
    relabel = relabel.at[jnp.where(svalid, seeds, N)].set(
        jnp.arange(S, dtype=i32), mode="drop"
    )
    all_nodes = jnp.full(node_budget, -1, i32)
    all_nodes = all_nodes.at[:S].set(jnp.where(svalid, seeds, -1))
    n_sofar = jnp.asarray(S, i32)

    frontier = jnp.where(svalid, seeds, -1)  # global ids, -1 invalid
    frontier_local = jnp.arange(S, dtype=i32)  # ascending (incl. pads)

    senders_parts, receivers_parts, weight_parts = [], [], []
    hop_blocks: list[HopBlock] = []
    for h, f in enumerate(fanout):
        key, sub = jax.random.split(key)
        Fb = int(frontier.shape[0])
        v = jnp.maximum(frontier, 0)
        fvalid = frontier >= 0
        deg = jnp.where(fvalid, csr.indptr[v + 1] - csr.indptr[v], 0)

        # uniform f-subset per node: top-f of iid uniforms over its slots
        u = jax.random.uniform(sub, (Fb, max_deg))
        pos_ok = jnp.arange(max_deg, dtype=i32)[None, :] < deg[:, None]
        scores = jnp.where(pos_ok, u, -1.0)
        vals, pos = jax.lax.top_k(scores, min(f, max_deg))
        evalid = vals >= 0.0  # [Fb, f]
        eid = jnp.minimum(csr.indptr[v][:, None] + pos, E - 1)
        if csr.sender_weight is not None:
            # one 8-byte random-access pass instead of two 4-byte ones
            sw = csr.sender_weight[eid]  # [Fb, f, 2]
            snd = sw[..., 0]
            w_raw = jax.lax.bitcast_convert_type(sw[..., 1], jnp.float32)
        else:
            snd = csr.senders[eid]  # [Fb, f] global sender ids
            w_raw = csr.edge_weight[eid]
        w = jnp.where(evalid, w_raw, 0.0)

        # receivers: this frontier's locals, broadcast per draw slot
        rloc = jnp.broadcast_to(
            frontier_local[:, None], evalid.shape
        ).reshape(-1)
        evalid_flat = evalid.reshape(-1)
        cand = jnp.where(evalid_flat, snd.reshape(-1), N)  # N = sentinel
        L = int(cand.shape[0])

        # within-hop dedup + new-node discovery (ascending global id).
        # The pairs sort carries the source position along, so fresh
        # locals scatter straight back to their edge slots — no second
        # relabel-table gather, and no table scatter at all on the LAST
        # hop (nothing reads the table after it).
        r_known = relabel[jnp.minimum(cand, N - 1)]
        known = jnp.where(cand < N, r_known >= 0, True)
        fresh_sorted, order = jax.lax.sort(
            (jnp.where(known, N, cand), jnp.arange(L, dtype=i32)),
            num_keys=1,
        )
        first = fresh_sorted < N
        first = first & jnp.concatenate(
            [jnp.ones(1, bool), fresh_sorted[1:] != fresh_sorted[:-1]]
        )
        prefix = jnp.cumsum(first.astype(i32))
        loc_new = n_sofar + prefix - 1  # same value for every duplicate
        if h + 1 < len(fanout):
            relabel = relabel.at[jnp.where(first, fresh_sorted, N)].set(
                loc_new, mode="drop"
            )
        all_nodes = all_nodes.at[
            jnp.where(first, loc_new, node_budget)
        ].set(fresh_sorted, mode="drop")
        base = n_sofar  # fill value: > every previous receiver local
        n_sofar = n_sofar + prefix[-1]

        # sender locals: known ones from the (single) table gather,
        # fresh ones via the positional scatter; invalid draws become
        # weight-0 self-edges on the receiver slot
        loc_at_pos = jnp.zeros(L, i32).at[order].set(
            jnp.where(fresh_sorted < N, loc_new, 0)
        )
        snd_loc = jnp.where(known, r_known, loc_at_pos)
        snd_final = jnp.where(evalid_flat, snd_loc, rloc)
        senders_parts.append(snd_final)
        receivers_parts.append(rloc)
        weight_parts.append(w.reshape(-1))
        hop_blocks.append(
            HopBlock(
                senders=snd_final.reshape(evalid.shape),
                weights=w,
                recv=frontier_local,
            )
        )

        # next frontier: first-occurrences, ascending; locals forward-
        # filled so the NEXT hop's receiver index stays monotone
        frontier = jnp.where(first, fresh_sorted, -1)
        ffl = jax.lax.cummax(jnp.where(first, loc_new, -1))
        frontier_local = jnp.where(
            ffl < 0, jnp.minimum(base, node_budget - 1), ffl
        )

    node_mask = all_nodes >= 0
    x = jnp.where(
        node_mask[:, None],
        csr.gather_features(jnp.clip(all_nodes, 0, N - 1)),
        0.0,
    )
    zeros_s = jnp.zeros(S, i32)
    return SampledNodeBatch(
        node_features=x,
        senders=jnp.concatenate(senders_parts)
        if senders_parts
        else jnp.zeros(0, i32),
        receivers=jnp.concatenate(receivers_parts)
        if receivers_parts
        else jnp.zeros(0, i32),
        edge_weight=jnp.concatenate(weight_parts)
        if weight_parts
        else jnp.zeros(0, jnp.float32),
        node_mask=node_mask,
        labels=zeros_s,
        label_mask=zeros_s.astype(bool),
        seed_mask=zeros_s.astype(bool),
        node_ids=all_nodes,
        num_seeds=S,
        hop_blocks=tuple(hop_blocks) if hop_blocks else None,
    )


def _device_sample_multiset(
    csr: DeviceGraphCSR,
    seeds: jnp.ndarray,
    key: jax.Array,
    fanout: Sequence[int],
) -> SampledNodeBatch:
    """No-dedup sampling: node slots are [seeds, hop-1 draws, hop-2
    draws, ...] in emission order, so every local id is ARITHMETIC —
    a draw's sender local is its own slot, its receiver local is its
    frontier row's slot.  The only random-access passes left are the
    degree lookup, the (sender, weight) fetch, and the feature gather.
    """
    N = csr.num_nodes
    E = csr.num_edges
    S = int(seeds.shape[0])
    fanout = tuple(int(f) for f in fanout)
    max_deg = max(csr.max_in_degree, max(fanout) if fanout else 1, 1)

    i32 = jnp.int32
    svalid = seeds >= 0
    frontier = jnp.where(svalid, seeds, -1)  # global ids, -1 invalid
    frontier_start = 0  # local id of the frontier's first slot
    offset = S  # next unassigned local slot

    all_nodes_parts = [frontier]
    senders_parts, receivers_parts, weight_parts = [], [], []
    hop_blocks: list[HopBlock] = []
    for f in fanout:
        key, sub = jax.random.split(key)
        Fb = int(frontier.shape[0])
        v = jnp.maximum(frontier, 0)
        fvalid = frontier >= 0
        deg = jnp.where(fvalid, csr.indptr[v + 1] - csr.indptr[v], 0)

        u = jax.random.uniform(sub, (Fb, max_deg))
        pos_ok = jnp.arange(max_deg, dtype=i32)[None, :] < deg[:, None]
        scores = jnp.where(pos_ok, u, -1.0)
        vals, pos = jax.lax.top_k(scores, min(f, max_deg))
        evalid = vals >= 0.0  # [Fb, f]
        eid = jnp.minimum(csr.indptr[v][:, None] + pos, E - 1)
        if csr.sender_weight is not None:
            sw = csr.sender_weight[eid]
            snd = sw[..., 0]
            w_raw = jax.lax.bitcast_convert_type(sw[..., 1], jnp.float32)
        else:
            snd = csr.senders[eid]
            w_raw = csr.edge_weight[eid]
        w = jnp.where(evalid, w_raw, 0.0)

        evalid_flat = evalid.reshape(-1)
        rloc_rows = frontier_start + jnp.arange(Fb, dtype=i32)
        rloc = jnp.broadcast_to(
            rloc_rows[:, None], evalid.shape
        ).reshape(-1)
        snd_slots = offset + jnp.arange(Fb * int(evalid.shape[1]),
                                        dtype=i32)
        # invalid draws: weight-0 self-edges on the receiver slot
        snd_final = jnp.where(evalid_flat, snd_slots, rloc)
        all_nodes_parts.append(
            jnp.where(evalid_flat, snd.reshape(-1), -1)
        )
        senders_parts.append(snd_final)
        receivers_parts.append(rloc)
        weight_parts.append(w.reshape(-1))
        hop_blocks.append(
            HopBlock(
                senders=snd_final.reshape(evalid.shape),
                weights=w,
                recv=rloc_rows,
                sender_start=int(offset),
                recv_start=int(frontier_start),
            )
        )
        frontier = jnp.where(evalid_flat, snd.reshape(-1), -1)
        frontier_start = offset
        offset += Fb * int(evalid.shape[1])

    all_nodes = jnp.concatenate(all_nodes_parts)
    node_mask = all_nodes >= 0
    x = jnp.where(
        node_mask[:, None],
        csr.gather_features(jnp.clip(all_nodes, 0, N - 1)),
        0.0,
    )
    zeros_s = jnp.zeros(S, i32)
    return SampledNodeBatch(
        node_features=x,
        senders=jnp.concatenate(senders_parts)
        if senders_parts
        else jnp.zeros(0, i32),
        receivers=jnp.concatenate(receivers_parts)
        if receivers_parts
        else jnp.zeros(0, i32),
        edge_weight=jnp.concatenate(weight_parts)
        if weight_parts
        else jnp.zeros(0, jnp.float32),
        node_mask=node_mask,
        labels=zeros_s,
        label_mask=zeros_s.astype(bool),
        seed_mask=zeros_s.astype(bool),
        node_ids=all_nodes,
        num_seeds=S,
        hop_blocks=tuple(hop_blocks) if hop_blocks else None,
    )


class DeviceSeedLoader:
    """Per-step :class:`SeedBatch` producer for device-side sampling.

    Mirrors :class:`~connectome_gnn_jax.data.sampled.SampledNodeLoader`'s
    epoch semantics (epoch-pinned shuffle, per-(epoch, step) sampling
    streams that advance even when ``shuffle=False``, ``set_epoch``
    resume replay) but yields only seed payloads — the graph never
    leaves the device, so there is nothing else to produce.  Host work
    per step: one permutation slice + one ~8 KB packed buffer.

    Parameters (sharding)
    ---------------------
    num_shards
        When set, ``batch_size`` is the GLOBAL seed count per step and
        each yielded :class:`SeedBatch` is STACKED: ``packed`` is
        ``[num_shards, 3 + 2·S]`` with ``S = batch_size / num_shards``
        seeds per shard, each row carrying its own sampling key
        (streams keyed by GLOBAL shard index, exactly like
        ``SampledNodeLoader``).  The ``csr`` rides along un-stacked —
        it replicates per device, only seeds shard.  Feed these to the
        mesh-mode :class:`~connectome_gnn_jax.train.Trainer` or to
        :func:`~connectome_gnn_jax.parallel.sampled_dp.
        make_device_sampled_dp_step`.
    process_index / process_count
        Multi-process data sharding: each yielded batch stacks only this
        process's contiguous ``num_shards / process_count`` rows; all
        processes agree on the global batch without coordination (lift
        with :func:`~connectome_gnn_jax.parallel.distributed.
        assemble_global` — the Trainer does this automatically).
    """

    def __init__(
        self,
        seed_pool,
        node_labels: Optional[np.ndarray] = None,
        *,
        batch_size: int = 512,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        csr: Optional[DeviceGraphCSR] = None,
        num_shards: Optional[int] = None,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
    ):
        self.csr = csr
        self.seeds = np.asarray(seed_pool, np.int64)
        self.node_labels = (
            np.asarray(node_labels, np.int32)
            if node_labels is not None
            else None
        )
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.drop_last = bool(drop_last)
        self._epoch = 0

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

    def __len__(self) -> int:
        n = len(self.seeds)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def __iter__(self):
        from connectome_gnn_jax.data.sampled import _sample_seed

        seeds = self.seeds
        epoch = self._epoch
        self._epoch += 1
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch)
            seeds = seeds[rng.permutation(len(seeds))]
        for b, start in enumerate(range(0, len(seeds), self.batch_size)):
            chunk = seeds[start : start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            if self.num_shards is None:
                yield make_seed_batch(
                    chunk,
                    self.node_labels,
                    _sample_seed(self.seed, epoch, b),
                    self.batch_size,
                    csr=self.csr,
                )
            else:
                ss = self._shard_size
                rows = np.stack([
                    _pack_seed_row(
                        chunk[s * ss : (s + 1) * ss],
                        self.node_labels,
                        _sample_seed(self.seed, epoch, b, s),
                        ss,
                    )
                    for s in range(self._shard_lo, self._shard_hi)
                ])
                yield SeedBatch(
                    packed=jnp.asarray(rows),
                    csr=self.csr,
                    num_seeds=ss,
                    labeled=self.node_labels is not None,
                )


class DeviceSampledModel:
    """Wrap a node model so ``apply`` takes a :class:`SeedBatch` and
    samples ON DEVICE before delegating — the whole step (sampling +
    forward/backward) fuses into the Trainer's one jitted program.

    The CSR arrays are jax Arrays captured by closure: JAX passes them to
    the executable as constants (no re-upload, no recompile per step).
    """

    def __init__(
        self, csr: DeviceGraphCSR, inner, fanout: Sequence[int],
        *, dedup: bool = True,
    ):
        self.csr = csr
        self.inner = inner
        self.fanout = tuple(int(f) for f in fanout)
        self.dedup = bool(dedup)
        if not self.dedup and not getattr(inner, "multiset_safe", False):
            # Multiset (dedup=False) sampling gives every draw its own
            # node slot; sender-degree normalization (GCN-style)
            # silently changes the estimator under duplicated sender
            # slots.  SAGE's receiver-side weighted mean is invariant
            # (see device_sampled_sage) — allowlist on the
            # multiset_safe marker, not a class blocklist.
            raise ValueError(
                "dedup=False (multiset sampling) is only valid for "
                "SAGE-family inners declaring multiset_safe = True: "
                "sender-degree normalization changes meaning under "
                "duplicated sender slots"
            )

    def init(self, key: jax.Array):
        return self.inner.init(key)

    def make_loader(self, seed_pool, node_labels=None, **kw) -> "DeviceSeedLoader":
        """A :class:`DeviceSeedLoader` whose batches carry this model's
        CSR as jit arguments (required at giant scale — see
        :class:`SeedBatch`)."""
        return DeviceSeedLoader(seed_pool, node_labels, csr=self.csr, **kw)

    def apply(
        self,
        params: dict,
        state: dict,
        batch: SeedBatch,
        *,
        train: bool = False,
        rng: Optional[jax.Array] = None,
        axis_name: Optional[str] = None,
    ):
        # prefer the batch-carried CSR (a jit ARGUMENT) over the closure
        # copy: closure constants are serialized into the remote-compile
        # request on this runtime and blow its size limit at giant scale
        csr = batch.csr if batch.csr is not None else self.csr
        key = jax.random.wrap_key_data(batch.key_data)
        sampled = device_sample(
            csr, batch.seeds, key, self.fanout, dedup=self.dedup
        )
        sampled = SampledNodeBatch(
            node_features=sampled.node_features,
            senders=sampled.senders,
            receivers=sampled.receivers,
            edge_weight=sampled.edge_weight,
            node_mask=sampled.node_mask,
            labels=batch.labels,
            label_mask=batch.label_mask,
            seed_mask=batch.seed_mask,
            node_ids=sampled.node_ids,
            num_seeds=sampled.num_seeds,
            hop_blocks=sampled.hop_blocks,
        )
        return self.inner.apply(
            params, state, sampled, train=train, rng=rng,
            axis_name=axis_name,
        )

    __call__ = apply


def make_epoch_runner(model: DeviceSampledModel, optimizer):
    """Whole-epoch-on-device training: ``lax.scan`` over seed chunks.

    With sampling already fused into the step, the remaining per-step
    cost on a remote runtime is the dispatch + SeedBatch transfer.  The
    epoch runner removes both: ONE ``[steps, 3+2S]`` packed buffer
    crosses the link and ONE program runs the whole epoch (sample →
    forward/backward → Adam, scanned), returning the final
    params/state/opt_state and per-step (loss, n) history.

    Step semantics replicate ``Trainer._train_step`` exactly (same rng
    split per step, same masked-CE loss), so a scanned epoch matches the
    equivalent step-by-step loop to float precision (params typically
    bitwise; BN state can differ at the last ulp from XLA's scan-body
    fusion choices) — asserted in ``tests/test_device_sampling.py``.

    Returns ``run(params, state, opt_state, rng, packed_all, csr) ->
    (params, state, opt_state, rng, losses, ns)``; build ``packed_all``
    with :func:`pack_epoch`.
    """
    import optax

    def _step(csr, params, state, opt_state, rng, packed_row, labeled):
        S = (packed_row.shape[0] - 3) // 2
        batch = SeedBatch(
            packed=packed_row, csr=csr, num_seeds=S, labeled=labeled
        )
        rng, step_key = jax.random.split(rng)

        def loss_fn(p):
            logits, new_state = model.apply(
                p, state, batch, train=True, rng=step_key
            )
            ce = optax.softmax_cross_entropy_with_integer_labels(
                logits, batch.labels
            )
            mask = batch.label_mask.astype(jnp.float32)
            n = jnp.sum(mask)
            loss = jnp.sum(ce * mask) / jnp.maximum(n, 1.0)
            return loss, (new_state, n)

        (loss, (new_state, n)), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(params)
        updates, new_opt_state = optimizer.update(grads, opt_state, params)
        new_params = optax.apply_updates(params, updates)
        return new_params, new_state, new_opt_state, rng, loss, n

    from functools import partial as _partial

    @_partial(jax.jit, static_argnames=("labeled",))
    def run(params, state, opt_state, rng, packed_all, csr, labeled=True):
        def body(carry, row):
            p, s, o, r = carry
            p, s, o, r, loss, n = _step(csr, p, s, o, r, row, labeled)
            return (p, s, o, r), (loss, n)

        (params, state, opt_state, rng), (losses, ns) = jax.lax.scan(
            body, (params, state, opt_state, rng), packed_all
        )
        return params, state, opt_state, rng, losses, ns

    return run


def pack_epoch(loader: DeviceSeedLoader) -> jnp.ndarray:
    """One epoch of a :class:`DeviceSeedLoader` as a single
    ``[steps, 3+2S]`` int32 buffer — host numpy all the way, ONE
    transfer (advances the loader's epoch, like iterating it)."""
    from connectome_gnn_jax.data.sampled import _sample_seed

    seeds = loader.seeds
    epoch = loader._epoch
    loader._epoch += 1
    if loader.shuffle:
        rng = np.random.default_rng(loader.seed + epoch)
        seeds = seeds[rng.permutation(len(seeds))]
    rows = []
    for b, start in enumerate(range(0, len(seeds), loader.batch_size)):
        chunk = seeds[start : start + loader.batch_size]
        if loader.drop_last and len(chunk) < loader.batch_size:
            break
        rows.append(
            _pack_seed_row(
                chunk,
                loader.node_labels,
                _sample_seed(loader.seed, epoch, b),
                loader.batch_size,
            )
        )
    return jnp.asarray(np.stack(rows))


def pack_epoch_sharded(loader: DeviceSeedLoader) -> np.ndarray:
    """One epoch of a SHARDED :class:`DeviceSeedLoader` as a single
    ``[steps, D_local, 3+2S]`` int32 buffer — the rows the loader's
    sharded iterator would yield step by step, stacked (advances the
    loader's epoch).  Feed to :func:`~connectome_gnn_jax.parallel.
    sampled_dp.make_device_sampled_dp_epoch_runner` (lifted to the
    global ``[steps, D, 3+2S]`` sharded array in multi-process runs)."""
    from connectome_gnn_jax.data.sampled import _sample_seed

    if loader.num_shards is None:
        raise ValueError(
            "pack_epoch_sharded needs a sharded DeviceSeedLoader "
            "(num_shards=D); use pack_epoch for the single-device path"
        )
    seeds = loader.seeds
    epoch = loader._epoch
    loader._epoch += 1
    if loader.shuffle:
        rng = np.random.default_rng(loader.seed + epoch)
        seeds = seeds[rng.permutation(len(seeds))]
    ss = loader._shard_size
    rows = []
    for b, start in enumerate(range(0, len(seeds), loader.batch_size)):
        chunk = seeds[start : start + loader.batch_size]
        if loader.drop_last and len(chunk) < loader.batch_size:
            break
        rows.append(np.stack([
            _pack_seed_row(
                chunk[s * ss : (s + 1) * ss],
                loader.node_labels,
                _sample_seed(loader.seed, epoch, b, s),
                ss,
            )
            for s in range(loader._shard_lo, loader._shard_hi)
        ]))
    return np.stack(rows)


def device_sampled_gcn(
    graph: ConnectomeGraph,
    *,
    hidden_dim: int = 64,
    num_classes: int = 2,
    fanout: Sequence[int] = (10, 10),
    dropout: float = 0.0,
    feature_dtype: str = "float32",
    in_degree_cap: Optional[int] = None,
) -> DeviceSampledModel:
    """Convenience: upload ``graph`` and wrap a matching ``NodeGCN``
    (``num_layers = len(fanout)``).  ``in_degree_cap`` pre-clamps each
    node to its ``cap`` strongest in-edges (the skewed-degree
    mitigation — see :meth:`DeviceGraphCSR.from_graph`)."""
    from connectome_gnn_jax.models.node_coo import BlockedNodeGCN

    csr = DeviceGraphCSR.from_graph(
        graph, feature_dtype=feature_dtype, in_degree_cap=in_degree_cap
    )
    inner = BlockedNodeGCN(
        in_channels=int(graph.node_features.shape[1]),
        hidden_dim=hidden_dim,
        num_classes=num_classes,
        num_layers=len(tuple(fanout)),
        dropout=dropout,
    )
    return DeviceSampledModel(csr, inner, fanout)


def device_sampled_sage(
    graph: ConnectomeGraph,
    *,
    hidden_dim: int = 64,
    num_classes: int = 2,
    fanout: Sequence[int] = (10, 10),
    dropout: float = 0.0,
    dedup: bool = True,
    feature_dtype: str = "float32",
    in_degree_cap: Optional[int] = None,
) -> DeviceSampledModel:
    """Convenience: upload ``graph`` and wrap a matching ``NodeSAGE``
    through the blocked aggregation path (``num_layers = len(fanout)``).

    ``dedup=False`` selects the multiset sampling mode (see
    :func:`device_sample`) — valid for SAGE because its aggregation is a
    receiver-side weighted mean, so duplicate sender slots change
    nothing but BatchNorm occurrence weighting; GCN's sender-degree
    normalization would change meaning, so only the SAGE family offers
    it.  ``in_degree_cap`` pre-clamps each node to its ``cap``
    strongest in-edges (see :meth:`DeviceGraphCSR.from_graph`)."""
    from connectome_gnn_jax.models.node_coo import BlockedNodeSAGE

    csr = DeviceGraphCSR.from_graph(
        graph, feature_dtype=feature_dtype, in_degree_cap=in_degree_cap
    )
    inner = BlockedNodeSAGE(
        in_channels=int(graph.node_features.shape[1]),
        hidden_dim=hidden_dim,
        num_classes=num_classes,
        num_layers=len(tuple(fanout)),
        dropout=dropout,
    )
    return DeviceSampledModel(csr, inner, fanout, dedup=dedup)
