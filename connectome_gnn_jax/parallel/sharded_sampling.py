"""Graph-SHARDED device-side sampling: the giant graph's adjacency and
features are node-partitioned across the mesh — no device holds the
whole graph.

`data/device_sampling.py` scales config 5 ("giant connectome with
neighbor sampling") as far as one device's HBM: the CSR replicates per
device (~0.61 GB at 1M/44M) and only seeds shard.  The north-star
sentence is about graphs that CANNOT do that.  This module is the
beyond-replication mode: nodes split into ``D`` contiguous ranges, each
device holding only its range's in-adjacency rows (packed
(sender, weight) pairs) and feature rows, and each hop of the fanout
sample resolves remote rows with mesh collectives.

Two exchange kernels, selected by ``compaction``:

* **Full-frontier broadcast** (``compaction=None`` — the oracle):
  ``all_gather`` every device's frontier, every OWNER answers every
  request slot (masked to owned), ``all_to_all`` the packed answers
  back with a per-slot owner select.  Every buffer is static and the
  result is exact, but the payload is ``D×`` the minimum — each owner
  ships answers for slots it does not own.
* **Compacted exchange** (``compaction=CompactionConfig(...)`` — the
  production kernel, round 5): requests owned by THIS device are
  answered locally with no collective at all; remote requests are
  bucketed per owner with a STATIC capacity ``C = ceil(alpha·n/D)``
  per (requester → owner) pair per round, and ``rounds`` compacted
  ``all_to_all`` exchanges carry them (ids+slot out, packed answers
  back).  Payload drops from ``Θ(D·n)`` to ``Θ(alpha·rounds·n)`` —
  counted, not modeled, in ``benchmarks/sharded_exchange.py``.
  Collectives move whole static buffers, so exact per-owner compaction
  needs the capacity bound: the scheme is EXACT (bitwise equal to the
  broadcast exchange — ``tests/test_sharded_sampling.py``) whenever no
  (requester → owner) pair carries more than ``rounds·C`` remote
  requests; beyond that, overflowing requests are dropped (they sample
  zero neighbors / zero features) and COUNTED — the per-step overflow
  counter is surfaced by ``sharded_device_sample_with_stats`` and the
  step builders, so training can assert it stays 0.  An adversarial
  frontier (every request owned by one remote shard) needs
  ``rounds = D/alpha`` for exactness — that bound, and the choice of
  semantic (masked carry-over rounds, NOT statistical drop: the
  sampler's keep-all oracle survives verbatim when overflow is 0), is
  the round-5 design decision recorded here.

Randomness is keyed ``fold_in(fold_in(hop_key, requester), slot)`` so
the draw for a given (requester, frontier slot) is identical no matter
WHICH device owns the node and WHICH exchange resolves it — this is
what makes the scheme a well-defined sampler, what the keep-all oracle
exercises, and what makes compacted == broadcast bitwise.

Owner-side draw buffers are bounded by ``max_in_degree``: the broadcast
exchange materializes ``[D, Fb, max_deg]`` uniforms per hop and the
compacted one ``[D, C, max_deg]`` — a GLOBAL static bound, so one
power-law hub node sets ``max_deg`` for the whole buffer.  At the
north-star shapes (max_deg ≈ 100) this is noise; for skewed-degree
graphs budget ``4·D·C·max_deg`` bytes per hop or pre-clamp in-degrees
at partition time: ``partition(..., in_degree_cap=K)`` /
``partition_streamed(..., in_degree_cap=K)`` keep each node's ``K``
largest-``|weight|`` in-edges (deterministic tie-break, bitwise equal
between the two builders, same rule as the replicated
``DeviceGraphCSR.from_graph(in_degree_cap=K)`` — tested).

Sampling semantics are the MULTISET mode of
:func:`~connectome_gnn_jax.data.device_sampling.device_sample`
(``dedup=False``): every draw gets its own node slot, locals are
arithmetic, so no global relabel table needs to exist anywhere — the
property that makes graph-sharded sampling collective-friendly.  With
``fanout >= max_in_degree`` every occurrence keeps every in-edge and
eval-mode model outputs must match the single-device sampler exactly
(``tests/test_sharded_sampling.py``).  SAGE-family inners only (the
multiset restriction, see ``device_sampled_sage``).

Reference counterpart: the single-device ``.to(device)`` residency model
of `/root/reference/connectome_gnn/graph.py:87-94`, generalized to
graphs that cannot fit one device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from connectome_gnn_jax.data.graph import ConnectomeGraph
from connectome_gnn_jax.data.sampled import HopBlock, SampledNodeBatch
from connectome_gnn_jax.utils.pytree import pytree_dataclass, static_field


@dataclasses.dataclass(frozen=True)
class CompactionConfig:
    """Static knobs of the compacted exchange (see module docstring).

    alpha
        Capacity factor: each (requester → owner) bucket holds
        ``C = ceil(alpha · n / D)`` requests per round (``n`` = the
        hop's frontier size or the feature stage's node budget) —
        ``alpha`` is relative to the uniform-ownership expectation
        ``n/D``.  Locally-answered requests consume NO capacity, so for
        locality-rich partitions the buckets carry only the (small)
        remote tail.
    rounds
        Masked carry-over rounds.  Exact up to ``rounds·C`` remote
        requests per (requester → owner) pair; beyond that requests
        drop (and count).  Payload scales linearly in ``rounds`` —
        buckets ship padded whether full or empty.
    dedup_features
        Request each remote node id ONCE in the feature stage and
        broadcast the answered row to its duplicate slots (multiset
        sampling re-draws hot nodes, so duplicates concentrate
        per-owner load) — capacity then bounds UNIQUE remote ids per
        (requester → owner) pair, making tight ``alpha`` settings
        exact where the slot-wise schedule would overflow.  Values are
        identical either way (feature answers depend only on the id);
        the per-hop DRAW requests can never dedup — their randomness
        is keyed per (requester, slot).
    alpha_features / rounds_features
        Per-stage overrides for the FEATURE exchange (``None`` = use
        ``alpha`` / ``rounds``).  The two stages have opposite
        economics: the feature stage carries nearly all the payload
        (``C_f·(8 + 4F)`` vs the hop stages' ``C·(8 + 8f)`` at the
        exchange-projection shape: 105 of 108.5 MB at the α=2/R=2 default)
        but dedups, so tight capacities stay exact, while the DRAW
        stages are cheap but can never dedup and absorb the per-slot
        skew.  Splitting them — generous draw α, tight feature α —
        keeps exactness at near-minimal payload; :func:`plan_compaction`
        measures the actual loads and picks both.
    """

    alpha: float = 2.0
    rounds: int = 2
    dedup_features: bool = True
    alpha_features: Optional[float] = None
    rounds_features: Optional[int] = None

    @property
    def feature_rounds(self) -> int:
        return self.rounds if self.rounds_features is None else int(
            self.rounds_features
        )

    def capacity(self, n: int, D: int) -> int:
        return max(1, -(-int(round(self.alpha * n)) // D))

    def feature_capacity(self, n: int, D: int) -> int:
        a = self.alpha if self.alpha_features is None else self.alpha_features
        return max(1, -(-int(round(a * n)) // D))


@pytree_dataclass
class ShardedGraphCSR:
    """Node-partitioned CSR: leaves carry a leading ``[D]`` shard axis
    (place with ``P(axis_name)`` / iterate per process).  Shard ``d``
    owns global nodes ``[d·P, (d+1)·P)`` (``P = nodes_per_shard``;
    the id space is padded to ``D·P`` — padded nodes have degree 0 and
    zero features).

    ``indptr[d]`` indexes shard-local edge storage; ``sender_weight[d]``
    is the packed (global sender id, bitcast f32 weight) rows of the
    shard's in-edges, padded to the max shard edge count so the pytree
    is rectangular (static shapes).
    """

    indptr: jnp.ndarray  # int32 [D, P+1]
    sender_weight: jnp.ndarray  # int32 [D, E_max, 2]
    node_features: jnp.ndarray  # float32 [D, P, F]
    nodes_per_shard: int = static_field(default=0)
    max_in_degree: int = static_field(default=0)
    num_nodes: int = static_field(default=0)

    @property
    def num_shards(self) -> int:
        return int(self.indptr.shape[0])

    @classmethod
    def partition(
        cls, graph: ConnectomeGraph, num_shards: int,
        *, in_degree_cap: Optional[int] = None,
    ) -> "ShardedGraphCSR":
        """Host-side one-time partition (receiver sort per shard).

        Materializes ALL ``D`` shards in this process's memory — fine
        when the graph fits the host.  For graphs that don't (the scale
        this mode exists for), use :func:`partition_streamed`, which
        builds only a chosen shard range from a chunked COO stream.

        ``in_degree_cap`` keeps only each node's ``cap``
        largest-``|weight|`` in-edges (:func:`~connectome_gnn_jax.data.
        device_sampling.cap_in_degree_mask`), bounding
        ``max_in_degree`` and with it the owner-side draw buffers'
        ``4·D·C·max_deg`` bytes/hop — the skewed-degree (power-law
        hub) mitigation the module docstring budgets.
        """
        D = int(num_shards)
        N = graph.num_nodes
        P = -(-N // D)
        F = graph.num_features

        src, dst = graph.edge_index
        w_all = graph.edge_weight
        if in_degree_cap is not None:
            from connectome_gnn_jax.data.device_sampling import (
                cap_in_degree_mask,
            )

            keep = cap_in_degree_mask(dst, w_all, in_degree_cap)
            src, dst, w_all = src[keep], dst[keep], w_all[keep]
        order = np.argsort(dst, kind="stable")
        src = src[order].astype(np.int64)
        dst = dst[order].astype(np.int64)
        w = w_all[order].astype(np.float32)

        counts = np.bincount(dst, minlength=D * P)
        max_deg = int(counts.max()) if counts.size else 0
        # shard edge ranges (dst sorted → contiguous per shard)
        starts = np.searchsorted(dst, np.arange(D) * P)
        ends = np.searchsorted(dst, (np.arange(D) + 1) * P)
        e_max = int((ends - starts).max()) if D else 0

        indptr = np.zeros((D, P + 1), np.int32)
        sw = np.zeros((D, max(e_max, 1), 2), np.int32)
        feats = np.zeros((D, P, F), np.float32)
        for d in range(D):
            lo, hi = starts[d], ends[d]
            c = counts[d * P : (d + 1) * P]
            np.cumsum(c, out=indptr[d, 1:])
            sw[d, : hi - lo, 0] = src[lo:hi]
            sw[d, : hi - lo, 1] = w[lo:hi].view(np.int32)
            n_here = min(P, N - d * P)
            if n_here > 0:
                feats[d, :n_here] = graph.node_features[
                    d * P : d * P + n_here
                ]
        return cls(
            indptr=jnp.asarray(indptr),
            sender_weight=jnp.asarray(sw),
            node_features=jnp.asarray(feats),
            nodes_per_shard=P,
            max_in_degree=max_deg,
            num_nodes=N,
        )

    @classmethod
    def partition_streamed(
        cls,
        edge_chunks,
        node_features,
        num_nodes: int,
        num_shards: int,
        *,
        shard_range: Optional[tuple] = None,
        in_degree_cap: Optional[int] = None,
    ) -> "ShardedGraphCSR":
        """Per-shard partition from a CHUNKED COO stream — the process
        materializes only its own shard range, never the whole graph
        (the ``INGEST_r02`` discipline applied to the sharded sampler:
        at the scale this mode exists for, the graph does not fit one
        host either).

        ``in_degree_cap`` applies :meth:`partition`'s top-``|weight|``
        clamp STREAMED: hub nodes (degree > cap) get a per-node
        threshold (the cap-th largest ``|w|``, collected in one extra
        stream replay over hub edges only — ``O(Σ hub degrees)`` host
        memory, small for the power-law case this exists for) and a
        tie budget, so pass 2 keeps exactly the edges the in-memory
        rule keeps — output stays BITWISE equal to
        ``partition(graph, D, in_degree_cap=cap)``.

        Parameters
        ----------
        edge_chunks
            Zero-arg callable returning a fresh iterator of
            ``(src, dst, weight)`` numpy chunks (the stream is replayed
            twice: pass 1 counts global in-degrees — an ``O(N)`` host
            array, tiny next to the edges — pass 2 routes owned edges
            into their slabs).  Chunk order must be stable between
            replays: within a destination node, edges land in stream
            order, exactly like :meth:`partition`'s stable receiver
            sort — output is BITWISE equal to it.
        node_features
            Either the full ``[N, F]`` array or a callable
            ``(lo, hi) -> [hi-lo, F]`` block reader (the streamed
            story: only owned rows are ever produced).
        shard_range
            ``(lo, hi)`` shard slice to materialize (default: all).
            The returned leaves carry ``hi-lo`` leading rows; lift to a
            global array with :func:`~connectome_gnn_jax.parallel.
            distributed.assemble_global` in multi-process runs.  Static
            fields (``nodes_per_shard``, ``max_in_degree``) stay GLOBAL
            so every process compiles the same program.
        """
        D = int(num_shards)
        N = int(num_nodes)
        P = -(-N // D)
        lo_s, hi_s = shard_range if shard_range is not None else (0, D)
        if not (0 <= lo_s < hi_s <= D):
            raise ValueError(f"bad shard_range {(lo_s, hi_s)} for D={D}")
        nloc = hi_s - lo_s

        # pass 1: global in-degree counts (O(N) host memory)
        counts = np.zeros(D * P, np.int64)
        for src, dst, w in edge_chunks():
            counts += np.bincount(
                np.asarray(dst, np.int64), minlength=D * P
            )

        # pass 1.5 (cap only): per-hub |w| threshold + tie budget
        cap_state = None
        if in_degree_cap is not None:
            cap = int(in_degree_cap)
            if cap < 1:
                raise ValueError(
                    f"in_degree_cap must be >= 1, got {cap}"
                )
            hub = counts > cap
            if hub.any():
                hub_nodes = np.flatnonzero(hub)
                hub_idx = np.full(D * P, -1, np.int64)
                hub_idx[hub_nodes] = np.arange(len(hub_nodes))
                hoff = np.zeros(len(hub_nodes) + 1, np.int64)
                np.cumsum(counts[hub_nodes], out=hoff[1:])
                hvals = np.empty(hoff[-1], np.float32)
                hcur = np.zeros(len(hub_nodes), np.int64)
                for src, dst, w in edge_chunks():
                    dst = np.asarray(dst, np.int64)
                    aw = np.abs(np.asarray(w, np.float32))
                    m = hub[np.clip(dst, 0, D * P - 1)] & (dst < D * P)
                    if not m.any():
                        continue
                    hi_ = hub_idx[dst[m]]
                    o = np.argsort(hi_, kind="stable")
                    hi_o, av_o = hi_[o], aw[m][o]
                    rank = np.arange(len(hi_o)) - np.searchsorted(
                        hi_o, hi_o
                    )
                    hvals[hoff[hi_o] + hcur[hi_o] + rank] = av_o
                    np.add.at(hcur, hi_o, 1)
                thr = np.zeros(D * P, np.float32)
                budget0 = np.zeros(D * P, np.int64)
                for h, gid in enumerate(hub_nodes):
                    vals = hvals[hoff[h] : hoff[h + 1]]
                    tv = np.partition(vals, len(vals) - cap)[
                        len(vals) - cap
                    ]  # the cap-th largest |w|
                    thr[gid] = tv
                    budget0[gid] = cap - int((vals > tv).sum())
                cap_state = (
                    hub, thr, budget0, np.zeros(D * P, np.int64),
                )
                counts = np.minimum(counts, cap)

        max_deg = int(counts.max()) if counts.size else 0
        e_max = int(counts.reshape(D, P).sum(axis=1).max()) if D else 0

        indptr = np.zeros((nloc, P + 1), np.int32)
        for i in range(nloc):
            d = lo_s + i
            indptr[i, 1:] = np.cumsum(counts[d * P : (d + 1) * P])
        sw = np.zeros((nloc, max(e_max, 1), 2), np.int32)
        cursor = np.zeros(nloc * P, np.int64)

        # pass 2: route owned edges straight into their slab positions
        node_lo, node_hi = lo_s * P, hi_s * P
        for src, dst, w in edge_chunks():
            src = np.asarray(src, np.int64)
            dst = np.asarray(dst, np.int64)
            w = np.asarray(w, np.float32)
            sel = (dst >= node_lo) & (dst < node_hi)
            if not sel.any():
                continue
            s, dloc, wv = src[sel], dst[sel] - node_lo, w[sel]
            # stable within-chunk order per destination = the stable
            # receiver sort's order
            order = np.argsort(dloc, kind="stable")
            s, dloc, wv = s[order], dloc[order], wv[order]
            if cap_state is not None:
                hub_m, thr, budget0, tie_seen = cap_state
                gid = dloc + node_lo
                ih = hub_m[gid]
                if ih.any():
                    aw = np.abs(wv)
                    keep = ~ih | (aw > thr[gid])
                    ties = ih & (aw == thr[gid])
                    if ties.any():
                        tg = gid[ties]  # ascending (dloc sorted)
                        rank_t = np.arange(len(tg)) - np.searchsorted(
                            tg, tg
                        )
                        keep[ties] = (tie_seen[tg] + rank_t) < budget0[tg]
                        np.add.at(tie_seen, tg, 1)
                    s, dloc, wv = s[keep], dloc[keep], wv[keep]
                    if len(dloc) == 0:
                        continue
            rank = np.arange(len(dloc)) - np.searchsorted(dloc, dloc)
            shard = dloc // P
            v = dloc - shard * P
            slot = indptr[shard, v] + cursor[dloc] + rank
            sw[shard, slot, 0] = s
            sw[shard, slot, 1] = wv.view(np.int32)
            np.add.at(cursor, dloc, 1)

        F = None
        feats = None
        for i in range(nloc):
            d = lo_s + i
            a, b = d * P, min((d + 1) * P, N)
            if b <= a:
                continue
            block = (
                node_features(a, b)
                if callable(node_features)
                else node_features[a:b]
            )
            block = np.asarray(block, np.float32)
            if feats is None:
                F = block.shape[1]
                feats = np.zeros((nloc, P, F), np.float32)
            feats[i, : b - a] = block
        if feats is None:
            feats = np.zeros((nloc, P, 1), np.float32)

        return cls(
            indptr=jnp.asarray(indptr),
            sender_weight=jnp.asarray(sw),
            node_features=jnp.asarray(feats),
            nodes_per_shard=P,
            max_in_degree=max_deg,
            num_nodes=N,
        )


def _exchange_select(local_answers, owner, axis_name):
    """Route owner-computed answers back to requesters and keep the
    valid block per slot.

    ``local_answers``: ``[D, L, ...]`` — what THIS device computed for
    every (requester, slot).  After ``all_to_all`` the leading axis
    indexes the OWNER that computed each block for THIS device;
    ``owner [L]`` picks the authoritative one per slot.
    """
    exchanged = jax.lax.all_to_all(
        local_answers, axis_name, split_axis=0, concat_axis=0, tiled=False
    )
    idx = owner.reshape((1, -1) + (1,) * (exchanged.ndim - 2))
    sel = jnp.take_along_axis(exchanged, idx.astype(jnp.int32), axis=0)
    return sel[0]


def _slot_uniforms(req_key: jax.Array, slots: jnp.ndarray, max_deg: int):
    """Per-request-slot uniforms ``[..., max_deg]``, keyed
    ``fold_in(req_key, slot)`` — identical however the request is
    routed (broadcast, compacted, or answered locally)."""
    flat = jnp.maximum(slots, 0).reshape(-1).astype(jnp.int32)
    u = jax.vmap(
        lambda s: jax.random.uniform(
            jax.random.fold_in(req_key, s), (max_deg,)
        )
    )(flat)
    return u.reshape(slots.shape + (max_deg,))


def _owner_answer(indptr, sw_tab, lo, P, Emax, nodes, u, f_eff):
    """Fanout draws for request ``nodes`` against THIS shard's rows.

    ``nodes``: int32 ``[...]`` global ids (-1 = no request);
    ``u``: ``[..., max_deg]`` per-slot uniforms.  Returns packed int32
    ``[..., f_eff, 2]`` (sender id, bitcast f32 weight); sender is -1
    (weight bits 0) where the node is not owned here, invalid, or has
    fewer than ``f_eff`` in-edges.
    """
    owned = (nodes >= lo) & (nodes < lo + P)
    nl = jnp.clip(nodes - lo, 0, P - 1)
    deg = jnp.where(owned, indptr[nl + 1] - indptr[nl], 0)
    pos_ok = (
        jnp.arange(u.shape[-1], dtype=jnp.int32) < deg[..., None]
    )
    scores = jnp.where(pos_ok, u, -1.0)
    vals, pos = jax.lax.top_k(scores, f_eff)
    evalid = (vals >= 0.0) & owned[..., None]
    eid = jnp.clip(indptr[nl][..., None] + pos, 0, Emax - 1)
    rows = sw_tab[eid]  # [..., f_eff, 2]
    snd = jnp.where(evalid, rows[..., 0], -1)
    wbits = jnp.where(evalid, rows[..., 1], 0)
    return jnp.stack([snd, wbits], axis=-1)


def _compact_schedule(ids, owner, eligible, D: int, C: int, R: int):
    """Assign each eligible request slot a (round, owner-bucket
    position) via ONE stable sort by owner: sorted rank within the
    owner group ``r`` maps to round ``r // C``, position ``r % C``.

    Returns ``req_ids [R, D, C]`` (global id, -1 pad),
    ``req_slot [R, D, C]`` (requester-local slot, -1 pad), and the
    overflow count (eligible slots whose rank is beyond ``R·C``)."""
    n = int(ids.shape[0])
    i32 = jnp.int32
    iota = jnp.arange(n, dtype=i32)
    okey = jnp.where(eligible, owner, D)
    sk, order = jax.lax.sort((okey, iota), num_keys=1)
    elig_sorted = sk < D
    first = elig_sorted & jnp.concatenate(
        [jnp.ones(1, bool), sk[1:] != sk[:-1]]
    )
    gstart = jax.lax.cummax(jnp.where(first, iota, -1))
    rank = iota - gstart
    rnd = rank // C
    pos = rank - rnd * C
    ok = elig_sorted & (rnd < R)
    overflow = jnp.sum((elig_sorted & (rnd >= R)).astype(i32))
    flat = jnp.where(ok, (rnd * D + sk) * C + pos, R * D * C)
    req_ids = (
        jnp.full(R * D * C, -1, i32)
        .at[flat]
        .set(ids[order], mode="drop")
        .reshape(R, D, C)
    )
    req_slot = (
        jnp.full(R * D * C, -1, i32)
        .at[flat]
        .set(order, mode="drop")
        .reshape(R, D, C)
    )
    return req_ids, req_slot, overflow


def _compact_schedule_dedup(ids, owner, eligible, D: int, C: int, R: int):
    """As :func:`_compact_schedule`, but each distinct (owner, id) pair
    is scheduled ONCE — at its first-occurrence slot — and every
    duplicate slot records where to copy the answer from.

    One stable sort by (owner, id): run firsts are the unique requests;
    their rank among the owner group's uniques gives (round, position).
    Returns ``req_ids``, ``req_slot``, ``overflow`` (UNIQUE ids beyond
    ``R·C`` for their owner), and ``dup_src [n]`` — for every slot, the
    first-occurrence slot of its id (itself for local/invalid slots):
    gather the answered buffer through it to fan answers out to
    duplicates."""
    n = int(ids.shape[0])
    i32 = jnp.int32
    iota = jnp.arange(n, dtype=i32)
    okey = jnp.where(eligible, owner, D)
    idkey = jnp.where(eligible, ids, -1)
    sk, sid, order = jax.lax.sort((okey, idkey, iota), num_keys=2)
    elig_sorted = sk < D
    new_pair = jnp.concatenate(
        [jnp.ones(1, bool), (sk[1:] != sk[:-1]) | (sid[1:] != sid[:-1])]
    )
    uniq = elig_sorted & new_pair
    grp_first = elig_sorted & jnp.concatenate(
        [jnp.ones(1, bool), sk[1:] != sk[:-1]]
    )
    u_idx = jnp.cumsum(uniq.astype(i32)) - 1  # unique ordinal per pos
    rank = u_idx - jax.lax.cummax(jnp.where(grp_first, u_idx, -1))
    rnd = rank // C
    pos = rank - rnd * C
    ok = uniq & (rnd < R)
    overflow = jnp.sum((uniq & (rnd >= R)).astype(i32))
    flat = jnp.where(ok, (rnd * D + sk) * C + pos, R * D * C)
    req_ids = (
        jnp.full(R * D * C, -1, i32)
        .at[flat]
        .set(ids[order], mode="drop")
        .reshape(R, D, C)
    )
    req_slot = (
        jnp.full(R * D * C, -1, i32)
        .at[flat]
        .set(order, mode="drop")
        .reshape(R, D, C)
    )
    # duplicate fan-out: the sorted position of each run's first is a
    # cummax over ascending iota; its ORIGINAL slot is order[pfirst]
    pfirst = jax.lax.cummax(jnp.where(uniq, iota, -1))
    src_sorted = jnp.where(
        elig_sorted, order[jnp.maximum(pfirst, 0)], order
    )
    dup_src = jnp.zeros(n, i32).at[order].set(src_sorted)
    return req_ids, req_slot, overflow, dup_src


def _compacted_rounds(
    req_ids, req_slot, answer_fn, out_buf, axis_name
):
    """Run the ``R`` compacted request/answer exchanges and scatter the
    answers back into ``out_buf [n, ...]`` at their requester slots.

    ``answer_fn(nodes [D, C], slots [D, C]) -> ans [D, C, ...]`` runs
    owner-side; after the return ``all_to_all`` the leading axis
    indexes the OWNER each bucket was sent to.
    """
    R, D, C = (int(s) for s in req_ids.shape)
    for r in range(R):
        req = jnp.stack([req_ids[r], req_slot[r]], axis=-1)  # [D, C, 2]
        recv = jax.lax.all_to_all(
            req, axis_name, split_axis=0, concat_axis=0
        )  # [D, C, 2] — axis 0 = requester mesh index
        ans = answer_fn(recv[..., 0], recv[..., 1])
        ans_back = jax.lax.all_to_all(
            ans, axis_name, split_axis=0, concat_axis=0
        )  # axis 0 = owner
        tgt = jnp.where(
            req_slot[r] >= 0, req_slot[r], out_buf.shape[0]
        ).reshape(-1)
        out_buf = out_buf.at[tgt].set(
            ans_back.reshape((D * C,) + ans_back.shape[2:]), mode="drop"
        )
    return out_buf


def sharded_device_sample(
    g: ShardedGraphCSR,
    seeds: jnp.ndarray,
    key: jax.Array,
    fanout: Sequence[int],
    *,
    axis_name: str = "data",
    compaction: Optional[CompactionConfig] = None,
) -> SampledNodeBatch:
    """Multiset fanout sample with node-partitioned graph state — call
    INSIDE ``shard_map`` (``g`` leaves are the local ``[1, ...]`` shard
    blocks; ``seeds`` are this device's ``[S]`` seed ids, -1 padding).

    Returns this device's :class:`SampledNodeBatch` (multiset layout:
    seeds first, then hop draws in emission order; ``node_ids`` carry
    GLOBAL ids).  ``compaction`` selects the compacted exchange (see
    module docstring; overflow counter discarded — use
    :func:`sharded_device_sample_with_stats` to surface it).
    """
    batch, _ = sharded_device_sample_with_stats(
        g, seeds, key, fanout, axis_name=axis_name, compaction=compaction
    )
    return batch


def sharded_device_sample_with_stats(
    g: ShardedGraphCSR,
    seeds: jnp.ndarray,
    key: jax.Array,
    fanout: Sequence[int],
    *,
    axis_name: str = "data",
    compaction: Optional[CompactionConfig] = None,
):
    """As :func:`sharded_device_sample`, returning ``(batch, overflow)``
    where ``overflow`` is this device's int32 count of request slots
    dropped by the compacted exchange's capacity bound (always 0 for
    the broadcast exchange)."""
    indptr = g.indptr[0]
    sw_tab = g.sender_weight[0]
    feats = g.node_features[0]
    P = g.nodes_per_shard
    D = jax.lax.axis_size(axis_name)
    me = jax.lax.axis_index(axis_name)
    lo = me * P
    Emax = int(sw_tab.shape[0])
    fanout = tuple(int(f) for f in fanout)
    max_deg = max(g.max_in_degree, max(fanout) if fanout else 1, 1)
    S = int(seeds.shape[0])

    i32 = jnp.int32
    svalid = seeds >= 0
    frontier = jnp.where(svalid, seeds, -1)
    frontier_start = 0
    offset = S
    overflow = jnp.zeros((), i32)

    all_nodes_parts = [frontier]
    senders_parts, receivers_parts, weight_parts = [], [], []
    hop_blocks: list[HopBlock] = []
    for f in fanout:
        key, sub = jax.random.split(key)
        Fb = int(frontier.shape[0])
        f_eff = min(f, max_deg)
        owner = jnp.clip(jnp.maximum(frontier, 0) // P, 0, D - 1)
        valid = frontier >= 0

        if compaction is None:
            # 1) broadcast every device's frontier
            frontier_all = jax.lax.all_gather(
                frontier, axis_name
            )  # [D, Fb]
            # 2) owner-side draws for EVERY request slot (masked owned)
            req_keys = jax.vmap(
                lambda r: jax.random.fold_in(sub, r)
            )(jnp.arange(D, dtype=jnp.uint32))
            slots = jnp.broadcast_to(
                jnp.arange(Fb, dtype=i32)[None], (D, Fb)
            )
            u = jax.vmap(_slot_uniforms, in_axes=(0, 0, None))(
                req_keys, slots, max_deg
            )  # [D, Fb, max_deg]
            ans = _owner_answer(
                indptr, sw_tab, lo, P, Emax, frontier_all, u, f_eff
            )  # [D, Fb, f, 2]
            # 3) route answers back; keep the authoritative owner/slot
            packed = _exchange_select(ans, owner, axis_name)  # [Fb, f, 2]
        else:
            # local requests answered with no collective at all
            local = valid & (owner == me)
            key_me = jax.random.fold_in(sub, me.astype(jnp.uint32))
            u_loc = _slot_uniforms(
                key_me, jnp.arange(Fb, dtype=i32), max_deg
            )
            ans_loc = _owner_answer(
                indptr, sw_tab, lo, P, Emax,
                jnp.where(local, frontier, -1), u_loc, f_eff,
            )  # [Fb, f, 2]
            # remote requests: per-owner buckets, R compacted rounds
            C = compaction.capacity(Fb, D)
            req_ids, req_slot, ovf = _compact_schedule(
                frontier, owner, valid & (owner != me),
                D, C, compaction.rounds,
            )
            overflow = overflow + ovf

            def edge_answer(nodes, slots):
                req_keys = jax.vmap(
                    lambda r: jax.random.fold_in(sub, r)
                )(jnp.arange(D, dtype=jnp.uint32))
                u = jax.vmap(_slot_uniforms, in_axes=(0, 0, None))(
                    req_keys, slots, max_deg
                )  # [D, C, max_deg]
                return _owner_answer(
                    indptr, sw_tab, lo, P, Emax, nodes, u, f_eff
                )

            inv = jnp.stack(
                [jnp.full((Fb, f_eff), -1, i32),
                 jnp.zeros((Fb, f_eff), i32)], axis=-1,
            )
            remote = _compacted_rounds(
                req_ids, req_slot, edge_answer, inv, axis_name
            )
            packed = jnp.where(local[:, None, None], ans_loc, remote)

        snd = packed[..., 0]  # [Fb, f]
        wv = jnp.where(
            snd >= 0,
            jax.lax.bitcast_convert_type(packed[..., 1], jnp.float32),
            0.0,
        )

        evalid_flat = (snd >= 0).reshape(-1)
        rloc_rows = frontier_start + jnp.arange(Fb, dtype=i32)
        rloc = jnp.broadcast_to(
            rloc_rows[:, None], (Fb, f_eff)
        ).reshape(-1)
        snd_slots = offset + jnp.arange(Fb * f_eff, dtype=i32)
        snd_final = jnp.where(evalid_flat, snd_slots, rloc)
        all_nodes_parts.append(
            jnp.where(evalid_flat, snd.reshape(-1), -1)
        )
        senders_parts.append(snd_final)
        receivers_parts.append(rloc)
        weight_parts.append(wv.reshape(-1))
        hop_blocks.append(
            HopBlock(
                senders=snd_final.reshape(Fb, f_eff),
                weights=wv,
                recv=rloc_rows,
                sender_start=int(offset),
                recv_start=int(frontier_start),
            )
        )
        frontier = jnp.where(evalid_flat, snd.reshape(-1), -1)
        frontier_start = offset
        offset += Fb * f_eff

    # 4) features for every node slot, resolved by owner exchange
    all_nodes = jnp.concatenate(all_nodes_parts)
    node_mask = all_nodes >= 0
    owner = jnp.clip(jnp.maximum(all_nodes, 0) // P, 0, D - 1)
    NBud = int(all_nodes.shape[0])
    F = int(feats.shape[-1])
    if compaction is None:
        ids_all = jax.lax.all_gather(all_nodes, axis_name)  # [D, NBud]
        owned = (ids_all >= lo) & (ids_all < lo + P)
        il = jnp.clip(ids_all - lo, 0, P - 1)
        x_own = jnp.where(owned[..., None], feats[il], 0.0)
        x = _exchange_select(x_own, owner, axis_name)
    else:
        local = node_mask & (owner == me)
        il = jnp.clip(all_nodes - lo, 0, P - 1)
        x_loc = jnp.where(local[:, None], feats[il], 0.0)
        C = compaction.feature_capacity(NBud, D)
        R_f = compaction.feature_rounds
        remote = node_mask & (owner != me)
        if compaction.dedup_features:
            req_ids, req_slot, ovf, dup_src = _compact_schedule_dedup(
                all_nodes, owner, remote, D, C, R_f
            )
        else:
            req_ids, req_slot, ovf = _compact_schedule(
                all_nodes, owner, remote, D, C, R_f
            )
            dup_src = None
        overflow = overflow + ovf

        def feat_answer(nodes, slots):
            del slots
            owned = (nodes >= lo) & (nodes < lo + P)
            nl = jnp.clip(nodes - lo, 0, P - 1)
            return jnp.where(owned[..., None], feats[nl], 0.0)

        x_rem = _compacted_rounds(
            req_ids, req_slot, feat_answer,
            jnp.zeros((NBud, F), feats.dtype), axis_name,
        )
        if dup_src is not None:
            x_rem = x_rem[dup_src]
        x = jnp.where(local[:, None], x_loc, x_rem)
    x = jnp.where(node_mask[:, None], x, 0.0)

    zeros_s = jnp.zeros(S, i32)
    batch = SampledNodeBatch(
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
    return batch, overflow


def _validate_sharded_args(mesh, axis_name, g, seeds):
    """Host-side shape contract for the graph-sharded step builders:
    the partition's shard count and the seed stack's leading axis must
    BOTH equal the mesh axis size — shard_map would otherwise silently
    split the ``[D, ...]`` leaves across devices, mis-routing the
    owner exchange (wrong samples, wrong gradients, no error)."""
    D = int(mesh.shape[axis_name])
    if g.num_shards != D:
        raise ValueError(
            f"ShardedGraphCSR has {g.num_shards} shards but mesh axis "
            f"'{axis_name}' has {D} devices — repartition the graph "
            f"(ShardedGraphCSR.partition(graph, {D}))"
        )
    if int(seeds.shape[0]) != D:
        raise ValueError(
            f"seeds must be stacked [D, S] with D={D} (one row per "
            f"mesh device), got shape {tuple(seeds.shape)}"
        )


def make_graph_sharded_sampled_forward(
    inner, mesh, fanout: Sequence[int], axis_name: str = "data",
    *, compaction: Optional[CompactionConfig] = None,
):
    """Jitted eval forward over the graph-sharded sampler.

    Signature: ``(params, state, g: ShardedGraphCSR, seeds [D, S],
    key_data [D, 2]) -> logits [D, S, C]`` — ``g`` sharded on its
    leading axis, seeds/keys one row per device.  The inner model must
    be SAGE-family (multiset semantics).
    """
    from functools import partial

    from jax.sharding import PartitionSpec as P

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(axis_name), P(axis_name), P(axis_name)),
        out_specs=P(axis_name),
    )
    def fwd(params, state, g, seeds, key_data):
        batch = sharded_device_sample(
            g, seeds[0], jax.random.wrap_key_data(key_data[0]),
            fanout, axis_name=axis_name, compaction=compaction,
        )
        logits, _ = inner.apply(params, state, batch, train=False)
        return logits[None]

    def fwd_checked(params, state, g, seeds, key_data):
        _validate_sharded_args(mesh, axis_name, g, seeds)
        return fwd(params, state, g, seeds, key_data)

    return fwd_checked


def make_graph_sharded_train_step(
    inner, optimizer, mesh, fanout: Sequence[int],
    axis_name: str = "data", *, guard: bool = False,
    compaction: Optional[CompactionConfig] = None,
):
    """Jitted train step over the graph-sharded sampler: sync-BN psum,
    globally-masked loss, psummed gradients (exactness rules of
    ``make_dp_train_step``).  Signature: ``(params, state, opt_state,
    step_key, g, seeds [D, S], key_data [D, 2], labels [D, S],
    label_mask [D, S]) -> (params, state, opt_state, loss, n
    [, overflow] [, ok])``.

    With ``compaction`` set, the globally-psummed int32 overflow count
    of the compacted exchange is appended (0 = the step was exact).
    ``guard=True`` appends ``make_dp_train_step``'s
    non-finite-rejection semantics (trailing ``ok`` output; rejected
    steps keep old params/state/opt bitwise on every replica).
    """
    from functools import partial

    import optax
    from jax.sharding import PartitionSpec as P

    from connectome_gnn_jax.parallel.shard_forward import apply_global_update

    n_extra = (1 if compaction is not None else 0) + (1 if guard else 0)

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(axis_name), P(axis_name),
                  P(axis_name), P(axis_name), P(axis_name)),
        out_specs=(P(), P(), P(), P(), P()) + (P(),) * n_extra,
    )
    def step(params, state, opt_state, step_key, g, seeds, key_data,
             labels, label_mask):
        batch, ovf = sharded_device_sample_with_stats(
            g, seeds[0], jax.random.wrap_key_data(key_data[0]),
            fanout, axis_name=axis_name, compaction=compaction,
        )
        batch = dataclasses.replace(
            batch, labels=labels[0], label_mask=label_mask[0]
        )
        rng = jax.random.fold_in(step_key, jax.lax.axis_index(axis_name))

        def loss_sum_fn(p):
            logits, new_state = inner.apply(
                p, state, batch, train=True, rng=rng, axis_name=axis_name
            )
            ce = optax.softmax_cross_entropy_with_integer_labels(
                logits, batch.labels
            )
            m = batch.label_mask.astype(jnp.float32)
            return jnp.sum(ce * m), (new_state, jnp.sum(m))

        (local_sum, (new_state, local_n)), grads = jax.value_and_grad(
            loss_sum_fn, has_aux=True
        )(params)
        new_params, new_opt_state, loss, n = apply_global_update(
            optimizer, axis_name, params, opt_state, local_sum, local_n,
            grads,
        )
        extras = ()
        if compaction is not None:
            extras += (jax.lax.psum(ovf, axis_name),)
        if not guard:
            return (new_params, new_state, new_opt_state, loss, n) + extras

        from connectome_gnn_jax.train import fault

        ok = fault.all_finite(loss, grads, new_state)
        trees, loss, n, ok_f = fault.guard_step_outputs(
            ok,
            (new_params, new_state, new_opt_state),
            (params, state, opt_state),
            loss, n,
        )
        return (*trees, loss, n) + extras + (ok_f,)

    def step_checked(params, state, opt_state, step_key, g, seeds,
                     key_data, labels, label_mask):
        _validate_sharded_args(mesh, axis_name, g, seeds)
        return step(params, state, opt_state, step_key, g, seeds,
                    key_data, labels, label_mask)

    return step_checked


def sharded_sampling_comm_model(
    *, D: int, S: int, fanout: Sequence[int], F: int, max_deg: int,
    compaction: Optional[CompactionConfig] = None,
) -> dict:
    """Analytic per-device per-step collective payload of the exchange,
    in bytes RECEIVED per device per step (= bytes sent: all_gather
    broadcasts its shard, all_to_all is symmetric).  Validated against
    the program-counted payload (`parallel/comm_accounting.py`) in
    ``tests/test_sharded_sampling.py``.

    Frontier sizes under multiset sampling: ``Fb_0 = S``,
    ``Fb_{h+1} = Fb_h · fanout[h]``; node budget
    ``NBud = S + Σ_h Fb_{h+1}``.

    Broadcast: per hop ``(D-1)·Fb·4`` frontier all_gather +
    ``(D-1)·Fb·f·8`` packed answers; features ``(D-1)·NBud·4`` ids +
    ``(D-1)·NBud·F·4`` rows.  Compacted (capacity ``C``, ``R`` rounds):
    per hop ``R·(D-1)·C·8`` requests + ``R·(D-1)·C·f·8`` answers;
    features ``R·(D-1)·C_f·8`` + ``R·(D-1)·C_f·F·4``.
    """
    fanout = tuple(int(f) for f in fanout)
    hop_bytes = 0
    Fb = S
    nbud = S
    for f in fanout:
        f_eff = min(f, max(max_deg, 1))
        if compaction is None:
            hop_bytes += (D - 1) * Fb * 4  # frontier all_gather
            hop_bytes += (D - 1) * Fb * f_eff * 8  # packed answers
        else:
            C = compaction.capacity(Fb, D)
            R = compaction.rounds
            hop_bytes += R * (D - 1) * C * 8  # (id, slot) requests
            hop_bytes += R * (D - 1) * C * f_eff * 8  # packed answers
        Fb *= f_eff
        nbud += Fb
    if compaction is None:
        feat_bytes = (D - 1) * nbud * 4 + (D - 1) * nbud * F * 4
    else:
        C = compaction.feature_capacity(nbud, D)
        R = compaction.feature_rounds
        feat_bytes = R * (D - 1) * C * 8 + R * (D - 1) * C * F * 4
    total = hop_bytes + feat_bytes
    return {
        "per_device_bytes_per_step": int(total),
        "hop_exchange_bytes": int(hop_bytes),
        "feature_exchange_bytes": int(feat_bytes),
        "node_budget": int(nbud),
    }


def _census_remote_load(ids, P, D, me):
    """Max over owners of this device's remote request count (slots)."""
    i32 = jnp.int32
    owner = jnp.clip(jnp.maximum(ids, 0) // P, 0, D - 1)
    rem = (ids >= 0) & (owner != me)
    cnt = jnp.zeros(D, i32).at[owner].add(rem.astype(i32))
    return jnp.max(cnt)


def _census_unique_remote_load(ids, P, D, me):
    """Max over owners of this device's UNIQUE remote id count — the
    load the dedup'd feature schedule has to carry."""
    i32 = jnp.int32
    owner = jnp.clip(jnp.maximum(ids, 0) // P, 0, D - 1)
    rem = (ids >= 0) & (owner != me)
    okey = jnp.where(rem, owner, D)
    idkey = jnp.where(rem, ids, -1)
    sk, sid = jax.lax.sort((okey, idkey), num_keys=2)
    new_pair = jnp.concatenate(
        [jnp.ones(1, bool), (sk[1:] != sk[:-1]) | (sid[1:] != sid[:-1])]
    )
    uniq = (sk < D) & new_pair
    cnt = jnp.zeros(D + 1, i32).at[sk].add(uniq.astype(i32))
    return jnp.max(cnt[:D])


def sharded_sampling_census(
    g: ShardedGraphCSR,
    seeds: jnp.ndarray,
    key: jax.Array,
    fanout: Sequence[int],
    *,
    axis_name: str = "data",
    dedup_features: bool = True,
):
    """Measure the exchange's per-stage peak bucket loads — call INSIDE
    ``shard_map`` (same contract as :func:`sharded_device_sample`).

    Runs the broadcast (exact) exchange once and counts, per stage, the
    maximum number of remote requests any (requester → owner) bucket
    would have to carry — exactly the quantity the compacted exchange's
    ``rounds·C`` must cover for bitwise exactness.  The hop stages
    count request SLOTS (draws can never dedup — their randomness is
    keyed per slot); the feature stage counts UNIQUE remote ids when
    ``dedup_features`` (the schedule :func:`_compact_schedule_dedup`
    actually carries), raw slots otherwise.

    Returns ``(draw_loads [num_hops], feature_load)`` int32, pmaxed
    over ``axis_name`` (identical on every device).  Feed to
    :func:`plan_compaction` — or use directly to validate a hand-picked
    :class:`CompactionConfig` against real frontiers.
    """
    batch, _ = sharded_device_sample_with_stats(
        g, seeds, key, fanout, axis_name=axis_name, compaction=None
    )
    P = g.nodes_per_shard
    D = jax.lax.axis_size(axis_name)
    me = jax.lax.axis_index(axis_name)
    fanout = tuple(int(f) for f in fanout)
    max_deg = max(g.max_in_degree, max(fanout) if fanout else 1, 1)
    ids = batch.node_ids
    S = int(seeds.shape[0])
    start, seg_len = 0, S
    draw_loads = []
    for f in fanout:
        seg = ids[start : start + seg_len]  # this hop's frontier
        draw_loads.append(_census_remote_load(seg, P, D, me))
        start += seg_len
        seg_len *= min(f, max_deg)
    if dedup_features:
        fl = _census_unique_remote_load(ids, P, D, me)
    else:
        fl = _census_remote_load(ids, P, D, me)
    dl = (
        jnp.stack(draw_loads)
        if draw_loads
        else jnp.zeros(0, jnp.int32)
    )
    return jax.lax.pmax(dl, axis_name), jax.lax.pmax(fl, axis_name)


def _alpha_for_capacity(C: int, n: int, D: int) -> float:
    """Smallest alpha whose ``capacity(n, D)`` is at least ``C``
    (guarding the float round-trip in the capacity formula)."""
    a = C * D / max(n, 1)
    while max(1, -(-int(round(a * n)) // D)) < C:
        a *= 1.0 + 1e-9
    return a


def plan_compaction(
    csr: ShardedGraphCSR,
    mesh,
    seeds,
    key: jax.Array,
    fanout: Sequence[int],
    *,
    axis_name: str = "data",
    safety: float = 1.25,
    rounds: int = 1,
    rounds_features: Optional[int] = None,
    dedup_features: bool = True,
    return_loads: bool = False,
) -> CompactionConfig:
    """Probe-measure the exchange's per-stage peak loads on real seed
    batches and return a :class:`CompactionConfig` that is exact on the
    observed frontiers with a ``safety`` margin, at near-minimal
    payload.

    The two stages get independent capacities (``alpha`` for the hop
    DRAW stages, ``alpha_features`` for the feature stage): the feature
    stage carries nearly all the bytes but dedups, so its capacity can
    sit tight against the measured unique-id load, while the cheap draw
    stages absorb the per-slot skew that caused tight uniform-``alpha``
    settings to overflow (the round-5 hop-stage residual).

    Parameters: ``seeds`` — int32 ``[D, S]`` or ``[steps, D, S]`` probe
    seed batches (row ``d`` = device ``d``'s seeds, -1 padded; use a
    few batches from the training seed pool); ``key`` — base PRNGKey
    (step ``t``, device ``d`` probes with ``fold_in(fold_in(key, t),
    d)``); ``rounds`` / ``rounds_features`` — round counts to plan FOR
    (capacity trades against rounds: exactness needs ``R·C ≥ load``).

    Returns the planned config (with ``return_loads=True``, a
    ``(config, {"draw_loads", "feature_load"})`` tuple).  The planned
    config is exact for the probed steps by construction; training
    still surfaces ``Trainer.last_sampling_overflow`` should a later
    frontier exceed the probed loads by more than ``safety``.

    Multi-process runs follow the framework's multi-host data
    contract: every process calls with the SAME global ``seeds`` /
    ``key`` (each lifts only its own rows internally) and a ``csr``
    it can place — either the full in-memory partition or one already
    placed with :func:`shard_csr`.  The probed loads are pmaxed over
    the whole mesh, so every process plans the identical config.
    """
    from functools import partial

    from jax.sharding import PartitionSpec as Pspec

    from connectome_gnn_jax.parallel.distributed import (
        assemble_global,
        local_shard_range,
    )

    fanout = tuple(int(f) for f in fanout)
    seeds = np.asarray(seeds, np.int32)
    if seeds.ndim == 2:
        seeds = seeds[None]
    if seeds.ndim != 3 or seeds.shape[1] != csr.num_shards:
        raise ValueError(
            "seeds must be [D, S] or [steps, D, S] with "
            f"D == num_shards ({csr.num_shards}); got {seeds.shape}"
        )
    _validate_sharded_args(mesh, axis_name, csr, seeds[0])
    D = csr.num_shards
    S = int(seeds.shape[-1])
    lo_r, hi_r = (
        local_shard_range(D) if jax.process_count() > 1 else (0, D)
    )
    gs_placed = shard_csr(csr, mesh, axis_name)

    spec = Pspec(axis_name)

    @jax.jit
    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(spec, spec, spec), out_specs=(spec, spec),
    )
    def census(gs, sd, kd):
        dl, fl = sharded_sampling_census(
            gs, sd[0], jax.random.wrap_key_data(kd[0]), fanout,
            axis_name=axis_name, dedup_features=dedup_features,
        )
        return dl[None], fl[None]

    def _local(x):  # pmaxed outputs: any addressable rows carry the max
        return np.asarray(
            x.addressable_data(0) if jax.process_count() > 1 else x
        )

    draw_max = np.zeros(len(fanout), np.int64)
    feat_max = 0
    for t in range(seeds.shape[0]):
        kt = jax.random.fold_in(key, t)
        kd = np.stack([
            np.asarray(jax.random.key_data(jax.random.fold_in(kt, d)))
            for d in range(D)
        ])
        dl, fl = census(
            gs_placed,
            assemble_global(seeds[t][lo_r:hi_r], mesh, axis_name),
            assemble_global(kd[lo_r:hi_r], mesh, axis_name),
        )
        dl, fl = _local(dl), _local(fl)
        assert dl.ndim == 2  # [D_local, H] rows, all pmaxed-identical
        draw_max = np.maximum(draw_max, np.max(dl, axis=0))
        feat_max = max(feat_max, int(np.max(fl)))

    R = max(1, int(rounds))
    R_f = R if rounds_features is None else max(1, int(rounds_features))
    max_deg = max(csr.max_in_degree, max(fanout) if fanout else 1, 1)
    Fb, nbud, alpha = S, S, 0.0
    for h, f in enumerate(fanout):
        C_h = max(1, int(np.ceil(safety * float(draw_max[h]) / R)))
        alpha = max(alpha, _alpha_for_capacity(C_h, Fb, D))
        Fb *= min(f, max_deg)
        nbud += Fb
    C_f = max(1, int(np.ceil(safety * float(feat_max) / R_f)))
    alpha_f = _alpha_for_capacity(C_f, nbud, D)
    cfg = CompactionConfig(
        alpha=max(alpha, 1e-6), rounds=R,
        dedup_features=dedup_features,
        alpha_features=alpha_f, rounds_features=R_f,
    )
    if return_loads:
        return cfg, {
            "draw_loads": draw_max.astype(int).tolist(),
            "feature_load": int(feat_max),
        }
    return cfg


def shard_csr(
    g: ShardedGraphCSR, mesh, axis_name: str = "data"
) -> ShardedGraphCSR:
    """Place a :class:`ShardedGraphCSR`'s ``[D, ...]`` leaves with shard
    ``d`` on mesh position ``d`` (one-time cost, like
    :func:`~connectome_gnn_jax.parallel.sampled_dp.replicate_csr` but
    sharded, not replicated).  Uses ``make_array_from_callback`` so each
    process materializes only its addressable rows in multi-process runs
    (the host-side partition is cheap numpy; the device transfer is the
    cost that matters and it is per-shard)."""
    from jax.sharding import NamedSharding, PartitionSpec

    def put(x):
        sh = NamedSharding(
            mesh, PartitionSpec(axis_name, *([None] * (x.ndim - 1)))
        )
        if getattr(x, "sharding", None) == sh:
            return x
        xn = np.asarray(x)
        return jax.make_array_from_callback(
            xn.shape, sh, lambda idx: xn[idx]
        )

    return jax.tree_util.tree_map(put, g)


def make_graph_sharded_eval_step(
    inner, mesh, fanout: Sequence[int], axis_name: str = "data",
    *, compaction: Optional[CompactionConfig] = None,
):
    """Jitted graph-sharded eval step returning global ``(loss_sum,
    correct, n_real)`` — the :meth:`Trainer.evaluate` contract, psummed
    across shards.  Signature: ``(params, state, g, seeds [D, S],
    key_data [D, 2], labels [D, S], label_mask [D, S])``."""
    from functools import partial

    import optax
    from jax.sharding import PartitionSpec as P

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(axis_name), P(axis_name), P(axis_name),
                  P(axis_name), P(axis_name)),
        out_specs=(P(), P(), P()),
    )
    def ev(params, state, g, seeds, key_data, labels, label_mask):
        batch = sharded_device_sample(
            g, seeds[0], jax.random.wrap_key_data(key_data[0]),
            fanout, axis_name=axis_name, compaction=compaction,
        )
        batch = dataclasses.replace(
            batch, labels=labels[0], label_mask=label_mask[0]
        )
        logits, _ = inner.apply(params, state, batch, train=False)
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits, batch.labels
        )
        m = batch.label_mask.astype(jnp.float32)
        correct = jnp.sum(
            (jnp.argmax(logits, axis=1) == batch.labels).astype(jnp.int32)
            * batch.label_mask
        )
        return (
            jax.lax.psum(jnp.sum(ce * m), axis_name),
            jax.lax.psum(correct, axis_name),
            jax.lax.psum(jnp.sum(m), axis_name),
        )

    def ev_checked(params, state, g, seeds, key_data, labels, label_mask):
        _validate_sharded_args(mesh, axis_name, g, seeds)
        return ev(params, state, g, seeds, key_data, labels, label_mask)

    return ev_checked


class GraphShardedSampledModel:
    """Product-API wrapper for beyond-replication training: the
    :class:`~connectome_gnn_jax.train.Trainer` in mesh mode drives
    graph-sharded sampled training/eval exactly like the replicated
    device-sampled path — same sharded :class:`~connectome_gnn_jax.data.
    device_sampling.DeviceSeedLoader`, same fit/evaluate surface — but
    no device ever holds the whole graph.

    ``compaction`` (default a :class:`CompactionConfig`) selects the
    compacted exchange; pass ``None`` to force the full-frontier
    broadcast oracle, or :func:`plan_compaction`'s probe-measured
    config for exact-with-margin capacities at near-minimal payload.
    The Trainer surfaces the exchange's overflow counter as
    ``trainer.last_sampling_overflow``.

    SAGE-family inners only (the sharded sampler is the multiset mode;
    see module docstring).  Build via :func:`graph_sharded_sage`.
    """

    def __init__(
        self, csr: ShardedGraphCSR, inner, fanout: Sequence[int],
        *, compaction: Optional[CompactionConfig] = CompactionConfig(),
    ):
        if not getattr(inner, "multiset_safe", False):
            raise ValueError(
                "graph-sharded sampling is multiset-mode: SAGE-family "
                "inners only (sender-degree normalization — GCN-style — "
                "changes meaning under duplicated sender slots; inners "
                "must declare multiset_safe = True)"
            )
        self.csr = csr
        self.inner = inner
        self.fanout = tuple(int(f) for f in fanout)
        self.compaction = compaction

    def init(self, key):
        return self.inner.init(key)

    def make_loader(self, seed_pool, node_labels=None, **kw):
        """A sharded :class:`DeviceSeedLoader` (``num_shards`` defaults
        to the partition's shard count; batches carry NO DeviceGraphCSR
        — the graph rides as the sharded step's explicit argument)."""
        from connectome_gnn_jax.data.device_sampling import DeviceSeedLoader

        kw.setdefault("num_shards", self.csr.num_shards)
        return DeviceSeedLoader(seed_pool, node_labels, **kw)

    def plan_compaction(self, mesh, seeds, key=None, *,
                        placed_csr=None, **kw):
        """Probe-measure and ADOPT exchange capacities for this model:
        runs :func:`plan_compaction` on the model's partition/fanout
        and sets the result on ``self.compaction``.  Returns the
        planned config (or ``(config, loads)`` with
        ``return_loads=True``).  The Trainer's cached steps key on the
        config, so re-planning mid-run takes effect on the next step.

        ``placed_csr``: an already-placed partition (``shard_csr``'s
        output — e.g. the Trainer's cached placement) to probe
        against; without it the host partition is placed afresh, which
        at giant-graph scale is a second full host→device transfer.
        """
        if key is None:
            key = jax.random.PRNGKey(0)
        out = plan_compaction(
            placed_csr if placed_csr is not None else self.csr,
            mesh, seeds, key, self.fanout, **kw
        )
        self.compaction = out[0] if isinstance(out, tuple) else out
        return out


def graph_sharded_sage(
    graph: ConnectomeGraph,
    num_shards: int,
    *,
    hidden_dim: int = 64,
    num_classes: int = 2,
    num_layers: int = 2,
    fanout: Sequence[int] = (10, 10),
    compaction: Optional[CompactionConfig] = CompactionConfig(),
    in_degree_cap: Optional[int] = None,
) -> GraphShardedSampledModel:
    """Partition ``graph`` into ``num_shards`` node ranges and wrap a
    :class:`~connectome_gnn_jax.models.node_coo.BlockedNodeSAGE` for
    Trainer-driven graph-sharded sampled training.

    ``in_degree_cap`` pre-clamps each node to its ``cap``
    largest-``|weight|`` in-edges (the skewed-degree mitigation — see
    :meth:`ShardedGraphCSR.partition`)."""
    from connectome_gnn_jax.models.node_coo import BlockedNodeSAGE

    csr = ShardedGraphCSR.partition(
        graph, num_shards, in_degree_cap=in_degree_cap
    )
    inner = BlockedNodeSAGE(
        in_channels=graph.num_features,
        hidden_dim=hidden_dim,
        num_classes=num_classes,
        num_layers=num_layers,
    )
    return GraphShardedSampledModel(csr, inner, fanout, compaction=compaction)
