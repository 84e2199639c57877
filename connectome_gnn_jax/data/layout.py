"""Automatic layout recovery for giant sparse graphs (host side).

The irregular scatter SpMM path is bound by random-row access, paid per
edge, while the banded block-dense path streams at device-memory
bandwidth.  The design answer for irregular graphs
(docs/ARCHITECTURE.md "locality recovery") is therefore: *recover
locality whenever it exists* — reorder, split band + remainder, and pick
the layout a calibrated cost model says is fastest.  This module is that
pipeline's one entry point:

    plan  = plan_layout(senders, receivers, num_nodes)   # analyze + decide
    adj   = build_layout(plan, senders, receivers, weights, num_nodes)

``plan_layout`` evaluates, for the identity ordering, the native
Reverse-Cuthill-McKee ordering (:func:`connectome_gnn_jax.data.reorder.
reverse_cuthill_mckee`) and — when cheaper orderings leave real mass out
of band — the shortcut-robust iteratively-reweighted spectral ordering
(:func:`~connectome_gnn_jax.data.reorder.spectral_ordering`), the
modeled per-SpMM time of every candidate band width W (band HBM traffic
+ activation windows + out-of-band remainder edges at the measured
scatter latency), subject to an HBM footprint budget — and returns the
argmin as a :class:`LayoutPlan` (format ∈ {banded, hybrid, coo},
ordering, W, remainder fraction, per-candidate cost table).

The model's constants are measured on an NVIDIA H100 80GB HBM3 (power
limit 400 W) by ``benchmarks/gpu_calibration.py``: ``scatter_ns_per_edge
=0.15`` (a ``segment_sum`` SpMM at 262,144 nodes, 16 edges per node,
F=64: 0.62 ms for 4.2M edges) and ``hbm_gbps=2090`` (1 GiB read + 1 GiB
written in 1.03 ms).

Reference counterpart: the dense/degree adjacency helpers this format
family replaces (`/root/reference/connectome_gnn/graph.py:72-85`);
the reference has no giant-graph path at all (SURVEY §0).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from connectome_gnn_jax.data.batch import round_up


class LayoutPlan(NamedTuple):
    """Outcome of :func:`plan_layout`.

    ``perm`` is ``perm[new] = old`` (identity when reordering didn't
    help); ``est_us`` maps each candidate format to its modeled per-SpMM
    microseconds under the CHOSEN ordering, so callers (and benchmarks)
    can report how contested the decision was.
    """

    format: str  # "banded" | "hybrid" | "coo"
    perm: np.ndarray
    reordered: bool
    block: int
    bandwidth: int  # chosen W in blocks (0 for coo)
    remainder_frac: float  # fraction of edges outside the chosen band
    bandwidth_before: int  # node-index bandwidth, input ordering
    bandwidth_after: int  # node-index bandwidth, chosen ordering
    est_us: dict


def _band_cost_curve(
    dist_counts: np.ndarray,
    num_nodes: int,
    num_edges: int,
    *,
    block: int,
    feat: int,
    hbm_gbps: float,
    scatter_ns_per_edge: float,
    max_band_bytes: float,
    quantized: bool,
) -> tuple[np.ndarray, np.ndarray]:
    """Modeled per-SpMM seconds for every band width W (in blocks).

    ``dist_counts[d]`` is the number of edges at block distance d.
    Returns ``(cost_s[W], rem_edges[W])`` with cost ``inf`` where the
    band would not fit ``max_band_bytes``.
    """
    nb = round_up(num_nodes, block) // block
    padded = nb * block
    W = np.arange(dist_counts.shape[0], dtype=np.float64)
    in_band = np.cumsum(dist_counts).astype(np.float64)
    rem = num_edges - in_band

    band_bytes = nb * (2 * W + 1) * block * block * (1.0 if quantized else 4.0)
    x_bytes = (2 * W + 2) * padded * feat * (2.0 if quantized else 4.0)
    out_bytes = padded * feat * 4.0
    stream = (band_bytes + x_bytes + out_bytes) / (hbm_gbps * 1e9)
    cost = stream + rem * scatter_ns_per_edge * 1e-9
    cost = np.where(band_bytes <= max_band_bytes, cost, np.inf)
    return cost, rem


def _coo_cost(
    num_nodes: int, num_edges: int, *, feat: int, hbm_gbps: float,
    scatter_ns_per_edge: float,
) -> float:
    return (
        num_edges * scatter_ns_per_edge * 1e-9
        + 2.0 * num_nodes * feat * 4.0 / (hbm_gbps * 1e9)
    )


def _index_bandwidth(senders: np.ndarray, receivers: np.ndarray) -> int:
    if senders.size == 0:
        return 0
    return int(
        np.abs(senders.astype(np.int64) - receivers.astype(np.int64)).max()
    )


def plan_layout(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    *,
    weights: Optional[np.ndarray] = None,
    block: int = 256,
    feat: int = 64,
    reorder: bool = True,
    spectral: bool | str = "auto",
    quantized: bool = False,
    max_band_gb: float = 8.0,
    hbm_gbps: float = 2090.0,
    scatter_ns_per_edge: float = 0.15,
) -> LayoutPlan:
    """Choose ordering + layout for a giant graph's SpMM.

    Evaluates the cost curve over every band width for the input
    ordering and (when ``reorder``) the RCM ordering, picks the global
    argmin across {banded, hybrid, coo}, and returns the plan.
    ``quantized`` prices the int8 serving path (band ×¼, activations ×½)
    instead of f32.  ``max_band_gb`` bounds the band's HBM footprint —
    candidates that don't fit are never chosen.

    ``spectral`` controls the Fiedler-vector fallback
    (:func:`~connectome_gnn_jax.data.reorder.spectral_ordering` — the
    shortcut-robust ordering RCM is not): ``"auto"`` (default) computes
    it only when the cheaper orderings still leave >5% of edges out of
    band (it costs an eigensolve); ``True``/``False`` force/skip it.
    ``weights`` (optional) feed the spectral objective.
    """
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    num_edges = int(senders.shape[0])
    bw_before = _index_bandwidth(senders, receivers)

    def eval_ordering(perm):
        if perm is None:
            s, r = senders, receivers
        else:
            inv = np.empty_like(perm)
            inv[perm] = np.arange(num_nodes)
            s, r = inv[senders], inv[receivers]
        dist = np.abs(s // block - r // block)
        counts = np.bincount(dist) if dist.size else np.zeros(1, np.int64)
        cost_s, rem = _band_cost_curve(
            counts, num_nodes, num_edges,
            block=block, feat=feat, hbm_gbps=hbm_gbps,
            scatter_ns_per_edge=scatter_ns_per_edge,
            max_band_bytes=max_band_gb * 1e9, quantized=quantized,
        )
        w = int(np.argmin(cost_s))
        rem_frac = float(rem[w]) / max(num_edges, 1)
        return (float(cost_s[w]) * 1e6, perm, w, rem_frac, s, r)

    candidates = [eval_ordering(None)]
    if reorder and num_edges:
        from connectome_gnn_jax.data.reorder import reverse_cuthill_mckee

        candidates.append(
            eval_ordering(
                reverse_cuthill_mckee(np.stack([senders, receivers]), num_nodes)
            )
        )

    coo_us = _coo_cost(
        num_nodes, num_edges, feat=feat, hbm_gbps=hbm_gbps,
        scatter_ns_per_edge=scatter_ns_per_edge,
    ) * 1e6

    best = min(candidates, key=lambda c: c[0])
    want_spectral = spectral is True or (
        spectral == "auto" and reorder and num_edges
        and (best[3] > 0.05 or not np.isfinite(best[0]))
    )
    if want_spectral:
        from connectome_gnn_jax.data.reorder import spectral_ordering

        # every IRLS iterate is a candidate — the cost model (not the
        # eigensolver) judges which reweighting round recovered the most
        # bandable mass (over-reweighting can disconnect; see
        # spectral_ordering's docstring)
        for perm_i in spectral_ordering(
            np.stack([senders, receivers]), num_nodes, weights,
            return_iterates=True,
        ):
            cand = eval_ordering(perm_i)
            if cand[0] < best[0]:
                best = cand

    cost_us, perm, w, rem_frac, s, r = best
    if coo_us <= cost_us or not np.isfinite(cost_us):
        fmt, w, rem_frac = "coo", 0, 1.0
    elif rem_frac == 0.0:
        fmt = "banded"
    else:
        fmt = "hybrid"

    reordered = perm is not None and fmt != "coo"
    if not reordered:
        perm = np.arange(num_nodes, dtype=np.int64)
        s, r = senders, receivers
    return LayoutPlan(
        format=fmt,
        perm=perm,
        reordered=reordered,
        block=block,
        bandwidth=w,
        remainder_frac=rem_frac,
        bandwidth_before=bw_before,
        bandwidth_after=_index_bandwidth(s, r),
        est_us={
            "chosen": min(cost_us, coo_us),
            "best_band_or_hybrid": cost_us,
            "coo": coo_us,
        },
    )


def build_layout(
    plan: LayoutPlan,
    senders: np.ndarray,
    receivers: np.ndarray,
    weights: np.ndarray,
    num_nodes: int,
):
    """Materialize the planned adjacency (applying ``plan.perm``).

    Returns a :class:`~connectome_gnn_jax.ops.banded.BandedMatrix`,
    :class:`~connectome_gnn_jax.ops.banded.HybridMatrix`, or — for
    ``"coo"`` — the receiver-sorted ``(senders, receivers, weights)``
    triple ready for :func:`~connectome_gnn_jax.ops.segment.coo_spmm`.
    Node-side arrays (features/labels) must be permuted with
    ``array[plan.perm]`` to match.
    """
    from connectome_gnn_jax.ops.banded import to_banded, to_hybrid

    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    weights = np.asarray(weights, np.float32)
    if plan.reordered:
        inv = np.empty_like(plan.perm)
        inv[plan.perm] = np.arange(num_nodes)
        senders, receivers = inv[senders], inv[receivers]

    if plan.format == "banded":
        return to_banded(
            senders, receivers, weights, num_nodes,
            block=plan.block, bandwidth=plan.bandwidth,
        )
    if plan.format == "hybrid":
        return to_hybrid(
            senders, receivers, weights, num_nodes,
            block=plan.block, bandwidth=plan.bandwidth,
        )
    order = np.argsort(receivers, kind="stable")
    return (
        senders[order].astype(np.int32),
        receivers[order].astype(np.int32),
        weights[order],
    )


def auto_layout(
    graph,
    *,
    block: int = 256,
    feat: Optional[int] = None,
    reorder: bool = True,
    quantized: bool = False,
    max_band_gb: float = 8.0,
):
    """One-call locality recovery for a :class:`~connectome_gnn_jax.data.
    graph.ConnectomeGraph`: plan, reorder, build.

    Returns ``(adjacency, reordered_graph, plan)`` — ``adjacency`` as in
    :func:`build_layout`, ``reordered_graph`` with features/edges
    relabeled by the chosen permutation (the original graph when no
    reorder won).
    """
    from connectome_gnn_jax.data.reorder import apply_ordering

    senders, receivers = graph.edge_index[0], graph.edge_index[1]
    plan = plan_layout(
        senders, receivers, graph.num_nodes,
        weights=graph.edge_weight,
        block=block,
        feat=feat if feat is not None else int(graph.node_features.shape[1]),
        reorder=reorder, quantized=quantized, max_band_gb=max_band_gb,
    )
    adj = build_layout(
        plan, senders, receivers, graph.edge_weight, graph.num_nodes
    )
    g2 = apply_ordering(graph, plan.perm) if plan.reordered else graph
    return adj, g2, plan
