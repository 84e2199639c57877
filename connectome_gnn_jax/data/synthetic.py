"""Synthetic connectome generator (host-side, numpy).

Generates Watts-Strogatz small-world brain connectivity graphs with
region-level features and weak-signal binary cognitive-trait labels.  Data
generation is deliberately host-side numpy: it is I/O-shaped work that feeds
the device pipeline, and keeping it on host preserves the reference suite's
exact random stream.

Seed-for-seed reproducibility contract
--------------------------------------
This module consumes the ``numpy.random.Generator`` stream in exactly the
same order as the reference implementation (reference:
``connectome_gnn/synthetic.py:222-301``), including its per-subject seed
fanout (``synthetic.py:289-290``: master rng draws ``integers(0, 2**31)`` per
subject).  Subject *i* of a dataset generated here is therefore
feature/edge/label-identical to subject *i* of the reference on the same
seed, which is what makes per-layer activation-parity testing against the
PyTorch reference possible.

The graph topology algorithm is standard Watts-Strogatz (Watts & Strogatz,
1998): a ring lattice over ``k`` nearest neighbours followed by probability-
``beta`` rewiring.  Edge weights are Beta(2, 5) distributed (skewed low, like
fractional-anisotropy values); labels come from a noisy linear model over
graph statistics, mimicking weak brain-behaviour correlations.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from connectome_gnn_jax.data.atlas import NUM_REGIONS, REGION_NAMES
from connectome_gnn_jax.data.graph import ConnectomeGraph

__all__ = [
    "REGION_NAMES",
    "NUM_REGIONS",
    "TRAIT_NAMES",
    "generate_connectome",
    "generate_dataset",
    "generate_spatial_graph",
    "small_world_stats",
]

TRAIT_NAMES = [
    "fluid_intelligence",
    "sustained_attention",
    "working_memory",
    "processing_speed",
    "cognitive_flexibility",
]


# ---------------------------------------------------------------------------
# Topology
# ---------------------------------------------------------------------------


def _watts_strogatz_edges(
    n: int, k: int, beta: float, rng: np.random.Generator
) -> set[tuple[int, int]]:
    """Undirected Watts-Strogatz edge set, one (min, max) tuple per edge.

    RNG consumption order (the reproducibility contract, matching
    reference synthetic.py:97-130): one ``rng.random()`` per ring-lattice
    edge in set-iteration order, then ``rng.choice`` over the candidate list
    only when a rewire fires and a candidate exists.
    """
    ring: set[tuple[int, int]] = set()
    for u in range(n):
        for step in range(1, k // 2 + 1):
            v = (u + step) % n
            ring.add((min(u, v), max(u, v)))

    rewired = set(ring)
    for u, v in ring:
        if rng.random() < beta:
            rewired.discard((u, v))
            # Candidate targets: any node that is not u and not already a
            # neighbour of u in the current edge set.
            candidates = list(
                set(range(n))
                - {u}
                - {w for a, b in rewired for w in (a, b) if (a == u or b == u)}
            )
            if candidates:
                w = rng.choice(candidates)
                rewired.add((min(u, w), max(u, w)))
            else:
                rewired.add((u, v))
    return rewired


def _edges_to_coo(
    edges: set[tuple[int, int]], rng: np.random.Generator
) -> tuple[np.ndarray, np.ndarray]:
    """Bidirectional COO arrays with one shared Beta(2, 5) weight per pair."""
    src: list[int] = []
    dst: list[int] = []
    wts: list[float] = []
    for u, v in edges:
        w = float(rng.beta(2, 5))
        src += [u, v]
        dst += [v, u]
        wts += [w, w]
    edge_index = np.array([src, dst], dtype=np.int32)
    edge_weight = np.array(wts, dtype=np.float32)
    return edge_index, edge_weight


# ---------------------------------------------------------------------------
# Node features
# ---------------------------------------------------------------------------


def _build_node_features(
    n: int,
    edge_index: np.ndarray,
    edge_weight: np.ndarray,
    rng: np.random.Generator,
) -> np.ndarray:
    """5-dim node features: [deg_norm, mean_incident_weight, volume_z,
    activation, thickness_z].

    Matches the reference feature recipe (synthetic.py:150-183) including its
    draw order and float32 arithmetic.  Note: like the reference, slot 1 is
    the mean incident edge weight (a clustering proxy), despite the
    reference docstring calling it a betweenness proxy.
    """
    src = edge_index[0]

    # Weighted degree, normalised by max.
    deg = np.zeros(n, dtype=np.float32)
    np.add.at(deg, src, edge_weight)
    deg_norm = deg / (deg.max() + 1e-8)

    # Regional volume proxy (log-normal), z-scored. torch .std() is the
    # unbiased estimator, hence ddof=1 here.
    vol = rng.lognormal(mean=7.5, sigma=0.5, size=n).astype(np.float32)
    vol_norm = (vol - vol.mean()) / (vol.std(ddof=1) + 1e-8)

    # Mean resting-state activation proxy.
    activation = rng.normal(0, 1, size=n).astype(np.float32)

    # Cortical thickness proxy, clipped to a physiological range.
    thickness = rng.normal(2.5, 0.3, size=n).clip(1.5, 4.0).astype(np.float32)
    thickness_norm = (thickness - thickness.mean()) / (thickness.std(ddof=1) + 1e-8)

    # Mean incident edge weight per node.
    wsum = np.zeros(n, dtype=np.float32)
    cnt = np.zeros(n, dtype=np.float32)
    np.add.at(wsum, src, edge_weight)
    np.add.at(cnt, src, np.ones(edge_index.shape[1], dtype=np.float32))
    mean_wt = wsum / (cnt + 1e-8)

    return np.stack(
        [deg_norm, mean_wt, vol_norm, activation, thickness_norm], axis=1
    ).astype(np.float32)


# ---------------------------------------------------------------------------
# Labels
# ---------------------------------------------------------------------------


def _generate_label(
    node_features: np.ndarray,
    edge_weight: np.ndarray,
    trait_idx: int,
    rng: np.random.Generator,
) -> int:
    """Binary trait label from a noisy linear model over graph statistics.

    Trait weights are drawn from a dedicated rng seeded ``trait_idx * 1337``
    (so trait 0 uses seed 0), matching reference synthetic.py:209-210.
    """
    mean_deg = float(node_features[:, 0].mean())
    mean_wt = float(edge_weight.mean())
    mean_cluster = float(node_features[:, 1].mean())

    trait_rng = np.random.default_rng(trait_idx * 1337)
    w = trait_rng.normal(0, 1, 3)

    score = w[0] * mean_deg + w[1] * mean_wt + w[2] * mean_cluster
    score += rng.normal(0, 2.0)
    return int(score > 0)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def generate_connectome(
    num_regions: int = NUM_REGIONS,
    k: int = 8,
    beta: float = 0.15,
    trait_idx: int = 0,
    subject_id: Optional[str] = None,
    seed: Optional[int] = None,
) -> ConnectomeGraph:
    """Generate one synthetic connectome graph.

    Parameters mirror the reference API (synthetic.py:222-229):
    ``num_regions`` nodes, ring-lattice degree ``k``, rewiring probability
    ``beta``, cognitive trait index 0-4, optional subject id and seed.
    """
    rng = np.random.default_rng(seed)
    if subject_id is None:
        subject_id = f"sub-{rng.integers(10000, 99999)}"

    edges = _watts_strogatz_edges(num_regions, k, beta, rng)
    edge_index, edge_weight = _edges_to_coo(edges, rng)
    node_features = _build_node_features(num_regions, edge_index, edge_weight, rng)
    label = _generate_label(node_features, edge_weight, trait_idx, rng)

    return ConnectomeGraph(
        node_features=node_features,
        edge_index=edge_index,
        edge_weight=edge_weight,
        label=label,
        subject_id=subject_id,
    )


def generate_dataset(
    num_subjects: int = 200,
    num_regions: int = NUM_REGIONS,
    k: int = 8,
    beta: float = 0.15,
    trait_idx: int = 0,
    seed: int = 42,
) -> list[ConnectomeGraph]:
    """Generate ``num_subjects`` synthetic connectomes.

    Per-subject seeds are fanned out from the master seed exactly like the
    reference (synthetic.py:289-290): the master rng draws one
    ``integers(0, 2**31)`` seed per subject, making subject *i* reproducible
    independent of generation order.
    """
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 2**31, size=num_subjects).tolist()
    return [
        generate_connectome(
            num_regions=num_regions,
            k=k,
            beta=beta,
            trait_idx=trait_idx,
            subject_id=f"sub-{i:04d}",
            seed=int(seeds[i]),
        )
        for i in range(num_subjects)
    ]


# ---------------------------------------------------------------------------
# Diagnostics
# ---------------------------------------------------------------------------


def small_world_stats(graphs: list[ConnectomeGraph]) -> dict:
    """Mean (weighted) clustering coefficient and BFS path length.

    Matches the reference diagnostic (synthetic.py:304-339): clustering is
    ``diag(A^3) / (deg (deg - 1))`` on the dense *weighted* adjacency, and the
    characteristic path length is an unweighted BFS averaged over at most 20
    source nodes per graph.
    """
    clustering_vals: list[float] = []
    avg_path_vals: list[float] = []
    for g in graphs:
        A = np.asarray(g.adjacency_matrix())
        n = A.shape[0]

        deg = A.sum(axis=1)
        triangles = np.diagonal(A @ A @ A)
        with np.errstate(divide="ignore", invalid="ignore"):
            c = np.where(deg * (deg - 1) > 0, triangles / (deg * (deg - 1)), 0.0)
        clustering_vals.append(float(c.mean()))

        # Unweighted BFS distances from up to 20 sources.
        neighbours = [np.where(A[i] > 0)[0] for i in range(n)]
        paths: list[int] = []
        for start in range(min(20, n)):
            visited = {start}
            frontier = [(start, 0)]
            while frontier:
                node, dist = frontier.pop(0)
                for nbr in neighbours[node]:
                    if nbr not in visited:
                        visited.add(nbr)
                        paths.append(dist + 1)
                        frontier.append((int(nbr), dist + 1))
        avg_path_vals.append(float(np.mean(paths)) if paths else float("nan"))

    return {
        "mean_clustering": float(np.mean(clustering_vals)),
        "mean_avg_path_length": float(np.nanmean(avg_path_vals)),
        "num_graphs": len(graphs),
    }


def generate_spatial_graph(
    num_nodes: int,
    degree: int = 12,
    band: int = 256,
    num_features: int = 5,
    seed: int = 0,
    shortcut_frac: float = 0.0,
) -> ConnectomeGraph:
    """Synthesize a spatially-local giant graph (voxel-like locality).

    Each node receives ``degree`` edges from senders within ``±band`` index
    positions (clipped at the boundary), with Beta(2, 5) weights and
    standard-normal features — the synthetic stand-in for voxel-level
    connectomes in the giant-graph benchmarks and demos.
    ``shortcut_frac`` rewires that fraction of edges to uniform random
    senders (small-world shortcuts) for the hybrid band+remainder regime.
    """
    rng = np.random.default_rng(seed)
    num_edges = num_nodes * degree
    receivers = np.repeat(np.arange(num_nodes), degree)
    senders = np.clip(
        receivers + rng.integers(-band, band + 1, num_edges), 0, num_nodes - 1
    )
    if shortcut_frac > 0:
        far = rng.integers(0, num_nodes, num_edges)
        senders = np.where(rng.random(num_edges) < shortcut_frac, far, senders)
    return ConnectomeGraph(
        node_features=rng.standard_normal((num_nodes, num_features)).astype(
            np.float32
        ),
        edge_index=np.stack([senders, receivers]).astype(np.int32),
        edge_weight=rng.beta(2, 5, num_edges).astype(np.float32),
        subject_id=f"spatial-{num_nodes}",
    )
