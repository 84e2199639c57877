"""Graph reordering for bandwidth reduction (host side).

The banded block-dense SpMM path (:mod:`connectome_gnn_jax.ops.banded`)
needs node orderings where edges connect nearby indices.  Spatially
embedded graphs (voxel connectomes) often have this natively; for others,
the classic Reverse-Cuthill-McKee ordering (BFS from a peripheral
low-degree node, neighbors visited degree-ascending, order reversed)
reduces matrix bandwidth well at O(N + E) cost.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from connectome_gnn_jax.data.graph import ConnectomeGraph


def reverse_cuthill_mckee(
    edge_index: np.ndarray, num_nodes: int
) -> np.ndarray:
    """RCM permutation: ``perm[new_index] = old_index``.

    Handles disconnected graphs (each component seeded from its
    minimum-degree unvisited node) and isolated nodes.
    """
    # BFS over the symmetrized adjacency (edge direction is irrelevant to
    # bandwidth; the input may store only one direction).
    src = np.concatenate([edge_index[0], edge_index[1]]).astype(np.int64)
    dst = np.concatenate([edge_index[1], edge_index[0]]).astype(np.int64)
    order = np.argsort(dst, kind="stable")
    src_sorted = src[order]
    starts = np.searchsorted(dst[order], np.arange(num_nodes))
    ends = np.searchsorted(dst[order], np.arange(num_nodes), side="right")
    degree = ends - starts

    from connectome_gnn_jax import native

    if native.AVAILABLE:
        # dst_sorted is sorted → ends[i] == starts[i+1]: CSR indptr directly
        indptr = np.concatenate([starts, [src_sorted.shape[0]]]).astype(np.int64)
        return native.rcm(indptr, src_sorted, degree.astype(np.int64))

    return _rcm_numpy(num_nodes, src_sorted, starts, ends, degree)


def _rcm_numpy(
    num_nodes: int,
    src_sorted: np.ndarray,
    starts: np.ndarray,
    ends: np.ndarray,
    degree: np.ndarray,
) -> np.ndarray:
    """Pure-numpy RCM BFS — fallback and the native kernel's oracle."""
    visited = np.zeros(num_nodes, bool)
    result: list[int] = []
    by_degree = np.argsort(degree, kind="stable")

    for seed in by_degree:
        if visited[seed]:
            continue
        visited[seed] = True
        queue = deque([int(seed)])
        while queue:
            node = queue.popleft()
            result.append(node)
            nbrs = src_sorted[starts[node] : ends[node]]
            nbrs = np.unique(nbrs)
            nbrs = nbrs[~visited[nbrs]]
            visited[nbrs] = True
            for nbr in nbrs[np.argsort(degree[nbrs], kind="stable")]:
                queue.append(int(nbr))

    return np.asarray(result[::-1], np.int64)


def _lobpcg_fiedler(adj, x0, *, tol: float, maxiter: int) -> np.ndarray:
    """Fiedler vector of ``adj``'s Laplacian via LOBPCG (Jacobi
    preconditioner, constant vector constrained out), unit variance."""
    import warnings

    import scipy.sparse as sp
    from scipy.sparse.linalg import lobpcg

    n = adj.shape[0]
    deg = np.asarray(adj.sum(axis=1)).ravel()
    lap = sp.diags(deg) - adj
    ones = np.ones((n, 1)) / np.sqrt(n)
    m_inv = sp.diags(1.0 / np.maximum(deg, 1e-12))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, vec = lobpcg(
            lap, x0, M=m_inv, Y=ones, tol=tol, maxiter=maxiter,
            largest=False,
        )
    v = vec[:, 0]
    return v / max(float(v.std()), 1e-30)



def spectral_ordering(
    edge_index: np.ndarray,
    num_nodes: int,
    edge_weight: np.ndarray | None = None,
    *,
    tol: float = 1e-8,
    maxiter: int = 200,
    reweight_iters: int = 3,
    seed: int = 0,
    return_iterates: bool = False,
    solver: str = "relax",
    relax_iters: int | None = None,
) -> np.ndarray | list[np.ndarray]:
    """Iteratively-reweighted Fiedler ordering: ``perm[new] = old``.

    Sorts nodes by the second-smallest eigenvector of the graph
    Laplacian — the 1-D embedding minimizing ``Σ w_ij (p_i - p_j)²``
    (Barnard/Pothen/Simon spectral envelope reduction) — then REWEIGHTS:
    edges stretched in the current embedding are downweighted
    (``w ← w₀ / (1 + stretch/9σ)``) and the eigenproblem re-solved,
    ``reweight_iters`` times, warm-started.

    Why both stages matter (measured, 16k-node ±256-band graph with 10%
    uniform shortcuts, scrambled ids): RCM's BFS levels are teleported
    by any single shortcut (~0.8 of edges left out of band); the PLAIN
    Fiedler vector fails differently — 10% uniform shortcuts make the
    graph an expander (λ₂ ≈ 0.38, no low-frequency geometry), leaving
    ~0.55.  The reweighting is what recovers the latent band: stretched
    edges are exactly the shortcuts, and three IRLS rounds drive
    λ₂ → 1e-6 and the out-of-band mass to ~0.28 (±4 blocks).  Further
    rounds can DISCONNECT the downweighted graph (λ₂ → 0, Fiedler
    degenerates to a component indicator) — so callers that can price
    orderings (``plan_layout``) should pass ``return_iterates=True`` and
    pick the cost-model argmin instead of trusting the last iterate.

    ``solver`` picks the embedding iteration.  The default ``"relax"``
    runs ``relax_iters`` Jacobi-smoothed lazy-random-walk sweeps
    (``x ← ½x + ½D⁻¹Wx``, per-component mean deflated — the
    algebraic-distance smoother) on a CSR whose structure is built once
    and whose weights update per IRLS round through a precomputed slot
    map; it is O(relax_iters·E) with a tiny constant and produces the
    same under-converged low-frequency mixes the reweighting needs.
    ``"lobpcg"`` keeps the original per-component LOBPCG eigensolve
    (tol/maxiter apply) — ~7× more plan time for equal-or-WORSE final
    orderings (measured, 262k-node small-world 10% scrambled:
    ``plan_layout`` 133.8 s → 19.2 s and remainder_frac 0.547 → 0.509;
    the under-converged relax iterates recover MORE bandable mass),
    retained as the oracle the relax path is tested against.

    Eigensolves (the ``"lobpcg"`` path) run per connected component with
    LOBPCG (Jacobi preconditioner, constant vector constrained out), a
    flat, bounded-iteration solve — a retired design
    note, because the obvious upgrade is a trap: a multilevel V-cycle
    (heavy-edge coarsen → dense coarse solve → prolong+refine) was built
    and measured WORSE on small-world graphs, twice over.  First, exact
    eigen-convergence is counterproductive here: the true fine-level
    Fiedler vector of an expander carries no geometry, while the
    UNDER-converged flat iterate keeps a low-frequency mix that is
    exactly the signal the reweighting amplifies (measured: better
    eigensolver → ordering degraded from 0.25 to 0.6-0.9 out-of-band at
    262k).  Second, heavy-edge coarsening cannot distinguish shortcuts
    from band edges (identical weight distributions), so every level
    merges across shortcuts and scrambles the latent geometry before
    the solve even starts (measured: coarse-level IRLS stuck at ~0.55
    where the same-size ORIGINAL graph reaches ~0.10).
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    src = np.concatenate([edge_index[0], edge_index[1]]).astype(np.int64)
    dst = np.concatenate([edge_index[1], edge_index[0]]).astype(np.int64)
    if edge_weight is None:
        w0 = np.ones(src.shape[0], np.float64)
    else:
        w0 = np.abs(
            np.concatenate([edge_weight, edge_weight]).astype(np.float64)
        )

    # symmetric CSR built ONCE (duplicates kept — matvec sums them); per
    # IRLS round only `.data` changes, via the precomputed `order` slot
    # map.  This removes the per-round coo→csr sort that used to cost
    # seconds per solve at giant scale.
    nnz = src.shape[0]
    # stable single-key sort by receiver only: CSR matvec does not need
    # within-row sorted columns, and argsort is much cheaper than
    # lexsort at 10⁸ entries
    order = np.argsort(dst, kind="stable")
    idx_dtype = np.int32 if nnz < np.iinfo(np.int32).max else np.int64
    indices = src[order].astype(idx_dtype)
    indptr = np.zeros(num_nodes + 1, idx_dtype)
    np.cumsum(np.bincount(dst, minlength=num_nodes), out=indptr[1:])

    def matrix(w) -> sp.csr_matrix:
        a = sp.csr_matrix(
            (np.ascontiguousarray(w[order]), indices, indptr),
            shape=(num_nodes, num_nodes),
        )
        return a

    if relax_iters is None:
        # smoothing budget: generous where matvecs are cheap (a 120-
        # sweep 8k-node solve costs milliseconds and closes most of the
        # quality gap to LOBPCG), lean at giant scale where each sweep
        # streams the whole edge list and 30 already ORDERS BETTER than
        # the converged eigensolve (see solver note above)
        relax_iters = 30 if num_nodes > 100_000 else 120

    struct = matrix(np.ones_like(w0))
    n_comp, comp = connected_components(struct, directed=False)
    comp_counts = np.bincount(comp, minlength=n_comp).astype(np.float64)
    rng = np.random.default_rng(seed)

    def solve_relax(w, warm: np.ndarray | None) -> np.ndarray:
        """Fixed-budget JOR relaxation (ω=½ lazy random walk) — the
        algebraic-distance smoother (Ron/Safro/Brandt), per-component
        deflated.  Deliberately NOT an eigensolver: under-converged
        low-frequency mixes are exactly the signal the reweighting
        amplifies (see the retired-design note below), and the cost
        model prices every IRLS iterate anyway, so a converged Fiedler
        vector buys nothing.  Measured better orderings at ~7× less
        plan time than the per-component LOBPCG it replaces (262k-node
        small-world 10%: plan 133.8 s → 19.2 s, remainder 0.547 →
        0.509)."""
        a = matrix(w)
        d = np.asarray(a.sum(axis=1)).ravel()
        dinv = 1.0 / np.maximum(d, 1e-30)
        x = (
            warm.astype(np.float64, copy=True)
            if warm is not None
            else rng.standard_normal(num_nodes)
        )
        for _ in range(relax_iters):
            x = 0.5 * x + 0.5 * ((a @ x) * dinv)
            x -= (
                np.bincount(comp, weights=x, minlength=n_comp)
                / comp_counts
            )[comp]
            norm = float(np.linalg.norm(x))
            if norm > 0.0:
                x /= norm
        var = (
            np.bincount(comp, weights=x * x, minlength=n_comp)
            / comp_counts
        )
        return x / np.maximum(np.sqrt(var), 1e-30)[comp]

    def solve_lobpcg(w, warm: np.ndarray | None) -> np.ndarray:
        adj = matrix(w)
        key = np.zeros(num_nodes, np.float64)
        for c in range(n_comp):
            nodes = np.flatnonzero(comp == c)
            if nodes.size <= 2:
                key[nodes] = np.arange(nodes.size)
                continue
            sub = adj[nodes][:, nodes].tocsr()
            x0 = (
                warm[nodes][:, None]
                if warm is not None
                else rng.standard_normal((nodes.size, 1))
            )
            try:
                key[nodes] = _lobpcg_fiedler(
                    sub, x0, tol=tol, maxiter=maxiter
                )
            except Exception:
                # eigensolver breakdown (degenerate component): keep
                # input order
                key[nodes] = np.arange(nodes.size)
        return key

    def to_perm(key) -> np.ndarray:
        # stable sort by (component, fiedler value): components contiguous
        return np.lexsort((key, comp)).astype(np.int64)

    solve = solve_relax if solver == "relax" else solve_lobpcg
    v = solve(w0, None)
    iterates = [to_perm(v)]
    for _ in range(reweight_iters):
        stretch = (v[src] - v[dst]) ** 2
        pos = stretch[stretch > 0]
        sigma = float(np.median(pos)) if pos.size else 1.0
        w = w0 / (1.0 + stretch / (9.0 * sigma + 1e-30))
        v = solve(w, v)
        iterates.append(to_perm(v))
    return iterates if return_iterates else iterates[-1]


def apply_ordering(graph: ConnectomeGraph, perm: np.ndarray) -> ConnectomeGraph:
    """Relabel a graph by ``perm`` (``perm[new] = old``)."""
    inverse = np.empty_like(perm)
    inverse[perm] = np.arange(len(perm))
    return ConnectomeGraph(
        node_features=graph.node_features[perm],
        edge_index=inverse[graph.edge_index.astype(np.int64)].astype(np.int32),
        edge_weight=graph.edge_weight,
        label=graph.label,
        subject_id=graph.subject_id,
    )


def bandwidth(edge_index: np.ndarray) -> int:
    """Maximum |sender - receiver| index distance over all edges."""
    if edge_index.shape[1] == 0:
        return 0
    return int(
        np.abs(
            edge_index[0].astype(np.int64) - edge_index[1].astype(np.int64)
        ).max()
    )
