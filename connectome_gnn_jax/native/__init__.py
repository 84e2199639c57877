"""Native (C++) host-runtime kernels with automatic build and fallback.

The device compute path is JAX/XLA/Pallas; this package accelerates the host
runtime *around* it: giant-graph ingest (RCM reordering, COO→band and
COO→dense packing) whose numpy forms are Python-loop- or ``np.add.at``-
bound at voxel-connectome scale.  The reference suite has no native code
at all (SURVEY §2: pure Python + torch scatter) — this layer is part of
the framework's production runtime.

Design:

* single C++17 translation unit (``cgt_native.cpp``), plain C ABI,
  driven through :mod:`ctypes` on raw numpy buffers — no pybind11;
* built on demand with ``g++ -O3`` into ``_cache/`` keyed by a source
  hash (first import compiles once, ~1 s; subsequent imports dlopen);
* every entry point is an *exact* drop-in for its numpy reference (same
  visit order, same float accumulation order → bitwise-identical output,
  asserted in ``tests/test_native.py``), so callers dispatch on
  :data:`AVAILABLE` without numerical consequences;
* set ``CGT_NO_NATIVE=1`` to force the numpy paths (also the automatic
  behavior wherever a toolchain is missing).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "cgt_native.cpp")

_lib: Optional[ctypes.CDLL] = None


def _build_and_load() -> ctypes.CDLL:
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha1(src).hexdigest()[:12]
    cache = os.path.join(_HERE, "_cache")
    so_path = os.path.join(cache, f"cgt_native_{tag}.so")
    if not os.path.exists(so_path):
        os.makedirs(cache, exist_ok=True)
        tmp = f"{so_path}.tmp{os.getpid()}"
        subprocess.run(
            [
                "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                "-fno-math-errno", _SRC, "-o", tmp,
            ],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, so_path)  # atomic: concurrent builders race safely
    lib = ctypes.CDLL(so_path)
    c_i64 = ctypes.c_int64
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.cgt_rcm.argtypes = [c_i64, p_i64, p_i64, p_i64, p_i64]
    lib.cgt_rcm.restype = None
    lib.cgt_band_pack.argtypes = [c_i64, p_i64, p_i64, p_f32, c_i64, c_i64, p_f32]
    lib.cgt_band_pack.restype = None
    lib.cgt_band_pack_range.argtypes = [
        c_i64, p_i64, p_i64, p_f32, c_i64, c_i64, c_i64, c_i64, p_f32,
    ]
    lib.cgt_band_pack_range.restype = None
    lib.cgt_dense_pack.argtypes = [c_i64, p_i64, p_i64, p_f32, c_i64, p_f32]
    lib.cgt_dense_pack.restype = None
    lib.cgt_sample_subgraph.argtypes = [
        c_i64, c_i64, p_i64, p_i64, p_i64, p_i64,  # graph CSR + senders
        c_i64, p_i64, c_i64, p_i64,                # seeds, fanout
        ctypes.c_uint64, p_i64, p_i64, p_i64, p_i64,
    ]
    lib.cgt_sample_subgraph.restype = c_i64
    p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.cgt_sampler_new.argtypes = [c_i64]
    lib.cgt_sampler_new.restype = ctypes.c_void_p
    lib.cgt_sampler_free.argtypes = [ctypes.c_void_p]
    lib.cgt_sampler_free.restype = None
    lib.cgt_sampler_sample_collate.argtypes = [
        ctypes.c_void_p, p_i64, p_i64, p_i64, p_i64, p_f32,  # index + weights
        c_i64, p_i64, c_i64, p_i64, ctypes.c_uint64,         # seeds, fanout
        c_i64, c_i64,                                        # budgets
        p_i32, p_i32, p_f32, p_i32, p_i64, p_i64,            # outputs
    ]
    lib.cgt_sampler_sample_collate.restype = c_i64
    return lib


if not os.environ.get("CGT_NO_NATIVE"):
    try:
        _lib = _build_and_load()
    except Exception:  # toolchain missing / unwritable cache → numpy paths
        _lib = None

AVAILABLE = _lib is not None


def rcm(
    indptr: np.ndarray, indices: np.ndarray, degree: np.ndarray
) -> np.ndarray:
    """Reverse Cuthill-McKee over a symmetrized CSR adjacency.

    Exact counterpart of the BFS in
    ``data/reorder.py::reverse_cuthill_mckee``; returns ``perm[new] = old``.
    """
    n = indptr.shape[0] - 1
    out = np.empty(n, np.int64)
    _lib.cgt_rcm(
        n,
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int64),
        np.ascontiguousarray(degree, np.int64),
        out,
    )
    return out


def band_pack(
    senders: np.ndarray,
    receivers: np.ndarray,
    weights: np.ndarray,
    band: np.ndarray,
    bandwidth: int,
) -> None:
    """Accumulate COO edges into a zeroed ``[nb, 2W+1, block, block]`` band
    in place (bitwise-identical to the ``np.add.at`` form)."""
    block = band.shape[2]
    _lib.cgt_band_pack(
        senders.shape[0],
        np.ascontiguousarray(senders, np.int64),
        np.ascontiguousarray(receivers, np.int64),
        np.ascontiguousarray(weights, np.float32),
        block,
        int(bandwidth),
        band,
    )


def band_pack_range(
    senders: np.ndarray,
    receivers: np.ndarray,
    weights: np.ndarray,
    band: np.ndarray,
    bandwidth: int,
    rb_lo: int,
) -> None:
    """Accumulate COO edges into a zeroed ``[nb_rows, 2W+1, block, block]``
    slab covering global block rows ``[rb_lo, rb_lo + nb_rows)`` in place.

    Edges with receiver blocks outside the window are skipped; visiting
    edges in input order keeps the slab bitwise-equal to the matching
    rows of a full :func:`band_pack` band — the streamed per-shard ingest
    primitive (each process packs only its own shards' rows).
    """
    block = band.shape[2]
    _lib.cgt_band_pack_range(
        senders.shape[0],
        np.ascontiguousarray(senders, np.int64),
        np.ascontiguousarray(receivers, np.int64),
        np.ascontiguousarray(weights, np.float32),
        block,
        int(bandwidth),
        int(rb_lo),
        band.shape[0],
        band,
    )


def sample_subgraph(
    order: np.ndarray,
    starts: np.ndarray,
    ends: np.ndarray,
    src: np.ndarray,
    num_nodes: int,
    num_edges: int,
    seeds: np.ndarray,
    fanout: np.ndarray,
    rng_seed: int,
) -> tuple[np.ndarray, np.ndarray]:
    """k-hop fanout sampling over a receiver-grouped edge index.

    Returns ``(node_ids, kept_edge_ids)`` — discovery-ordered nodes
    (seeds first) and ascending kept edge ids.  Uniform-without-
    replacement draws from a splitmix64 stream (NOT numpy's) — see
    ``data/sampling.py`` for when each path applies.
    """
    out_nodes = np.empty(num_nodes, np.int64)
    out_edges = np.empty(max(num_edges, 1), np.int64)
    n_nodes = np.zeros(1, np.int64)
    n_edges = np.zeros(1, np.int64)
    rc = _lib.cgt_sample_subgraph(
        num_nodes, num_edges,
        np.ascontiguousarray(order, np.int64),
        np.ascontiguousarray(starts, np.int64),
        np.ascontiguousarray(ends, np.int64),
        np.ascontiguousarray(src, np.int64),
        seeds.shape[0], np.ascontiguousarray(seeds, np.int64),
        len(fanout), np.ascontiguousarray(fanout, np.int64),
        int(rng_seed) & 0xFFFFFFFFFFFFFFFF,
        out_nodes, n_nodes, out_edges, n_edges,
    )
    if rc == 1:
        raise ValueError("seed node out of range")
    if rc == 2:
        raise ValueError("edge sender id out of range (corrupt edge_index)")
    return out_nodes[: n_nodes[0]].copy(), out_edges[: n_edges[0]].copy()


_SAMPLE_COLLATE_ERRORS = {
    1: "seed node out of range",
    2: "edge sender id out of range (corrupt edge_index)",
    5: "duplicate seed node",
}


def sampler_new(num_nodes: int) -> int:
    """Allocate a persistent fused-sampler handle (``visited`` scratch
    lives across calls — per-sample cost scales with the sample, not the
    graph).  NOT thread-safe: one handle per producer thread."""
    return _lib.cgt_sampler_new(int(num_nodes))


def sampler_free(handle: int) -> None:
    """Release a :func:`sampler_new` handle."""
    if handle:
        _lib.cgt_sampler_free(handle)


def sampler_sample_collate(
    handle: int,
    order: np.ndarray,
    starts: np.ndarray,
    ends: np.ndarray,
    src: np.ndarray,
    edge_weight: np.ndarray,
    seeds: np.ndarray,
    fanout: np.ndarray,
    rng_seed: int,
    node_budget: int,
    edge_budget: int,
    out_senders: np.ndarray,
    out_receivers: np.ndarray,
    out_weights: np.ndarray,
    out_node_ids: np.ndarray,
) -> tuple[int, int]:
    """Fused k-hop sample + collate into caller-provided padded buffers.

    Writes locally-relabeled, receiver-sorted edges (draws from the same
    splitmix64 stream as :func:`sample_subgraph` — identical sampled
    subgraph for the same ``rng_seed``), inert padding (edges →
    ``node_budget-1`` / weight 0, node ids → -1), and returns
    ``(n_nodes, n_edges)``.  Output buffers may be views into one larger
    contiguous array (the single-transfer ingest layout).
    """
    n_nodes = np.zeros(1, np.int64)
    n_edges = np.zeros(1, np.int64)
    rc = _lib.cgt_sampler_sample_collate(
        handle,
        np.ascontiguousarray(order, np.int64),
        np.ascontiguousarray(starts, np.int64),
        np.ascontiguousarray(ends, np.int64),
        np.ascontiguousarray(src, np.int64),
        np.ascontiguousarray(edge_weight, np.float32),
        seeds.shape[0], np.ascontiguousarray(seeds, np.int64),
        len(fanout), np.ascontiguousarray(fanout, np.int64),
        int(rng_seed) & 0xFFFFFFFFFFFFFFFF,
        int(node_budget), int(edge_budget),
        out_senders, out_receivers, out_weights, out_node_ids,
        n_nodes, n_edges,
    )
    if rc == 3:
        raise ValueError(
            f"sampled > node_budget {node_budget} nodes"
        )
    if rc == 4:
        raise ValueError(f"sampled > edge_budget {edge_budget} edges")
    if rc:
        raise ValueError(_SAMPLE_COLLATE_ERRORS.get(int(rc), f"error {rc}"))
    return int(n_nodes[0]), int(n_edges[0])


def dense_pack(
    senders: np.ndarray,
    receivers: np.ndarray,
    weights: np.ndarray,
    adj: np.ndarray,
) -> None:
    """Accumulate COO edges into a zeroed dense ``[n, n]`` receiver-major
    adjacency in place (bitwise-identical to ``np.add.at``)."""
    _lib.cgt_dense_pack(
        senders.shape[0],
        np.ascontiguousarray(senders, np.int64),
        np.ascontiguousarray(receivers, np.int64),
        np.ascontiguousarray(weights, np.float32),
        adj.shape[0],
        adj,
    )
