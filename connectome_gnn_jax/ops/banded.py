"""Banded block-dense SpMM — the matmul path for giant spatially-local graphs.

Classic CSR SpMM (gather → segment-sum) is bound by random row access.
But voxel-level connectomes — and most mesh/space-embedded
graphs — are *local*: after a spatial or Reverse-Cuthill-McKee ordering
(:func:`connectome_gnn_jax.data.reorder.reverse_cuthill_mckee`), every
edge connects nodes within a bounded index distance.  That turns the
sparse matrix into a **block band**:

    A ∈ [N, N]  →  band[rb, d] = dense (block × block) tile of
                   A[rb·block : (rb+1)·block,
                     (rb+d-W)·block : (rb+d-W+1)·block],   d ∈ [0, 2W]

and SpMM into a batched dense contraction

    out[rb] = Σ_d band[rb, d] @ x_blocks[rb + d - W]

which is dense matmul work: the sender "gather" collapses to a
*block-index* shift (regular, XLA-friendly), and the only waste is block
sparsity (empty entries inside tiles); the denser the blocks, the closer
to the matmul roofline.

Blocks are receiver-major like the dense batch layout: ``band[rb, d, i, j]``
is the weight of edge ``(sender = (rb+d-W)·block + j) → (receiver =
rb·block + i)``.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from connectome_gnn_jax.data.batch import round_up


class BandedMatrix(NamedTuple):
    """Block-banded sparse matrix.

    ``band`` is ``[NB, 2W+1, block, block]`` (f32); ``num_nodes`` is the
    unpadded logical dimension; the padded dimension is ``NB · block``.
    """

    band: jnp.ndarray
    num_nodes: int
    bandwidth: int  # W, in blocks

    @property
    def block(self) -> int:
        return int(self.band.shape[2])

    @property
    def num_blocks(self) -> int:
        return int(self.band.shape[0])


def to_banded(
    senders: np.ndarray,
    receivers: np.ndarray,
    weights: np.ndarray,
    num_nodes: int,
    *,
    block: int = 256,
    bandwidth: int | None = None,
) -> BandedMatrix:
    """Convert a COO edge list to block-banded form (host side).

    ``bandwidth`` (in blocks) defaults to the smallest band containing
    every edge.  Duplicate edges accumulate additively, matching COO
    scatter semantics.  Raises if an edge falls outside an explicitly
    given band — reorder the graph first.
    """
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    weights = np.asarray(weights, np.float32)

    padded = round_up(num_nodes, block)
    nb = padded // block
    rb = receivers // block
    cb = senders // block
    d = cb - rb
    if bandwidth is None:
        bandwidth = int(np.abs(d).max()) if d.size else 0
    elif d.size and np.abs(d).max() > bandwidth:
        raise ValueError(
            f"edge outside band: |block distance| {int(np.abs(d).max())} > "
            f"bandwidth {bandwidth}; reorder the graph (e.g. RCM) first"
        )
    W = int(bandwidth)

    band = np.zeros((nb, 2 * W + 1, block, block), np.float32)
    from connectome_gnn_jax import native

    if native.AVAILABLE:
        native.band_pack(senders, receivers, weights, band, W)
    else:
        np.add.at(
            band,
            (rb, d + W, receivers % block, senders % block),
            weights,
        )
    return BandedMatrix(jnp.asarray(band), int(num_nodes), W)


def banded_spmm(a: BandedMatrix, x: jnp.ndarray) -> jnp.ndarray:
    """``out = A @ x`` over the block band; returns ``[num_nodes, F]``.

    Sender blocks are materialized as a shifted block-window view (a
    coarse block-level take, not a per-row gather), then contracted with
    the band in one batched ``einsum``.

    Differentiable wrt ``x`` through a custom VJP: XLA's autodiff
    transpose of the block-window ``take`` is a SCATTER-ADD over the
    overlapping windows.  The custom backward computes
    ``x̄ = Aᵀ·ȳ`` as one batched einsum (``windows_bar[rb, d] =
    band[rb, d]ᵀ · ȳ[rb]``) plus ``2W+1`` STATIC slice-adds — dense
    regular ops only.  The adjacency is training data, not a parameter:
    its cotangent is returned as zeros (DCE'd when unused).

    The band may be stored **bfloat16** (``a._replace(band=a.band.
    astype(jnp.bfloat16))``) for HALF the resident bytes (5.37 → 2.7 GB
    at the 1M/±512 config — a 2× bigger banded graph per device), at
    bf16 rounding of the band entries.  Accumulation stays
    ``preferred_element_type=float32`` in both directions.
    """
    return _banded_spmm_vjp(a.band, x, a.num_nodes, int(x.shape[0]))


def _banded_spmm_impl(band, x, num_nodes: int):
    nb, dd, block, _ = band.shape
    W = (dd - 1) // 2
    padded = nb * block
    F = x.shape[1]

    x_pad = jnp.zeros((padded + 2 * W * block, F), x.dtype)
    x_pad = jax.lax.dynamic_update_slice(
        x_pad, x[:num_nodes], (W * block, 0)
    )
    x_blocks = x_pad.reshape(nb + 2 * W, block, F)

    # windows[rb, d] = x_blocks[rb + d]  — block-level take (regular access)
    idx = jnp.arange(nb)[:, None] + jnp.arange(2 * W + 1)[None, :]
    windows = jnp.take(x_blocks, idx, axis=0)  # [NB, 2W+1, block, F]

    out = jnp.einsum(
        "ndrc,ndcf->nrf",
        band,
        windows,
        preferred_element_type=jnp.float32,
    )
    return out.reshape(padded, F)[:num_nodes]


@partial(jax.custom_vjp, nondiff_argnums=(2, 3))
def _banded_spmm_vjp(band, x, num_nodes: int, x_rows: int):
    return _banded_spmm_impl(band, x, num_nodes)


def _banded_spmm_fwd(band, x, num_nodes: int, x_rows: int):
    return _banded_spmm_impl(band, x, num_nodes), band


def _banded_spmm_bwd(num_nodes: int, x_rows: int, res, g):
    band = res
    nb, dd, block, _ = band.shape
    W = (dd - 1) // 2
    padded = nb * block
    F = g.shape[1]

    g_pad = jnp.zeros((padded, F), g.dtype)
    g_pad = jax.lax.dynamic_update_slice(g_pad, g[:num_nodes], (0, 0))
    g_blocks = g_pad.reshape(nb, block, F)

    # x_blocks_bar[rb + d] += band[rb, d]ᵀ @ ȳ[rb], one batched einsum
    # PER DIAGONAL + a static slice-add.  Deliberately NOT one
    # [NB, 2W+1, block, F] windows_bar einsum: that tensor's layout is
    # contested between the conv-lowered contraction and its consumers,
    # and XLA resolves it with band-sized layout-conversion copies
    # (visible in the HLO as {2,3,0,1} copies).
    xbar_blocks = jnp.zeros((nb + 2 * W, block, F), jnp.float32)
    for d in range(2 * W + 1):
        contrib = jnp.einsum(
            "nrc,nrf->ncf", band[:, d], g_blocks,
            preferred_element_type=jnp.float32,
        )
        xbar_blocks = xbar_blocks.at[d : d + nb].add(contrib)
    xbar = xbar_blocks[W : W + nb].reshape(padded, F)[:x_rows]
    if x_rows > num_nodes:
        # x rows beyond num_nodes never entered the forward
        xbar = jnp.concatenate([
            xbar[:num_nodes],
            jnp.zeros((x_rows - num_nodes, F), jnp.float32),
        ])
    return jnp.zeros_like(band), xbar


_banded_spmm_vjp.defvjp(_banded_spmm_fwd, _banded_spmm_bwd)


def transpose_banded(a: BandedMatrix) -> BandedMatrix:
    """``Aᵀ`` in banded form (same block size and bandwidth).

    ``bandT[cb, d] = band[cb + d - W, 2W - d]ᵀ``: receiver/sender roles
    swap, so the destination tile on diagonal ``d`` is the transposed
    source tile from the mirrored diagonal of the shifted block row
    (rows shifted off either edge are zero — the band is zero there by
    construction).  This is the cotangent operator of
    :func:`banded_spmm` w.r.t. ``x`` (``x̄ = Aᵀ·ȳ``), used to run the
    quantized Pallas kernels in training (:func:`connectome_gnn_jax.ops.
    banded_quant.banded_spmm_quant_fm_grad`).
    """
    W, blk = a.bandwidth, a.block
    out = []
    for d in range(2 * W + 1):
        shift = d - W  # source block row = cb + shift
        tiles = jnp.swapaxes(a.band[:, 2 * W - d], 1, 2)
        if shift > 0:
            tiles = jnp.concatenate(
                [tiles[shift:], jnp.zeros((shift, blk, blk), tiles.dtype)]
            )
        elif shift < 0:
            tiles = jnp.concatenate(
                [jnp.zeros((-shift, blk, blk), tiles.dtype), tiles[:shift]]
            )
        out.append(tiles)
    return BandedMatrix(jnp.stack(out, axis=1), a.num_nodes, W)


def banded_row_sum(a: BandedMatrix) -> jnp.ndarray:
    """Weighted receiver (row) degrees, ``[padded]`` — the SAGE mean
    normalizer (rows are local to their block, no halo needed)."""
    return jnp.sum(a.band, axis=(1, 3)).reshape(a.num_blocks * a.block)


def banded_sender_degree(a: BandedMatrix) -> jnp.ndarray:
    """Weighted sender (column) degrees of the banded matrix, ``[padded]``.

    Column ``cb·block + j`` receives contributions from every row block
    ``rb`` with ``cb = rb + d - W`` — a coarse block-level scatter (NB·D
    segments), nothing per-edge.
    """
    block, nb, W = a.block, a.num_blocks, a.bandwidth
    col_sums = jnp.sum(a.band, axis=2)  # [NB, 2W+1, block] over receivers i
    rb = jnp.arange(nb)[:, None]
    d = jnp.arange(2 * W + 1)[None, :]
    cb = (rb + d).reshape(-1)  # destination block in the padded-by-W space
    deg_blocks = jax.ops.segment_sum(
        col_sums.reshape(-1, block), cb, num_segments=nb + 2 * W
    )
    # drop the W halo blocks on each side
    return deg_blocks[W : W + nb].reshape(nb * block)


def _scale_band(a: BandedMatrix, dinv: jnp.ndarray) -> BandedMatrix:
    """Rescale band entries by ``dinv[receiver] · w · dinv[sender]``.

    The sender side needs ``dinv`` shifted through the same halo-window
    indexing the SpMM uses (zero outside the padded range).
    """
    block, nb, W = a.block, a.num_blocks, a.bandwidth
    dinv_rows = dinv.reshape(nb, 1, block, 1)  # receiver side
    dinv_pad = jnp.concatenate(
        [jnp.zeros((W * block,), dinv.dtype), dinv,
         jnp.zeros((W * block,), dinv.dtype)]
    ).reshape(nb + 2 * W, block)
    idx = jnp.arange(nb)[:, None] + jnp.arange(2 * W + 1)[None, :]
    dinv_cols = jnp.take(dinv_pad, idx, axis=0)[:, :, None, :]  # sender side
    return BandedMatrix(dinv_rows * a.band * dinv_cols, a.num_nodes, W)


def gcn_normalize_banded(
    a: BandedMatrix, *, self_loop_weight: float = 1.0, eps: float = 1e-8
) -> tuple[BandedMatrix, jnp.ndarray]:
    """Symmetric GCN normalization of a banded adjacency.

    Returns the normalized band and ``dinv [padded]``; same math as
    :func:`connectome_gnn_jax.ops.gcn_norm.gcn_normalize` (sender degrees +
    self-loop weight, ``(deg + 1e-8)^-0.5``).  Padded node slots get
    ``deg = self_loop_weight`` and stay inert (their features are zero).
    """
    deg = banded_sender_degree(a) + self_loop_weight
    dinv = jax.lax.rsqrt(deg + eps)  # [padded]
    return _scale_band(a, dinv), dinv


def banded_block_diag(parts) -> tuple[BandedMatrix, jnp.ndarray]:
    """Block-diagonal concatenation of banded matrices (host/jit-safe).

    Because out-of-range band entries are zero by construction, stacking
    the per-part bands along the block-row axis IS the block-diagonal
    matrix — part ``i``'s rows occupy its padded range and its boundary
    blocks reference the neighboring part only through all-zero tiles.
    This is the single-device equivalent of a multi-subject giant-graph
    cohort (the 2-D combined-parallel oracle).

    Returns ``(combined, node_valid_mask)``; the mask is False on each
    part's internal padding rows (``num_nodes .. padded``), which callers
    must also zero in the concatenated features.  All parts must share
    ``block`` and ``bandwidth``.
    """
    blocks = {p.block for p in parts}
    widths = {p.bandwidth for p in parts}
    if len(blocks) != 1 or len(widths) != 1:
        raise ValueError("banded_block_diag requires uniform block/bandwidth")
    band = jnp.concatenate([p.band for p in parts], axis=0)
    valid = jnp.concatenate(
        [
            jnp.arange(p.num_blocks * p.block) < p.num_nodes
            for p in parts
        ]
    )
    num_nodes = int(band.shape[0]) * int(band.shape[2])
    return BandedMatrix(band, num_nodes, widths.pop()), valid


class HybridMatrix(NamedTuple):
    """Band + sparse-remainder decomposition of a sparse matrix.

    Real graphs are rarely *purely* bandable: small-world connectomes keep
    a few long-range shortcuts even after RCM reordering.  The hybrid form
    routes the local bulk through the banded matmul path and only the
    out-of-band remainder through the scatter path — recovering most of
    the ~40× banded speedup on graphs where a pure band would be rejected
    or enormous.

    ``remainder_*`` are COO arrays padded to a static length (receiver-
    sorted, padding ids one-past-the-end with weight 0, same conventions
    as :class:`~connectome_gnn_jax.data.batch.ConnectomeBatch`).
    """

    band: BandedMatrix
    remainder_senders: jnp.ndarray
    remainder_receivers: jnp.ndarray
    remainder_weights: jnp.ndarray

    @property
    def num_nodes(self) -> int:
        return self.band.num_nodes


def to_hybrid(
    senders: np.ndarray,
    receivers: np.ndarray,
    weights: np.ndarray,
    num_nodes: int,
    *,
    block: int = 256,
    bandwidth: int = 4,
    edge_multiple: int = 128,
) -> HybridMatrix:
    """Split a COO edge list into a ±``bandwidth``-block band plus a
    sparse remainder (host side).

    Pick ``bandwidth`` so the band captures the local bulk; everything
    farther from the diagonal lands in the remainder.  With
    ``bandwidth=0`` the band holds only the diagonal blocks.
    """
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    weights = np.asarray(weights, np.float32)

    d = senders // block - receivers // block
    in_band = np.abs(d) <= bandwidth
    band = to_banded(
        senders[in_band], receivers[in_band], weights[in_band], num_nodes,
        block=block, bandwidth=bandwidth,
    )

    rem_s = senders[~in_band]
    rem_r = receivers[~in_band]
    rem_w = weights[~in_band]
    order = np.argsort(rem_r, kind="stable")
    e = rem_s.shape[0]
    padded = band.num_blocks * block
    cap = round_up(max(e, 1), edge_multiple)
    out_s = np.full(cap, padded, np.int32)
    out_r = np.full(cap, padded, np.int32)
    out_w = np.zeros(cap, np.float32)
    out_s[:e] = rem_s[order]
    out_r[:e] = rem_r[order]
    out_w[:e] = rem_w[order]
    return HybridMatrix(
        band, jnp.asarray(out_s), jnp.asarray(out_r), jnp.asarray(out_w)
    )


def hybrid_block_diag(parts) -> tuple["HybridMatrix", jnp.ndarray]:
    """Block-diagonal concatenation of hybrid matrices.

    Band parts stack exactly (:func:`banded_block_diag`); each part's
    REAL remainder edges are offset by the part's padded start and the
    combined list is receiver-sorted and re-padded (the per-part padding
    sentinels point at the part's own padded end and would alias the next
    part's rows if kept).  Returns ``(combined, node_valid_mask)`` — the
    single-device oracle for a 2-D sharded hybrid cohort.
    """
    band, valid = banded_block_diag([p.band for p in parts])
    ss, rr, ww = [], [], []
    off = 0
    for p in parts:
        padded = p.band.num_blocks * p.band.block
        s = np.asarray(p.remainder_senders, np.int64)
        r = np.asarray(p.remainder_receivers, np.int64)
        w = np.asarray(p.remainder_weights, np.float32)
        real = r < padded
        ss.append(s[real] + off)
        rr.append(r[real] + off)
        ww.append(w[real])
        off += padded
    s = np.concatenate(ss) if ss else np.empty(0, np.int64)
    r = np.concatenate(rr) if rr else np.empty(0, np.int64)
    w = np.concatenate(ww) if ww else np.empty(0, np.float32)
    order = np.argsort(r, kind="stable")
    e = s.shape[0]
    cap = round_up(max(e, 1), 128)
    out_s = np.full(cap, off, np.int32)
    out_r = np.full(cap, off, np.int32)
    out_w = np.zeros(cap, np.float32)
    out_s[:e] = s[order]
    out_r[:e] = r[order]
    out_w[:e] = w[order]
    return (
        HybridMatrix(
            band, jnp.asarray(out_s), jnp.asarray(out_r), jnp.asarray(out_w)
        ),
        valid,
    )


def hybrid_spmm(
    a: HybridMatrix, x: jnp.ndarray, *, remainder_chunk: int | None = None
) -> jnp.ndarray:
    """``A @ x`` for the hybrid form: banded matmul bulk + scatter remainder.

    ``remainder_chunk`` bounds device memory when the remainder is giant
    (XLA materializes the gathered messages; see
    :func:`~connectome_gnn_jax.ops.segment.coo_spmm`) — pass e.g.
    ``4 << 20`` for multi-ten-million-edge remainders on a 16 GB chip.
    """
    from connectome_gnn_jax.ops.segment import coo_spmm

    out = banded_spmm(a.band, x)
    rem = coo_spmm(
        a.remainder_weights,
        a.remainder_senders,
        a.remainder_receivers,
        x[: a.num_nodes],
        a.num_nodes,
        indices_are_sorted=True,
        edge_chunk=remainder_chunk,
    )
    return out + rem


def hybrid_row_sum(a: HybridMatrix) -> jnp.ndarray:
    """Weighted receiver (row) degrees over band + remainder, ``[padded]``."""
    row = banded_row_sum(a.band)
    return row + jax.ops.segment_sum(
        a.remainder_weights, a.remainder_receivers, num_segments=row.shape[0]
    )


def hybrid_sender_degree(a: HybridMatrix) -> jnp.ndarray:
    """Weighted sender degrees over band + remainder, ``[padded]``."""
    deg = banded_sender_degree(a.band)
    padded = deg.shape[0]
    deg_rem = jax.ops.segment_sum(
        a.remainder_weights, a.remainder_senders, num_segments=padded
    )
    return deg + deg_rem


def gcn_normalize_hybrid(
    a: HybridMatrix, *, self_loop_weight: float = 1.0, eps: float = 1e-8
) -> tuple["HybridMatrix", jnp.ndarray]:
    """Symmetric GCN normalization of a hybrid adjacency.

    Same math as the COO/banded variants: sender degrees (+ self-loop)
    over BOTH parts, ``(deg + 1e-8)^-0.5``, per-entry rescale.
    """
    deg = hybrid_sender_degree(a) + self_loop_weight
    dinv = jax.lax.rsqrt(deg + eps)  # [padded]
    band_norm = _scale_band(a.band, dinv)

    # padded remainder ids point one-past-the-end; clamp for the gather
    # (their weight is 0, so the value is irrelevant)
    safe_s = jnp.minimum(a.remainder_senders, deg.shape[0] - 1)
    safe_r = jnp.minimum(a.remainder_receivers, deg.shape[0] - 1)
    rem_norm = dinv[safe_r] * a.remainder_weights * dinv[safe_s]
    return (
        HybridMatrix(
            band_norm, a.remainder_senders, a.remainder_receivers, rem_norm
        ),
        dinv,
    )
