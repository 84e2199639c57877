"""Int8-quantized banded SpMM: a quarter of the band bytes of the f32 path.

The f32 banded path (:func:`~connectome_gnn_jax.ops.banded.banded_spmm`)
reads the whole ``[NB, 2W+1, block, block]`` band on every pass, and at
giant-graph scale those bytes dominate.  This module stores the band as
**int8 with one f32 scale per (row-block, diagonal) tile** (4× fewer
band bytes) and streams activations as bf16 (2× fewer), with all
accumulation in f32.

A tile's scale factors out of its product, ``(s·Q) @ x = s·(Q @ x)``, so
each diagonal ``d`` is one batched ``dot_general`` of the int8 tiles
(converted to bf16) with the shifted activation blocks, accumulated in
f32, and the per-tile scale is applied to the product afterwards:

    out[rb] = Σ_d  scales[rb, d] · (band_q[rb, d] @ x_blocks[rb + d])

The w8a8 variant also quantizes activations per column block and runs
``int8 × int8 → int32`` products.

Quantization error is bounded per entry by ``scale/2 = tile_maxabs/254``
(round-to-nearest), i.e. ~0.2% of the tile's largest weight; the bf16
activation cast contributes ≤2⁻⁸ relative.  The equivalence bound vs the
f32 path is asserted in ``tests/test_banded_quant.py``.
"""

from __future__ import annotations

from functools import partial as _partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from connectome_gnn_jax.ops.banded import BandedMatrix


class QuantizedBandedMatrix(NamedTuple):
    """Per-tile symmetric int8 quantization of a :class:`BandedMatrix`.

    ``band_q`` is ``[NB, 2W+1, block, block]`` int8; ``scales`` is
    ``[NB, 2W+1]`` f32 with ``band ≈ band_q · scales[..., None, None]``.
    """

    band_q: jnp.ndarray
    scales: jnp.ndarray
    num_nodes: int
    bandwidth: int

    @property
    def block(self) -> int:
        return int(self.band_q.shape[2])

    @property
    def num_blocks(self) -> int:
        return int(self.band_q.shape[0])


@jax.jit
def _quantize(band: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    maxabs = jnp.max(jnp.abs(band), axis=(2, 3))
    scales = jnp.where(maxabs > 0, maxabs / 127.0, 1.0).astype(jnp.float32)
    q = jnp.clip(
        jnp.round(band / scales[:, :, None, None]), -127, 127
    ).astype(jnp.int8)
    return q, scales


def quantize_band(a: BandedMatrix) -> QuantizedBandedMatrix:
    """Symmetric per-tile int8 quantization (device side, jitted).

    Max entry error is ``scales/2`` (round-to-nearest of ``band/scale``
    with ``scale = tile_maxabs/127``); all-zero tiles get scale 1.
    """
    q, scales = _quantize(a.band)
    return QuantizedBandedMatrix(q, scales, a.num_nodes, a.bandwidth)


def dequantize_band(q: QuantizedBandedMatrix) -> BandedMatrix:
    """f32 band reconstruction — the oracle for the quantized products."""
    band = q.band_q.astype(jnp.float32) * q.scales[:, :, None, None]
    return BandedMatrix(band, q.num_nodes, q.bandwidth)


def banded_spmm_quant_xla(
    q: QuantizedBandedMatrix, x: jnp.ndarray
) -> jnp.ndarray:
    """``A_q @ x`` by dequantizing to an f32 band, then the f32 einsum.

    Materializes the f32 band (4× the int8 bytes); the correctness
    oracle for :func:`banded_spmm_quant`.
    """
    from connectome_gnn_jax.ops.banded import banded_spmm

    return banded_spmm(dequantize_band(q), x)


def _pad_node_blocks(x: jnp.ndarray, num_nodes: int, nb: int, W: int,
                     block: int, axis: int) -> jnp.ndarray:
    """Zero-pad ``x[:num_nodes]`` along ``axis`` into the W-shifted frame
    of ``nb + 2W`` node blocks: padded block ``w`` holds nodes
    ``(w - W)·block ...``."""
    x = jax.lax.slice_in_dim(x, 0, num_nodes, axis=axis)
    pad = [(0, 0)] * x.ndim
    pad[axis] = (W * block, (nb + W) * block - num_nodes)
    return jnp.pad(x, pad)


def banded_spmm_quant(
    q: QuantizedBandedMatrix, x: jnp.ndarray
) -> jnp.ndarray:
    """``A_q @ x`` (int8 band, bf16 x, f32 accumulation).

    Returns f32 ``[num_nodes, F]``: one batched bf16 product per
    diagonal, each scaled by its tiles' scales.
    """
    block, nb, W = q.block, q.num_blocks, q.bandwidth
    F = x.shape[1]
    x_blocks = _pad_node_blocks(
        x.astype(jnp.bfloat16), q.num_nodes, nb, W, block, axis=0
    ).reshape(nb + 2 * W, block, F)
    out = jnp.zeros((nb, block, F), jnp.float32)
    for d in range(2 * W + 1):
        prod = jnp.einsum(
            "nrc,ncf->nrf", q.band_q[:, d].astype(jnp.bfloat16),
            x_blocks[d : d + nb], preferred_element_type=jnp.float32,
        )
        out = out + q.scales[:, d, None, None] * prod
    return out.reshape(nb * block, F)[: q.num_nodes]


class QuantizedHybridMatrix(NamedTuple):
    """Hybrid form with an int8 band: quantized local bulk + f32 sparse
    remainder (the remainder is tiny; quantizing it would save nothing).
    """

    band: QuantizedBandedMatrix
    remainder_senders: jnp.ndarray
    remainder_receivers: jnp.ndarray
    remainder_weights: jnp.ndarray

    @property
    def num_nodes(self) -> int:
        return self.band.num_nodes


def quantize_hybrid(h) -> QuantizedHybridMatrix:
    """Quantize a :class:`~connectome_gnn_jax.ops.banded.HybridMatrix`'s
    band part; the remainder COO stays f32."""
    return QuantizedHybridMatrix(
        quantize_band(h.band),
        h.remainder_senders,
        h.remainder_receivers,
        h.remainder_weights,
    )


def hybrid_spmm_quant(
    a: QuantizedHybridMatrix, x: jnp.ndarray
) -> jnp.ndarray:
    """``A @ x`` for the quantized hybrid form: int8-band bulk + f32
    scatter remainder."""
    from connectome_gnn_jax.ops.segment import coo_spmm

    out = banded_spmm_quant(a.band, x)
    rem = coo_spmm(
        a.remainder_weights,
        a.remainder_senders,
        a.remainder_receivers,
        x[: a.num_nodes],
        a.num_nodes,
        indices_are_sorted=True,
    )
    return out + rem


class QuantizedBandedMatrixFM(NamedTuple):
    """Feature-major (serving-layout) form of :class:`QuantizedBandedMatrix`.

    ``band_qT`` holds the per-diagonal tiles TRANSPOSED
    (``[NB, 2W+1, block(sender), block(receiver)]``) so the SpMM runs as
    ``outT = xT_window @ tileT`` with activations living as ``[F, N]``
    across layers; see :func:`banded_spmm_quant_fm`.
    """

    band_qT: jnp.ndarray
    scales: jnp.ndarray
    num_nodes: int
    bandwidth: int

    @property
    def block(self) -> int:
        return int(self.band_qT.shape[2])

    @property
    def num_blocks(self) -> int:
        return int(self.band_qT.shape[0])


def to_feature_major(q: QuantizedBandedMatrix) -> QuantizedBandedMatrixFM:
    """One-time serving prep: transpose each int8 tile (sender-major)."""
    return QuantizedBandedMatrixFM(
        jnp.swapaxes(q.band_q, 2, 3), q.scales, q.num_nodes, q.bandwidth
    )


def _xT_blocks(q: QuantizedBandedMatrixFM, xT: jnp.ndarray, dtype):
    """``[F, num_nodes]`` → ``[F, nb + 2W, block]`` in the W-shifted frame."""
    F = xT.shape[0]
    return _pad_node_blocks(
        xT.astype(dtype), q.num_nodes, q.num_blocks, q.bandwidth, q.block,
        axis=1,
    ).reshape(F, q.num_blocks + 2 * q.bandwidth, q.block)


def banded_spmm_quant_fm(
    q: QuantizedBandedMatrixFM, xT: jnp.ndarray
) -> jnp.ndarray:
    """``(A_q @ x)ᵀ`` with feature-major activations: ``xT`` is
    ``[F, num_nodes]``; returns ``[F, num_nodes]`` f32.

    A layout-persistent caller (``BandedNodeGCN.apply_quantized``) keeps
    activations ``[F, N]`` across layers, paying the transpose only at
    the model boundary.
    """
    nb, W = q.num_blocks, q.bandwidth
    F = xT.shape[0]
    xb = _xT_blocks(q, xT, jnp.bfloat16)
    outT = jnp.zeros((F, nb, q.block), jnp.float32)
    for d in range(2 * W + 1):
        prod = jnp.einsum(
            "ncr,fnc->fnr", q.band_qT[:, d].astype(jnp.bfloat16),
            xb[:, d : d + nb], preferred_element_type=jnp.float32,
        )
        outT = outT + q.scales[None, :, d, None] * prod
    return outT.reshape(F, nb * q.block)[:, : q.num_nodes]


def quantize_activations_fm(
    xT_pad: jnp.ndarray, block: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-column-block symmetric int8 quantization of padded
    feature-major activations: ``[F, NBwin·block]`` → int8 of the same
    shape + one f32 scale per column block (max-abs/127; all-zero blocks
    get scale 1).  Max entry error ``scale/2`` ≈ 0.4% of the block's
    largest activation.  Under a whole-model jit this fuses with the
    preceding layer's BN/ReLU epilogue (one elementwise+reduction pass).
    """
    F, total = xT_pad.shape
    nbw = total // block
    xb = xT_pad.astype(jnp.float32).reshape(F, nbw, block)
    maxabs = jnp.max(jnp.abs(xb), axis=(0, 2))
    scale = jnp.where(maxabs > 0, maxabs / 127.0, 1.0)
    xq = jnp.clip(
        jnp.round(xb / scale[None, :, None]), -127, 127
    ).astype(jnp.int8)
    return xq.reshape(F, total), scale.astype(jnp.float32)


def banded_spmm_quant_fm_w8a8(
    q: QuantizedBandedMatrixFM, xT: jnp.ndarray
) -> jnp.ndarray:
    """``(A_q @ x)ᵀ`` with int8 band AND int8 activations.

    Activations are quantized per column block
    (:func:`quantize_activations_fm`); each diagonal is one batched
    ``int8 × int8 → int32`` product, scaled by its tile scale times its
    activation block's scale.  Additional error vs the bf16-activation
    path is the per-block activation rounding (~0.4% per entry).

    ``xT`` is ``[F, num_nodes]`` f32/bf16; returns ``[F, num_nodes]``.
    """
    nb, W, block = q.num_blocks, q.bandwidth, q.block
    F = xT.shape[0]
    xq, xscales = quantize_activations_fm(
        _xT_blocks(q, xT, jnp.float32).reshape(F, -1), block
    )
    xq = xq.reshape(F, nb + 2 * W, block)
    outT = jnp.zeros((F, nb, block), jnp.float32)
    for d in range(2 * W + 1):
        prod = jnp.einsum(
            "ncr,fnc->fnr", q.band_qT[:, d], xq[:, d : d + nb],
            preferred_element_type=jnp.int32,
        )
        s = q.scales[:, d] * xscales[d : d + nb]
        outT = outT + s[None, :, None] * prod.astype(jnp.float32)
    return outT.reshape(F, nb * block)[:, : q.num_nodes]


def transpose_quantized(q: QuantizedBandedMatrix) -> QuantizedBandedMatrix:
    """``Aᵀ`` of an already-quantized band, exactly.

    Per-tile max-abs is transpose-invariant, so
    ``quantize(transpose(A)) == transpose(quantize(A))`` bit-for-bit
    (same scales on the moved tiles, tile contents transposed; shifted-in
    zero rows keep the all-zero convention ``scale=1``).  Transposing the
    int8 band instead of the f32 one cuts the peak device memory of
    training prep ~4×.  Same tile geometry as
    :func:`~connectome_gnn_jax.ops.banded.transpose_banded`.
    """
    W, blk = q.bandwidth, q.block
    tiles_out, scales_out = [], []
    for d in range(2 * W + 1):
        shift = d - W  # source block row = cb + shift
        tiles = jnp.swapaxes(q.band_q[:, 2 * W - d], 1, 2)
        sc = q.scales[:, 2 * W - d]
        if shift > 0:
            tiles = jnp.concatenate(
                [tiles[shift:], jnp.zeros((shift, blk, blk), tiles.dtype)]
            )
            sc = jnp.concatenate([sc[shift:], jnp.ones((shift,), sc.dtype)])
        elif shift < 0:
            tiles = jnp.concatenate(
                [jnp.zeros((-shift, blk, blk), tiles.dtype), tiles[:shift]]
            )
            sc = jnp.concatenate([jnp.ones((-shift,), sc.dtype), sc[:shift]])
        tiles_out.append(tiles)
        scales_out.append(sc)
    return QuantizedBandedMatrix(
        jnp.stack(tiles_out, axis=1), jnp.stack(scales_out, axis=1),
        q.num_nodes, q.bandwidth,
    )


def quantize_transposed_fm(band_norm) -> QuantizedBandedMatrixFM:
    """Feature-major quantization of ``Aᵀ`` — the backward operand of the
    trainable quantized SpMM.  Computed as :func:`transpose_quantized` of
    the int8 band (bitwise identical to quantizing the f32 transpose,
    ~4× less peak device memory).  For a symmetric normalized adjacency
    (undirected graphs through GCN sym-norm) this is exactly the
    re-indexed forward quantization; for general bands the scales travel
    with their tiles (same per-entry bound either way)."""
    return to_feature_major(transpose_quantized(quantize_band(band_norm)))


@_partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def _fm_trainable(num_nodes, bandwidth, band_qT, scales, bandT_qT, scalesT,
                  xT):
    q = QuantizedBandedMatrixFM(band_qT, scales, num_nodes, bandwidth)
    return banded_spmm_quant_fm(q, xT)


def _fm_trainable_fwd(num_nodes, bandwidth, band_qT, scales, bandT_qT,
                      scalesT, xT):
    q = QuantizedBandedMatrixFM(band_qT, scales, num_nodes, bandwidth)
    return banded_spmm_quant_fm(q, xT), (bandT_qT, scalesT)


def _fm_trainable_bwd(num_nodes, bandwidth, res, gT):
    bandT_qT, scalesT = res
    qT = QuantizedBandedMatrixFM(bandT_qT, scalesT, num_nodes, bandwidth)
    dxT = banded_spmm_quant_fm(qT, gT)
    # the quantized operands are constants (int8 primals take float0
    # cotangents; f32 scale zeros are DCE'd by XLA)
    f0 = np.zeros((), jax.dtypes.float0)
    return (
        np.broadcast_to(f0, bandT_qT.shape),
        jnp.zeros_like(scalesT),
        np.broadcast_to(f0, bandT_qT.shape),
        jnp.zeros_like(scalesT),
        dxT,
    )


_fm_trainable.defvjp(_fm_trainable_fwd, _fm_trainable_bwd)


def banded_spmm_quant_fm_grad(
    q: QuantizedBandedMatrixFM,
    qT: QuantizedBandedMatrixFM,
    xT: jnp.ndarray,
) -> jnp.ndarray:
    """TRAINABLE feature-major quantized SpMM: ``(A_q @ x)ᵀ`` whose VJP
    w.r.t. ``xT`` is the same int8 product on the transposed band
    (``x̄ᵀ = (Aᵀ·ȳ)ᵀ`` — a banded SpMM with mirrored diagonals,
    :func:`~connectome_gnn_jax.ops.banded.transpose_banded`).  Both the
    forward and backward band reads stay int8; gradient error carries
    the same per-entry quantization bound as the forward.  ``qT`` comes
    from :func:`quantize_transposed_fm` at prepare time.
    """
    if q.num_nodes != qT.num_nodes or q.bandwidth != qT.bandwidth:
        raise ValueError("q and qT disagree on geometry")
    return _fm_trainable(
        q.num_nodes, q.bandwidth,
        q.band_qT, q.scales, qT.band_qT, qT.scales, xT,
    )
