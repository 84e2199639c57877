"""Node-level GCN over a banded giant graph (single device).

The node-classification model for the voxel-level regime on one chip: a
spatially-ordered (or RCM-reordered) giant connectome in banded block-dense
form, L symmetric-normalized GCN convolutions running as shifted-window
batched matmuls at the HBM roofline (:mod:`connectome_gnn_jax.ops.banded`),
masked BatchNorm + ReLU + dropout per layer, and a per-node linear head.

Multi-device giant graphs use
:class:`connectome_gnn_jax.parallel.EdgePartitionedGCN`; this class is its
single-chip, locality-exploiting sibling.  Numerics match the COO GCN layer
(same sender-degree normalization, self-loop weight 1.0, reference
epsilons — verified against the COO oracle in ``tests/test_banded.py``).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from connectome_gnn_jax.models.layers import gcn_layer_init
from connectome_gnn_jax.nn.layers import (
    batch_norm_apply,
    batch_norm_init,
    dense_apply,
    dense_init,
    dropout,
)
from connectome_gnn_jax.ops.banded import (
    BandedMatrix,
    HybridMatrix,
    banded_spmm,
    gcn_normalize_banded,
    gcn_normalize_hybrid,
    hybrid_spmm,
)


def init_node_gcn_params(
    key: jax.Array,
    in_channels: int,
    hidden_dim: int,
    num_classes: int,
    num_layers: int,
) -> tuple[dict, dict]:
    """Shared parameter/state builder for node-level GCN classifiers
    (L GCN convolutions + BatchNorm + per-node linear head).  Used by
    :class:`BandedNodeGCN` and the partitioned giant-graph models, which
    are therefore parameter-compatible with each other."""
    dims = [in_channels] + [hidden_dim] * num_layers
    keys = jax.random.split(key, num_layers + 1)
    convs = [
        gcn_layer_init(keys[i], dims[i], dims[i + 1]) for i in range(num_layers)
    ]
    norm_params, norm_states = zip(
        *(batch_norm_init(hidden_dim) for _ in range(num_layers))
    )
    head = dense_init(keys[-1], hidden_dim, num_classes)
    return (
        {"convs": convs, "norms": list(norm_params), "head": head},
        {"norms": list(norm_states)},
    )


class BandedNodeGCN:
    """L-layer node-classification GCN over a :class:`BandedMatrix`."""

    def __init__(
        self,
        in_channels: int,
        hidden_dim: int = 64,
        num_classes: int = 2,
        num_layers: int = 3,
        dropout: float = 0.0,
    ):
        self.in_channels = int(in_channels)
        self.hidden_dim = int(hidden_dim)
        self.num_classes = int(num_classes)
        self.num_layers = int(num_layers)
        self.dropout = float(dropout)

    def init(self, key: jax.Array) -> tuple[dict, dict]:
        return init_node_gcn_params(
            key, self.in_channels, self.hidden_dim, self.num_classes,
            self.num_layers,
        )

    def apply(
        self,
        params: dict,
        state: dict,
        adjacency: BandedMatrix,
        x: jnp.ndarray,
        *,
        node_mask: Optional[jnp.ndarray] = None,
        train: bool = False,
        rng: Optional[jax.Array] = None,
    ) -> tuple[jnp.ndarray, dict]:
        """Per-node logits ``[num_nodes, C]`` plus updated BN state.

        ``adjacency`` may be a :class:`BandedMatrix` (pure band) or a
        :class:`HybridMatrix` (band + sparse remainder, for graphs with
        long-range shortcuts) — identical numerics either way.
        """
        # Normalization is layer-invariant; XLA CSEs the recomputation.
        if isinstance(adjacency, HybridMatrix):
            adj_norm, dinv = gcn_normalize_hybrid(adjacency)
            spmm = hybrid_spmm
        else:
            adj_norm, dinv = gcn_normalize_banded(adjacency)
            spmm = banded_spmm
        return self._forward(
            params, state, spmm, adj_norm, dinv, x,
            node_mask=node_mask, train=train, rng=rng,
        )

    def prepare(self, adjacency, *, band_dtype: str = "float32"):
        """One-time f32 training setup: GCN-normalize the adjacency.

        Returns ``(adj_norm, dinv)`` for :meth:`apply_normalized`.
        :meth:`apply` re-normalizes on every call — fine under jit where
        XLA CSEs it across layers, but a *training step* over a giant
        band would pay ~3 band-sized HBM passes per step for an operand
        that never changes.  Hoist it once, then step on the result.

        ``band_dtype="bfloat16"`` (pure bands) stores the normalized
        band bf16 — HALF the residency (5.37 → 2.7 GB at 1M/±512, a 2×
        bigger banded graph per device), with f32 accumulation either
        way (see :func:`~connectome_gnn_jax.ops.banded.banded_spmm`).
        """
        if isinstance(adjacency, HybridMatrix):
            if band_dtype != "float32":
                raise ValueError(
                    "band_dtype is a pure-band option (the hybrid "
                    "remainder path is f32)"
                )
            return gcn_normalize_hybrid(adjacency)
        adj_norm, dinv = gcn_normalize_banded(adjacency)
        if band_dtype == "bfloat16":
            adj_norm = adj_norm._replace(
                band=adj_norm.band.astype(jnp.bfloat16)
            )
        elif band_dtype != "float32":
            raise ValueError(
                f"band_dtype must be float32/bfloat16, got {band_dtype!r}"
            )
        return adj_norm, dinv

    def apply_normalized(
        self,
        params: dict,
        state: dict,
        adj_norm,
        dinv: jnp.ndarray,
        x: jnp.ndarray,
        *,
        node_mask: Optional[jnp.ndarray] = None,
        train: bool = False,
        rng: Optional[jax.Array] = None,
    ) -> tuple[jnp.ndarray, dict]:
        """:meth:`apply` over a pre-normalized adjacency from
        :meth:`prepare` — identical numerics, no per-step normalization."""
        spmm = hybrid_spmm if isinstance(adj_norm, HybridMatrix) else banded_spmm
        return self._forward(
            params, state, spmm, adj_norm, dinv, x,
            node_mask=node_mask, train=train, rng=rng,
        )

    def prepare_quant_trainable(self, adjacency: BandedMatrix):
        """One-time setup for int8-band TRAINING: normalize, quantize the
        band feature-major, and quantize its TRANSPOSE (the backward
        operand — ``x̄ = Aᵀ·ȳ`` is a banded SpMM with mirrored diagonals).

        Returns ``(adj_q, adj_qT, dinv)`` for :meth:`apply_quant_trainable`.
        Pure-band adjacencies only (the hybrid remainder trains f32).
        """
        from connectome_gnn_jax.ops.banded_quant import (
            quantize_band,
            to_feature_major,
            transpose_quantized,
        )

        if isinstance(adjacency, HybridMatrix):
            raise ValueError(
                "quantized training supports pure bands; hybrid graphs "
                "train through apply/apply_normalized (f32)"
            )
        adj_norm, dinv = gcn_normalize_banded(adjacency)
        # quantize once, transpose the int8 band (bitwise identical to
        # quantizing the f32 transpose, ~4× less peak HBM at giant scale)
        q_row = quantize_band(adj_norm)
        q = to_feature_major(q_row)
        qT = to_feature_major(transpose_quantized(q_row))
        return q, qT, dinv

    def apply_quant_trainable(
        self,
        params: dict,
        state: dict,
        adj_q,
        adj_qT,
        dinv: jnp.ndarray,
        x: jnp.ndarray,
        *,
        node_mask: Optional[jnp.ndarray] = None,
        train: bool = True,
        rng: Optional[jax.Array] = None,
    ) -> tuple[jnp.ndarray, dict]:
        """Differentiable int8-band forward (feature-major end-to-end).

        Same layer math as :meth:`apply` with the SpMM replaced by the
        int8 product in BOTH directions
        (:func:`~connectome_gnn_jax.ops.banded_quant.
        banded_spmm_quant_fm_grad`): forward reads the quantized band,
        backward reads the quantized transpose — 4× fewer band bytes
        each way than f32 training.  Train-mode BatchNorm runs
        feature-major with identical semantics
        (:func:`~connectome_gnn_jax.nn.layers.batch_norm_apply_fm`).
        Gradient error carries the quantization bound (~1% relative,
        asserted in ``tests/test_banded_quant.py``).
        """
        from connectome_gnn_jax.nn.layers import batch_norm_apply_fm
        from connectome_gnn_jax.ops.banded_quant import (
            banded_spmm_quant_fm_grad,
        )

        n = adj_q.num_nodes
        self_normT = (dinv * dinv)[None, :n]
        mask = node_mask if node_mask is not None else jnp.ones((n,), bool)

        hT = x[:n].T
        new_norms = []
        drop_keys = (
            jax.random.split(rng, self.num_layers)
            if (train and rng is not None)
            else [None] * self.num_layers
        )
        for i in range(self.num_layers):
            hwT = jnp.dot(
                params["convs"][i]["kernel"].T, hT,
                preferred_element_type=jnp.float32,
            )
            hT = (
                banded_spmm_quant_fm_grad(adj_q, adj_qT, hwT)
                + self_normT * hwT
                + params["convs"][i]["bias"][:, None]
            )
            hT, bn_state = batch_norm_apply_fm(
                params["norms"][i], state["norms"][i], hT, mask, train=train
            )
            new_norms.append(bn_state)
            hT = jax.nn.relu(hT)
            hT = dropout(drop_keys[i], hT, self.dropout, train=train)
        logits_T = jnp.dot(
            params["head"]["kernel"].T, hT,
            preferred_element_type=jnp.float32,
        )
        if "bias" in params["head"]:
            logits_T = logits_T + params["head"]["bias"][:, None]
        return logits_T.T, {"norms": new_norms}

    def prepare_quantized(self, adjacency, feature_major: bool = True):
        """One-time serving setup: GCN-normalize, then int8-quantize.

        Returns ``(adj_q, dinv)`` for :meth:`apply_quantized` — the band
        part of the *normalized* adjacency per-tile quantized to int8
        (4× fewer band bytes than f32; ~0.2% per-entry
        error, see :mod:`connectome_gnn_jax.ops.banded_quant`).
        Quantizing after normalization matters: the sym-norm rescale is
        exact, only the final SpMM operand is rounded.

        ``feature_major`` (pure-band adjacency only) returns the
        transposed-tile form consumed by
        :func:`~connectome_gnn_jax.ops.banded_quant.banded_spmm_quant_fm`;
        :meth:`apply_quantized` then keeps activations ``[F, N]`` across
        layers.  Hybrid adjacencies stay
        row-major (the scatter remainder wants node-major rows).
        """
        from connectome_gnn_jax.ops.banded_quant import (
            quantize_band,
            quantize_hybrid,
            to_feature_major,
        )

        if isinstance(adjacency, HybridMatrix):
            adj_norm, dinv = gcn_normalize_hybrid(adjacency)
            return quantize_hybrid(adj_norm), dinv
        adj_norm, dinv = gcn_normalize_banded(adjacency)
        q = quantize_band(adj_norm)
        return (to_feature_major(q) if feature_major else q), dinv

    def apply_quantized(
        self,
        params: dict,
        state: dict,
        adj_q,
        dinv: jnp.ndarray,
        x: jnp.ndarray,
        *,
        node_mask: Optional[jnp.ndarray] = None,
        w8a8: bool = False,
    ) -> tuple[jnp.ndarray, dict]:
        """Inference forward over a :func:`prepare_quantized` adjacency.

        Serving-only (no ``train`` path: gradients through the int8 band
        are not defined); BN uses running statistics.

        ``w8a8`` (feature-major adjacencies only) also quantizes each
        layer's activations per column block to int8 and runs
        ``int8 × int8`` products (:func:`~connectome_gnn_jax.ops.
        banded_quant.banded_spmm_quant_fm_w8a8`), at ~1% additional
        relative error.
        """
        from connectome_gnn_jax.ops.banded_quant import (
            QuantizedBandedMatrixFM,
            QuantizedHybridMatrix,
            banded_spmm_quant,
            hybrid_spmm_quant,
        )

        if isinstance(adj_q, QuantizedBandedMatrixFM):
            return self._forward_quant_fm(
                params, state, adj_q, dinv, x, w8a8=w8a8
            )
        if w8a8:
            raise ValueError(
                "w8a8 serving requires a feature-major adjacency "
                "(prepare_quantized(..., feature_major=True))"
            )
        spmm = (
            hybrid_spmm_quant
            if isinstance(adj_q, QuantizedHybridMatrix)
            else banded_spmm_quant
        )
        return self._forward(
            params, state, spmm, adj_q, dinv, x,
            node_mask=node_mask, train=False, rng=None,
        )

    def _forward_quant_fm(
        self, params, state, adj_q, dinv, x, *, w8a8=False
    ) -> tuple[jnp.ndarray, dict]:
        """Layout-persistent quantized serving: activations stay
        feature-major (``[F, N]``) across every layer, and only the tiny input
        (``[N, in_channels]``) and logits (``[N, classes]``) transpose at
        the model boundary.  Eval-mode semantics identical to
        :meth:`_forward` (running-stat BN, no dropout).  ``w8a8`` swaps
        in int8 activations (per-layer requantization fuses with the
        BN/ReLU epilogue under jit)."""
        from connectome_gnn_jax.nn.layers import batch_norm_eval_fm
        from connectome_gnn_jax.ops.banded_quant import (
            banded_spmm_quant_fm,
            banded_spmm_quant_fm_w8a8,
        )

        spmm = banded_spmm_quant_fm_w8a8 if w8a8 else banded_spmm_quant_fm
        n = adj_q.num_nodes
        self_normT = (dinv * dinv)[None, :n]

        hT = x[:n].T
        for i in range(self.num_layers):
            hwT = jnp.dot(
                params["convs"][i]["kernel"].T, hT,
                preferred_element_type=jnp.float32,
            )
            hT = (
                spmm(adj_q, hwT)
                + self_normT * hwT
                + params["convs"][i]["bias"][:, None]
            )
            hT = batch_norm_eval_fm(params["norms"][i], state["norms"][i], hT)
            hT = jax.nn.relu(hT)
        logits_T = jnp.dot(
            params["head"]["kernel"].T, hT,
            preferred_element_type=jnp.float32,
        )
        if "bias" in params["head"]:
            logits_T = logits_T + params["head"]["bias"][:, None]
        return logits_T.T, {"norms": state["norms"]}

    def _forward(
        self, params, state, spmm, adj_norm, dinv, x,
        *, node_mask, train, rng,
    ) -> tuple[jnp.ndarray, dict]:
        n = adj_norm.num_nodes
        if node_mask is None:
            node_mask = jnp.ones((n,), bool)
        self_norm = (dinv * dinv)[:n, None]

        h = x[:n]
        new_norms = []
        drop_keys = (
            jax.random.split(rng, self.num_layers)
            if (train and rng is not None)
            else [None] * self.num_layers
        )
        for i in range(self.num_layers):
            hw = jnp.dot(
                h, params["convs"][i]["kernel"],
                preferred_element_type=jnp.float32,
            )
            h = (
                spmm(adj_norm, hw)
                + self_norm * hw
                + params["convs"][i]["bias"]
            )
            h, bn_state = batch_norm_apply(
                params["norms"][i], state["norms"][i], h, node_mask, train=train
            )
            new_norms.append(bn_state)
            h = jax.nn.relu(h)
            h = dropout(drop_keys[i], h, self.dropout, train=train)
        logits = dense_apply(params["head"], h)
        return logits, {"norms": new_norms}
