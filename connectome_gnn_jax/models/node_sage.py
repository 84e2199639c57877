"""Node-level GraphSAGE over a banded giant graph (single device).

The SAGE counterpart of :class:`~connectome_gnn_jax.models.node_gcn.BandedNodeGCN`
for the voxel-level regime: L weighted-mean-aggregate SAGE convolutions
(reference semantics, ``connectome_gnn/models.py:136-152`` — messages
``x[src]·w``, normalizer = incident-weight sum ``+1e-8``, concat-project-
ReLU, no self-loops) running as shifted-window batched matmuls over the
block band, then masked BatchNorm + dropout per layer (NO extra ReLU —
the reference's SAGE asymmetry, models.py:256-262) and a per-node linear
head.  Accepts :class:`BandedMatrix` or :class:`HybridMatrix`.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from connectome_gnn_jax.models.layers import sage_layer_init
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
    banded_row_sum,
    banded_spmm,
    hybrid_row_sum,
    hybrid_spmm,
)

EPS = 1e-8


def init_node_sage_params(
    key: jax.Array,
    in_channels: int,
    hidden_dim: int,
    num_classes: int,
    num_layers: int,
) -> tuple[dict, dict]:
    """L SAGE convolutions (Xavier concat-kernels, torch-default bias) +
    BatchNorm + per-node linear head."""
    dims = [in_channels] + [hidden_dim] * num_layers
    keys = jax.random.split(key, num_layers + 1)
    convs = [
        sage_layer_init(keys[i], dims[i], dims[i + 1]) for i in range(num_layers)
    ]
    norm_params, norm_states = zip(
        *(batch_norm_init(hidden_dim) for _ in range(num_layers))
    )
    head = dense_init(keys[-1], hidden_dim, num_classes)
    return (
        {"convs": convs, "norms": list(norm_params), "head": head},
        {"norms": list(norm_states)},
    )


class BandedNodeSAGE:
    """L-layer node-classification GraphSAGE over a block-banded graph."""

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
        return init_node_sage_params(
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
        """Per-node logits ``[num_nodes, C]`` plus updated BN state."""
        if isinstance(adjacency, HybridMatrix):
            spmm, w_sum = hybrid_spmm, hybrid_row_sum(adjacency)
        else:
            spmm, w_sum = banded_spmm, banded_row_sum(adjacency)
        return self._forward(
            params, state, spmm, adjacency, w_sum, x,
            node_mask=node_mask, train=train, rng=rng,
        )

    def prepare_quantized(self, adjacency, feature_major: bool = True):
        """One-time serving setup: int8-quantize the (raw-weight) band and
        precompute the exact f32 mean normalizer.

        Returns ``(adj_q, w_sum)`` for :meth:`apply_quantized`.  SAGE's
        normalizer is the receiver-side weight sum — computing it from
        the f32 band BEFORE quantization keeps the mean denominator
        exact; only the message numerator is rounded.

        ``feature_major`` (pure-band adjacency only): transposed-tile
        form for :func:`~connectome_gnn_jax.ops.banded_quant.
        banded_spmm_quant_fm`; activations then stay ``[F, N]``
        across layers in :meth:`apply_quantized`.  Hybrid adjacencies
        stay row-major.
        """
        from connectome_gnn_jax.ops.banded_quant import (
            quantize_band,
            quantize_hybrid,
            to_feature_major,
        )

        if isinstance(adjacency, HybridMatrix):
            return quantize_hybrid(adjacency), hybrid_row_sum(adjacency)
        q = quantize_band(adjacency)
        return (to_feature_major(q) if feature_major else q), banded_row_sum(
            adjacency
        )

    def apply_quantized(
        self,
        params: dict,
        state: dict,
        adj_q,
        w_sum: jnp.ndarray,
        x: jnp.ndarray,
        *,
        node_mask: Optional[jnp.ndarray] = None,
    ) -> tuple[jnp.ndarray, dict]:
        """Inference forward over a :func:`prepare_quantized` adjacency
        (serving-only; BN uses running statistics)."""
        from connectome_gnn_jax.ops.banded_quant import (
            QuantizedBandedMatrixFM,
            QuantizedHybridMatrix,
            banded_spmm_quant,
            hybrid_spmm_quant,
        )

        if isinstance(adj_q, QuantizedBandedMatrixFM):
            return self._forward_quant_fm(params, state, adj_q, w_sum, x)
        spmm = (
            hybrid_spmm_quant
            if isinstance(adj_q, QuantizedHybridMatrix)
            else banded_spmm_quant
        )
        return self._forward(
            params, state, spmm, adj_q, w_sum, x,
            node_mask=node_mask, train=False, rng=None,
        )

    def _forward_quant_fm(
        self, params, state, adj_q, w_sum, x
    ) -> tuple[jnp.ndarray, dict]:
        """Layout-persistent quantized serving (feature-major activations;
        see ``BandedNodeGCN._forward_quant_fm``).  The concat-aggregate
        becomes an axis-0 concatenation in ``[F, N]`` layout; eval-mode
        semantics identical to :meth:`_forward`."""
        from connectome_gnn_jax.nn.layers import batch_norm_eval_fm
        from connectome_gnn_jax.ops.banded_quant import banded_spmm_quant_fm

        n = adj_q.num_nodes
        w_sumT = w_sum[None, :n]

        hT = x[:n].T
        for i in range(self.num_layers):
            aggT = banded_spmm_quant_fm(adj_q, hT) / (
                w_sumT + EPS
            )
            catT = jnp.concatenate([hT, aggT], axis=0)
            hT = jnp.dot(
                params["convs"][i]["kernel"].T, catT,
                preferred_element_type=jnp.float32,
            )
            if "bias" in params["convs"][i]:
                hT = hT + params["convs"][i]["bias"][:, None]
            hT = jax.nn.relu(hT)
            hT = batch_norm_eval_fm(params["norms"][i], state["norms"][i], hT)
            # reference SAGE asymmetry: no post-BN ReLU (models.py:256-262)
        logits_T = jnp.dot(
            params["head"]["kernel"].T, hT,
            preferred_element_type=jnp.float32,
        )
        if "bias" in params["head"]:
            logits_T = logits_T + params["head"]["bias"][:, None]
        return logits_T.T, {"norms": state["norms"]}

    def _forward(
        self, params, state, spmm, adjacency, w_sum, x,
        *, node_mask, train, rng,
    ) -> tuple[jnp.ndarray, dict]:
        n = adjacency.num_nodes
        if node_mask is None:
            node_mask = jnp.ones((n,), bool)
        w_sum = w_sum[:n][:, None]

        h = x[:n]
        new_norms = []
        drop_keys = (
            jax.random.split(rng, self.num_layers)
            if (train and rng is not None)
            else [None] * self.num_layers
        )
        for i in range(self.num_layers):
            agg = spmm(adjacency, h)[:n] / (w_sum + EPS)
            h = jax.nn.relu(
                dense_apply(params["convs"][i], jnp.concatenate([h, agg], axis=1))
            )
            h, bn_state = batch_norm_apply(
                params["norms"][i], state["norms"][i], h, node_mask, train=train
            )
            new_norms.append(bn_state)
            # reference SAGE asymmetry: no post-BN ReLU (models.py:256-262)
            h = dropout(drop_keys[i], h, self.dropout, train=train)
        logits = dense_apply(params["head"], h)
        return logits, {"norms": new_norms}
