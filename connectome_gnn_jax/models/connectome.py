"""Full connectome classification models: GCN and GraphSAGE.

Architecture (reference ``connectome_gnn/models.py:159-266``):

    node features → conv × L (with BatchNorm / activation / dropout)
                  → masked mean-pool per graph
                  → MLP head (Linear → ReLU → Dropout → Linear) → logits

Behavioral asymmetry preserved from the reference: GCN's encode applies an
explicit ReLU after BatchNorm (models.py:209) while SAGE's does not — its
ReLU lives inside the SAGE layer (models.py:152 vs 256-262).

Models are hyperparameter holders with pure ``init`` / ``apply`` / ``encode``
methods: parameters and BatchNorm running stats are explicit pytrees, PRNG
keys are threaded explicitly for dropout, and ``axis_name`` plumbs the
data-parallel axis into BatchNorm for cross-device batch statistics.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from connectome_gnn_jax.data.batch import ConnectomeBatch
from connectome_gnn_jax.data.dense import DenseConnectomeBatch
from connectome_gnn_jax.models.layers import (
    gcn_layer_apply,
    gcn_layer_apply_dense,
    gcn_layer_init,
    sage_layer_apply,
    sage_layer_apply_dense,
    sage_layer_init,
)
from connectome_gnn_jax.nn.layers import (
    batch_norm_apply,
    batch_norm_init,
    dense_apply,
    dense_init,
    dropout,
)
from connectome_gnn_jax.ops.segment import graph_mean_pool


class _ConnectomeModel:
    """Shared skeleton for connectome graph classifiers."""

    #: (key, in, out) -> params     — set by subclasses
    _layer_init: Callable
    #: (params, x, senders, receivers, w) -> x'   (COO/CSR path)
    _layer_apply: Callable
    #: (params, x [B,n,F], adj [B,n,n]) -> x'     (dense matmul path)
    _dense_layer_apply: Callable
    #: whether encode applies an explicit ReLU after BatchNorm
    _relu_after_norm: bool

    def __init__(
        self,
        in_channels: int,
        hidden_dim: int = 64,
        num_classes: int = 2,
        num_layers: int = 3,
        dropout: float = 0.3,
        compute_dtype=jnp.float32,
    ):
        """``compute_dtype=jnp.bfloat16`` enables mixed precision on the
        dense matmul path (bf16 matmul operands, f32 accumulation and
        statistics); parameters and the COO path stay f32."""
        self.in_channels = int(in_channels)
        self.hidden_dim = int(hidden_dim)
        self.num_classes = int(num_classes)
        self.num_layers = int(num_layers)
        self.dropout = float(dropout)
        self.compute_dtype = compute_dtype

    # ------------------------------------------------------------------
    # Init
    # ------------------------------------------------------------------

    def init(self, key: jax.Array) -> tuple[dict, dict]:
        """Returns ``(params, state)`` pytrees.

        ``params["convs"]`` is a list of per-layer conv params,
        ``params["norms"]`` the BatchNorm affine params, ``params["head"]``
        the two MLP head layers; ``state["norms"]`` holds BatchNorm running
        moments.
        """
        dims = [self.in_channels] + [self.hidden_dim] * self.num_layers
        keys = jax.random.split(key, self.num_layers + 2)

        convs = [
            type(self)._layer_init(keys[i], dims[i], dims[i + 1])
            for i in range(self.num_layers)
        ]
        norm_params, norm_states = zip(
            *(batch_norm_init(self.hidden_dim) for _ in range(self.num_layers))
        )
        head = {
            "fc1": dense_init(
                keys[self.num_layers], self.hidden_dim, self.hidden_dim // 2
            ),
            "fc2": dense_init(
                keys[self.num_layers + 1], self.hidden_dim // 2, self.num_classes
            ),
        }
        params = {"convs": list(convs), "norms": list(norm_params), "head": head}
        state = {"norms": list(norm_states)}
        return params, state

    def num_params(self, params: dict) -> int:
        return sum(int(p.size) for p in jax.tree_util.tree_leaves(params))

    # ------------------------------------------------------------------
    # Forward
    # ------------------------------------------------------------------

    def encode(
        self,
        params: dict,
        state: dict,
        batch: ConnectomeBatch,
        *,
        train: bool = False,
        rng: Optional[jax.Array] = None,
        axis_name: Optional[str] = None,
    ) -> tuple[jnp.ndarray, dict]:
        """Graph-level embeddings ``[B, hidden_dim]`` plus updated BN state.

        Dispatches on the batch layout: COO/CSR (:class:`ConnectomeBatch`,
        general path) or dense adjacency (:class:`DenseConnectomeBatch`,
        matmul path) — identical numerics either way.
        """
        if isinstance(batch, DenseConnectomeBatch):
            return self._encode_dense(
                params, state, batch, train=train, rng=rng, axis_name=axis_name
            )
        x = batch.node_features
        new_norm_states = []
        drop_keys = (
            jax.random.split(rng, self.num_layers)
            if (train and rng is not None)
            else [None] * self.num_layers
        )
        for i in range(self.num_layers):
            x = type(self)._layer_apply(
                params["convs"][i],
                x,
                batch.senders,
                batch.receivers,
                batch.edge_weight,
            )
            x, bn_state = batch_norm_apply(
                params["norms"][i],
                state["norms"][i],
                x,
                batch.node_mask,
                train=train,
                axis_name=axis_name,
            )
            new_norm_states.append(bn_state)
            if type(self)._relu_after_norm:
                x = jax.nn.relu(x)
            x = dropout(drop_keys[i], x, self.dropout, train=train)
        pooled = graph_mean_pool(x, batch.node_graph_ids, batch.num_graphs)
        return pooled, {"norms": new_norm_states}

    def _encode_dense(
        self,
        params: dict,
        state: dict,
        batch: DenseConnectomeBatch,
        *,
        train: bool = False,
        rng: Optional[jax.Array] = None,
        axis_name: Optional[str] = None,
    ) -> tuple[jnp.ndarray, dict]:
        """Dense-adjacency encode: batched-matmul aggregation."""
        B, n, _ = batch.node_features.shape
        x = batch.node_features
        flat_mask = batch.node_mask.reshape(B * n)
        new_norm_states = []
        drop_keys = (
            jax.random.split(rng, self.num_layers)
            if (train and rng is not None)
            else [None] * self.num_layers
        )
        for i in range(self.num_layers):
            x = type(self)._dense_layer_apply(
                params["convs"][i], x, batch.adj, compute_dtype=self.compute_dtype
            )
            flat, bn_state = batch_norm_apply(
                params["norms"][i],
                state["norms"][i],
                x.reshape(B * n, -1),
                flat_mask,
                train=train,
                axis_name=axis_name,
            )
            x = flat.reshape(B, n, -1)
            new_norm_states.append(bn_state)
            if type(self)._relu_after_norm:
                x = jax.nn.relu(x)
            x = dropout(drop_keys[i], x, self.dropout, train=train)
        # Masked mean-pool per graph (same +1e-8 denominator as the
        # segment-mean pooling, reference models.py:47).
        m = batch.node_mask.astype(x.dtype)[:, :, None]
        pooled = jnp.sum(x * m, axis=1) / (jnp.sum(m, axis=1) + 1e-8)
        return pooled, {"norms": new_norm_states}

    def apply(
        self,
        params: dict,
        state: dict,
        batch: ConnectomeBatch,
        *,
        train: bool = False,
        rng: Optional[jax.Array] = None,
        axis_name: Optional[str] = None,
    ) -> tuple[jnp.ndarray, dict]:
        """Class logits ``[B, num_classes]`` plus updated BN state."""
        if train and rng is not None:
            rng, head_key = jax.random.split(rng)
        else:
            head_key = None
        emb, new_state = self.encode(
            params, state, batch, train=train, rng=rng, axis_name=axis_name
        )
        h = jax.nn.relu(dense_apply(params["head"]["fc1"], emb))
        h = dropout(head_key, h, self.dropout, train=train)
        logits = dense_apply(params["head"]["fc2"], h)
        return logits, new_state

    __call__ = apply


class GCNConnectome(_ConnectomeModel):
    """L-layer weighted GCN classifier (reference models.py:159-216).

    Encode sequence per layer: conv → BatchNorm → ReLU → dropout.
    """

    _layer_init = staticmethod(gcn_layer_init)
    _layer_apply = staticmethod(gcn_layer_apply)
    _dense_layer_apply = staticmethod(gcn_layer_apply_dense)
    _relu_after_norm = True


class GraphSAGEConnectome(_ConnectomeModel):
    """L-layer weighted GraphSAGE classifier (reference models.py:219-266).

    Encode sequence per layer: conv → BatchNorm → dropout (no extra ReLU —
    the nonlinearity lives inside the SAGE layer).
    """

    _layer_init = staticmethod(sage_layer_init)
    _layer_apply = staticmethod(sage_layer_apply)
    _dense_layer_apply = staticmethod(sage_layer_apply_dense)
    _relu_after_norm = False
