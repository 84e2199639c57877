"""Node-level COO classifiers for sampled (and full-batch) giant graphs.

``NodeGCN`` / ``NodeSAGE`` run the same convolution stacks as the
graph-level models (reference layer math, ``connectome_gnn/models.py:66-152``)
over a :class:`~connectome_gnn_jax.data.sampled.SampledNodeBatch`, with a
per-node linear head read at the ``num_seeds`` SEED slots only — the
seed-supervised minibatch objective of GraphSAGE-style training.

``apply`` returns per-seed logits ``[S, C]`` against the batch's
``labels``/``label_mask``, so the standard :class:`~connectome_gnn_jax.
train.Trainer` drives sampled training and evaluation unchanged.  The
same model over :func:`~connectome_gnn_jax.data.sampled.full_graph_batch`
is the full-batch oracle sampled training is validated against
(``tests/test_sampled_training.py``).

Parameter pytrees are shared with the banded/partitioned node families
(:func:`~connectome_gnn_jax.models.node_gcn.init_node_gcn_params` /
:func:`~connectome_gnn_jax.models.node_sage.init_node_sage_params`), so
checkpoints move freely between the COO, banded, and sharded execution
paths of the same architecture.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from connectome_gnn_jax.data.sampled import SampledNodeBatch
from connectome_gnn_jax.models.layers import (gcn_layer_apply,
                                              gcn_layer_apply_blocked,
                                              sage_layer_apply,
                                              sage_layer_apply_blocked)
from connectome_gnn_jax.models.node_gcn import init_node_gcn_params
from connectome_gnn_jax.models.node_sage import init_node_sage_params
from connectome_gnn_jax.nn.layers import batch_norm_apply, dense_apply, dropout


class _NodeModel:
    """Shared skeleton: L convolutions + masked BatchNorm + per-node head,
    logits at the seed slots.

    ``Blocked*`` subclasses set ``_blocked_layer_apply``; when the batch
    carries the device sampler's per-hop ``hop_blocks``, the convolution
    runs through it (reshape-sums + frontier-count scatters instead of
    edge-count scatter/gather — see
    :func:`~connectome_gnn_jax.models.layers.gcn_layer_apply_blocked`),
    falling back to the flat COO path otherwise.  Same parameters, same
    math up to summation order; checkpoints are interchangeable."""

    _blocked_layer_apply = None

    def __init__(
        self,
        in_channels: int,
        hidden_dim: int = 64,
        num_classes: int = 2,
        num_layers: int = 2,
        dropout: float = 0.0,
    ):
        self.in_channels = int(in_channels)
        self.hidden_dim = int(hidden_dim)
        self.num_classes = int(num_classes)
        self.num_layers = int(num_layers)
        self.dropout = float(dropout)

    def apply(
        self,
        params: dict,
        state: dict,
        batch: SampledNodeBatch,
        *,
        train: bool = False,
        rng: Optional[jax.Array] = None,
        axis_name: Optional[str] = None,
    ) -> tuple[jnp.ndarray, dict]:
        """Per-seed logits ``[num_seeds, C]`` plus updated BN state."""
        blocked = (
            self._blocked_layer_apply is not None
            and batch.hop_blocks is not None
        )
        x = batch.node_features
        new_norms = []
        drop_keys = (
            jax.random.split(rng, self.num_layers)
            if (train and rng is not None)
            else [None] * self.num_layers
        )
        for i in range(self.num_layers):
            if blocked:
                x = self._blocked_layer_apply(
                    params["convs"][i], x, batch.hop_blocks,
                    batch.num_seeds,
                )
            else:
                x = self._layer_apply(
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
            new_norms.append(bn_state)
            if self._relu_after_norm:
                x = jax.nn.relu(x)
            x = dropout(drop_keys[i], x, self.dropout, train=train)
        logits = dense_apply(params["head"], x[: batch.num_seeds])
        return logits, {"norms": new_norms}

    __call__ = apply


class NodeGCN(_NodeModel):
    """L-layer node-classification GCN over sampled/full COO batches.

    Same per-layer math as :class:`GCNConnectome` (sym-norm conv → BN →
    ReLU → dropout), per-node linear head at seeds.
    """

    _layer_apply = staticmethod(gcn_layer_apply)
    _relu_after_norm = True

    def init(self, key: jax.Array) -> tuple[dict, dict]:
        return init_node_gcn_params(
            key, self.in_channels, self.hidden_dim, self.num_classes,
            self.num_layers,
        )


class BlockedNodeGCN(NodeGCN):
    """`NodeGCN` that aggregates through the device sampler's per-hop
    [frontier, fanout] blocks when the batch carries them (see
    :class:`_NodeModel`); checkpoints are interchangeable with
    :class:`NodeGCN`."""

    _blocked_layer_apply = staticmethod(gcn_layer_apply_blocked)


class NodeSAGE(_NodeModel):
    """L-layer node-classification GraphSAGE (ReLU inside the layer,
    none after BN — the reference asymmetry, models.py:256-262).

    ``multiset_safe``: SAGE aggregation is a receiver-side weighted
    mean, invariant to the multiset sampler's duplicated sender slots —
    the marker the multiset/graph-sharded wrappers allowlist on (GCN's
    sender-degree normalization is NOT invariant and must not carry
    it)."""

    _layer_apply = staticmethod(sage_layer_apply)
    _relu_after_norm = False
    multiset_safe = True

    def init(self, key: jax.Array) -> tuple[dict, dict]:
        return init_node_sage_params(
            key, self.in_channels, self.hidden_dim, self.num_classes,
            self.num_layers,
        )


class BlockedNodeSAGE(NodeSAGE):
    """`NodeSAGE` that aggregates through the device sampler's per-hop
    [frontier, fanout] blocks when the batch carries them (see
    :class:`_NodeModel`); checkpoints are interchangeable with
    :class:`NodeSAGE`."""

    _blocked_layer_apply = staticmethod(sage_layer_apply_blocked)
