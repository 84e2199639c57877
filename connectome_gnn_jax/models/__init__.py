"""Model families: GCN and GraphSAGE connectome classifiers."""

from connectome_gnn_jax.models.compat import params_from_reference_state_dict
from connectome_gnn_jax.models.connectome import (
    GCNConnectome,
    GraphSAGEConnectome,
)
from connectome_gnn_jax.models.node_coo import (BlockedNodeGCN,
                                                 BlockedNodeSAGE, NodeGCN,
                                                 NodeSAGE)
from connectome_gnn_jax.models.node_gcn import BandedNodeGCN
from connectome_gnn_jax.models.node_sage import BandedNodeSAGE
from connectome_gnn_jax.models.layers import (
    gcn_layer_apply,
    gcn_layer_init,
    sage_layer_apply,
    sage_layer_init,
)

__all__ = [
    "BandedNodeGCN",
    "BlockedNodeGCN",
    "BlockedNodeSAGE",
    "NodeGCN",
    "NodeSAGE",
    "BandedNodeSAGE",
    "GCNConnectome",
    "GraphSAGEConnectome",
    "gcn_layer_apply",
    "gcn_layer_init",
    "params_from_reference_state_dict",
    "sage_layer_apply",
    "sage_layer_init",
]
