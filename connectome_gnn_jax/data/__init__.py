"""Data layer: host-side graphs, padded device batches, loaders, synthesis."""

from connectome_gnn_jax.data.atlas import NUM_REGIONS, REGION_NAMES
from connectome_gnn_jax.data.batch import ConnectomeBatch, collate_graphs, round_up, to_device
from connectome_gnn_jax.data.dense import DenseConnectomeBatch, collate_dense
from connectome_gnn_jax.data.device_sampling import (
    DeviceGraphCSR,
    cap_in_degree_mask,
    DeviceSampledModel,
    DeviceSeedLoader,
    SeedBatch,
    device_sample,
    device_sampled_gcn,
    device_sampled_sage,
    make_epoch_runner,
    make_seed_batch,
    pack_epoch,
    pack_epoch_sharded,
)
from connectome_gnn_jax.data.graph import ConnectomeGraph
from connectome_gnn_jax.data.io import graph_from_adjacency, load_dataset, save_dataset
from connectome_gnn_jax.data.layout import (
    LayoutPlan,
    auto_layout,
    build_layout,
    plan_layout,
)
from connectome_gnn_jax.data.loader import ConnectomeDataLoader
from connectome_gnn_jax.data.prefetch import PrefetchIterator, PrefetchLoader
from connectome_gnn_jax.data.sampled import (
    HopBlock,
    SampledNodeBatch,
    SampledNodeLoader,
    collate_sampled,
    fanout_budgets,
    full_graph_batch,
)
from connectome_gnn_jax.data.sampling import (
    NeighborSampler,
    sample_subgraph,
    sample_subgraph_fast,
)
from connectome_gnn_jax.data.synthetic import (
    TRAIT_NAMES,
    generate_connectome,
    generate_dataset,
    generate_spatial_graph,
    small_world_stats,
)

__all__ = [
    "NUM_REGIONS",
    "REGION_NAMES",
    "TRAIT_NAMES",
    "ConnectomeBatch",
    "ConnectomeGraph",
    "ConnectomeDataLoader",
    "DenseConnectomeBatch",
    "DeviceGraphCSR",
    "cap_in_degree_mask",
    "DeviceSampledModel",
    "DeviceSeedLoader",
    "SeedBatch",
    "device_sample",
    "device_sampled_gcn",
    "device_sampled_sage",
    "make_epoch_runner",
    "make_seed_batch",
    "pack_epoch",
    "pack_epoch_sharded",
    "LayoutPlan",
    "PrefetchIterator",
    "PrefetchLoader",
    "auto_layout",
    "build_layout",
    "plan_layout",
    "collate_dense",
    "collate_graphs",
    "graph_from_adjacency",
    "load_dataset",
    "save_dataset",
    "NeighborSampler",
    "HopBlock",
    "SampledNodeBatch",
    "SampledNodeLoader",
    "collate_sampled",
    "fanout_budgets",
    "full_graph_batch",
    "sample_subgraph",
    "sample_subgraph_fast",
    "generate_connectome",
    "generate_dataset",
    "generate_spatial_graph",
    "round_up",
    "small_world_stats",
    "to_device",
]
