"""connectome-gnn-jax: a GNN message-passing framework in JAX.

A from-scratch JAX/XLA/Pallas framework for brain-connectome graph
classification with the capabilities of the reference
``danieleschmidt/connectome-gnn-suite`` — same model family (weighted GCN and
GraphSAGE), same data contracts (COO connectome graphs, block-diagonal
packing, seed-reproducible Watts-Strogatz synthesis), same training behavior
(BatchNorm/dropout, mean-pool readout, Adam with early stopping and
best-weights restore) — redesigned for accelerators:

* padded, statically-shaped device batches (compile once, run forever);
* segment-sum / SpMM aggregation over receiver-sorted (CSR) edge lists,
  with interchangeable XLA and Pallas kernel backends;
* jit/shard_map training over named device meshes with exact cross-device
  BatchNorm statistics.

Quickstart
----------
    import optax
    from connectome_gnn_jax import (
        GCNConnectome, ConnectomeDataLoader, Trainer, generate_dataset)

    graphs = generate_dataset(num_subjects=200, seed=42)
    train_loader = ConnectomeDataLoader(graphs[:160], batch_size=16)
    val_loader = ConnectomeDataLoader(graphs[160:], batch_size=16, shuffle=False)

    model = GCNConnectome(in_channels=5, hidden_dim=64, num_classes=2)
    trainer = Trainer(model, optimizer=optax.adam(1e-3))
    history = trainer.fit(train_loader, val_loader, num_epochs=50, patience=10)
"""

from connectome_gnn_jax.data import (
    NUM_REGIONS,
    REGION_NAMES,
    ConnectomeBatch,
    ConnectomeDataLoader,
    ConnectomeGraph,
    collate_graphs,
    generate_connectome,
    generate_dataset,
    small_world_stats,
)
from connectome_gnn_jax.models import GCNConnectome, GraphSAGEConnectome
from connectome_gnn_jax.train import Trainer

__version__ = "0.1.0"

__all__ = [
    "NUM_REGIONS",
    "REGION_NAMES",
    "ConnectomeBatch",
    "ConnectomeDataLoader",
    "ConnectomeGraph",
    "GCNConnectome",
    "GraphSAGEConnectome",
    "Trainer",
    "collate_graphs",
    "generate_connectome",
    "generate_dataset",
    "small_world_stats",
    "__version__",
]
