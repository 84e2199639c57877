"""Training layer: trainer, optimizers, checkpointing, fault handling."""

from connectome_gnn_jax.train.checkpoint import restore_checkpoint, save_checkpoint
from connectome_gnn_jax.train.fault import PreemptionGuard
from connectome_gnn_jax.train.trainer import Trainer, reference_adam

__all__ = [
    "PreemptionGuard",
    "Trainer",
    "reference_adam",
    "restore_checkpoint",
    "save_checkpoint",
]
