"""Neural-net building blocks: dense, masked BatchNorm, dropout, initializers."""

from connectome_gnn_jax.nn.initializers import (
    torch_linear_bias,
    torch_linear_kernel,
    xavier_uniform,
)
from connectome_gnn_jax.nn.layers import (
    batch_norm_apply,
    batch_norm_init,
    dense_apply,
    dense_init,
    dropout,
    xavier_dense_init,
)

__all__ = [
    "batch_norm_apply",
    "batch_norm_init",
    "dense_apply",
    "dense_init",
    "dropout",
    "torch_linear_bias",
    "torch_linear_kernel",
    "xavier_dense_init",
    "xavier_uniform",
]
