"""Utilities: pytree dataclasses, profiling, the compile cache."""

from connectome_gnn_jax.utils.compile_cache import enable_compile_cache
from connectome_gnn_jax.utils.pytree import pytree_dataclass, static_field

__all__ = ["enable_compile_cache", "pytree_dataclass", "static_field"]
