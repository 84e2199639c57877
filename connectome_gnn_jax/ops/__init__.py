"""Compute ops: segment reductions, SpMM, GCN normalization, fused kernels.

Interchangeable implementations of the aggregation kernels:

* the XLA COO path (:mod:`segment`) — ``jax.ops.segment_sum`` based, the
  correctness oracle and general ragged-graph path;
* the banded block-dense path (:mod:`banded`) — batched matmuls for
  spatially-local giant graphs, with an int8-band variant
  (:mod:`banded_quant`);
* the fused Pallas path (:mod:`fused_pallas`) — whole-model GCN and
  GraphSAGE inference in a single Triton-route kernel over the dense
  batch layout.
"""

from connectome_gnn_jax.ops.banded import (
    BandedMatrix,
    HybridMatrix,
    banded_block_diag,
    banded_row_sum,
    banded_spmm,
    gcn_normalize_banded,
    gcn_normalize_hybrid,
    hybrid_block_diag,
    hybrid_row_sum,
    hybrid_spmm,
    to_banded,
    to_hybrid,
    transpose_banded,
)
from connectome_gnn_jax.ops.banded_quant import (
    QuantizedBandedMatrix,
    QuantizedBandedMatrixFM,
    QuantizedHybridMatrix,
    banded_spmm_quant,
    banded_spmm_quant_fm,
    banded_spmm_quant_fm_grad,
    banded_spmm_quant_fm_w8a8,
    quantize_activations_fm,
    transpose_quantized,
    banded_spmm_quant_xla,
    dequantize_band,
    hybrid_spmm_quant,
    quantize_band,
    quantize_hybrid,
    quantize_transposed_fm,
    to_feature_major,
)
from connectome_gnn_jax.ops.fused_pallas import (
    forward_auto,
    fused_gcn_forward,
    fused_kernel_for,
    fused_sage_forward,
)
from connectome_gnn_jax.ops.gcn_norm import GCNNorm, gcn_normalize
from connectome_gnn_jax.ops.segment import (
    coo_spmm,
    graph_mean_pool,
    sddmm,
    segment_mean,
    segment_sum,
)

__all__ = [
    "BandedMatrix",
    "HybridMatrix",
    "GCNNorm",
    "QuantizedBandedMatrix",
    "QuantizedBandedMatrixFM",
    "QuantizedHybridMatrix",
    "banded_block_diag",
    "banded_row_sum",
    "banded_spmm",
    "banded_spmm_quant",
    "banded_spmm_quant_fm",
    "banded_spmm_quant_fm_grad",
    "banded_spmm_quant_fm_w8a8",
    "quantize_activations_fm",
    "transpose_quantized",
    "banded_spmm_quant_xla",
    "dequantize_band",
    "hybrid_spmm_quant",
    "quantize_band",
    "quantize_hybrid",
    "quantize_transposed_fm",
    "coo_spmm",
    "forward_auto",
    "fused_gcn_forward",
    "fused_kernel_for",
    "fused_sage_forward",
    "gcn_normalize",
    "gcn_normalize_banded",
    "gcn_normalize_hybrid",
    "hybrid_block_diag",
    "hybrid_row_sum",
    "hybrid_spmm",
    "graph_mean_pool",
    "sddmm",
    "segment_mean",
    "segment_sum",
    "to_banded",
    "to_feature_major",
    "transpose_banded",
    "to_hybrid",
]
