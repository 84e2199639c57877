"""GCN symmetric normalization (degree + SDDMM-style edge reweighting).

Implements the weighted Kipf-Welling normalization used by the reference GCN
layer (reference ``connectome_gnn/models.py:94-108``):

    Â = A_w + I                      (self-loops, weight 1.0)
    d_i = Σ_j Â_ij                   (weighted degree over senders)
    ŵ_ij = d_i^{-1/2} · Â_ij · d_j^{-1/2}

Static-shape formulation: the reference materializes the self-loop-augmented
edge list by concatenation (models.py:94-100) and scatters over it.  Here the
self-loop block is folded out algebraically instead:

* degree: ``deg = segment_sum(w, senders) + self_loop_weight`` — the
  self-loops contribute exactly one ``self_loop_weight`` per node;
* aggregation: the self-loop term is ``d_i^{-1} · w_self · (xW)_i``, a pure
  elementwise rescale that XLA fuses for free.

This keeps the edge list untouched (so receiver-sorted CSR order survives
for the fast segment-sum / Pallas paths) and removes two O(P) concats per
layer.  Padded edges carry weight 0 → contribute nothing; padded node slots
get ``deg = self_loop_weight`` and stay inert.

The per-edge reweighting is a gather-gather-multiply — an SDDMM-shaped op
that XLA fuses into one elementwise pass over the edge list.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

EPS = 1e-8


class GCNNorm(NamedTuple):
    """Symmetric GCN normalization factors for a (padded) edge list.

    ``edge_norm [Q]`` are the normalized off-diagonal weights ŵ_ij;
    ``self_norm [P]`` is the per-node self-loop coefficient
    ``d_i^{-1/2} · w_self · d_i^{-1/2}``; ``deg_inv_sqrt [P]`` is kept for
    diagnostics and custom kernels.
    """

    edge_norm: jnp.ndarray
    self_norm: jnp.ndarray
    deg_inv_sqrt: jnp.ndarray


def gcn_normalize(
    senders: jnp.ndarray,
    receivers: jnp.ndarray,
    edge_weight: jnp.ndarray,
    num_nodes: int,
    *,
    self_loop_weight: float = 1.0,
    eps: float = EPS,
) -> GCNNorm:
    """Compute self-loop-augmented symmetric normalization factors.

    Numerics match the reference sequence: weighted degree over senders of
    the augmented edge list (models.py:103-104), ``(deg + 1e-8)^-0.5``
    (models.py:105), per-edge ``d^-1/2 · w · d^-1/2`` (models.py:108).
    """
    # Degrees reduce over SENDERS, which are unsorted even in CSR batches
    # (only receivers are sorted) — hence no indices_are_sorted fast path.
    deg = (
        jax.ops.segment_sum(
            edge_weight,
            senders,
            num_segments=num_nodes,
            indices_are_sorted=False,
        )
        + self_loop_weight
    )
    deg_inv_sqrt = jax.lax.rsqrt(deg + eps)
    edge_norm = deg_inv_sqrt[senders] * edge_weight * deg_inv_sqrt[receivers]
    self_norm = deg_inv_sqrt * deg_inv_sqrt * self_loop_weight
    return GCNNorm(edge_norm, self_norm, deg_inv_sqrt)
