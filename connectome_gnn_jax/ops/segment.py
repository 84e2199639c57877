"""Segment reduction primitives.

These are the message-passing kernels of the framework — the
replacement for the reference's ``scatter_add_``-based helpers
(reference ``connectome_gnn/models.py:40-59``).  They are expressed with
``jax.ops.segment_sum`` so XLA lowers them to sorted-segment reductions;
batches built by :func:`~connectome_gnn_jax.data.batch.collate_graphs` sort
edges by receiver, so callers should pass ``indices_are_sorted=True`` on the
edge→node reductions to unlock the fast lowering.

The numerical contract matches the reference exactly: means divide by
``count + 1e-8`` (models.py:47), never by a clamped count.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

EPS = 1e-8


def segment_sum(
    data: jnp.ndarray,
    segment_ids: jnp.ndarray,
    num_segments: int,
    *,
    indices_are_sorted: bool = False,
) -> jnp.ndarray:
    """Sum ``data`` rows into ``num_segments`` buckets.

    Out-of-range ids (used for padding) are dropped — this is what makes the
    batch's ``node_graph_ids == num_graphs`` padding convention inert.
    """
    return jax.ops.segment_sum(
        data,
        segment_ids,
        num_segments=num_segments,
        indices_are_sorted=indices_are_sorted,
    )


def segment_mean(
    data: jnp.ndarray,
    segment_ids: jnp.ndarray,
    num_segments: int,
    *,
    indices_are_sorted: bool = False,
    eps: float = EPS,
) -> jnp.ndarray:
    """Mean of ``data`` rows per segment, with the reference's ``+eps``
    denominator (models.py:40-47)."""
    totals = segment_sum(
        data, segment_ids, num_segments, indices_are_sorted=indices_are_sorted
    )
    ones = jnp.ones((data.shape[0], 1), dtype=data.dtype)
    counts = segment_sum(
        ones, segment_ids, num_segments, indices_are_sorted=indices_are_sorted
    )
    return totals / (counts + eps)


def graph_mean_pool(
    node_emb: jnp.ndarray,
    node_graph_ids: jnp.ndarray,
    num_graphs: int,
    *,
    indices_are_sorted: bool = True,
) -> jnp.ndarray:
    """Mean-pool node embeddings per graph → ``[num_graphs, F]``.

    Padded nodes carry graph id ``num_graphs`` and drop out of both the sum
    and the count, so the mean is over real nodes only (matching the
    reference's unpadded pooling, models.py:57-59).
    """
    return segment_mean(
        node_emb,
        node_graph_ids,
        num_graphs,
        indices_are_sorted=indices_are_sorted,
    )


def coo_spmm(
    values: jnp.ndarray,
    senders: jnp.ndarray,
    receivers: jnp.ndarray,
    features: jnp.ndarray,
    num_nodes: int,
    *,
    indices_are_sorted: bool = True,
    edge_chunk: int | None = None,
) -> jnp.ndarray:
    """Sparse-matrix × dense-matrix product in COO form.

    Computes ``out[i] = Σ_{e : receivers[e]=i} values[e] * features[senders[e]]``
    — the gather→scale→segment-sum sequence that is the heart of both GCN
    aggregation (models.py:112-113) and SAGE neighbour sums (models.py:146-149).
    Padded edges must carry ``values == 0``.

    ``edge_chunk`` bounds device memory for GIANT edge lists: XLA
    materializes the gathered messages (``E·F·4`` bytes — 10 GB at 40M
    edges / F=64, past a 16 GB chip), so above the chunk size the edge
    list is processed in fixed-size slices scatter-added into the output
    carry.  The op is random-row latency bound (~13 ns/edge), so
    chunking costs nothing measurable; f32 accumulation order changes
    (same tolerance class as any resharding).  Edges are zero-padded up
    to a chunk multiple — inert by the ``values == 0`` padding contract.
    """
    E = values.shape[0]
    if edge_chunk is None or E <= int(edge_chunk):
        messages = features[senders] * values[:, None]
        return segment_sum(
            messages, receivers, num_nodes,
            indices_are_sorted=indices_are_sorted,
        )

    chunk = int(edge_chunk)
    pad = (-E) % chunk
    if pad:
        values = jnp.concatenate([values, jnp.zeros((pad,), values.dtype)])
        senders = jnp.concatenate(
            [senders, jnp.zeros((pad,), senders.dtype)]
        )
        receivers = jnp.concatenate(
            [receivers, jnp.full((pad,), num_nodes, receivers.dtype)]
        )
    num_chunks = (E + pad) // chunk

    def body(i, out):
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, i * chunk, chunk)
        msgs = features[sl(senders)] * sl(values)[:, None]
        # extra row absorbs padding / out-of-range ids, dropped at the end
        return out.at[jnp.minimum(sl(receivers), num_nodes)].add(
            msgs, indices_are_sorted=indices_are_sorted, mode="drop"
        )

    out = jax.lax.fori_loop(
        0, num_chunks, body,
        jnp.zeros((num_nodes + 1, features.shape[1]), features.dtype),
    )
    return out[:num_nodes]


def sddmm(
    x: jnp.ndarray,
    y: jnp.ndarray,
    senders: jnp.ndarray,
    receivers: jnp.ndarray,
) -> jnp.ndarray:
    """Sampled dense-dense matrix multiply over an edge list.

    ``out[e] = x[receivers[e]] · y[senders[e]]`` — per-edge dot products of
    node embeddings, the standard sparse-attention / edge-scoring primitive
    (the normalization in :mod:`ops.gcn_norm` is the rank-1 special case).
    XLA fuses the two gathers and the contraction into one pass over the
    edge list.
    """
    return jnp.sum(x[receivers] * y[senders], axis=-1)
