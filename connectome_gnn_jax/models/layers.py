"""Message-passing layers: GCN and GraphSAGE convolutions.

Pure init/apply function pairs over explicit parameter pytrees, operating on
the padded COO batch layout.  Numeric contract (reference
``connectome_gnn/models.py``):

* ``GCNLayer``: weighted symmetric-normalized convolution
  ``H' = D̂^{-1/2} Â D̂^{-1/2} (H W) + b`` with self-loop weight 1.0,
  Xavier-uniform kernel, zero-init bias added *after* aggregation
  (models.py:78-114).
* ``SAGELayer``: weighted-mean neighbour aggregation, concat with self
  features, single linear + ReLU; Xavier kernel with torch-default bias and
  no self-loops (models.py:121-152).

Both use the ``+1e-8`` epsilon denominators of the reference.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from connectome_gnn_jax.nn.initializers import xavier_uniform
from connectome_gnn_jax.nn.layers import dense_apply, xavier_dense_init
from connectome_gnn_jax.ops.gcn_norm import gcn_normalize
from connectome_gnn_jax.ops.segment import coo_spmm, segment_sum

EPS = 1e-8


# ---------------------------------------------------------------------------
# GCN
# ---------------------------------------------------------------------------


def gcn_layer_init(key: jax.Array, in_channels: int, out_channels: int) -> dict:
    """Xavier-uniform kernel ``[in, out]`` + zero bias (models.py:78-82)."""
    return {
        "kernel": xavier_uniform(key, in_channels, out_channels),
        "bias": jnp.zeros((out_channels,), jnp.float32),
    }


def gcn_layer_apply(
    params: dict,
    x: jnp.ndarray,
    senders: jnp.ndarray,
    receivers: jnp.ndarray,
    edge_weight: jnp.ndarray,
    *,
    indices_are_sorted: bool = True,
) -> jnp.ndarray:
    """Symmetric-normalized weighted graph convolution.

    Transform-then-aggregate (models.py:111-113): the dense transform runs
    as a matmul at width ``out_channels``; aggregation is a gather-scale-
    segment-sum over the receiver-sorted edge list, with the self-loop block
    folded into an elementwise rescale (see :mod:`ops.gcn_norm`).
    """
    num_nodes = x.shape[0]
    norm = gcn_normalize(senders, receivers, edge_weight, num_nodes)
    xw = jnp.dot(x, params["kernel"], preferred_element_type=jnp.float32)
    out = coo_spmm(
        norm.edge_norm,
        senders,
        receivers,
        xw,
        num_nodes,
        indices_are_sorted=indices_are_sorted,
    )
    out = out + norm.self_norm[:, None] * xw
    return out + params["bias"]


def gcn_layer_apply_blocked(
    params: dict,
    x: jnp.ndarray,
    hop_blocks,
    num_seeds: int,
) -> jnp.ndarray:
    """:func:`gcn_layer_apply` over the device sampler's per-hop
    [frontier, fanout] blocks — same math, fewer random-access passes.

    The flat path pays an edge-count scatter per layer forward (the
    segment-sum) and an edge-count gather per layer backward (the
    cotangent pickup at receivers).  In the blocked layout every hop's
    receivers are blockwise-constant, so aggregation is a reshape-sum
    per block plus a FRONTIER-count scatter (hop 0's is a pure slice —
    its receivers are ``arange(num_seeds)`` by construction), and the
    backward gather becomes a broadcast.  Only the sender-side accesses
    (feature gather forward, feature scatter backward), which exist in
    any layout, remain at edge count.  Numerics match the flat path up
    to summation order (per-block partial sums instead of a sequential
    segment sum).
    """
    num_nodes = x.shape[0]
    snd_flat = jnp.concatenate([b.senders.reshape(-1) for b in hop_blocks])
    w_flat = jnp.concatenate([b.weights.reshape(-1) for b in hop_blocks])
    deg = (
        jax.ops.segment_sum(
            w_flat, snd_flat, num_segments=num_nodes,
            indices_are_sorted=False,
        )
        + 1.0
    )
    dis = jax.lax.rsqrt(deg + EPS)
    xw = jnp.dot(x, params["kernel"], preferred_element_type=jnp.float32)
    out = (dis * dis)[:, None] * xw  # self-loop term (weight 1.0)
    for h, b in enumerate(hop_blocks):
        recv_dis = dis[:num_seeds] if h == 0 else dis[b.recv]
        e = dis[b.senders] * b.weights * recv_dis[:, None]  # [Fb, f]
        part = jnp.einsum(
            "bf,bfc->bc", e, xw[b.senders],
            preferred_element_type=jnp.float32,
        )
        if h == 0:
            out = out.at[:num_seeds].add(part)
        else:
            out = out.at[b.recv].add(part)
    return out + params["bias"]


# ---------------------------------------------------------------------------
# GraphSAGE
# ---------------------------------------------------------------------------


def sage_layer_init(key: jax.Array, in_channels: int, out_channels: int) -> dict:
    """Xavier kernel over concat(self, agg) with torch-default bias
    (models.py:130-134)."""
    return xavier_dense_init(key, 2 * in_channels, out_channels)


def sage_layer_apply(
    params: dict,
    x: jnp.ndarray,
    senders: jnp.ndarray,
    receivers: jnp.ndarray,
    edge_weight: jnp.ndarray,
    *,
    indices_are_sorted: bool = True,
) -> jnp.ndarray:
    """Weighted-mean aggregate → concat → linear → ReLU (models.py:136-152)."""
    num_nodes = x.shape[0]
    msg_sum = coo_spmm(
        edge_weight,
        senders,
        receivers,
        x,
        num_nodes,
        indices_are_sorted=indices_are_sorted,
    )
    w_sum = segment_sum(
        edge_weight[:, None],
        receivers,
        num_nodes,
        indices_are_sorted=indices_are_sorted,
    )
    agg = msg_sum / (w_sum + EPS)
    combined = jnp.concatenate([x, agg], axis=1)
    return jax.nn.relu(dense_apply(params, combined))


def sage_layer_apply_blocked(
    params: dict,
    x: jnp.ndarray,
    hop_blocks,
    num_seeds: int,
) -> jnp.ndarray:
    """:func:`sage_layer_apply` over the device sampler's per-hop
    [frontier, fanout] blocks — same math, fewer random-access passes.

    In the blocked layout every hop's receivers are blockwise-constant
    (and each local node receives edges in exactly ONE hop — the hop
    whose frontier discovered it), so the weighted-mean numerator and
    denominator reduce per block row (``einsum`` / row-sum) and land via
    a frontier-count scatter; hop 0's lands via a pure slice.  Only the
    sender-side feature gather (and its backward scatter), which exist
    in any layout, remain at edge count.  Numerics match the flat path
    up to summation order.
    """
    num_nodes = x.shape[0]
    msg = jnp.zeros(x.shape, jnp.float32)
    w_sum = jnp.zeros((num_nodes,), jnp.float32)
    for h, b in enumerate(hop_blocks):
        Fb, f = b.weights.shape
        s0 = getattr(b, "sender_start", None)
        if isinstance(s0, int):
            # multiset mode: senders are the draws' own contiguous slots
            # — a static slice, no random access.  Invalid draws read
            # their own (zeroed) slot instead of the receiver row the
            # flat path reads, but carry weight 0 either way.
            xs = x[s0 : s0 + Fb * f].reshape(Fb, f, -1)
        else:
            xs = x[b.senders]
        part = jnp.einsum(
            "bf,bfc->bc", b.weights, xs,
            preferred_element_type=jnp.float32,
        )
        wrow = jnp.sum(b.weights, axis=1)
        r0 = getattr(b, "recv_start", None)
        if h == 0:
            msg = msg.at[:num_seeds].add(part)
            w_sum = w_sum.at[:num_seeds].add(wrow)
        elif isinstance(r0, int):
            # multiset mode: receivers are the frontier's contiguous
            # slots — a static slice-add, no scatter
            msg = msg.at[r0 : r0 + Fb].add(part)
            w_sum = w_sum.at[r0 : r0 + Fb].add(wrow)
        else:
            msg = msg.at[b.recv].add(part)
            w_sum = w_sum.at[b.recv].add(wrow)
    agg = msg / (w_sum + EPS)[:, None]
    combined = jnp.concatenate([x, agg], axis=1)
    return jax.nn.relu(dense_apply(params, combined))


# ---------------------------------------------------------------------------
# Dense (batched-matmul) variants — same math over the [B, n, n] layout
# ---------------------------------------------------------------------------


def gcn_layer_apply_dense(
    params: dict,
    x: jnp.ndarray,
    adj: jnp.ndarray,
    *,
    compute_dtype=jnp.float32,
) -> jnp.ndarray:
    """GCN convolution over dense receiver-major adjacency ``[B, n, n]``.

    Identical numerics to :func:`gcn_layer_apply` (degree over senders,
    self-loop weight 1.0, ``(deg + 1e-8)^-0.5``), expressed as a batched
    matmul.  The normalization is the same
    for every layer of a forward pass; XLA CSEs the recomputation.

    ``compute_dtype=jnp.bfloat16`` runs the matmul operands in bf16 with
    f32 accumulation; normalization and statistics stay
    f32.  Output is always f32.
    """
    # Out-degree of sender j = column sum over receivers i, plus self-loop.
    # Degree/normalization in f32 regardless of compute dtype.
    deg = jnp.sum(adj, axis=1, dtype=jnp.float32) + 1.0
    dinv = jax.lax.rsqrt(deg + EPS)  # [B, n]
    adj_norm = dinv[:, :, None] * adj * dinv[:, None, :]

    xw = jnp.dot(
        x.astype(compute_dtype),
        params["kernel"].astype(compute_dtype),
        preferred_element_type=jnp.float32,
    )
    out = (
        jnp.matmul(
            adj_norm.astype(compute_dtype),
            xw.astype(compute_dtype),
            preferred_element_type=jnp.float32,
        )
        + (dinv * dinv)[:, :, None] * xw
    )
    return out + params["bias"]


def sage_layer_apply_dense(
    params: dict,
    x: jnp.ndarray,
    adj: jnp.ndarray,
    *,
    compute_dtype=jnp.float32,
) -> jnp.ndarray:
    """SAGE convolution over dense adjacency: weighted-mean via matmul."""
    msg_sum = jnp.matmul(
        adj.astype(compute_dtype),
        x.astype(compute_dtype),
        preferred_element_type=jnp.float32,
    )
    w_sum = jnp.sum(adj, axis=-1, keepdims=True, dtype=jnp.float32)
    agg = msg_sum / (w_sum + EPS)
    combined = jnp.concatenate([x, agg], axis=-1)
    y = jnp.dot(
        combined.astype(compute_dtype),
        params["kernel"].astype(compute_dtype),
        preferred_element_type=jnp.float32,
    )
    if "bias" in params:
        y = y + params["bias"]
    return jax.nn.relu(y)
