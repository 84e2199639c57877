"""Fused Pallas kernels: whole-model GCN / GraphSAGE inference in one launch.

At connectome scale (batches of 84-node graphs), the math of a forward
pass is under a microsecond per graph, while XLA's plan for
``model.apply`` is a chain of small kernels, each paying a launch and a
round trip of its intermediates through device memory.  These kernels
run the ENTIRE eval-mode forward — L convolutions with folded BatchNorm
and ReLU, the masked mean-pool and the 2-layer MLP head — inside one
``pallas_call`` written for the Triton route.

Layout: one program per graph (``grid=(B,)``).  The program holds its
graph's ``[n, n]`` adjacency and ``[n, H]`` activations on chip from the
first convolution to the logits, so nothing crosses programs and the
head, which is row-wise per graph, runs in the same program.  Triton
wants power-of-two shapes and ``pl.dot`` operands of at least 16 along
every axis, so the wrapper zero-pads nodes, features, hidden and head
widths; padded nodes are masked out of the pool and padded channels stay
exactly zero.

Eval-mode BatchNorm and the conv bias fold into one affine per layer
(computed at call time from params/state):

    BN(z + b_conv) = z * s' + t',   s' = scale / sqrt(var + eps)
                                    t' = (b_conv - mean) * s' + bias

Precision: the kernels' float32 dots follow
``jax.default_matmul_precision`` as XLA's do — TF32 on the tensor cores
by default, IEEE float32 under ``"highest"`` or ``"float32"``.

Scope: inference, hidden-width-uniform models, dense batch layout with
``n <= 128`` nodes per graph; larger graphs and training use XLA.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from connectome_gnn_jax.utils.pytree import pytree_dataclass, static_field

EPS = 1e-8

#: Largest per-graph node count the fused kernels take; a graph's
#: adjacency and activations must fit one program's registers and
#: shared memory.  Larger graphs are batched matmuls XLA runs well.
MAX_FUSED_NODES = 128


def _pow2(v: int, lo: int = 16) -> int:
    """Smallest power of two ``>= max(v, lo)``."""
    return max(lo, 1 << (int(v) - 1).bit_length())


def _dot_precision() -> jax.lax.Precision:
    """The in-kernel dot precision matching XLA's for float32 operands."""
    p = jax.config.jax_default_matmul_precision
    if p in ("highest", "float32"):
        return jax.lax.Precision.HIGHEST
    return jax.lax.Precision.DEFAULT


def _pad_to(a: jnp.ndarray, shape) -> jnp.ndarray:
    return jnp.pad(a, [(0, t - s) for s, t in zip(a.shape, shape)])


def _mean_pool_head(h, mask, w_f1, b_f1, w_f2, b_f2):
    """Masked mean-pool of ``h [n, H]`` and the MLP head, for one graph.

    The head's operands are a single row, below ``pl.dot``'s 16-row
    minimum, so each layer is a broadcast product reduced over rows.
    """
    m = mask[:, None]
    pooled = jnp.sum(h * m, axis=0) / (jnp.sum(mask) + EPS)          # [H]
    hidden = jnp.maximum(jnp.sum(pooled[:, None] * w_f1, axis=0) + b_f1, 0.0)
    return jnp.sum(hidden[:, None] * w_f2, axis=0) + b_f2            # [C]


def _fused_gcn_kernel(
    x_ref,         # [n, F]   this graph's node features
    adj_ref,       # [n, n]   receiver-major adjacency
    mask_ref,      # [n]      1.0 for real nodes
    w_in_ref,      # [F, H]   first conv kernel
    w_h_ref,       # [max(L-1, 1), H, H] remaining conv kernels
    bn_scale_ref,  # [L, H]   folded affine scale  s'
    bn_shift_ref,  # [L, H]   folded affine shift  t'
    w_f1_ref,      # [H, H2]  head layer 1
    b_f1_ref,      # [H2]
    w_f2_ref,      # [H2, C]  head layer 2
    b_f2_ref,      # [C]
    out_ref,       # [C]      this graph's logits
    *,
    num_layers: int,
    precision,
):
    dot = partial(jnp.dot, precision=precision,
                  preferred_element_type=jnp.float32)
    adj = adj_ref[...]
    # Symmetric normalization with self-loop weight 1.0; column sums are
    # sender degrees.
    deg = jnp.sum(adj, axis=0) + 1.0
    dinv = jax.lax.rsqrt(deg + EPS)
    adj_n = dinv[:, None] * adj * dinv[None, :]
    self_n = (dinv * dinv)[:, None]

    h = x_ref[...]
    for layer in range(num_layers):
        w = w_in_ref[...] if layer == 0 else w_h_ref[layer - 1]
        hw = dot(h, w)
        agg = dot(adj_n, hw) + self_n * hw
        h = jnp.maximum(agg * bn_scale_ref[layer] + bn_shift_ref[layer], 0.0)

    out_ref[...] = _mean_pool_head(
        h, mask_ref[...], w_f1_ref[...], b_f1_ref[...], w_f2_ref[...],
        b_f2_ref[...],
    )


def _fused_sage_kernel(
    x_ref,          # [n, F]
    adj_ref,        # [n, n]
    mask_ref,       # [n]
    w_self_in_ref,  # [F, H]
    w_agg_in_ref,   # [F, H]
    w_self_h_ref,   # [max(L-1, 1), H, H]
    w_agg_h_ref,    # [max(L-1, 1), H, H]
    b_ref,          # [L, H]   conv bias (inside the ReLU)
    bn_scale_ref,   # [L, H]   eval-BN affine scale (applied after ReLU)
    bn_shift_ref,   # [L, H]
    w_f1_ref,       # [H, H2]
    b_f1_ref,       # [H2]
    w_f2_ref,       # [H2, C]
    b_f2_ref,       # [C]
    out_ref,        # [C]
    *,
    num_layers: int,
    precision,
):
    """Whole-model GraphSAGE inference for one graph.

    Per layer: weighted-mean aggregate → split-matmul concat projection
    → ReLU, then the folded eval-BatchNorm affine (SAGE's encode has no
    post-BN ReLU).  The concat ``[h, agg] @ W`` is computed as
    ``h @ W_self + agg @ W_agg``.
    """
    dot = partial(jnp.dot, precision=precision,
                  preferred_element_type=jnp.float32)
    adj = adj_ref[...]
    w_sum = jnp.sum(adj, axis=1)[:, None] + EPS

    h = x_ref[...]
    for layer in range(num_layers):
        w_self = w_self_in_ref[...] if layer == 0 else w_self_h_ref[layer - 1]
        w_agg = w_agg_in_ref[...] if layer == 0 else w_agg_h_ref[layer - 1]
        agg = dot(adj, h) / w_sum
        z = dot(h, w_self) + dot(agg, w_agg) + b_ref[layer]
        h = jnp.maximum(z, 0.0) * bn_scale_ref[layer] + bn_shift_ref[layer]

    out_ref[...] = _mean_pool_head(
        h, mask_ref[...], w_f1_ref[...], b_f1_ref[...], w_f2_ref[...],
        b_f2_ref[...],
    )


def fold_bn_affine(
    params: dict,
    state: dict,
    num_layers: int,
    eps: float = 1e-5,
    include_conv_bias: bool = True,
):
    """Fold eval-mode BatchNorm into per-layer (scale, shift).

    With ``include_conv_bias`` the conv bias is folded in too (valid when
    the bias is added *before* BN, as in GCN); SAGE's bias sits inside the
    ReLU and must stay separate.
    """
    scales, shifts = [], []
    for i in range(num_layers):
        bn_p = params["norms"][i]
        bn_s = state["norms"][i]
        inv = jax.lax.rsqrt(bn_s["var"] + eps)
        s = bn_p["scale"] * inv
        pre = params["convs"][i]["bias"] if include_conv_bias else 0.0
        t = (pre - bn_s["mean"]) * s + bn_p["bias"]
        scales.append(s)
        shifts.append(t)
    return jnp.stack(scales), jnp.stack(shifts)


def _stack_hidden(kernels, num_layers: int, Hp: int) -> jnp.ndarray:
    """``[max(L-1, 1), Hp, Hp]`` stack of the post-input conv kernels
    (one zero slab when ``L == 1``: a zero-size operand has no block)."""
    if num_layers == 1:
        return jnp.zeros((1, Hp, Hp), jnp.float32)
    return jnp.stack([_pad_to(k, (Hp, Hp)) for k in kernels])


@pytree_dataclass
class FusedWeights:
    """A model's kernel operands: BatchNorm folded, kernels stacked and
    everything zero-padded to the kernels' shapes.  Prepared once per
    set of parameters (:func:`pack_fused_weights`) and reused for every
    batch served with them."""

    arrays: tuple
    family: str = static_field()  # "gcn" | "sage"
    num_layers: int = static_field()
    num_classes: int = static_field()


def _head_weights(params: dict, H_p: int) -> list:
    fc1, fc2 = params["head"]["fc1"], params["head"]["fc2"]
    H2, C = fc2["kernel"].shape
    H2_p, C_p = _pow2(H2), _pow2(C)
    return [
        _pad_to(fc1["kernel"], (H_p, H2_p)),
        _pad_to(fc1["bias"], (H2_p,)),
        _pad_to(fc2["kernel"], (H2_p, C_p)),
        _pad_to(fc2["bias"], (C_p,)),
    ]


def _check_uniform(params: dict, in_mult: int) -> None:
    if not _uniform_hidden_width(params, in_mult):
        raise ValueError(
            "fused kernel requires uniform hidden width across layers"
        )


@partial(jax.jit, static_argnames=("num_layers",))
def pack_gcn_weights(params: dict, state: dict, *, num_layers: int
                     ) -> FusedWeights:
    """:class:`FusedWeights` of a :class:`GCNConnectome`."""
    _check_uniform(params, 1)
    F, H = params["convs"][0]["kernel"].shape
    H_p = _pow2(H)
    bn_scale, bn_shift = fold_bn_affine(params, state, num_layers)
    arrays = (
        _pad_to(params["convs"][0]["kernel"], (_pow2(F), H_p)),
        _stack_hidden([params["convs"][i]["kernel"]
                       for i in range(1, num_layers)], num_layers, H_p),
        _pad_to(bn_scale, (num_layers, H_p)),
        _pad_to(bn_shift, (num_layers, H_p)),
        *_head_weights(params, H_p),
    )
    C = params["head"]["fc2"]["kernel"].shape[1]
    return FusedWeights(arrays, "gcn", num_layers, C)


@partial(jax.jit, static_argnames=("num_layers",))
def pack_sage_weights(params: dict, state: dict, *, num_layers: int
                      ) -> FusedWeights:
    """:class:`FusedWeights` of a :class:`GraphSAGEConnectome`: the
    concat kernels ``[h, agg] @ W`` split into self and neighbour
    halves."""
    _check_uniform(params, 2)
    F2, H = params["convs"][0]["kernel"].shape
    F = F2 // 2
    H_p, F_p = _pow2(H), _pow2(F)
    # eval-BN affine (applied AFTER the in-layer ReLU; conv bias cannot be
    # folded through the nonlinearity, so it stays separate)
    bn_scale, bn_shift = fold_bn_affine(
        params, state, num_layers, include_conv_bias=False
    )
    convs = [params["convs"][i]["kernel"] for i in range(num_layers)]
    biases = jnp.stack([params["convs"][i]["bias"] for i in range(num_layers)])
    arrays = (
        _pad_to(convs[0][:F], (F_p, H_p)),
        _pad_to(convs[0][F:], (F_p, H_p)),
        _stack_hidden([k[:H] for k in convs[1:]], num_layers, H_p),
        _stack_hidden([k[H:] for k in convs[1:]], num_layers, H_p),
        _pad_to(biases, (num_layers, H_p)),
        _pad_to(bn_scale, (num_layers, H_p)),
        _pad_to(bn_shift, (num_layers, H_p)),
        *_head_weights(params, H_p),
    )
    C = params["head"]["fc2"]["kernel"].shape[1]
    return FusedWeights(arrays, "sage", num_layers, C)


_KERNELS = {"gcn": _fused_gcn_kernel, "sage": _fused_sage_kernel}


@partial(jax.jit, static_argnames=("interpret",))
def fused_apply(
    weights: FusedWeights,
    x: jnp.ndarray,
    adj: jnp.ndarray,
    node_mask: jnp.ndarray,
    *,
    interpret: bool = False,
) -> jnp.ndarray:
    """Eval-mode logits ``[B, C]`` of a dense batch through the fused
    kernel, one program per graph.  Pads the batch to the kernel's
    power-of-two shapes; ``weights`` come padded already."""
    B, n, _ = x.shape
    n_p, F_p = _pow2(n), weights.arrays[0].shape[0]
    C_p = weights.arrays[-1].shape[0]
    graph_args = (
        _pad_to(x.astype(jnp.float32), (B, n_p, F_p)),
        _pad_to(adj.astype(jnp.float32), (B, n_p, n_p)),
        _pad_to(node_mask.astype(jnp.float32), (B, n_p)),
    )

    def per_graph(shape):
        return pl.BlockSpec((None,) + shape, lambda b: (b,) + (0,) * len(shape))

    def whole(a):
        return pl.BlockSpec(a.shape, lambda b: (0,) * a.ndim)

    kernel = partial(_KERNELS[weights.family], num_layers=weights.num_layers,
                     precision=_dot_precision())
    out = pl.pallas_call(
        kernel,
        grid=(B,),
        out_shape=jax.ShapeDtypeStruct((B, C_p), jnp.float32),
        in_specs=[per_graph((n_p, F_p)), per_graph((n_p, n_p)),
                  per_graph((n_p,))] + [whole(w) for w in weights.arrays],
        out_specs=per_graph((C_p,)),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=4 if n_p <= 64 else 8, num_stages=1
        ),
        interpret=interpret,
        name=f"fused_{weights.family}_kernel",
    )(*graph_args, *weights.arrays)
    return out[:, : weights.num_classes]


def fused_gcn_forward(
    params: dict,
    state: dict,
    x: jnp.ndarray,
    adj: jnp.ndarray,
    node_mask: jnp.ndarray,
    *,
    num_layers: int = 3,
    interpret: bool = False,
) -> jnp.ndarray:
    """Run the fused GCN inference kernel.  Returns logits ``[B, C]``.

    ``params``/``state`` are the standard :class:`GCNConnectome` pytrees;
    ``x``/``adj``/``node_mask`` come from a :class:`DenseConnectomeBatch`.
    """
    weights = pack_gcn_weights(params, state, num_layers=num_layers)
    return fused_apply(weights, x, adj, node_mask, interpret=interpret)


def fused_sage_forward(
    params: dict,
    state: dict,
    x: jnp.ndarray,
    adj: jnp.ndarray,
    node_mask: jnp.ndarray,
    *,
    num_layers: int = 3,
    interpret: bool = False,
) -> jnp.ndarray:
    """Fused GraphSAGE inference kernel.  Returns logits ``[B, C]``.

    ``params``/``state`` are :class:`GraphSAGEConnectome` pytrees;
    ``x``/``adj``/``node_mask`` come from a :class:`DenseConnectomeBatch`.
    """
    weights = pack_sage_weights(params, state, num_layers=num_layers)
    return fused_apply(weights, x, adj, node_mask, interpret=interpret)


def _uniform_hidden_width(params: dict, in_mult: int) -> bool:
    """Whether every post-input conv kernel is ``in_mult·H → H`` (the
    fused kernels' weight-stacking precondition; ``in_mult`` is 2 for
    SAGE's concat kernels)."""
    H = params["convs"][0]["kernel"].shape[1]
    return all(
        conv["kernel"].shape == (in_mult * H, H) for conv in params["convs"][1:]
    )


def _kernel_family(model, params: dict):
    """``"gcn"``/``"sage"`` for float32 models of uniform hidden width
    whose family has a fused kernel, else ``None``."""
    from connectome_gnn_jax.models import GCNConnectome, GraphSAGEConnectome

    if isinstance(model, GCNConnectome):
        family, in_mult = "gcn", 1
    elif isinstance(model, GraphSAGEConnectome):
        family, in_mult = "sage", 2
    else:
        return None
    if (
        model.compute_dtype != jnp.float32
        or not _uniform_hidden_width(params, in_mult)
    ):
        return None
    return family


def fused_kernel_for(model, params: dict, batch, platform: str):
    """The fused kernel that serves ``batch`` on ``platform``, or ``None``
    where the plain XLA forward does.

    The kernels run on ``"gpu"`` for float32 GCN and GraphSAGE models of
    uniform hidden width over dense batches of at most
    :data:`MAX_FUSED_NODES` nodes per graph.
    """
    family = _kernel_family(model, params)
    if (
        family is None
        or platform != "gpu"
        or not hasattr(batch, "adj")
        or batch.node_features.shape[1] > MAX_FUSED_NODES
    ):
        return None
    return {"gcn": fused_gcn_forward, "sage": fused_sage_forward}[family]


def pack_fused_weights(model, params: dict, state: dict):
    """:class:`FusedWeights` for ``model``, or ``None`` when its family,
    dtype or widths have no fused kernel."""
    family = _kernel_family(model, params)
    if family is None:
        return None
    pack = pack_gcn_weights if family == "gcn" else pack_sage_weights
    return pack(params, state, num_layers=model.num_layers)


def forward_auto(
    model, params: dict, state: dict, batch, *, interpret: bool = False,
    weights: FusedWeights | None = None,
) -> jnp.ndarray:
    """Eval-mode logits through the fused kernel where
    :func:`fused_kernel_for` picks one, else through ``model.apply``.

    On a GPU backend a chosen kernel is compiled and run; a compile error
    raises.  Elsewhere the plain path runs, unless ``interpret`` asks for
    the chosen kernel under the Pallas interpreter (how CPU tests
    exercise it).  A server that runs many batches with the same
    parameters passes ``weights`` from :func:`pack_fused_weights`, so the
    per-batch work is the kernel and the batch padding alone.
    """
    platform = "gpu" if interpret else jax.default_backend()
    if fused_kernel_for(model, params, batch, platform) is None:
        logits, _ = model.apply(params, state, batch, train=False)
        return logits
    if weights is None:
        weights = pack_fused_weights(model, params, state)
    return fused_apply(
        weights, batch.node_features, batch.adj, batch.node_mask,
        interpret=interpret,
    )
