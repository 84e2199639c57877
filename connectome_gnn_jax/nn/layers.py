"""Core neural-net building blocks: dense, masked BatchNorm, dropout.

Everything here is a pure function over explicit parameter pytrees — no
module framework, no hidden state.  That keeps every piece trivially
jittable, shardable (params are plain pytrees for ``NamedSharding``), and
easy to load with reference weights for parity testing.

Masked BatchNorm is the one genuinely static-shape redesign: the reference
normalizes over all packed nodes of a ragged batch
(reference ``connectome_gnn/models.py:208``, torch ``BatchNorm1d``).  With
static padding, the batch statistics must exclude padded rows or the
numerics drift from the reference — so the layer takes the node mask and
computes masked moments.  Under data parallelism, passing ``axis_name``
psums the moment sums across devices, reproducing single-device statistics
exactly (the distributed-BatchNorm contract from SURVEY §7.4).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from connectome_gnn_jax.nn.initializers import (
    torch_linear_bias,
    torch_linear_kernel,
    xavier_uniform,
)


# ---------------------------------------------------------------------------
# Dense
# ---------------------------------------------------------------------------


def dense_init(
    key: jax.Array,
    in_features: int,
    out_features: int,
    *,
    kernel_init=torch_linear_kernel,
    bias: bool = True,
    bias_init=torch_linear_bias,
    dtype=jnp.float32,
) -> dict:
    """Initialize a dense layer ``{"kernel": [in, out], "bias": [out]}``."""
    k_kernel, k_bias = jax.random.split(key)
    params = {"kernel": kernel_init(k_kernel, in_features, out_features, dtype)}
    if bias:
        params["bias"] = bias_init(k_bias, in_features, out_features, dtype)
    return params


def dense_apply(params: dict, x: jnp.ndarray) -> jnp.ndarray:
    """``x @ kernel (+ bias)`` with f32 accumulation."""
    y = jnp.dot(x, params["kernel"], preferred_element_type=jnp.float32)
    if "bias" in params:
        y = y + params["bias"]
    return y


def xavier_dense_init(
    key: jax.Array, in_features: int, out_features: int, *, bias: bool = True
) -> dict:
    """Dense layer with Xavier-uniform kernel and torch-default bias —
    the reference's SAGE linear recipe (models.py:133-134)."""
    return dense_init(
        key, in_features, out_features, kernel_init=xavier_uniform, bias=bias
    )


# ---------------------------------------------------------------------------
# Masked BatchNorm
# ---------------------------------------------------------------------------


def batch_norm_init(num_features: int, dtype=jnp.float32) -> tuple[dict, dict]:
    """Returns ``(params, state)``: affine scale/bias and running moments.

    Matches torch ``BatchNorm1d`` defaults: scale 1, bias 0, running mean 0,
    running var 1, eps 1e-5, momentum 0.1.
    """
    params = {
        "scale": jnp.ones((num_features,), dtype),
        "bias": jnp.zeros((num_features,), dtype),
    }
    state = {
        "mean": jnp.zeros((num_features,), dtype),
        "var": jnp.ones((num_features,), dtype),
    }
    return params, state


def batch_norm_apply(
    params: dict,
    state: dict,
    x: jnp.ndarray,
    mask: Optional[jnp.ndarray],
    *,
    train: bool,
    momentum: float = 0.1,
    eps: float = 1e-5,
    axis_name: Optional[str] = None,
) -> tuple[jnp.ndarray, dict]:
    """Masked batch normalization over rows of ``x [N, F]``.

    Train mode: normalize with *biased* batch variance over unmasked rows and
    update running stats with the *unbiased* variance (torch semantics).
    Eval mode: normalize with running stats.  With ``axis_name`` set (inside
    ``shard_map``), moment sums are psummed so sharded batches reproduce
    single-device statistics bit-for-bit up to reduction order.
    """
    if train:
        if mask is None:
            mask = jnp.ones((x.shape[0],), dtype=x.dtype)
        m = mask.astype(x.dtype)[:, None]
        n = jnp.sum(m)
        sum_x = jnp.sum(x * m, axis=0)
        sum_x2 = jnp.sum((x * x) * m, axis=0)
        if axis_name is not None:
            n = jax.lax.psum(n, axis_name)
            sum_x = jax.lax.psum(sum_x, axis_name)
            sum_x2 = jax.lax.psum(sum_x2, axis_name)
        mean = sum_x / n
        var = sum_x2 / n - mean * mean  # biased
        var = jnp.maximum(var, 0.0)

        y = (x - mean) * jax.lax.rsqrt(var + eps)
        # Unbiased variance for the running estimate (torch keeps Bessel's
        # correction only in the running update).
        var_unbiased = var * (n / jnp.maximum(n - 1.0, 1.0))
        new_state = {
            "mean": (1.0 - momentum) * state["mean"] + momentum * mean,
            "var": (1.0 - momentum) * state["var"] + momentum * var_unbiased,
        }
    else:
        y = (x - state["mean"]) * jax.lax.rsqrt(state["var"] + eps)
        new_state = state

    y = y * params["scale"] + params["bias"]
    return y, new_state


def batch_norm_apply_fm(
    params: dict,
    state: dict,
    xT: jnp.ndarray,
    mask: Optional[jnp.ndarray],
    *,
    train: bool,
    momentum: float = 0.1,
    eps: float = 1e-5,
) -> tuple[jnp.ndarray, dict]:
    """:func:`batch_norm_apply` for FEATURE-MAJOR activations ``xT [F, N]``
    (the quantized-band training layout): identical semantics — biased
    batch variance on the normalize path, unbiased (Bessel) running
    update, masked node counting — with reductions along the node axis.
    """
    if not train:
        return batch_norm_eval_fm(params, state, xT, eps=eps), state
    if mask is None:
        mask = jnp.ones((xT.shape[1],), dtype=xT.dtype)
    m = mask.astype(xT.dtype)[None, :]
    n = jnp.sum(m)
    mean = jnp.sum(xT * m, axis=1) / n
    var = jnp.sum((xT * xT) * m, axis=1) / n - mean * mean
    var = jnp.maximum(var, 0.0)
    y = (xT - mean[:, None]) * jax.lax.rsqrt(var + eps)[:, None]
    var_unbiased = var * (n / jnp.maximum(n - 1.0, 1.0))
    new_state = {
        "mean": (1.0 - momentum) * state["mean"] + momentum * mean,
        "var": (1.0 - momentum) * state["var"] + momentum * var_unbiased,
    }
    return y * params["scale"][:, None] + params["bias"][:, None], new_state


def batch_norm_eval_fm(
    params: dict, state: dict, xT: jnp.ndarray, eps: float = 1e-5
) -> jnp.ndarray:
    """Eval-mode batch norm for FEATURE-MAJOR activations ``xT [F, N]``
    (the quantized-band serving layout) — running stats broadcast along
    the node axis; same arithmetic as :func:`batch_norm_apply` eval."""
    y = (xT - state["mean"][:, None]) * jax.lax.rsqrt(
        state["var"] + eps
    )[:, None]
    return y * params["scale"][:, None] + params["bias"][:, None]


# ---------------------------------------------------------------------------
# Dropout
# ---------------------------------------------------------------------------


def dropout(
    key: Optional[jax.Array],
    x: jnp.ndarray,
    rate: float,
    *,
    train: bool,
) -> jnp.ndarray:
    """Inverted dropout with an explicit PRNG key (the reference relies on
    torch's global RNG, models.py:210; JAX threads keys explicitly)."""
    if not train or rate <= 0.0:
        return x
    if key is None:
        raise ValueError("dropout in train mode requires a PRNG key")
    keep = 1.0 - rate
    mask = jax.random.bernoulli(key, keep, x.shape)
    return jnp.where(mask, x / keep, 0.0)
