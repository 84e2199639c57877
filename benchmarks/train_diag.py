#!/usr/bin/env python3
"""Giant-graph TRAIN-step teardown.

Decomposes the banded giant-graph train step: each of the four band
passes (fwd + transposed bwd × L layers) is timed individually through
every available band product, the non-band remainder (weight matmuls,
BatchNorm, boundary relayout, loss/Adam) is timed as its own passes, and
the full steps are re-timed so `step ≈ Σ parts` can be checked —
anything unexplained is reported as `unattributed`.

Band products compared per pass at the 1M-node config:
  f32      banded_spmm (XLA einsum; bwd = transposed-band einsum)
  fm       banded_spmm_quant_fm (int8 band, bf16 x, [F, N] activations)
  w8a8     banded_spmm_quant_fm_w8a8 (int8 band AND activations)

Writes ``--out`` (JSON).  Methodology: chained/carried on-device
fori_loops with normalized feedback and full-vs-quarter differencing
(benchmarks/suite.py); ``hbm_frac`` is modeled bytes over the device's
published memory bandwidth (``suite.PEAKS``).

Reference loop being scaled: the reference's train.py:41-54.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import optax

from benchmarks.suite import (
    carried_loop_time,
    chained_loop_time,
    device_loop_time,
    peaks,
)


def band_pass_bytes(q, feat, *, act_bytes=2, out_bytes=4, quant_x=0):
    """Traffic model of one quantized band pass (one activation window
    read per diagonal)."""
    W = q.bandwidth
    padded = q.num_blocks * q.block
    return (
        q.band_qT.size + q.scales.size * 4
        + (2 * W + 1) * padded * feat * act_bytes
        + padded * feat * out_bytes
        + quant_x * padded * feat * 5
    )


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="chiprun_out/train_diag.json")
    p.add_argument("--nodes", type=int, default=1 << 20)
    p.add_argument("--degree", type=int, default=38)
    p.add_argument("--band", type=int, default=512)
    p.add_argument("--feat", type=int, default=64)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--block", type=int, default=256)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--step-iters", type=int, default=6)
    args = p.parse_args()
    peak_bps = peaks()["hbm_bytes_per_s"]

    import importlib

    quant_exp = importlib.import_module("benchmarks.quant_experiments")
    from connectome_gnn_jax.models import BandedNodeGCN
    from connectome_gnn_jax.nn.layers import batch_norm_apply_fm
    from connectome_gnn_jax.ops.banded import (
        BandedMatrix,
        banded_spmm,
        gcn_normalize_banded,
        transpose_banded,
    )
    from connectome_gnn_jax.ops.banded_quant import (
        QuantizedBandedMatrixFM,
        banded_spmm_quant_fm,
        banded_spmm_quant_fm_w8a8,
        quantize_band,
        to_feature_major,
        transpose_quantized,
    )

    N, F, L, block = args.nodes, args.feat, args.layers, args.block
    it = args.iters
    results: dict = {
        "harness": "benchmarks/train_diag.py",
        "device_kind": jax.devices()[0].device_kind,
        "config": f"{N} nodes / {N * args.degree} edges, block={block}, "
                  f"F={F}, L={L}",
        "passes": {},
        "steps": {},
    }

    a, E = quant_exp.build_band(N, args.degree, args.band, block)
    adj_norm, dinv = gcn_normalize_banded(a)
    a.band.delete()
    W = adj_norm.bandwidth
    nb = adj_norm.num_blocks
    padded = nb * block

    x = jax.random.normal(jax.random.PRNGKey(1), (N, F), jnp.float32)
    xT = jnp.asarray(x.T)
    labels = jax.random.bernoulli(
        jax.random.PRNGKey(2), 0.5, (N,)
    ).astype(jnp.int32)

    def fetch(v):
        return float(jnp.sum(v))

    def record_pass(name, dt, bytes_model):
        results["passes"][name] = {
            "ms": dt * 1e3,
            "edges_per_s": E / dt,
            "model_gbps": bytes_model / dt / 1e9,
            "hbm_frac": bytes_model / dt / peak_bps,
        }
        print(f"# {name}: {dt*1e3:.3f} ms "
              f"({bytes_model/dt/peak_bps:.2f} of memory peak)",
              file=sys.stderr, flush=True)

    # ---- f32 band passes (the 5t path) -------------------------------
    # Memory discipline at the 1M config: the f32 band is 5.37 GB, so
    # the band and its transpose are never live together.  Quantize
    # first, then SWAP band↔bandᵀ via transpose+delete;
    # transpose_banded is an involution so the original is recovered
    # for the f32 full-step timing at the end.
    f32_band_bytes = adj_norm.band.size * 4
    f32_bytes = f32_band_bytes + (2 * W + 2) * padded * F * 4
    dt = chained_loop_time(
        lambda v, b: banded_spmm(adj_norm._replace(band=b), v), x, it,
        adj_norm.band,
    )
    record_pass("f32_fwd", dt, f32_bytes)

    # ---- f32 transposed pass (swap: only ONE f32 band live) -----------
    # The transpose runs as a DONATED jitted program: the eager
    # transpose materializes every per-diagonal temporary alongside
    # input and output (~3x band); under jit+donation XLA streams
    # diagonals through the donated buffer and peak stays ~2x band.
    def _band_T(band):
        return transpose_banded(BandedMatrix(band, N, W)).band

    _swap = jax.jit(_band_T, donate_argnums=0)
    adj_T = BandedMatrix(_swap(adj_norm.band), N, W)
    fetch(adj_T.band[0, 0, 0])
    del adj_norm  # band buffer was donated away
    dt = chained_loop_time(
        lambda v, b: banded_spmm(adj_T._replace(band=b), v), x, it,
        adj_T.band,
    )
    record_pass("f32_bwd_transposed", dt, f32_bytes)

    # ---- quantized operands (derived from the transposed band; block
    # absmax is transpose-invariant so quantize_band(A^T) ==
    # transpose_quantized(quantize_band(A)) exactly) ---------------------
    qT_row = quantize_band(adj_T)
    fetch(qT_row.scales)
    q_row = transpose_quantized(qT_row)
    q = to_feature_major(q_row)
    qT = to_feature_major(qT_row)
    fetch(q.scales)
    fetch(qT.scales)
    q_row.band_q.delete()
    qT_row.band_q.delete()

    # ---- fm passes — the 5tq path -------------------------------------
    fm_bytes = band_pass_bytes(q, F)
    dt = chained_loop_time(
        lambda vT, bq, s: banded_spmm_quant_fm(
            QuantizedBandedMatrixFM(bq, s, N, W), vT,
        ),
        xT, it, q.band_qT, q.scales,
    )
    record_pass("fm_fwd", dt, fm_bytes)
    dt = chained_loop_time(
        lambda vT, bq, s: banded_spmm_quant_fm(
            QuantizedBandedMatrixFM(bq, s, N, W), vT,
        ),
        xT, it, qT.band_qT, qT.scales,
    )
    record_pass("fm_bwd", dt, fm_bytes)

    # ---- w8a8 pass (serving product; quantizes x inside) --------------
    dt = chained_loop_time(
        lambda vT, bq, s: banded_spmm_quant_fm_w8a8(
            QuantizedBandedMatrixFM(bq, s, N, W), vT,
        ),
        xT, it, q.band_qT, q.scales,
    )
    record_pass("w8a8_fwd_incl_quant", dt, band_pass_bytes(q, F, act_bytes=1, quant_x=1))

    # ---- non-band remainder passes ------------------------------------
    Wm = jax.random.normal(jax.random.PRNGKey(3), (F, F), jnp.float32)

    def wmat(vT, Wm):
        return jnp.dot(Wm, vT, preferred_element_type=jnp.float32)

    dt = chained_loop_time(wmat, xT, it, Wm)
    record_pass("weight_matmul_fm", dt, 2 * F * N * 4)

    from connectome_gnn_jax.nn.layers import batch_norm_init

    bn_p, bn_s = batch_norm_init(F)

    def bn_relu_fm(vT, scale, bias, mean, var):
        y, st = batch_norm_apply_fm(
            {"scale": scale, "bias": bias}, {"mean": mean, "var": var},
            vT, None, train=True,
        )
        return jax.nn.relu(y) + 0 * st["mean"][:, None]

    dt = chained_loop_time(
        bn_relu_fm, xT, it, bn_p["scale"], bn_p["bias"], bn_s["mean"],
        bn_s["var"],
    )
    record_pass("bn_train_relu_fm", dt, 3 * F * N * 4)

    def boundary(v):
        return jnp.swapaxes(v[: nb * block].reshape(nb, block, F), 1, 2)

    dt = chained_loop_time(
        lambda v: boundary(v).swapaxes(1, 2).reshape(padded, F), x, it
    )
    record_pass("boundary_relayout_roundtrip", dt, 4 * F * N * 4)

    # ---- f32 ROW-MAJOR non-band passes --------------------------------
    # These rows run in the SAME layout the f32 step uses
    # ([N, F] activations, masked BN over axis 0), so the f32
    # attribution below is a sum of measured rows, not a subtraction.
    from connectome_gnn_jax.nn.layers import batch_norm_apply

    mask_n = jnp.ones((N,), bool)

    def wmat_rm(v, Wm_):
        return jnp.dot(v, Wm_, preferred_element_type=jnp.float32)

    dt = chained_loop_time(wmat_rm, x, it, Wm)
    record_pass("weight_matmul_rm", dt, 2 * F * N * 4)

    # marginal cost of the weight matmul FUSED behind a band pass (f32
    # layout): combo − measured band pass
    dt_combo = chained_loop_time(
        lambda v, b, Wm_: jnp.dot(
            banded_spmm(adj_T._replace(band=b), v), Wm_,
            preferred_element_type=jnp.float32,
        ),
        x, it, adj_T.band, Wm,
    )
    marg = dt_combo - results["passes"]["f32_bwd_transposed"]["ms"] / 1e3
    record_pass("weight_matmul_rm_marginal", max(marg, 1e-9),
                2 * F * N * 4)

    def bn_relu_rm(v, scale, bias, mean, var):
        y, st = batch_norm_apply(
            {"scale": scale, "bias": bias}, {"mean": mean, "var": var},
            v, mask_n, train=True,
        )
        return jax.nn.relu(y) + 0 * st["mean"][None, :]

    dt_bn_fwd = chained_loop_time(
        bn_relu_rm, x, it, bn_p["scale"], bn_p["bias"], bn_s["mean"],
        bn_s["var"],
    )
    record_pass("bn_train_relu_rm", dt_bn_fwd, 3 * F * N * 4)

    def bn_relu_rm_grad(v, scale, bias, mean, var):
        def f(u):
            y, _ = batch_norm_apply(
                {"scale": scale, "bias": bias},
                {"mean": mean, "var": var}, u, mask_n, train=True,
            )
            return jnp.sum(jax.nn.relu(y) ** 2)

        return jax.grad(f)(v)

    dt_bn_fb = chained_loop_time(
        bn_relu_rm_grad, x, it, bn_p["scale"], bn_p["bias"],
        bn_s["mean"], bn_s["var"],
    )
    record_pass("bn_train_relu_rm_fwd_bwd", dt_bn_fb, 8 * F * N * 4)

    g_cot = jax.random.normal(jax.random.PRNGKey(7), (N, F), jnp.float32)

    def dw_rm(v, g):
        dw = jnp.einsum(
            "nf,nk->fk", v, g, preferred_element_type=jnp.float32
        )
        # sum over ALL of dw: keeping only a row would let XLA drop
        # 63/64 of the reduction as dead code
        return v + 1e-30 * dw.sum(0)

    dt = chained_loop_time(dw_rm, x, it, g_cot)
    record_pass("dw_reduction_rm", dt, 2 * F * N * 4)

    Wh = jax.random.normal(jax.random.PRNGKey(8), (F, 2), jnp.float32)

    def head_ce(v, Wh_, labels_):
        def f(u):
            logits = jnp.dot(u, Wh_, preferred_element_type=jnp.float32)
            return jnp.mean(
                optax.softmax_cross_entropy_with_integer_labels(
                    logits, labels_
                )
            )

        return jax.grad(f)(v)

    dt = chained_loop_time(head_ce, x, it, Wh, labels)
    record_pass("head_ce_fwd_bwd_rm", dt, 3 * F * N * 4)

    # ---- full train steps ---------------------------------------------
    model = BandedNodeGCN(in_channels=F, hidden_dim=F, num_classes=2,
                          num_layers=L)
    params, state = model.init(jax.random.PRNGKey(0))
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)

    def make_step(apply_fn, *operands):
        def step(carry, *args):
            (*ops_, x_, labels_, eps, i) = args
            pcarry, s, o = carry

            def loss_fn(p):
                logits, new_s = apply_fn(p, s, *ops_, x_ + eps)
                ce = optax.softmax_cross_entropy_with_integer_labels(
                    logits, labels_
                )
                return jnp.mean(ce), new_s

            (_, new_s), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                pcarry
            )
            updates, new_o = opt.update(grads, o, pcarry)
            return (optax.apply_updates(pcarry, updates), new_s, new_o)

        return step

    def record_step(name, apply_fn, operands, bytes_model):
        dt = carried_loop_time(
            make_step(apply_fn), (params, state, opt_state),
            tuple(operands) + (x, labels), args.step_iters,
            lambda c: jnp.sum(c[0]["head"]["kernel"]),
        )
        results["steps"][name] = {
            "ms": dt * 1e3,
            "edges_per_s": L * E / dt,
            "hbm_frac": bytes_model / dt / peak_bps,
        }
        print(f"# step {name}: {dt*1e3:.3f} ms", file=sys.stderr, flush=True)
        return dt

    # quant steps first (the idle adj_T f32 band + int8 operands fit;
    # the f32 step runs LAST, alone with its recovered band)
    quant_pass = band_pass_bytes(q, F)
    quant_step_bytes = L * (2 * quant_pass + 4 * padded * F * 4)
    record_step(
        "fm_5tq",
        lambda p, s, bq, sc, bqT, scT, dinv_, x_: model.apply_quant_trainable(
            p, s, QuantizedBandedMatrixFM(bq, sc, N, W),
            QuantizedBandedMatrixFM(bqT, scT, N, W), dinv_, x_, train=True,
        ),
        (q.band_qT, q.scales, qT.band_qT, qT.scales, dinv),
        quant_step_bytes,
    )

    # f32 (5t) — recover the row-major band by REBUILDING it from the
    # (deterministic) generator instead of a second transpose: free
    # everything first and pay the host rebuild.
    q.band_qT.delete()
    qT.band_qT.delete()
    adj_T.band.delete()
    del adj_T
    g_cot.delete()
    a2, _ = quant_exp.build_band(N, args.degree, args.band, block)
    adj_norm, dinv2 = gcn_normalize_banded(a2)
    a2.band.delete()
    dinv = dinv2
    fetch(adj_norm.band[0, 0, 0])
    f32_step_bytes = L * (
        2 * f32_band_bytes + 3 * (2 * W + 2) * padded * F * 4
    )
    record_step(
        "f32_5t",
        lambda p, s, band, dinv_, x_: model.apply_normalized(
            p, s, BandedMatrix(band, N, W), dinv_, x_, train=True
        ),
        (adj_norm.band, dinv), f32_step_bytes,
    )

    # forward-ONLY train-mode pass through the same model: splits the
    # f32 non-band residual into its fwd and bwd halves (what the grad
    # transform adds is then step − forward − band_bwd-attributable
    # rows, all measured)
    def f32_fwd_model(band, dinv_, x_, eps, i):
        logits, _ = model.apply_normalized(
            params, state, BandedMatrix(band, N, W), dinv_, x_ + eps,
            train=True,
        )
        return jnp.sum(logits)

    dt = device_loop_time(
        f32_fwd_model, (adj_norm.band, dinv, x), args.step_iters
    )
    results["steps"]["f32_forward_train_mode"] = {
        "ms": dt * 1e3,
        "edges_per_s": L * E / dt,
        "hbm_frac": (f32_step_bytes / 3) / dt / peak_bps,
    }
    print(f"# step f32_forward_train_mode: {dt*1e3:.3f} ms",
          file=sys.stderr, flush=True)
    adj_norm.band.delete()

    # ---- attribution ---------------------------------------------------
    ps = results["passes"]
    st = results["steps"]
    results["attribution"] = {
        "fm_5tq": {
            "band_passes_ms": L * (ps["fm_fwd"]["ms"] + ps["fm_bwd"]["ms"]),
            "step_ms": st["fm_5tq"]["ms"],
            "non_band_ms": st["fm_5tq"]["ms"]
            - L * (ps["fm_fwd"]["ms"] + ps["fm_bwd"]["ms"]),
        },
        "f32_5t": {
            "band_passes_ms": L
            * (ps["f32_fwd"]["ms"] + ps["f32_bwd_transposed"]["ms"]),
            "step_ms": st["f32_5t"]["ms"],
            "non_band_ms": st["f32_5t"]["ms"]
            - L * (ps["f32_fwd"]["ms"] + ps["f32_bwd_transposed"]["ms"]),
        },
    }
    # f32 non-band residual attributed as a SUM of measured f32 rows:
    # per layer the step pays hw = h·W (fwd),
    # dh = ḡ·Wᵀ (bwd, same cost row), dW = hᵀ·ḡ, and BN+ReLU fwd+bwd;
    # once per step the CE head fwd+bwd.  weight_matmul_rm_marginal
    # records how much of the matmul fuses into the band pass for free.
    f32_rows = {
        "weight_matmuls (L*(fwd+bwd))": 2 * L
        * ps["weight_matmul_rm"]["ms"],
        "dw_reductions (L)": L * ps["dw_reduction_rm"]["ms"],
        "bn_relu_fwd_bwd (L)": L * ps["bn_train_relu_rm_fwd_bwd"]["ms"],
        "head_ce_fwd_bwd": ps["head_ce_fwd_bwd_rm"]["ms"],
    }
    expected = sum(f32_rows.values())
    fwd_ms = st["f32_forward_train_mode"]["ms"]
    fwd_band = L * ps["f32_fwd"]["ms"]
    fwd_expected_non_band = (
        L * (ps["weight_matmul_rm"]["ms"] + ps["bn_train_relu_rm"]["ms"])
        # head fwd only ≈ a third of the fwd+bwd row
        + ps["head_ce_fwd_bwd_rm"]["ms"] / 3
    )
    results["attribution"]["f32_5t"].update({
        "expected_non_band_rows_ms": f32_rows,
        "expected_non_band_ms": expected,
        "unattributed_ms": results["attribution"]["f32_5t"][
            "non_band_ms"
        ] - expected,
        "forward_train_mode_ms": fwd_ms,
        "forward_non_band_ms": fwd_ms - fwd_band,
        "forward_expected_non_band_ms": fwd_expected_non_band,
        "backward_ms": st["f32_5t"]["ms"] - fwd_ms,
        "backward_band_ms": L * ps["f32_bwd_transposed"]["ms"],
        "backward_non_band_ms": st["f32_5t"]["ms"] - fwd_ms
        - L * ps["f32_bwd_transposed"]["ms"],
    })

    out = json.dumps(results, indent=2)
    print(out)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(out + "\n")


if __name__ == "__main__":
    main()
