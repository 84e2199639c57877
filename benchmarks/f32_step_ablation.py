#!/usr/bin/env python3
"""f32 train-step ablation: the in-context cost of each component.

Isolated rows (benchmarks/train_diag.py) can under-count in-context
costs (rematerialization, lost fusion), so this harness measures the f32
giant-graph train step with components REMOVED one at a time — each
delta is that component's true in-context cost, fwd+bwd included:

  full              2-layer conv(BN,ReLU) + head CE + Adam (the 5t step)
  no_bn             BatchNorm replaced by identity
  no_wmat           conv weight matmul skipped
  wmat_no_dw        stop_gradient(W): matmuls kept, dW reductions gone
  full_barrier      optimization_barrier between matmul and band pass
  wmat_vjp_barrier  custom matmul VJP with a barrier'd cotangent
  full_band_bf16    band stored bf16
  fwd_only          full forward, no grad (reference point)

Methodology: carried on-device loops, full-vs-quarter differencing
(benchmarks/suite.py).  The earlier no_head /
band_only variants were removed: their loss paths left the readout
parameter without a gradient, so XLA legally DCE'd the body.
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

from benchmarks.suite import carried_loop_time, device_loop_time


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="F32_ABLATION_r05.json")
    p.add_argument("--nodes", type=int, default=1 << 20)
    p.add_argument("--degree", type=int, default=38)
    p.add_argument("--band", type=int, default=512)
    p.add_argument("--feat", type=int, default=64)
    p.add_argument("--block", type=int, default=256)
    p.add_argument("--iters", type=int, default=6)
    args = p.parse_args()

    import importlib

    quant_exp = importlib.import_module("benchmarks.quant_experiments")
    from connectome_gnn_jax.nn.layers import batch_norm_apply, batch_norm_init
    from connectome_gnn_jax.ops.banded import banded_spmm, gcn_normalize_banded

    N, F, L = args.nodes, args.feat, 2
    a, E = quant_exp.build_band(N, args.degree, args.band, args.block)
    adj, dinv = gcn_normalize_banded(a)
    a.band.delete()
    self_norm = (dinv * dinv)[:N, None]

    x = jax.random.normal(jax.random.PRNGKey(1), (N, F), jnp.float32)
    labels = jax.random.bernoulli(
        jax.random.PRNGKey(2), 0.5, (N,)
    ).astype(jnp.int32)
    mask = jnp.ones((N,), bool)

    k = jax.random.split(jax.random.PRNGKey(3), L + 1)
    bn_p, bn_s = zip(*(batch_norm_init(F) for _ in range(L)))
    params = {
        "w": [jax.random.normal(k[i], (F, F), jnp.float32) / np.sqrt(F)
              for i in range(L)],
        "bn": list(bn_p),
        "head": jax.random.normal(k[L], (F, 2), jnp.float32) / np.sqrt(F),
    }
    state = {"bn": list(bn_s)}
    opt = optax.adam(1e-3)

    from connectome_gnn_jax.ops.banded import BandedMatrix

    W = adj.bandwidth

    @jax.custom_vjp
    def matmul_barrier(h, w):
        return jnp.dot(h, w, preferred_element_type=jnp.float32)

    def _mb_fwd(h, w):
        return matmul_barrier(h, w), (h, w)

    def _mb_bwd(res, g):
        h, w = res
        g = jax.lax.optimization_barrier(g)
        dh = jnp.dot(g, w.T, preferred_element_type=jnp.float32)
        dw = jnp.einsum("nf,nk->fk", h, g,
                        preferred_element_type=jnp.float32)
        return dh, dw

    matmul_barrier.defvjp(_mb_fwd, _mb_bwd)

    def forward(p, band, x_, *, use_bn, use_wmat, use_head,
                kw_barrier=False, kw_sg_w=False, kw_sg_h=False,
                kw_mb=False):
        h = x_
        new_bn = []
        am = BandedMatrix(band, N, W)
        for i in range(L):
            w_i = p["w"][i]
            if kw_sg_w:
                w_i = jax.lax.stop_gradient(w_i)
            if not use_wmat:
                hw = h
            elif kw_mb:
                hw = matmul_barrier(h, w_i)
            else:
                hw = jnp.dot(h, w_i, preferred_element_type=jnp.float32)
            if kw_sg_h:
                # dW still computed, but the dh = g @ W^T chain is cut:
                # cotangents reach earlier layers only through self_norm
                hw = hw + jax.lax.stop_gradient(
                    jnp.dot(h, w_i, preferred_element_type=jnp.float32)
                ) * 0.0
            if kw_barrier:
                hw = jax.lax.optimization_barrier(hw)
            h = banded_spmm(am, hw) + self_norm * hw
            if use_bn:
                h, st = batch_norm_apply(
                    p["bn"][i], state["bn"][i], h, mask, train=True
                )
                new_bn.append(st)
            h = jax.nn.relu(h)
        if use_head:
            logits = jnp.dot(h, p["head"],
                             preferred_element_type=jnp.float32)
            ce = optax.softmax_cross_entropy_with_integer_labels(
                logits, labels
            )
            return jnp.mean(ce)
        return jnp.sum(h) * 1e-12

    # --- blocked-activation variant: [nb, block, F] end-to-end, so the
    # dW einsum's operands live in the conv's own blocked layout and no
    # relayout copies are needed (the retired-dW-tax hypothesis test)
    nb = adj.num_blocks
    blk = adj.block
    padded = nb * blk
    Wb_ = adj.bandwidth
    sn_b = jnp.pad((dinv * dinv)[:N], (0, padded - N)).reshape(
        nb, blk, 1
    )
    bn_eps = 1e-5

    def banded_spmm_blocked(band, hb):
        xb = jnp.pad(hb, ((Wb_, Wb_), (0, 0), (0, 0)))
        idx = jnp.arange(nb)[:, None] + jnp.arange(2 * Wb_ + 1)[None, :]
        windows = jnp.take(xb, idx, axis=0)
        return jnp.einsum("ndrc,ndcf->nrf", band, windows,
                          preferred_element_type=jnp.float32)

    nmask_b = (jnp.arange(padded) < N).reshape(nb, blk, 1).astype(
        jnp.float32
    )
    labels_pad = jnp.pad(labels, (0, padded - N))
    lmask = (jnp.arange(padded) < N).astype(jnp.float32)

    def forward_blocked(p, band, x_):
        hb = jnp.pad(x_, ((0, padded - N), (0, 0))).reshape(nb, blk, F)
        for i in range(L):
            hwb = jnp.einsum("nbf,fk->nbk", hb, p["w"][i],
                             preferred_element_type=jnp.float32)
            hb = banded_spmm_blocked(band, hwb) + sn_b * hwb
            # masked train-mode BN over the (block, row) axes
            cnt = jnp.sum(nmask_b)
            mu = jnp.sum(hb * nmask_b, axis=(0, 1)) / cnt
            var = jnp.sum(((hb - mu) ** 2) * nmask_b, axis=(0, 1)) / cnt
            hb = (hb - mu) * jax.lax.rsqrt(var + bn_eps)
            hb = hb * p["bn"][i]["scale"] + p["bn"][i]["bias"]
            hb = jax.nn.relu(hb) * nmask_b
        logits = jnp.einsum("nbf,fk->nbk", hb, p["head"],
                            preferred_element_type=jnp.float32)
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits.reshape(padded, 2), labels_pad
        )
        return jnp.sum(ce * lmask) / N

    def step_blocked(carry, band, x_, eps, i):
        p, o = carry

        def loss_fn(pp):
            return forward_blocked(pp, band, x_ + eps)

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, o2 = opt.update(grads, o, p)
        return (optax.apply_updates(p, updates), o2)

    def make_step(**kw):
        def step(carry, band, x_, eps, i):
            p, o = carry

            def loss_fn(pp):
                return forward(pp, band, x_ + eps, **kw)

            loss, grads = jax.value_and_grad(loss_fn)(p)
            updates, o2 = opt.update(grads, o, p)
            return (optax.apply_updates(p, updates), o2)

        return step

    results = {}

    def record(name, dt):
        results[name] = {"ms": dt * 1e3}
        print(f"# {name}: {dt*1e3:.3f} ms", file=sys.stderr, flush=True)

    opt_state = opt.init(params)
    band_bf16 = adj.band.astype(jnp.bfloat16)
    variants = {
        "full": dict(use_bn=True, use_wmat=True, use_head=True),
        "no_bn": dict(use_bn=False, use_wmat=True, use_head=True),
        "no_wmat": dict(use_bn=True, use_wmat=False, use_head=True),
        "full_barrier": dict(use_bn=True, use_wmat=True, use_head=True,
                             kw_barrier=True),
        "wmat_no_dw": dict(use_bn=True, use_wmat=True, use_head=True,
                           kw_sg_w=True),
        "wmat_vjp_barrier": dict(use_bn=True, use_wmat=True,
                                 use_head=True, kw_mb=True),
    }
    for name, kw in variants.items():
        dt = carried_loop_time(
            make_step(**kw), (params, opt_state), (adj.band, x),
            args.iters, lambda c: jnp.sum(c[0]["head"]),
        )
        record(name, dt)

    # the band stored bf16: half the band traffic
    dt = carried_loop_time(
        make_step(use_bn=True, use_wmat=True, use_head=True),
        (params, opt_state), (band_bf16, x),
        args.iters, lambda c: jnp.sum(c[0]["head"]),
    )
    record("full_band_bf16", dt)

    dt = carried_loop_time(
        step_blocked, (params, opt_state), (adj.band, x),
        args.iters, lambda c: jnp.sum(c[0]["head"]),
    )
    record("full_blocked_activations", dt)

    def fwd_only(band, x_, eps, i):
        return forward(params, band, x_ + eps, use_bn=True,
                       use_wmat=True, use_head=True)

    dt = device_loop_time(fwd_only, (adj.band, x), args.iters)
    record("fwd_only", dt)

    full = results["full"]["ms"]
    results["deltas_ms"] = {
        "bn_total_in_context": full - results["no_bn"]["ms"],
        "wmat_total_in_context": full - results["no_wmat"]["ms"],
        "dw_total_in_context": full - results["wmat_no_dw"]["ms"],
        "backward_of_full": full - results["fwd_only"]["ms"],
    }
    out = json.dumps(results, indent=2)
    print(out)
    with open(args.out, "w") as f:
        f.write(out + "\n")


if __name__ == "__main__":
    main()
