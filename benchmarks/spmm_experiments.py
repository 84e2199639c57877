#!/usr/bin/env python3
"""Irregular giant-graph SpMM formulation experiments (GPU).

This script isolates where the scatter path for fully irregular graphs
(BASELINE config 5) spends its time and races
alternative formulations, using the suite's hoisting-proof chained-loop
methodology.  Variants:

  base    coo_spmm, receiver-sorted (production path)
  ssort   same edges sender-sorted: gather contiguous-ish, scatter random
  sget    sorted gather via .at[].get(indices_are_sorted=True) + segment_sum
  scat    scatter formulation zeros.at[r].add(w * x[s])
  bf16    base with bfloat16 features (half the random-access bytes)
  diag    gather + *regular* reshape-reduction (diagnostic: bounds the
          cost of segment_sum vs a dense reduction; NOT numerically
          equivalent — timing only)
  gonly   gather only, consumed by a cheap exact row-slice mix
          (diagnostic lower bound for any gather-based SpMM)
"""

from __future__ import annotations

import sys
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from benchmarks.suite import chained_loop_time

NUM_NODES = 262_144
AVG_DEG = 16
FEAT = int(os.environ.get("SPMM_FEAT", 64))
ITERS = int(os.environ.get("SPMM_ITERS", 8))


def main() -> None:
    rng = np.random.default_rng(0)
    E = NUM_NODES * AVG_DEG
    receivers = np.sort(rng.integers(0, NUM_NODES, E)).astype(np.int32)
    senders = rng.integers(0, NUM_NODES, E).astype(np.int32)
    weights = rng.random(E, np.float32)
    x0 = rng.standard_normal((NUM_NODES, FEAT)).astype(np.float32)

    # sender-sorted copy of the same graph
    so = np.argsort(senders, kind="stable")
    s_s, r_s, w_s = senders[so], receivers[so], weights[so]

    from connectome_gnn_jax.ops import coo_spmm

    variants = {}

    variants["base"] = (
        lambda v, w, s, r: coo_spmm(w, s, r, v, NUM_NODES, indices_are_sorted=True),
        (jnp.asarray(weights), jnp.asarray(senders), jnp.asarray(receivers)),
    )

    variants["ssort"] = (
        lambda v, w, s, r: coo_spmm(w, s, r, v, NUM_NODES, indices_are_sorted=False),
        (jnp.asarray(w_s), jnp.asarray(s_s), jnp.asarray(r_s)),
    )

    def sget(v, w, s, r):
        rows = v.at[s].get(mode="promise_in_bounds", indices_are_sorted=True)
        msgs = rows * w[:, None]
        return jax.ops.segment_sum(msgs, r, num_segments=NUM_NODES)

    variants["sget"] = (
        sget, (jnp.asarray(w_s), jnp.asarray(s_s), jnp.asarray(r_s))
    )

    def scat(v, w, s, r):
        msgs = v[s] * w[:, None]
        return jnp.zeros((NUM_NODES, FEAT), v.dtype).at[r].add(
            msgs, mode="promise_in_bounds", indices_are_sorted=True
        )

    variants["scat"] = (
        scat, (jnp.asarray(weights), jnp.asarray(senders), jnp.asarray(receivers))
    )

    def bf16(v, w, s, r):
        out = coo_spmm(
            w, s, r, v.astype(jnp.bfloat16), NUM_NODES, indices_are_sorted=True
        )
        return out.astype(jnp.float32)

    variants["bf16"] = (
        bf16,
        (jnp.asarray(weights, jnp.bfloat16), jnp.asarray(senders),
         jnp.asarray(receivers)),
    )

    def diag(v, w, s, r):
        msgs = v[s] * w[:, None]
        return jnp.sum(msgs.reshape(AVG_DEG, NUM_NODES, FEAT), axis=0)

    variants["diag"] = (
        diag, (jnp.asarray(weights), jnp.asarray(senders), jnp.asarray(receivers))
    )

    def gonly(v, w, s, r):
        rows = v[s]
        # exact dependence on every gathered row, one cheap add per row
        return rows.reshape(AVG_DEG, NUM_NODES, FEAT)[0] + 0.001 * jnp.sum(
            rows.reshape(AVG_DEG, NUM_NODES, FEAT)[1:], axis=0
        )

    variants["gonly"] = (
        gonly, (jnp.asarray(weights), jnp.asarray(senders), jnp.asarray(receivers))
    )

    names = sys.argv[1].split(",") if len(sys.argv) > 1 else list(variants)
    for name in names:
        fn, consts = variants[name]
        dt = chained_loop_time(fn, jnp.asarray(x0), ITERS, *consts)
        print(
            f"{name:6s} {dt*1e3:8.2f} ms/spmm   {E/dt/1e6:8.1f} M edges/s",
            flush=True,
        )


if __name__ == "__main__":
    main()
