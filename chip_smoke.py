#!/usr/bin/env python3
"""Smoke test of the train-and-serve path on NVIDIA GPUs.

Runs the system's main path once through the entry points a user calls,
at the published width (5 input features, hidden 64, 3 layers, batches
of 16 connectomes of 84 regions), with random weights from fixed seeds,
and checks every result against the plain float32 reference:

* ``train``   — ``Trainer.fit`` of GCNConnectome and GraphSAGEConnectome
                for 2 epochs: finite, falling loss (step time printed);
* ``serve``   — ``Trainer.predict`` on dense loaders (the fused Triton
                kernel at 84 regions, XLA at 360 regions / hidden 256 /
                batch 64) against ``model.apply`` at ``"highest"``;
* ``band``    — int8 band serving (bf16 and w8a8 activations) and one
                int8 training step on a 262,144-node spatial graph,
                F = 64, against the f32 band path at ``"highest"``;
* ``sampled`` — device-side sampled GraphSAGE training on a 262,144-node
                degree-16 graph, batch 1024, fanout (10, 10).

``--four`` runs only the four-GPU phase: data-parallel ``fit`` on four
cards against the same steps on one card, and graph-sharded sampling on
four shards against the replicated device sampler (keep-all fanout),
then a few graph-sharded ``fit`` steps with no exchange overflow.

Exits non-zero, printing no result, when JAX finds no GPU (or fewer than
four with ``--four``) or when any check fails.  The last line of stdout
is one JSON object naming the device.

Usage:
    python chip_smoke.py            # one GPU
    python chip_smoke.py --four     # four GPUs of one host
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time

import numpy as np

ONE_GPU_PHASES = ("train", "serve", "band", "sampled")
FOUR_GPU_PHASES = ("four",)

#: Max |predict − reference| / max |reference| when the kernel's and
#: XLA's float32 dots run at the default precision (TF32 on H100: 10
#: mantissa bits, ~5e-4 relative per product, compounded over 3 layers
#: and the head).
TF32_TOL = 2e-2
#: The same bound with IEEE float32 dots everywhere
#: (``default_matmul_precision("highest")``): only summation order
#: differs, so a TF32 or bf16 slip fails it.
F32_TOL = 1e-4
#: Int8-band serving bounds, as asserted by tests/test_banded_quant.py:
#: relative L2 error of bf16-activation and of w8a8 serving logits, and
#: the share of argmax predictions that must agree.
QUANT_SERVE_TOL, W8A8_SERVE_TOL = 5e-2, 8e-2
QUANT_AGREE, W8A8_AGREE = 0.99, 0.98
#: Int8 training: relative error of the loss and of the flat gradient.
QUANT_LOSS_TOL, QUANT_GRAD_TOL = 2e-2, 5e-2
#: Four cards vs one (data parallel): only reduction order differs.
DP_TOL = 5e-3


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-GPU phase (needs 4 GPUs)")
    return p.parse_args(argv)


def select_phases(args) -> tuple[tuple[str, ...], int]:
    """The phases to run and the number of GPUs they need."""
    if args.four:
        return FOUR_GPU_PHASES, 4
    return ONE_GPU_PHASES, 1


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def rel_max(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def agree(got, want) -> float:
    return float(np.mean(np.argmax(got, 1) == np.argmax(want, 1)))


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------


def phase_train():
    from connectome_gnn_jax import (
        ConnectomeDataLoader, GCNConnectome, GraphSAGEConnectome, Trainer,
        generate_dataset,
    )

    graphs = generate_dataset(num_subjects=300, seed=42)
    for cls in (GCNConnectome, GraphSAGEConnectome):
        tr = ConnectomeDataLoader(graphs[:240], batch_size=16, shuffle=True,
                                  seed=0)
        va = ConnectomeDataLoader(graphs[240:], batch_size=16, shuffle=False)
        trainer = Trainer(cls(5, 64, num_layers=3), seed=0)
        hist = trainer.fit(tr, va, num_epochs=2, patience=10, verbose=False)
        losses = hist["train_loss"]
        check(all(math.isfinite(v) for v in losses + hist["val_loss"]),
              f"{cls.__name__} finite loss {losses}")
        check(losses[-1] < losses[0], f"{cls.__name__} falling loss {losses}")
        check(sum(hist["skipped_steps"]) == 0,
              f"{cls.__name__} no skipped steps")
        t0 = time.perf_counter()
        trainer.train_epoch(tr)
        step_ms = (time.perf_counter() - t0) / len(tr) * 1e3
        print(f"train {cls.__name__}: train_loss {losses} val_loss "
              f"{hist['val_loss']}; step time {step_ms:.3f} ms "
              f"(batch 16, information only)")


def phase_serve():
    import jax

    from connectome_gnn_jax import (
        ConnectomeDataLoader, GCNConnectome, GraphSAGEConnectome, Trainer,
        generate_dataset,
    )
    from connectome_gnn_jax.ops.fused_pallas import fused_kernel_for

    for regions, hidden, B in ((84, 64, 16), (360, 256, 64)):
        graphs = generate_dataset(num_subjects=2 * B, num_regions=regions,
                                  k=16 if regions == 360 else 8, seed=1)
        loader = ConnectomeDataLoader(graphs, batch_size=B, shuffle=False,
                                      layout="dense")
        for cls in (GCNConnectome, GraphSAGEConnectome):
            model = cls(5, hidden, num_layers=3)
            trainer = Trainer(model, seed=0)
            batches = list(loader)
            # non-trivial BatchNorm statistics, as after training
            _, trainer.state = jax.jit(
                lambda p, s, b: model.apply(p, s, b, train=True,
                                            rng=jax.random.PRNGKey(1))
            )(trainer.params, trainer.state, batches[0])
            fused = fused_kernel_for(model, trainer.params, batches[0], "gpu")
            path = f"{fused.__name__} (Triton)" if fused else "XLA"

            apply = jax.jit(
                lambda p, s, b: model.apply(p, s, b, train=False)[0]
            )
            with jax.default_matmul_precision("highest"):
                ref = np.concatenate([
                    np.asarray(apply(trainer.params, trainer.state, b))[
                        np.asarray(b.graph_mask)]
                    for b in batches
                ])
                got_f32 = trainer.predict(loader)
            got = trainer.predict(loader)
            check(got.shape == ref.shape == (2 * B, 2),
                  f"predict shape {got.shape}")
            e_tf32, e_f32 = rel_max(got, ref), rel_max(got_f32, ref)
            print(f"serve {cls.__name__} {regions} regions hidden {hidden} "
                  f"batch {B} via {path}: reference float32 at 'highest'; "
                  f"predict at default precision (TF32 dots) rel err "
                  f"{e_tf32:.3e} (tol {TF32_TOL}); predict at 'highest' "
                  f"(IEEE float32 dots) rel err {e_f32:.3e} (tol {F32_TOL})")
            check(np.isfinite(got).all(), "finite logits")
            check(e_tf32 <= TF32_TOL, f"TF32 predict within {TF32_TOL}")
            check(e_f32 <= F32_TOL, f"float32 predict within {F32_TOL}")


def _spatial_graph(num_features: int, seed: int):
    from connectome_gnn_jax.data import generate_spatial_graph

    return generate_spatial_graph(262_144, degree=16, band=256,
                                  num_features=num_features, seed=seed)


def _one_hop_labels(g) -> np.ndarray:
    """Label = whether the weighted mean of the in-neighbours' first
    feature is above its median (a task one aggregation can learn)."""
    src, dst = g.edge_index
    num = np.bincount(dst, g.edge_weight * g.node_features[src, 0],
                      minlength=g.num_nodes)
    den = np.bincount(dst, g.edge_weight, minlength=g.num_nodes)
    agg = num / (den + 1e-8)
    return (agg > np.median(agg)).astype(np.int32)


def _quant_spmm_bound(a, q, x: np.ndarray) -> np.ndarray:
    """Per-entry bound on |int8 SpMM − f32 SpMM| (as in
    tests/test_banded_quant.py): rounding each band entry costs at most
    half its tile's scale times the window's |x|, and the bf16 casts at
    most 2⁻⁸ of the band's row mass times max |x|."""
    block, nb, W, n = a.block, a.num_blocks, a.bandwidth, a.num_nodes
    xp = np.zeros(((nb + 2 * W) * block, x.shape[1]), np.float32)
    xp[W * block : W * block + n] = x[:n]
    xb = np.abs(xp).reshape(nb + 2 * W, block, -1).sum(1)
    scales = np.asarray(q.scales)
    qbound = sum(scales[:, d : d + 1] / 2 * xb[d : d + nb]
                 for d in range(2 * W + 1))
    row_mass = np.abs(np.asarray(a.band)).sum(axis=(1, 3)).reshape(-1, 1)
    return (np.repeat(qbound, block, axis=0)[:n]
            + (row_mass * 2.0 ** -8 * np.abs(xp).max())[:n] + 1e-4)


def phase_band():
    """Eager calls: the band and its quantized forms are NamedTuples
    with static geometry, passed as they are."""
    import jax
    import jax.numpy as jnp
    import optax

    from connectome_gnn_jax.models import BandedNodeGCN, BandedNodeSAGE
    from connectome_gnn_jax.ops import (
        banded_spmm, banded_spmm_quant_fm, quantize_band, to_banded,
        to_feature_major,
    )

    g = _spatial_graph(64, seed=0)
    a = to_banded(g.edge_index[0], g.edge_index[1], g.edge_weight,
                  g.num_nodes, block=256)
    x = jnp.asarray(g.node_features)
    print(f"band: {g.num_nodes} nodes, {g.num_edges} edges, F=64, block "
          f"{a.block}, bandwidth {a.bandwidth} blocks")
    hi = jax.default_matmul_precision("highest")

    with hi:
        want = np.asarray(banded_spmm(a, x))
    got = np.asarray(
        banded_spmm_quant_fm(to_feature_major(quantize_band(a)), x.T).T
    )
    bound = _quant_spmm_bound(a, quantize_band(a), np.asarray(x))
    excess = float(np.max(np.abs(got - want) - bound))
    print(f"band spmm int8 x bf16 vs f32 at 'highest': rel L2 err "
          f"{rel_l2(got, want):.3e}; max (|err| - analytic bound) "
          f"{excess:.3e} (must be <= 0)")
    check(excess <= 0, "int8 SpMM within the analytic quantization bound")

    gcn = BandedNodeGCN(64, 64, num_layers=2)
    params, state = gcn.init(jax.random.PRNGKey(0))
    with hi:
        ref, _ = gcn.apply(params, state, a, x, train=False)
    adj_q, dinv = gcn.prepare_quantized(a)
    for w8a8, tol, need in ((False, QUANT_SERVE_TOL, QUANT_AGREE),
                            (True, W8A8_SERVE_TOL, W8A8_AGREE)):
        got, _ = gcn.apply_quantized(params, state, adj_q, dinv, x,
                                     w8a8=w8a8)
        e, ag = rel_l2(got, ref), agree(np.asarray(got), np.asarray(ref))
        print(f"band BandedNodeGCN apply_quantized w8a8={w8a8}: rel L2 err "
              f"{e:.3e} (tol {tol}), argmax agreement {ag:.4f} (need {need})")
        check(e < tol and ag > need, f"GCN int8 serving w8a8={w8a8}")

    sage = BandedNodeSAGE(64, 64, num_layers=2)
    sp, ss = sage.init(jax.random.PRNGKey(1))
    with hi:
        ref, _ = sage.apply(sp, ss, a, x, train=False)
    adj_q, w_sum = sage.prepare_quantized(a)
    got, _ = sage.apply_quantized(sp, ss, adj_q, w_sum, x)
    e, ag = rel_l2(got, ref), agree(np.asarray(got), np.asarray(ref))
    print(f"band BandedNodeSAGE apply_quantized: rel L2 err {e:.3e} (tol "
          f"{QUANT_SERVE_TOL}), argmax agreement {ag:.4f}")
    check(e < QUANT_SERVE_TOL and ag > QUANT_AGREE, "SAGE int8 serving")

    labels = jnp.asarray(_one_hop_labels(g))
    q, qT, dinv = gcn.prepare_quant_trainable(a)
    adj_norm, _ = gcn.prepare(a)

    def loss(p, fwd):
        logits, _ = fwd(p)
        return jnp.mean(
            optax.softmax_cross_entropy_with_integer_labels(logits, labels))

    quant_fwd = lambda p: gcn.apply_quant_trainable(  # noqa: E731
        p, state, q, qT, dinv, x, train=True)
    f32_fwd = lambda p: gcn.apply_normalized(  # noqa: E731
        p, state, adj_norm, dinv, x, train=True)
    lq, gq = jax.value_and_grad(lambda p: loss(p, quant_fwd))(params)
    with hi:
        lf, gf = jax.value_and_grad(lambda p: loss(p, f32_fwd))(params)
    flat = lambda t: np.concatenate(  # noqa: E731
        [np.asarray(v).ravel() for v in jax.tree_util.tree_leaves(t)])
    e_loss = abs(float(lq) - float(lf)) / abs(float(lf))
    e_grad = rel_l2(flat(gq), flat(gf))
    opt = optax.adam(1e-3)
    new = optax.apply_updates(params, opt.update(gq, opt.init(params),
                                                 params)[0])
    print(f"band int8 train step: loss {float(lq):.6f} vs f32 "
          f"{float(lf):.6f} (rel {e_loss:.3e}, tol {QUANT_LOSS_TOL}); "
          f"grad rel L2 err {e_grad:.3e} (tol {QUANT_GRAD_TOL})")
    check(e_loss < QUANT_LOSS_TOL and e_grad < QUANT_GRAD_TOL,
          "int8 training step within the quantization bound")
    check(np.isfinite(flat(new)).all(), "finite params after the step")


def phase_sampled():
    import jax

    from connectome_gnn_jax import Trainer
    from connectome_gnn_jax.data import device_sampled_sage

    g = _spatial_graph(64, seed=1)
    labels = _one_hop_labels(g)
    model = device_sampled_sage(g, hidden_dim=64, fanout=(10, 10),
                                dedup=False)
    rng = np.random.default_rng(0)
    tr = model.make_loader(rng.permutation(g.num_nodes)[:8 * 1024], labels,
                           batch_size=1024, seed=0, drop_last=True)
    va = model.make_loader(rng.permutation(g.num_nodes)[:2 * 1024], labels,
                           batch_size=1024, shuffle=False, drop_last=True)
    trainer = Trainer(model, seed=0)
    hist = trainer.fit(tr, va, num_epochs=2, patience=10, verbose=False)
    losses = hist["train_loss"] + hist["val_loss"]
    check(all(math.isfinite(v) for v in losses), f"finite loss {losses}")
    check(sum(hist["skipped_steps"]) == 0, "no skipped steps")
    t0 = time.perf_counter()
    trainer.train_epoch(tr)
    jax.block_until_ready(trainer.params)
    step_ms = (time.perf_counter() - t0) / len(tr) * 1e3
    print(f"sampled device_sampled_sage {g.num_nodes} nodes, batch 1024, "
          f"fanout (10, 10): train_loss {hist['train_loss']} val_loss "
          f"{hist['val_loss']}; step time {step_ms:.3f} ms (information only)")


def phase_four():
    import jax
    import jax.numpy as jnp

    from connectome_gnn_jax import (
        ConnectomeDataLoader, GCNConnectome, Trainer, generate_dataset,
    )
    from connectome_gnn_jax.data import DeviceGraphCSR, device_sample
    from connectome_gnn_jax.models.node_coo import BlockedNodeSAGE
    from connectome_gnn_jax.parallel import (
        ShardedGraphCSR, create_mesh, graph_sharded_sage,
        make_graph_sharded_sampled_forward,
    )
    from connectome_gnn_jax.train import reference_adam

    mesh = create_mesh(devices=jax.devices()[:4])
    hi = jax.default_matmul_precision("highest")

    # data parallel on four cards == the same steps on one card
    graphs = generate_dataset(num_subjects=96, seed=42)
    model = GCNConnectome(5, 64, num_layers=3, dropout=0.0)
    hists, trainers = [], []
    for shards in (None, 4):
        tr = ConnectomeDataLoader(graphs[:64], batch_size=16, shuffle=False,
                                  num_shards=shards)
        va = ConnectomeDataLoader(graphs[64:], batch_size=16, shuffle=False,
                                  num_shards=shards)
        t = Trainer(model, optimizer=reference_adam(1e-3), seed=0,
                    mesh=mesh if shards else None)
        with hi:
            hists.append(t.fit(tr, va, num_epochs=3, patience=10,
                               verbose=False))
        trainers.append(t)
    e_train = rel_max(hists[1]["train_loss"], hists[0]["train_loss"])
    e_val = rel_max(hists[1]["val_loss"], hists[0]["val_loss"])
    print(f"four: DP fit 4 cards vs 1 card, GCN hidden 64, batch 16: "
          f"train_loss {hists[1]['train_loss']} vs {hists[0]['train_loss']} "
          f"(rel {e_train:.3e}), val_loss rel {e_val:.3e} (tol {DP_TOL})")
    check(e_train < DP_TOL and e_val < DP_TOL, "DP losses match one card")
    for p4, p1 in zip(jax.tree_util.tree_leaves(trainers[1].params),
                      jax.tree_util.tree_leaves(trainers[0].params)):
        check(np.allclose(np.asarray(p4), np.asarray(p1), rtol=DP_TOL,
                          atol=5e-4), "DP params match one card")

    # graph-sharded sampler == replicated multiset sampler (keep-all)
    g = _spatial_graph(64, seed=1)
    csr = DeviceGraphCSR.from_graph(g)
    F = csr.max_in_degree
    sg = ShardedGraphCSR.partition(g, 4)
    inner = BlockedNodeSAGE(in_channels=64, hidden_dim=64, num_layers=2)
    params, state = inner.init(jax.random.PRNGKey(1))
    seeds = np.random.default_rng(0).permutation(g.num_nodes)[:4 * 256]
    seeds = seeds.reshape(4, 256).astype(np.int32)
    keys = np.stack([np.asarray(jax.random.key_data(jax.random.PRNGKey(r)))
                     for r in range(4)])
    fwd = make_graph_sharded_sampled_forward(inner, mesh, (F, F))
    with hi:
        sharded = np.asarray(fwd(params, state, sg, jnp.asarray(seeds),
                                 jnp.asarray(keys)))
        worst = 0.0
        for r in range(4):
            single = device_sample(csr, jnp.asarray(seeds[r]),
                                   jax.random.PRNGKey(50 + r), (F, F),
                                   dedup=False)
            want, _ = inner.apply(params, state, single, train=False)
            worst = max(worst, rel_max(sharded[r], want))
    print(f"four: graph-sharded keep-all fanout ({F}, {F}) on 4 shards vs "
          f"replicated multiset sampler, {g.num_nodes} nodes: rel err "
          f"{worst:.3e} (tol {F32_TOL})")
    check(worst <= F32_TOL, "graph-sharded matches the replicated sampler")

    labels = _one_hop_labels(g)
    gs_model = graph_sharded_sage(g, num_shards=4, hidden_dim=64,
                                  fanout=(10, 10))
    rng = np.random.default_rng(1)
    tr = gs_model.make_loader(rng.permutation(g.num_nodes)[:8 * 1024],
                              labels, batch_size=1024, seed=0,
                              drop_last=True)
    va = gs_model.make_loader(rng.permutation(g.num_nodes)[:2 * 1024],
                              labels, batch_size=1024, shuffle=False,
                              drop_last=True)
    trainer = Trainer(gs_model, mesh=mesh, seed=0)
    hist = trainer.fit(tr, va, num_epochs=2, patience=10, verbose=False)
    losses = hist["train_loss"] + hist["val_loss"]
    print(f"four: graph_sharded_sage fit on 4 shards, batch 1024: train_loss "
          f"{hist['train_loss']} val_loss {hist['val_loss']}; exchange "
          f"overflow {trainer.last_sampling_overflow}")
    check(all(math.isfinite(v) for v in losses), "finite graph-sharded loss")
    check(trainer.last_sampling_overflow == 0, "no exchange overflow")


PHASES = {
    "train": phase_train,
    "serve": phase_serve,
    "band": phase_band,
    "sampled": phase_sampled,
    "four": phase_four,
}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def main(argv=None) -> None:
    args = parse_args(argv)
    phases, need = select_phases(args)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU; JAX found {devices}")
    if len(devices) < need:
        raise SystemExit(f"chip_smoke: needs {need} GPUs, found {len(devices)}")

    from connectome_gnn_jax import native
    from connectome_gnn_jax.utils import enable_compile_cache

    cache = enable_compile_cache()
    print(card_line())
    print(f"device_kind {devices[0].device_kind}; {len(devices)} visible; "
          f"jax {jax.__version__}; compile cache {cache}; native host "
          f"library {native.AVAILABLE}; phases {list(phases)}", flush=True)
    for name in phases:
        t0 = time.perf_counter()
        PHASES[name]()
        print(f"phase {name} ok in {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices),
    }}))


if __name__ == "__main__":
    main()
