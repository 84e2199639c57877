"""In-run fault detection and preemption handling.

The reference suite has no failure-recovery story (SURVEY §5: the row the
round-1 review left partial).  On accelerator jobs the failure modes that matter
are:

* **numeric blowup** — a bad batch / LR spike produces a non-finite loss
  or gradient; one such step silently poisons the parameters and every
  step after it.  :func:`guard_step_outputs` detects this INSIDE the
  jitted step (a tree-reduce over the gradients fuses into the backward
  pass; no host sync) and makes the step a no-op: parameters, model
  state and optimizer state keep their old values, and the step reports
  ``ok=0`` so the trainer can count skipped steps — exactly one host
  sync per epoch, like the loss accumulation.
* **preemption** — cloud and cluster jobs get SIGTERM with a grace window.
  :class:`PreemptionGuard` turns the signal into a flag the training
  loop polls at epoch boundaries; combined with the atomic fit
  checkpoint (:meth:`Trainer.fit(checkpoint_dir=...)`) the job persists
  its full state and exits cleanly, and ``resume=True`` continues it.
* **elasticity** — checkpoints hold replicated, device-count-agnostic
  pytrees, and the data-parallel step's numerics are shard-count
  invariant (globally-normalized loss, sync-BN).  A run checkpointed on
  one topology therefore resumes EXACTLY on another (single device ↔
  N-device mesh), which is the practical recovery path when a slice
  comes back at a different size.  Proven in
  ``tests/test_fault.py::TestElasticResume``.

When every value is finite the guard is the identity — the selects fold
to the new values — so it is safe (and on by default) in the production
trainer; the clean-run equivalence is asserted bitwise in
``tests/test_fault.py``.
"""

from __future__ import annotations

import signal

import jax
import jax.numpy as jnp


def all_finite(*trees) -> jnp.ndarray:
    """Scalar bool: every array leaf of every pytree is entirely finite.

    Cost is one ``isfinite`` + reduce per leaf, fused by XLA into the
    producing computation — negligible next to the matmuls.
    """
    ok = jnp.asarray(True)
    for tree in trees:
        for leaf in jax.tree_util.tree_leaves(tree):
            ok = jnp.logical_and(ok, jnp.all(jnp.isfinite(leaf)))
    return ok


def select_tree(ok: jnp.ndarray, new_tree, old_tree):
    """Leaf-wise ``where(ok, new, old)`` — the no-op update when a step
    is rejected.  ``ok`` must be a scalar bool."""
    return jax.tree_util.tree_map(
        lambda n, o: jnp.where(ok, n, o), new_tree, old_tree
    )


def guard_step_outputs(
    ok: jnp.ndarray,
    new_trees: tuple,
    old_trees: tuple,
    loss: jnp.ndarray,
    n: jnp.ndarray,
):
    """Apply the non-finite guard to a train step's outputs.

    Returns ``(trees, loss, n, ok_f32)`` where each tree in ``trees`` is
    the new value if ``ok`` else the old one, and a rejected step
    contributes ``loss=0, n=0`` to the epoch accumulators (so one bad
    batch cannot turn the epoch-mean loss into NaN).
    """
    trees = tuple(
        select_tree(ok, n_t, o_t) for n_t, o_t in zip(new_trees, old_trees)
    )
    zero = jnp.zeros_like(loss)
    return (
        trees,
        jnp.where(ok, loss, zero),
        jnp.where(ok, n, jnp.zeros_like(n)),
        ok.astype(jnp.float32),
    )


class PreemptionGuard:
    """Turn SIGTERM/SIGINT into a cooperative stop flag.

    Usage::

        with PreemptionGuard() as guard:
            for epoch in ...:
                train_epoch(...)
                if guard.triggered:
                    save_checkpoint(...); break

    The previous handlers are restored on exit.  A second signal while
    the guard is active falls through to the previous handler (so a
    double Ctrl-C still kills a hung job).
    """

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self.triggered = False
        self._previous = {}

    def _handle(self, signum, frame):
        if self.triggered:
            prev = self._previous.get(signum)
            if callable(prev):
                prev(signum, frame)
            elif prev == signal.SIG_DFL:
                signal.signal(signum, signal.SIG_DFL)
                signal.raise_signal(signum)
            return
        self.triggered = True

    def __enter__(self):
        for sig in self.SIGNALS:
            try:
                self._previous[sig] = signal.signal(sig, self._handle)
            except ValueError:
                # not the main thread — polling still works, signals
                # just won't be intercepted
                pass
        return self

    def __exit__(self, *exc):
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()
        return False
