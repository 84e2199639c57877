"""Profiling and timing utilities.

The reference has no tracing/profiling at all (SURVEY §5); the
equivalents here are thin wrappers over ``jax.profiler`` (device traces
viewable in XProf/TensorBoard) plus a dependency-free step timer for
throughput accounting in training loops and benchmarks.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import jax


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a device trace for the enclosed block.

    Example::

        with profiling.trace("/tmp/trace"):
            trainer.train_epoch(loader)
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StepTimer:
    """Wall-clock timer with device synchronization and simple stats.

    ``tic()``/``toc(result)`` around a step; ``toc`` blocks on ``result``
    so the measurement covers device execution, not just dispatch.
    """

    def __init__(self) -> None:
        self.times: list[float] = []
        self._t0: Optional[float] = None

    def tic(self) -> None:
        self._t0 = time.perf_counter()

    def toc(self, result=None) -> float:
        if result is not None:
            jax.block_until_ready(result)
        if self._t0 is None:
            raise RuntimeError("toc() without tic()")
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        self._t0 = None
        return dt

    @property
    def total(self) -> float:
        return sum(self.times)

    @property
    def mean(self) -> float:
        return self.total / len(self.times) if self.times else 0.0

    def summary(self, skip_first: int = 1) -> dict:
        """Mean/min/total excluding the first ``skip_first`` (compile) steps."""
        steady = self.times[skip_first:] or self.times
        return {
            "steps": len(self.times),
            "total_s": self.total,
            "mean_s": sum(steady) / len(steady) if steady else 0.0,
            "min_s": min(steady) if steady else 0.0,
        }
