"""Background-thread batch prefetching.

Host-side collation (packing + padding + ``jnp.asarray``) runs on the CPU
while the previous step executes on the device.  ``PrefetchIterator`` wraps any
batch iterable with a bounded background producer thread, so collate and
host→device transfer overlap device compute — the stand-in for
the reference loader's synchronous per-batch packing (reference
``connectome_gnn/graph.py:190-197``, which re-collates inside the hot loop).

Usage::

    for batch in PrefetchIterator(loader, depth=2):
        step(batch)

or wrap a loader once for all epochs::

    loader = PrefetchLoader(ConnectomeDataLoader(...), depth=2)
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator


class PrefetchIterator:
    """Iterate ``iterable`` with ``depth`` batches produced ahead.

    Safe against partial consumption: abandoning the iterator (or calling
    :meth:`close`, also done by ``__del__``) unblocks and stops the
    producer thread so queued batches don't stay pinned for the process
    lifetime.
    """

    _SENTINEL = object()

    def __init__(self, iterable: Iterable, depth: int = 2):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._error: list[BaseException] = []
        self._closed = threading.Event()
        self._done = False

        def producer() -> None:
            try:
                for item in iterable:
                    # bounded put that gives up when the consumer is gone
                    while not self._closed.is_set():
                        try:
                            self._queue.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if self._closed.is_set():
                        return
            except BaseException as exc:  # surface in consumer
                self._error.append(exc)
            finally:
                while not self._closed.is_set():
                    try:
                        self._queue.put(self._SENTINEL, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=producer, daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop the producer and release queued batches."""
        self._closed.set()
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=1.0)

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._queue.get()
        if item is self._SENTINEL:
            self._done = True
            self._thread.join()
            if self._error:
                raise self._error[0]
            raise StopIteration
        return item


class PrefetchLoader:
    """Loader wrapper: every ``iter()`` starts a fresh prefetching pass."""

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = depth

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self) -> PrefetchIterator:
        return PrefetchIterator(self.loader, depth=self.depth)
