"""Host-side batch prefetching (counterpart of mofanerf_tpu/data/prefetch.py).

A background thread prepares the next batches' host work (disk reads,
decoding, index sampling, the copies to the card) while the card runs the
current step.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator


class Prefetcher:
    """Wraps a `make_batch(step) -> batch` callable with a lookahead thread."""

    def __init__(self, make_batch: Callable[[int], object], depth: int = 2):
        self.make_batch = make_batch
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc = None

    def _worker(self, start: int, n: int) -> None:
        try:
            for i in range(start, n):
                if self._stop.is_set():
                    return
                self.q.put(self.make_batch(i))
        except Exception as e:  # surfaced on the next item
            self._exc = e
            self.q.put(None)

    def iterate(self, start: int, n: int) -> Iterator:
        t = threading.Thread(target=self._worker, args=(start, n), daemon=True)
        t.start()
        try:
            for _ in range(start, n):
                item = self.q.get()
                if item is None and self._exc is not None:
                    raise self._exc
                yield item
        finally:
            self._stop.set()
