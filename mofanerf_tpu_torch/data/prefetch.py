"""Host-side batch prefetching (counterpart of mofanerf_tpu/data/prefetch.py).

A background thread prepares the next batches' host work (disk reads,
decoding, index sampling, the copies to the card) while the card runs the
current step. `ImagePool` is RefineNet's replay buffer of fakes.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np


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


class ImagePool:
    """Replay buffer for the discriminator's fakes (pix2pixHD's ImagePool).
    pool_size 0, the reference's setting, passes images through. Its draws
    are the JAX package's, from `np.random.default_rng(seed)` in the same
    order."""

    def __init__(self, pool_size: int = 0, seed: int = 0):
        self.pool_size = pool_size
        self.images = []
        self.rng = np.random.default_rng(seed)

    def query(self, images):
        if self.pool_size == 0:
            return images
        out = []
        for img in np.asarray(images):
            if len(self.images) < self.pool_size:
                self.images.append(img)
                out.append(img)
            elif self.rng.uniform() > 0.5:
                idx = int(self.rng.integers(self.pool_size))
                out.append(self.images[idx])
                self.images[idx] = img
            else:
                out.append(img)
        return np.stack(out)
