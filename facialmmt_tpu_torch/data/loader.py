"""Host-side batch loader: sampling, static-shape batches, background prefetch
(counterpart of facialmmt_tpu/data/loader.py; the index plan is numpy on both
sides, so the same seed and epoch give the same batches).

Replaces the reference's torch DataLoader + per-sample __getitem__ workers
(reference main.py:125-130) with an epoch iterator that
  * pads the final partial batch by repetition and reports n_valid (batch
    shapes stay static; eval trims with n_valid);
  * assembles batches in a background thread so host decode overlaps device
    compute;
  * yields numpy batches.
"""

from __future__ import annotations

import threading
import queue as queue_mod
from typing import Callable, Iterator, List

import numpy as np


def epoch_batches(n: int, batch_size: int, *, shuffle: bool,
                  seed: int = 0, epoch: int = 0) -> List[np.ndarray]:
    """Index batches for one epoch.  RandomSampler (train) or
    SequentialSampler (eval) semantics (reference main.py:128-130); the final
    partial batch is padded by repeating its last index."""
    order = np.arange(n)
    if shuffle:
        rng = np.random.default_rng(seed + epoch * 1_000_003)
        rng.shuffle(order)
    batches = []
    for start in range(0, n, batch_size):
        chunk = order[start:start + batch_size]
        n_valid = len(chunk)
        if n_valid < batch_size:
            chunk = np.concatenate(
                [chunk, np.full(batch_size - n_valid, chunk[-1])])
        batches.append((chunk, n_valid))
    return batches


class PrefetchLoader:
    """Iterate batches with background assembly.

    make_batch(indices) -> batch dict; runs in a worker thread `prefetch` ahead.
    Yields (batch, n_valid).
    """

    def __init__(self, make_batch: Callable, n: int, batch_size: int, *,
                 shuffle: bool, seed: int = 0, prefetch: int = 2):
        self.make_batch = make_batch
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = max(1, prefetch)

    def __len__(self):
        return (self.n + self.batch_size - 1) // self.batch_size

    def epoch(self, epoch: int = 0, start_batch: int = 0) -> Iterator:
        """start_batch > 0 skips the first `start_batch` batches of the epoch
        WITHOUT assembling them (exact mid-epoch resume: the index plan is a
        pure function of (seed, epoch), so the remaining batches are identical
        to the ones an uninterrupted run would have seen)."""
        plan = epoch_batches(self.n, self.batch_size, shuffle=self.shuffle,
                             seed=self.seed, epoch=epoch)[start_batch:]
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """Timed put so the worker exits if the consumer abandons the epoch
            (a plain q.put would block forever on the bounded queue)."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def worker():
            try:
                for indices, n_valid in plan:
                    if stop.is_set():
                        return
                    if not put((self.make_batch(indices), n_valid)):
                        return
            except Exception as e:  # surface worker errors to the consumer
                put(e)
            finally:
                put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
