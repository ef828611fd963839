"""Batching loader with a bounded prefetch thread (port of ``mrisr_tpu/data/loader.py``).

Batch ``i`` of epoch ``e`` holds the dataset items at the indices
:meth:`Loader._index_batches` gives for ``(seed, e)``: a numpy
``default_rng(seed + e)`` shuffle, as in the reference.  A background
thread stacks the items (or calls the dataset's vectorised ``get_batch``)
while the consumer trains.  With ``pin_memory`` the thread puts the batch's
arrays into pinned host tensors, so a copy to the card can be
``non_blocking``.  An abandoned iteration (a step-bounded loop that breaks
mid-epoch) stops and joins the thread.  There is no ``mesh`` argument until
the port runs on several devices.

:meth:`Loader.batches` runs epoch after epoch from a global batch number, so
a resumed training loop gets the batches the uninterrupted one would have.
``make_seconds`` and ``made`` add up the thread's time to make batches.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Iterator

import numpy as np
import torch


def _stack(samples: list[dict]) -> dict:
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], (np.ndarray, np.generic, float, int)):
            out[k] = np.stack([np.asarray(v) for v in vals])
        else:
            out[k] = vals  # strings etc.
    return out


def _pinned(batch: dict) -> dict:
    """The batch's numeric arrays as pinned host tensors; other entries as they are."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory() if isinstance(v, np.ndarray) else v
            for k, v in batch.items()}


class Loader:
    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = True,
        prefetch: int = 2,
        pin_memory: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.pin_memory = pin_memory
        self._epoch = 0
        self.make_seconds = 0.0
        self.made = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def batches(self, start: int = 0) -> Iterator[dict]:
        """Batches without end from global batch number ``start``: epoch ``start // len(self) + 1`` first,
        from its batch ``start % len(self)``."""
        per_epoch = len(self)
        if per_epoch == 0:
            raise ValueError(f"{len(self.dataset)} items make no batch of {self.batch_size}")
        epoch, skip = divmod(start, per_epoch)
        self._epoch = epoch
        while True:
            yield from self._iterate(skip)
            skip = 0

    def _index_batches(self, skip: int = 0):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        stop = n - n % self.batch_size if self.drop_last else n
        for s in range(skip * self.batch_size, stop, self.batch_size):
            yield idx[s : s + self.batch_size]

    def __iter__(self) -> Iterator[dict]:
        return self._iterate(0)

    def _iterate(self, skip: int) -> Iterator[dict]:
        """The next epoch's stacked batches (from its batch ``skip``) from a bounded prefetch thread.

        The thread only blocks on ``q.put`` with a timeout while it polls a
        stop event, so a consumer that stops early (and closes this
        generator) always gets it joined.  An error in the thread is raised
        on the consumer's side.
        """
        self._epoch += 1
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()
        errors: list[BaseException] = []
        # A dataset with a vectorised get_batch (the native slice cache's gather) skips the per-item loop.
        fast = getattr(self.dataset, "get_batch", None)

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch_idx in self._index_batches(skip):
                    if stop.is_set():
                        return
                    t0 = time.perf_counter()
                    item = fast(batch_idx) if fast is not None else _stack([self.dataset[int(i)] for i in batch_idx])
                    if self.pin_memory:
                        item = _pinned(item)
                    self.make_seconds += time.perf_counter() - t0
                    self.made += 1
                    if not put(item):
                        return
            except BaseException as e:  # surfaced on the consumer side
                errors.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
            if errors:
                raise errors[0]
        finally:
            stop.set()
            while True:  # unblock a worker waiting on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5.0)
