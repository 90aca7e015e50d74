"""Synchronous data loader (replaces torch.utils.data.DataLoader for the
test stage; reference net_run_dsbn/agent_abstract.py:241-318).

Per-item seeding (``seed + items_served``) of the python/numpy RNG before
each ``__getitem__``, in manifest order. Collation stacks equal-shaped
arrays into a leading batch axis, turns scalars into [N] arrays and keeps
strings as lists (the transform-inverse JSON params survive as singleton
lists, like torch collation did in the reference). ``prefetch_iter`` decodes
the next batch in a thread while the device works on the current one. The
multiprocess worker pool belongs to the training slice.
"""
from __future__ import annotations

import queue
import random
import threading
from typing import Dict, Iterator, List

import numpy as np


def _seed_all(seed: int):
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))


def collate(samples: List[dict]) -> Dict[str, object]:
    batch: Dict[str, object] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        first = vals[0]
        if isinstance(first, np.ndarray):
            batch[key] = np.stack(vals, axis=0)
        elif isinstance(first, (int, float, np.integer, np.floating)):
            batch[key] = np.asarray(vals)
        else:
            batch[key] = vals   # strings (names, JSON params), tuples
    return batch


class DataLoader:
    """In-order batches of ``batch_size`` (the last one may be short)."""

    def __init__(self, dataset, batch_size: int = 1, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, object]]:
        buf = []
        for i in range(len(self.dataset)):
            _seed_all(self.seed + i)
            buf.append(self.dataset[i])
            if len(buf) == self.batch_size:
                yield collate(buf)
                buf = []
        if buf:
            yield collate(buf)


def prefetch_iter(iterable, depth: int = 2):
    """Thread-backed look-ahead over any iterable: item i+1's production
    (NIfTI decode, transform chain — gzip/numpy release the GIL) overlaps
    the consumer's work on item i. Used by the agent's test stage so host
    decode hides under device inference; errors re-raise at the consumer."""
    q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
    sentinel = object()
    failure = []
    stop = threading.Event()

    def _put_until_stop(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False   # consumer abandoned the generator

    def _producer():
        try:
            for item in iterable:
                if not _put_until_stop(item):
                    return
        except BaseException as exc:   # surface to the consumer
            failure.append(exc)
        _put_until_stop(sentinel)

    thread = threading.Thread(target=_producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if failure:
                    raise failure[0]
                return
            yield item
    finally:
        # consumer raised or abandoned the generator: release the producer
        # (it may be blocked in put holding decoded volumes) and drain
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
