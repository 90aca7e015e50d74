"""Synchronous data loader (replaces torch.utils.data.DataLoader;
reference net_run_dsbn/agent_abstract.py:241-318) with the JAX package's
sampling rules (``io/loader.py`` there, its ``num_workers=0`` path):

* ``shuffle``: epoch e visits the items in the order of
  ``np.random.RandomState(seed + e).shuffle``; otherwise manifest order;
* per-item seeding: the python/numpy RNG is seeded with ``seed + n`` before
  the n-th ``__getitem__`` the loader serves (per epoch from
  ``epoch * len(dataset)`` when iterated, counted across epochs by
  ``stream``), so the random transforms' draws do not depend on how the
  items are produced; a lock keeps loaders in two threads from
  interleaving their draws;
* ``drop_last`` drops a short final batch of an epoch;
* ``stream()`` / ``repeat_loader``: an endless stream of full batches that
  chains reshuffled epochs without a barrier (an epoch may end mid-batch).

Collation stacks equal-shaped arrays into a leading batch axis, turns
scalars into [N] arrays and keeps strings as lists (the transform-inverse
JSON params survive as singleton lists, like torch collation did in the
reference). ``prefetch_iter`` produces the next items in a thread while the
device works on the current one. The JAX package's worker-process pool is
not ported: ``num_workers`` is accepted and the loader stays synchronous.
"""
from __future__ import annotations

import queue
import random
import threading
from typing import Dict, Iterator, List

import numpy as np


# The python and numpy RNGs are process-wide. A loader holds this lock from
# seeding an item to the end of its transforms, so a train stream produced
# in a prefetch thread and a valid loader read in the main thread cannot
# interleave their draws.
_RNG_LOCK = threading.Lock()


def _seeded_item(dataset, index: int, seed: int):
    with _RNG_LOCK:
        random.seed(seed)
        np.random.seed(seed % (2 ** 32))
        return dataset[index]


def host_random(draw):
    """``draw()``, a draw from the process-wide numpy RNG (the paradigm
    agents' per-iteration choices), under the loaders' lock: it never lands
    between an item's seeding and the end of its transforms."""
    with _RNG_LOCK:
        return draw()


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
    """Batches of ``batch_size`` items (see the module docstring)."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[Dict[str, object]]:
        indices = self._epoch_indices()
        epoch_base = self._epoch * len(self.dataset)
        self._epoch += 1
        buf = []
        for i, item_idx in enumerate(indices):
            buf.append(_seeded_item(self.dataset, int(item_idx),
                                    self.seed + epoch_base + i))
            if len(buf) == self.batch_size:
                yield collate(buf)
                buf = []
        if buf and not self.drop_last:
            yield collate(buf)

    def stream(self) -> Iterator[Dict[str, object]]:
        """Endless full batches over reshuffled epochs, no epoch barrier;
        item n of the stream is seeded with ``seed + n``."""
        if len(self.dataset) == 0:
            raise ValueError('cannot stream from an empty dataset')
        counter = 0
        buf = []
        while True:
            for item_idx in self._epoch_indices():
                buf.append(_seeded_item(self.dataset, int(item_idx),
                                        self.seed + counter))
                counter += 1
                if len(buf) == self.batch_size:
                    yield collate(buf)
                    buf = []
            self._epoch += 1


def repeat_loader(loader) -> Iterator:
    """Endless iterator over a loader (reference repeat_dataloader,
    agent_seg.py:150-153): a DataLoader's ``stream``, else its epochs one
    after the other."""
    if isinstance(loader, DataLoader):
        yield from loader.stream()
    else:
        while True:
            yield from loader


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
