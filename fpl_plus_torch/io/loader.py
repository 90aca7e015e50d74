"""Data loader (replaces torch.utils.data.DataLoader; reference
net_run_dsbn/agent_abstract.py:241-318) with the JAX package's sampling
rules and worker pool (``io/loader.py`` there):

* ``shuffle``: epoch e visits the items in the order of
  ``np.random.RandomState(seed + e).shuffle``; otherwise manifest order;
* per-item seeding: the python/numpy RNG is seeded with ``seed + n`` before
  the n-th ``__getitem__`` the loader serves (per epoch from
  ``epoch * len(dataset)`` when iterated, counted across epochs by
  ``stream``), so the random transforms' draws depend neither on how the
  items are produced nor on how many workers produce them;
* ``drop_last`` drops a short final batch of an epoch;
* ``stream()`` / ``repeat_loader``: an endless stream of full batches that
  chains reshuffled epochs without a barrier (an epoch may end mid-batch).

``num_workers = 0`` produces the items in the calling thread; a lock keeps
loaders in two threads from interleaving their draws on the process-wide
RNG (``host_random`` takes it for the agents' own draws).

``num_workers > 0`` produces them in a pool of worker processes, started at
the first iteration:

* the multiprocessing context is ``forkserver`` (``spawn`` where there is
  none), never ``fork``: the main process holds a CUDA context;
* the workers import the dataset chain only (``io/``, ``transforms/``:
  numpy and scipy, no torch) and never touch the card. The main module is
  hidden while they start, because spawn and forkserver children would
  otherwise re-import it (a script such as ``chip_smoke.py``, or the CLI,
  imports torch); the forkserver preloads the chain, so a worker starts as
  a fork of a warm interpreter;
* a worker takes ``(tag, position, item, seed)`` tasks, seeds the RNG with
  ``seed``, and returns the sample: its arrays' bytes in a shared-memory
  segment, the rest pickled through a queue (through a pipe, the
  flagship's ~7 MB items cost the main process several copies under the
  interpreter lock: PERF.md); the main process copies the arrays out,
  removes the segment, and collates in order within a window of 2 items
  per worker (at least ``batch_size`` in ``stream``), so the batches are
  bit-identical to the synchronous path's;
* a worker's exception re-raises here with the item named, and a worker
  that exits raises: nothing falls back to the synchronous path.
  ``shutdown()`` (the agents call it at the end of a run and on error, and
  ``__del__`` does) stops and joins them; they are daemons, and each also
  exits when the main process is gone.

Collation stacks equal-shaped arrays into a leading batch axis, turns
scalars into [N] arrays and keeps strings as lists (the transform-inverse
JSON params survive as singleton lists, like torch collation did in the
reference). ``prefetch_iter`` produces the next items in a thread while the
device works on the current one.
"""
from __future__ import annotations

import contextlib
import itertools
import multiprocessing as mp
import pickle
import queue
import random
import sys
import threading
import time
import traceback
import types
from multiprocessing import shared_memory
from typing import Dict, Iterator, List, Optional

import numpy as np


# The python and numpy RNGs are process-wide. A loader holds this lock from
# seeding an item to the end of its transforms, so a train stream produced
# in a prefetch thread and a valid loader read in the main thread cannot
# interleave their draws.
_RNG_LOCK = threading.Lock()

# what the forkserver imports once, so that workers fork with it loaded
_PRELOAD = ['fpl_plus_torch.io.loader', 'fpl_plus_torch.io.dataset',
            'fpl_plus_torch.transforms.trans_dict']
_POLL_S = 1.0      # how often a waiting side checks that the other lives
_PREFETCH = 2      # items in flight per worker


def _seed_all(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))


def _seeded_item(dataset, index: int, seed: int):
    with _RNG_LOCK:
        _seed_all(seed)
        return dataset[index]


def host_random(draw):
    """``draw()``, a draw from the process-wide numpy RNG (the paradigm
    agents' per-iteration choices), under the loaders' lock: it never lands
    between an item's seeding and the end of its transforms. Pool workers
    seed their own processes' RNGs, so with them the draw no longer shares
    its RNG with item seeding."""
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


def _to_shared(sample):
    """``(pickle, segment name, [(offset, size)])``: the sample pickled with
    its arrays' bytes out of band, in one shared-memory segment (None when
    it has no array)."""
    buffers = []
    head = pickle.dumps(sample, protocol=5, buffer_callback=buffers.append)
    raws = [b.raw() for b in buffers]
    if not raws:
        return head, None, []
    shm = shared_memory.SharedMemory(create=True,
                                     size=sum(r.nbytes for r in raws))
    spans, offset = [], 0
    for raw in raws:
        shm.buf[offset:offset + raw.nbytes] = raw
        spans.append((offset, raw.nbytes))
        offset += raw.nbytes
    shm.close()
    return head, shm.name, spans


def _from_shared(payload):
    """The sample of a ``_to_shared`` payload, its arrays copied out; the
    segment is removed."""
    head, name, spans = payload
    if name is None:
        return pickle.loads(head)
    shm = shared_memory.SharedMemory(name=name)
    try:
        views = [shm.buf[o:o + n] for o, n in spans]
        sample = pickle.loads(head, buffers=views)
        out = {k: (np.array(v) if isinstance(v, np.ndarray) else v)
               for k, v in sample.items()}
        del sample
        for view in views:
            view.release()
    finally:
        shm.close()
        shm.unlink()
    return out


def _release(payload) -> None:
    """Remove the segment of a payload that will not be read."""
    if payload is not None and payload[1] is not None:
        shm = shared_memory.SharedMemory(name=payload[1])
        shm.close()
        shm.unlink()


def _worker_loop(dataset, task_q, result_q, stop) -> None:
    """A pool worker: seed, produce, share, until told to stop or the main
    process is gone."""
    parent = mp.parent_process()
    while True:
        try:
            task = task_q.get(timeout=_POLL_S)
        except queue.Empty:
            if parent is not None and not parent.is_alive():
                return
            continue
        if task is None or stop.is_set():
            return
        tag, pos, item, seed = task
        _seed_all(seed)
        try:
            result = (tag, pos, _to_shared(dataset[item]), None)
        except Exception:
            result = (tag, pos, None, 'item {0} (seed {1}):\n{2}'.format(
                item, seed, traceback.format_exc()))
        result_q.put(result)


def _context():
    try:
        ctx = mp.get_context('forkserver')
    except ValueError:
        return mp.get_context('spawn')
    ctx.set_forkserver_preload(_PRELOAD)   # no effect once the server runs
    return ctx


@contextlib.contextmanager
def _main_module_hidden():
    """Spawn and forkserver children re-import the parent's ``__main__``
    (by path or module name) before they unpickle their target. The
    workers' target and dataset live in this package, so they need nothing
    of it: while they start, ``__main__`` is an empty module."""
    main = sys.modules['__main__']
    sys.modules['__main__'] = types.ModuleType('__main__')
    try:
        yield
    finally:
        sys.modules['__main__'] = main


class DataLoader:
    """Batches of ``batch_size`` items (see the module docstring)."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 num_workers: int = 0, seed: int = 0, drop_last: bool = False):
        if num_workers < 0:
            raise ValueError('num_workers must be >= 0, got {0}'.format(
                num_workers))
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0
        self._pool = None
        self._tags = itertools.count()
        self._received = {}

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(idx)
        return idx

    # -- worker pool ------------------------------------------------------
    def _ensure_pool(self) -> None:
        if self._pool is not None:
            return
        ctx = _context()
        self._task_q, self._result_q = ctx.Queue(), ctx.Queue()
        self._stop = ctx.Event()
        self._pool = []
        try:
            with _main_module_hidden():
                for _ in range(self.num_workers):
                    p = ctx.Process(target=_worker_loop,
                                    args=(self.dataset, self._task_q,
                                          self._result_q, self._stop),
                                    daemon=True)
                    p.start()
                    self._pool.append(p)
        except BaseException:
            self.shutdown()
            raise

    def shutdown(self) -> None:
        """Stop and join the worker processes (a no-op without a pool)."""
        pool, self._pool = self._pool, None
        if pool is None:
            return
        self._stop.set()
        for _ in pool:
            self._task_q.put(None)
        # the workers finish the item in hand; the segments of results
        # never read (received, queued) are removed meanwhile
        for payload, _ in self._received.values():
            _release(payload)
        self._received.clear()
        deadline = time.monotonic() + 10
        while True:
            try:
                _release(self._result_q.get(timeout=0.1)[2])
            except queue.Empty:
                if not any(p.is_alive() for p in pool) or \
                        time.monotonic() > deadline:
                    break
        for p in pool:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        while True:              # what the last workers put before exiting
            try:
                _release(self._result_q.get_nowait()[2])
            except queue.Empty:
                break
        for q in (self._task_q, self._result_q):
            q.cancel_join_thread()
            q.close()

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass

    def _submit(self, tag, pos: int, item: int, seed: int) -> None:
        self._task_q.put((tag, pos, item, seed))

    def _receive(self, tag, pos: int):
        """The sample of task ``(tag, pos)``, waiting for the workers;
        raises on a worker's error or exit."""
        key = (tag, pos)
        while key not in self._received:
            if self._pool is None:
                raise RuntimeError('the loader was shut down')
            try:
                r_tag, r_pos, payload, err = self._result_q.get(
                    timeout=_POLL_S)
            except queue.Empty:
                dead = [p for p in self._pool if p.exitcode is not None]
                if dead:
                    codes = [(p.pid, p.exitcode) for p in dead]
                    self.shutdown()
                    raise RuntimeError('data worker (pid, exit code) {0} '
                                       'exited'.format(codes))
                continue
            if r_tag == tag:
                self._received[(r_tag, r_pos)] = (payload, err)
            else:                # a result of an abandoned iteration
                _release(payload)
        payload, err = self._received.pop(key)
        if err is not None:
            self.shutdown()
            raise RuntimeError('data worker failed on ' + err)
        return _from_shared(payload)

    def _pooled(self, items: Iterator[int], seed_base: int, window: int):
        """The samples of ``items`` in order, item n seeded with
        ``seed_base + n``, produced by the pool with ``window`` items in
        flight."""
        self._ensure_pool()
        tag = next(self._tags)
        for payload, _ in self._received.values():
            _release(payload)
        self._received.clear()
        submitted = 0
        for item in itertools.islice(items, window):
            self._submit(tag, submitted, int(item), seed_base + submitted)
            submitted += 1
        for pos in itertools.count():
            if pos == submitted:
                return
            sample = self._receive(tag, pos)
            for item in itertools.islice(items, 1):
                self._submit(tag, submitted, int(item),
                             seed_base + submitted)
                submitted += 1
            yield sample

    def _synced(self, items: Iterator[int], seed_base: int):
        for n, item in enumerate(items):
            yield _seeded_item(self.dataset, int(item), seed_base + n)

    def _samples(self, items: Iterator[int], seed_base: int, window: int):
        if self.num_workers == 0:
            return self._synced(items, seed_base)
        return self._pooled(items, seed_base, window)

    # -- iteration --------------------------------------------------------
    def __iter__(self) -> Iterator[Dict[str, object]]:
        indices = self._epoch_indices(self._epoch)
        epoch_base = self._epoch * len(self.dataset)
        self._epoch += 1
        buf = []
        for sample in self._samples(iter(indices), self.seed + epoch_base,
                                    self.num_workers * _PREFETCH):
            buf.append(sample)
            if len(buf) == self.batch_size:
                yield collate(buf)
                buf = []
        if buf and not self.drop_last:
            yield collate(buf)

    def stream(self) -> Iterator[Dict[str, object]]:
        """Endless full batches over reshuffled epochs, no epoch barrier;
        item n of the stream is seeded with ``seed + n``. The epoch counter
        follows the items consumed, not the pool's look-ahead."""
        n = len(self.dataset)
        if n == 0:
            raise ValueError('cannot stream from an empty dataset')
        start = self._epoch
        window = max(self.num_workers * _PREFETCH, self.batch_size)
        indices = itertools.chain.from_iterable(
            self._epoch_indices(e) for e in itertools.count(start))
        buf = []
        for consumed, sample in enumerate(
                self._samples(indices, self.seed, window), 1):
            buf.append(sample)
            if len(buf) == self.batch_size:
                self._epoch = start + consumed // n
                yield collate(buf)
                buf = []


def repeat_loader(loader) -> Iterator:
    """Endless iterator over a loader (reference repeat_dataloader,
    agent_seg.py:150-153): a DataLoader's ``stream``, else its epochs one
    after the other."""
    if isinstance(loader, DataLoader):
        yield from loader.stream()
    else:
        while True:
            yield from loader


def prefetch_iter(iterable, depth: int = 2, name: Optional[str] = None):
    """Thread-backed look-ahead over any iterable: item i+1's production
    (NIfTI decode, transform chain — gzip/numpy release the GIL) overlaps
    the consumer's work on item i. Used by the agent's test stage so host
    decode hides under device inference, and around its train batches;
    errors re-raise at the consumer. Closing the generator returns once
    the producer thread has finished the item in hand.

    ``name`` (``test_loader``, ``train_loader``): the consumer's waits run
    in the span ``<name>_wait`` (``utils/trace_metrics.py``), and each
    item the producer draws adds its seconds to the counter
    ``<name>_produce`` (a thread the profiler does not record)."""
    # imported here: the pool's workers load this module, and no torch
    from fpl_plus_torch.utils.trace_metrics import count, span
    q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
    sentinel = object()
    failure = []
    stop = threading.Event()
    wait = (lambda: span(name + '_wait')) if name else contextlib.nullcontext

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
            items = iter(iterable)
            while True:
                t0 = time.perf_counter()
                item = next(items, sentinel)
                if item is sentinel:
                    break
                if name:
                    count(name + '_produce', time.perf_counter() - t0)
                if not _put_until_stop(item):
                    return
        except BaseException as exc:   # surface to the consumer
            failure.append(exc)
        _put_until_stop(sentinel)

    thread = threading.Thread(target=_producer, daemon=True)
    thread.start()
    try:
        while True:
            with wait():
                item = q.get()
            if item is sentinel:
                if failure:
                    raise failure[0]
                return
            yield item
    finally:
        # consumer raised or abandoned the generator: stop the producer (it
        # may be blocked in put holding decoded volumes) and wait until it
        # has left the iterable, so that what the iterable reads (a
        # loader's pool) is not in use when its owner shuts it down; then
        # drop what it queued
        stop.set()
        thread.join()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
