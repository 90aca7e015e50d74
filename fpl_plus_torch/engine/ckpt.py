"""Checkpoints in the reference ``.pt`` layout: resolution, loading,
atomic writing and an asynchronous writer.

Parity with the reference (PyMIC/pymic/net_run_dsbn/agent_abstract.py:136-153
and agent_seg.py:767-828): a checkpoint is ``{ckpt_dir}/{prefix}_{it}.pt``,
a ``torch.save`` of ``{'iteration', 'valid_pred', 'model_state_dict',
'optimizer_state_dict'}``; the sidecar text files ``{prefix}_latest.txt`` /
``{prefix}_best.txt`` hold the iteration number. ``ckpt_mode`` 0 = latest,
1 = best, 2 = the explicit ``ckpt_name``, 3 = the list ``ckpt_name`` of an
ensemble (the test stage averages its members' logits).

Durability and overlap, as in the JAX package's ``engine/ckpt.py`` (the
reference's ``torch.save`` is synchronous and not atomic):

* atomic: the artifact is written to ``<name>.tmp``, fsync'd, then
  ``os.replace``d into place and its directory fsync'd; the ``_latest.txt``
  pointer is written the same way only after that, so a crash at any point
  leaves the previous pointer naming a complete checkpoint;
* asynchronous: ``CheckpointWriter.submit`` snapshots the state to the CPU
  on the caller's thread (the optimizer updates the parameters in place, so
  the copy must finish before the next step) and a single worker thread
  pickles and writes. ``flush()`` drains the queue and re-raises the first
  worker error; the agent flushes before anything reads the files.

Data parallelism: every rank holds the same state, and only global rank
0 writes (``parallel/multihost.py`` ``is_primary_host``): artifacts,
pointers and the writer's snapshots are skipped on the other ranks. A
barrier comes before any rank reads what rank 0 wrote, and every rank
then loads the same file.

``average_checkpoints`` is the uniform mean of checkpoints' state dicts
(the JAX package's ``engine/ckpt.py:221-239``), which
``utils/model_operate.py`` writes out.
"""
from __future__ import annotations

import io
import os
import queue
import threading
from typing import Any, Dict, List, Optional, Union

import torch

from fpl_plus_torch.parallel.multihost import is_primary_host
from fpl_plus_torch.utils.trace_metrics import span


def ckpt_prefix_of(config: dict) -> str:
    ckpt_dir = config['training']['ckpt_save_dir']
    prefix = config['training'].get('ckpt_prefix', None)
    if prefix is None:
        prefix = ckpt_dir.split('/')[-1]
    return prefix


def checkpoint_path(ckpt_dir: str, prefix: str, iteration: int) -> str:
    return '{0}/{1}_{2}.pt'.format(ckpt_dir, prefix, iteration)


def get_checkpoint_name(config: dict) -> Union[str, List[str]]:
    """Resolve the inference checkpoint exactly like the reference: a path,
    or for ``ckpt_mode`` 3 a list of paths."""
    ckpt_mode = config['testing']['ckpt_mode']
    if ckpt_mode in (0, 1):
        ckpt_dir = config['training']['ckpt_save_dir']
        prefix = ckpt_prefix_of(config)
        txt = '{0}/{1}_{2}.txt'.format(
            ckpt_dir, prefix, 'latest' if ckpt_mode == 0 else 'best')
        with open(txt) as f:
            it_num = f.read().replace('\n', '')
        return checkpoint_path(ckpt_dir, prefix, it_num)
    if ckpt_mode in (2, 3):
        name = config['testing']['ckpt_name']
        if (ckpt_mode == 3) != isinstance(name, (list, tuple)):
            raise ValueError('ckpt_mode should be 3 if and only if ckpt_name '
                             'is a list, got ckpt_mode {0} and {1!r}'.format(
                                 ckpt_mode, name))
        return list(name) if ckpt_mode == 3 else name
    raise ValueError('Undefined ckpt_mode {0}'.format(ckpt_mode))


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load a reference-layout ``.pt`` checkpoint onto the CPU. Reference
    checkpoints carry numpy scalars (``valid_pred``), which torch's
    ``weights_only`` loader rejects, so the full unpickler runs: load only
    checkpoints this framework or the reference wrote."""
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    for key in ('iteration', 'model_state_dict'):
        if key not in ckpt:
            raise KeyError('{0} is not a reference-layout checkpoint (no '
                           '{1!r})'.format(path, key))
    return ckpt


# the state-dict entries that are batch statistics, not parameters
STATISTICS = ('running_mean', 'running_var', 'num_batches_tracked')


def average_checkpoints(paths: List[str]) -> Dict[str, torch.Tensor]:
    """The uniform mean of the ``model_state_dict`` of the checkpoints at
    ``paths``, entry by entry, accumulated in float64 and cast to the
    first checkpoint's dtypes (an integer entry truncates, as numpy's
    ``astype`` does in the JAX package)."""
    if not paths:
        raise ValueError('no checkpoints to average')
    acc, template = None, None
    for path in paths:
        sd = load_checkpoint(path)['model_state_dict']
        if template is None:
            template = sd
            acc = {k: v.to(torch.float64) for k, v in sd.items()}
        else:
            if set(sd) != set(acc):
                raise ValueError('{0} holds other entries than {1}'.format(
                    path, paths[0]))
            for k, v in sd.items():
                acc[k] += v.to(torch.float64)
    return {k: (acc[k] / len(paths)).to(template[k].dtype) for k in acc}


def _fsync_dir(path: str) -> None:
    """fsync the directory entry so a completed ``os.replace`` is durable
    before the next rename (artifact before pointer)."""
    fd = os.open(os.path.dirname(path) or '.', os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_write(path: str, data: bytes) -> None:
    """tmp + fsync + ``os.replace`` + directory fsync: ``path`` keeps its
    old content or holds the complete new content, never a torn write."""
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(path)


def _write_pointer(ckpt_dir: str, prefix: str, kind: str,
                   iteration: int) -> None:
    if not is_primary_host():
        return
    _atomic_write('{0}/{1}_{2}.txt'.format(ckpt_dir, prefix, kind),
                  str(iteration).encode())


def save_checkpoint(ckpt_dir: str, prefix: str, iteration: int,
                    state: Dict[str, Any], valid_pred: float,
                    update_latest: bool = True) -> str:
    """Write ``{prefix}_{iteration}.pt`` from ``state`` (its
    ``model_state_dict`` and ``optimizer_state_dict``), then, with
    ``update_latest``, the latest pointer (on the primary rank only)."""
    name = checkpoint_path(ckpt_dir, prefix, iteration)
    if not is_primary_host():
        return name
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {'iteration': iteration, 'valid_pred': float(valid_pred)}
    payload.update(state)
    buf = io.BytesIO()
    torch.save(payload, buf)
    _atomic_write(name, buf.getvalue())
    if update_latest:    # the pointer only after the artifact is durable
        _write_pointer(ckpt_dir, prefix, 'latest', iteration)
    return name


def write_best_pointer(ckpt_dir: str, prefix: str, iteration: int) -> None:
    _write_pointer(ckpt_dir, prefix, 'best', iteration)


def snapshot(tree):
    """A CPU copy of every tensor in a nested dict/list (state dicts,
    optimizer state), made now: later in-place updates do not reach it."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to('cpu', copy=True)
    if isinstance(tree, dict):
        return {k: snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(snapshot(v) for v in tree)
    return tree


class CheckpointWriter:
    """Background checkpoint writer with ``save_checkpoint``'s atomic rename
    and pointer-after-artifact order. One worker thread: submission order is
    pointer-update order, so ``_latest.txt`` always names the newest durable
    artifact. ``submit`` blocks when ``max_pending`` snapshots wait."""

    def __init__(self, max_pending: int = 2):
        self._q: 'queue.Queue' = queue.Queue(maxsize=max_pending)
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    def _loop(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                with span('ckpt_write'):   # a thread: counted, not traced
                    save_checkpoint(*item)
            except BaseException as exc:   # re-raised by flush()
                if self._error is None:    # keep the first error
                    self._error = exc
            finally:
                self._q.task_done()

    def _raise_error(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def submit(self, ckpt_dir: str, prefix: str, iteration: int,
               state: Dict[str, Any], valid_pred: float,
               update_latest: bool = True) -> str:
        """Snapshot ``state`` to the CPU now and queue its write (on the
        primary rank only)."""
        self._raise_error()
        if not is_primary_host():
            return checkpoint_path(ckpt_dir, prefix, iteration)
        snap = snapshot(state)
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
        self._q.put((ckpt_dir, prefix, iteration, snap, valid_pred,
                     update_latest))
        return checkpoint_path(ckpt_dir, prefix, iteration)

    def flush(self) -> None:
        """Block until every submitted checkpoint is durable; re-raise the
        first worker error."""
        self._q.join()
        self._raise_error()

    def close(self) -> None:
        """Flush, then stop the worker."""
        try:
            self.flush()
        finally:
            if self._thread is not None and self._thread.is_alive():
                self._q.put(None)
                self._thread.join(timeout=10)
            self._thread = None
