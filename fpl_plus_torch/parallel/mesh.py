"""Data-parallel scale-out over ranks (one card each) and the sharded
sliding window.

Counterpart of the JAX package's ``parallel/mesh.py``. There a 1-D device
mesh shards the batch and XLA runs the single-device program over the
global batch. Here each rank is a process that holds its rows of the
batch, and the global-batch quantities are collectives written out:

* ``Mesh``: the process group, this rank, the world size, this rank's
  device, and its place among its host's ranks;
* the DSBN / BatchNorm batch statistics of a train-mode forward are the
  global batch's (``models/dsbn.py``, through ``all_reduce_sum``, whose
  backward is again an all-reduce), and a train-mode dropout mask is drawn
  for the global batch, each rank keeping its rows (``models/common.py``):
  both read ``active_mesh()``, which a sharded train step sets;
* the loss sees the global batch: the prediction is gathered
  (``gather_rows``, whose backward keeps this rank's rows of the gradient,
  which every rank computes alike), and so are the labels and weights; the
  per-rank parameter gradients then sum to the global one
  (``engine/train.py``);
* a forward of two streams in one batch (the labelled and unlabelled rows
  of a semi-supervised step, DAST's clean and noisy rows) holds this
  rank's rows of each stream, one segment after the other: within
  ``batch_segments(sizes)`` its dropout masks are the one-card masks' rows
  of this rank in each segment, and ``gather_segments`` gathers its output
  in the one-card order (each segment over the ranks, then the segments);
* every collective is an ``all_reduce`` or a ``broadcast``: a gather is the
  all-reduce of a zero-filled buffer in which each rank fills its own
  slot, because gloo (the CPU backend, and the backend of two ranks that
  share one card) has only those two for CUDA tensors.
"""
from __future__ import annotations

import contextlib
import logging
import os
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from fpl_plus_torch.parallel import multihost


class Mesh:
    """The ranks of one data-parallel run. ``group``: a process group
    (None: the default group). ``local_rank`` / ``local_size``: this rank's
    place among the ranks that share its host's batch (default: the
    group's, as on one host)."""

    def __init__(self, group=None, device='cpu',
                 local_rank: Optional[int] = None,
                 local_size: Optional[int] = None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.device = torch.device(device)
        if local_size is None:
            local_rank, local_size = self.rank, self.size
        if self.size % local_size or not 0 <= local_rank < local_size:
            raise ValueError('local rank {0} of {1} in a group of {2}'.format(
                local_rank, local_size, self.size))
        self.local_rank = local_rank
        self.local_size = local_size

    def __repr__(self):
        return 'Mesh(rank {0} of {1}, {2})'.format(self.rank, self.size,
                                                    self.device)

    # -- collectives ----------------------------------------------------------
    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns it."""
        dist.all_reduce(t, group=self.group)
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        dist.broadcast(t, dist.get_global_rank(self.group, src)
                       if self.group is not None else src, group=self.group)
        return t

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """``[n, ...]`` on every rank -> ``[size * n, ...]``, rank r's rows
        at ``[r n, (r + 1) n)`` (all ranks hold the same ``n``)."""
        return self.gather_segments(t, (t.shape[0],))

    def segment_slices(self, sizes: Sequence[int]):
        """Where this rank's rows of consecutive segments of ``sizes`` rows
        each (the same sizes on every rank) lie in the global batch of the
        one-card order, whose segment s holds the ranks' rows of segment s
        in rank order: one slice per segment."""
        out, lo = [], 0
        for n in sizes:
            start = self.size * lo + self.rank * int(n)
            out.append(slice(start, start + int(n)))
            lo += int(n)
        return out

    def gather_segments(self, t: torch.Tensor,
                        sizes: Sequence[int]) -> torch.Tensor:
        """``t`` holds this rank's rows of consecutive segments of
        ``sizes`` rows -> the global batch in the one-card order
        (``segment_slices``) on every rank."""
        if sum(int(n) for n in sizes) != t.shape[0]:
            raise ValueError('segments {0} of a batch of {1}'.format(
                list(sizes), t.shape[0]))
        out = torch.zeros((self.size * t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        lo = 0
        for n, dst in zip(sizes, self.segment_slices(sizes)):
            out[dst] = t[lo:lo + int(n)]
            lo += int(n)
        return self.all_reduce(out)

    def segment_rows(self, t: torch.Tensor,
                     sizes: Sequence[int]) -> torch.Tensor:
        """This rank's rows of each segment of the global ``t``: the
        inverse of ``gather_segments``."""
        return torch.cat([t[s] for s in self.segment_slices(sizes)])

    def share(self, n: int) -> Tuple[int, int]:
        """This rank's contiguous share ``[lo, hi)`` of ``n`` items: the
        first ``n % size`` ranks take one more."""
        base, extra = divmod(n, self.size)
        lo = self.rank * base + min(self.rank, extra)
        return lo, lo + base + (1 if self.rank < extra else 0)


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The mesh over the joined process group, on this rank's device
    (default: its card when the backend is NCCL, else the CPU).
    ``n_devices`` must be the group's size."""
    if not dist.is_initialized():
        raise RuntimeError('make_mesh needs a process group: join one with '
                           'parallel.multihost.maybe_initialize_distributed')
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError('a mesh of {0} over a group of {1} ranks'.format(
            n_devices, size))
    if device is None:
        device = ('cuda:{0}'.format(torch.cuda.current_device())
                  if dist.get_backend() == 'nccl' else 'cpu')
    return Mesh(None, device, *multihost.local_layout())


_ACTIVE = {'mesh': None, 'segments': None}


def active_mesh() -> Optional[Mesh]:
    """The mesh of the data-parallel train step running now, else None."""
    return _ACTIVE['mesh']


def active_segments() -> Optional[Tuple[int, ...]]:
    """The segment sizes of the batch forwarded now (``batch_segments``),
    else None: the batch is one segment."""
    return _ACTIVE['segments']


@contextlib.contextmanager
def batch_segments(sizes: Optional[Sequence[int]]):
    """Within: the forward's batch is this rank's rows of consecutive
    segments of ``sizes`` rows each (None: one segment), so that a
    data-parallel step draws each segment's rows of the one-card masks."""
    prev = _ACTIVE['segments']
    _ACTIVE['segments'] = None if sizes is None else tuple(
        int(n) for n in sizes)
    try:
        yield
    finally:
        _ACTIVE['segments'] = prev


@contextlib.contextmanager
def data_parallel(mesh: Optional[Mesh]):
    """Within: train-mode batch statistics and dropout draws are the global
    batch's over ``mesh`` (None: this rank's own)."""
    prev = _ACTIVE['mesh']
    _ACTIVE['mesh'] = mesh
    try:
        yield mesh
    finally:
        _ACTIVE['mesh'] = prev


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce(t.clone())

    @staticmethod
    def backward(ctx, grad):
        # every rank's loss reaches the sum: its gradient is the sum of
        # the ranks' gradients
        return ctx.mesh.all_reduce(grad.contiguous().clone()), None


class _GatherSegments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, sizes, mesh):
        ctx.mesh, ctx.sizes = mesh, sizes
        return mesh.gather_segments(t, sizes)

    @staticmethod
    def backward(ctx, grad):
        # every rank evaluates the same loss on the same gathered rows, so
        # its gradient is already the global one: keep this rank's rows
        return ctx.mesh.segment_rows(grad, ctx.sizes), None, None


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Differentiable sum of ``t`` over the ranks."""
    return _AllReduceSum.apply(t, mesh)


def gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Differentiable ``Mesh.gather_rows``: the gradient of the result
    flows back to this rank's rows."""
    return gather_segments(t, (t.shape[0],), mesh)


def gather_segments(t: torch.Tensor, sizes: Sequence[int],
                    mesh: Mesh) -> torch.Tensor:
    """Differentiable ``Mesh.gather_segments``: the global batch of a
    forward of consecutive segments in the one-card order; the gradient of
    the result flows back to this rank's rows of each segment."""
    return _GatherSegments.apply(t, tuple(int(n) for n in sizes), mesh)


def local_device_count(device_type: str = 'cuda') -> int:
    """The devices a host offers its ranks: its cards, or on the CPU the
    cores this process may run on."""
    if device_type == 'cuda':
        return torch.cuda.device_count()
    if hasattr(os, 'sched_getaffinity'):
        return len(os.sched_getaffinity(0))
    return os.cpu_count() or 1


def mesh_size_from_config(config: dict, stage: str = 'train',
                          device_type: str = 'cuda') -> int:
    """How many ranks a cfg requests, resolved as the JAX package resolves
    its mesh (the reference's only knob is the ``gpus`` list of
    ``nn.DataParallel``, net_run_dsbn/agent_seg.py:693-698).

    Resolution order per stage section ([testing] for stage 'test',
    [training] otherwise; [testing] falls back to [training]):

    * ``mesh_devices = N`` — explicit size; ``-1`` means all devices;
    * otherwise a multi-entry ``gpus`` list maps to its length;
    * otherwise 1, or with several hosts (``[training] multihost`` or the
      ``FPLX_*`` triple) all devices of every host.

    "All devices" are the host count times ``local_device_count``. The
    result is clamped to them with a warning; a multi-host mesh that does
    not span them raises, as in the JAX package."""
    sections = ['testing', 'training'] if stage == 'test' else ['training']
    n = None
    for sec in sections:
        n = (config.get(sec, {}) or {}).get('mesh_devices', None)
        if n is not None:
            break
    if n is None:
        for sec in sections:
            gpus = (config.get(sec, {}) or {}).get('gpus', None)
            if isinstance(gpus, (list, tuple)) and len(gpus) > 0:
                n = len(gpus)
                break
    _, hosts = multihost.host_layout()
    avail = hosts * local_device_count(device_type)
    multi = multihost.multihost_requested(config) or hosts > 1
    if n is None:
        if multi:
            logging.info('multihost run without mesh_devices: defaulting '
                         'to a mesh over all %d global devices', avail)
            return max(avail, 1)
        return 1
    n = int(n)
    if n == -1:
        n = avail
    if hosts > 1 and n < avail:
        raise ValueError(
            'multi-host runs need the mesh to span all {0} global devices '
            '(got mesh_devices={1}); per-process sub-meshes would train '
            'unsynchronized replicas'.format(avail, n))
    if n > avail:
        logging.warning('config requests a %d-device mesh but only %d '
                        'device(s) are visible; clamping', n, avail)
        n = avail
    return max(n, 1)


def stage_mesh(config: dict, stage: str, device) -> Optional[Mesh]:
    """The mesh of a stage in this process: over the joined group when the
    stage's size is the group's (a group of one included: its collectives
    run all the same), None for a single-device stage. A stage that asks
    for several ranks without a group raises: ``python -m
    fpl_plus_torch.cli`` starts the ranks."""
    device = torch.device(device)
    n = mesh_size_from_config(config, stage, device.type)
    if not dist.is_initialized():
        if n > 1:
            raise RuntimeError(
                'the {0} stage asks for {1} ranks but this process joined no '
                'process group; run it through python -m fpl_plus_torch.cli, '
                'which starts them'.format(stage, n))
        return None
    world = dist.get_world_size()
    if n == world:
        return make_mesh(n, device)
    if n == 1:
        return None
    raise ValueError('the {0} stage asks for {1} ranks but the run has {2}; '
                     'a stage runs on 1 rank or on all of them'.format(
                         stage, n, world))


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank (broadcast in
    place)."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            mesh.broadcast(t.data)
    return module


def shard_batch(tree, mesh: Mesh, axis: int = 0):
    """This rank's rows of every tensor (or array) leaf of ``tree``: the
    leaves hold its host's batch on ``axis``, which the host's ranks split
    into equal contiguous slices. Numbers and strings stay."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        n = tree.shape[axis]
        if n % mesh.local_size:
            raise ValueError('a batch of {0} does not split over {1} ranks'
                             .format(n, mesh.local_size))
        k = n // mesh.local_size
        idx = [slice(None)] * tree.ndim
        idx[axis] = slice(mesh.local_rank * k, (mesh.local_rank + 1) * k)
        return tree[tuple(idx)]
    if isinstance(tree, dict):
        return {k: shard_batch(v, mesh, axis) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(v, mesh, axis) for v in tree)
    return tree


class ShardedStep:
    """A train step over ``mesh``: called with this rank's rows
    (``shard_batch``) and the same generators and values on every rank,
    it runs the step under ``data_parallel(mesh)`` and returns the global
    metrics, which every rank computes alike."""

    def __init__(self, step, mesh: Mesh):
        step.mesh = mesh
        self.step = step
        self.mesh = mesh

    def __call__(self, *args, **kwargs):
        with data_parallel(self.mesh):
            return self.step(*args, **kwargs)


def make_sharded_train_step(train_step, mesh: Mesh) -> ShardedStep:
    """Wrap an ``engine/train.py`` step (or the discriminator step) for
    data-parallel training over ``mesh``. The module and optimizer state
    must be the same on every rank (``replicate``); the step then gathers
    the global batch for the loss, sums the gradients over the ranks
    before each update, and every rank takes the same update."""
    return ShardedStep(train_step, mesh)


def sharded_sliding_window(predictor: Callable, window: Sequence[int],
                           mesh: Mesh, chunk: int = 1):
    """A sliding window whose start grid is split over ``mesh``.

    Returns ``fn(volume_v, starts, weights=None) -> (output [V, K, *img],
    counter [*img])``: ``volume_v [V, C, *img]`` is on every rank,
    ``starts [P, dim]`` is the whole grid; each rank accumulates its
    contiguous share of the windows (``weights``: one per start, default
    1, so weight-0 duplicates add nothing) in ``chunk`` s, and one
    all-reduce each merges the outputs and the counters. The primary head
    of a multi-head predictor only, as in the JAX package."""
    window = tuple(int(w) for w in window)

    def run(volume_v: torch.Tensor, starts, weights=None):
        starts = np.asarray(starts, np.int64)
        if weights is None:
            weights = np.ones(len(starts), np.float32)
        lo, hi = mesh.share(len(starts))
        img = tuple(volume_v.shape[2:])
        out = cnt = None
        for i in range(lo, hi, chunk):
            sts = starts[i:min(i + chunk, hi)]
            patches = torch.stack([volume_v[(slice(None), slice(None)) + tuple(
                slice(s, s + w) for s, w in zip(st, window))]
                for st in sts], 1)
            pred = predictor(patches.flatten(0, 1))
            if isinstance(pred, (list, tuple)):
                pred = pred[0]
            pred = pred.float().reshape((volume_v.shape[0], len(sts))
                                        + tuple(pred.shape[1:]))
            if out is None:
                out = torch.zeros((volume_v.shape[0], pred.shape[2]) + img,
                                  dtype=torch.float32,
                                  device=volume_v.device)
                cnt = torch.zeros(img, dtype=torch.float32,
                                  device=volume_v.device)
            for j, st in enumerate(sts):
                box = tuple(slice(s, s + w) for s, w in zip(st, window))
                w_j = float(weights[i + j])
                out[(slice(None), slice(None)) + box] += w_j * pred[:, j]
                cnt[box] += w_j
        if out is None:   # no window on this rank: a zero contribution
            pred = predictor(volume_v[(slice(None), slice(None)) + tuple(
                slice(0, w) for w in window)])
            if isinstance(pred, (list, tuple)):
                pred = pred[0]
            out = torch.zeros((volume_v.shape[0], pred.shape[1]) + img,
                              dtype=torch.float32, device=volume_v.device)
            cnt = torch.zeros(img, dtype=torch.float32,
                              device=volume_v.device)
        return mesh.all_reduce(out), mesh.all_reduce(cnt)

    return run
