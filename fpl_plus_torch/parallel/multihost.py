"""Multi-process scale-out surface: the process group, the ranks'
identity, barriers and the one-writer gate.

Counterpart of the JAX package's ``parallel/multihost.py``. In JAX one
process drives every device of its host; here one process drives one card,
which is PyTorch's own idiom, so a JAX process becomes a group of ranks on
its host, one per local device:

* a host is one CLI process. With a mesh larger than one rank per host the
  CLI starts the host's ranks itself (``launch_local_ranks``); host ``h``'s
  local rank ``l`` is global rank ``h * local_size + l`` and drives
  ``cuda:l`` (or the CPU under ``--device cpu``);
* the hosts are named, as in JAX, by ``[training] multihost = True`` plus
  the ``FPLX_COORDINATOR`` (``host:port`` of host 0, where the group's
  store listens) / ``FPLX_NUM_PROCESSES`` / ``FPLX_PROCESS_ID`` triple. A
  single-host mesh needs none of it: the CLI picks a free local port;
* the backend is NCCL on the card and gloo on the CPU. A failed or
  degraded group raises: no rank falls back to a single-process run.

Only global rank 0 writes to shared storage (``is_primary_host``):
checkpoints and pointers, scalar logs, predictions, the FPL list, the
evaluation CSVs. Barriers sit where one rank's writes are another's reads.
"""
from __future__ import annotations

import datetime
import logging
import os
import socket

import torch
import torch.distributed as dist

ENV_COORDINATOR = 'FPLX_COORDINATOR'
ENV_NUM_PROCESSES = 'FPLX_NUM_PROCESSES'
ENV_PROCESS_ID = 'FPLX_PROCESS_ID'
TIMEOUT = datetime.timedelta(seconds=1800)

# the layout of the group this process joined (host, hosts, local rank,
# local size); the single-process layout until then
_LAYOUT = {'host': 0, 'hosts': 1, 'local_rank': 0, 'local_size': 1}
_BARRIER_SEQ = {'n': 0}


def multihost_requested(config: dict) -> bool:
    """``[training] multihost = True`` or a coordinator in the
    environment."""
    tcfg = config.get('training', {}) or {}
    return bool(tcfg.get('multihost', False)
                or os.environ.get(ENV_COORDINATOR))


def host_layout():
    """``(host index, host count)``: the joined group's, else the
    ``FPLX_PROCESS_ID`` / ``FPLX_NUM_PROCESSES`` pair (``(0, 1)`` without
    it)."""
    if dist.is_initialized():
        return _LAYOUT['host'], _LAYOUT['hosts']
    hosts = int(os.environ.get(ENV_NUM_PROCESSES, '1'))
    host = int(os.environ.get(ENV_PROCESS_ID, '0'))
    if hosts < 1 or not 0 <= host < hosts:
        raise ValueError('{0}={1} and {2}={3} name no host'.format(
            ENV_PROCESS_ID, host, ENV_NUM_PROCESSES, hosts))
    return host, hosts


def local_layout():
    """``(local rank, local size)``: this rank among its host's ranks."""
    return _LAYOUT['local_rank'], _LAYOUT['local_size']


def free_local_port() -> int:
    """A TCP port free on this host now, for a single-host group's store."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def maybe_initialize_distributed(config: dict, device_type: str = 'cuda',
                                 local_rank: int = 0, local_size: int = 1,
                                 coordinator: str = None) -> bool:
    """Join the process group when the config or the environment asks for
    more than this one process: ``[training] multihost``, the ``FPLX_*``
    triple, or ``local_size`` > 1 ranks on this host (``coordinator``: the
    ``host:port`` of the group's store, else ``FPLX_COORDINATOR``).

    Runs before any device use. Returns True when it formed the group
    (False when nothing asks for one, or when a group already exists). A
    world smaller than ``hosts x local_size`` raises, as the JAX package
    does for a degraded job: every rank would believe it is primary."""
    if dist.is_initialized():
        logging.warning('process group already initialised; kept')
        return False
    if not (multihost_requested(config) or local_size > 1):
        return False
    coordinator = coordinator or os.environ.get(ENV_COORDINATOR)
    if not coordinator:
        raise RuntimeError(
            '[training] multihost = True needs {0} (host:port of host 0) '
            'with {1} and {2}: there is no cluster auto-discovery'.format(
                ENV_COORDINATOR, ENV_NUM_PROCESSES, ENV_PROCESS_ID))
    host, hosts = host_layout()
    world = hosts * local_size
    rank = host * local_size + local_rank
    backend = 'nccl' if device_type == 'cuda' else 'gloo'
    if device_type == 'cuda':
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method='tcp://' + coordinator,
                            world_size=world, rank=rank, timeout=TIMEOUT)
    if dist.get_world_size() != world or dist.get_rank() != rank:
        raise RuntimeError(
            'process group degraded: rank {0} of {1}, but rank {2} of {3} '
            'was requested'.format(dist.get_rank(), dist.get_world_size(),
                                   rank, world))
    _LAYOUT.update(host=host, hosts=hosts, local_rank=local_rank,
                   local_size=local_size)
    _BARRIER_SEQ['n'] = 0
    warm_collectives(device_type)
    # print(): the CLI sets up logging after the group forms
    print('multihost: rank {0}/{1}, host {2}/{3}, {4} local rank(s), {5}'
          .format(rank, world, host, hosts, local_size, backend), flush=True)
    return True


def process_info():
    """``(rank, world, host index, host count)``; ``(0, 1, 0, 1)`` in a
    process that joined no group."""
    if not dist.is_initialized():
        return 0, 1, 0, 1
    return (dist.get_rank(), dist.get_world_size(), _LAYOUT['host'],
            _LAYOUT['hosts'])


def is_primary_host() -> bool:
    """True on global rank 0 and in a process that joined no group: the
    writers of shared storage run only there."""
    return process_info()[0] == 0


def barrier(tag: str = 'sync') -> None:
    """Every rank of the group waits here (no-op without a group). The
    barriers are sequence-numbered in the log: every rank calls them in
    the same program order. gloo's ``monitored_barrier`` names a rank that
    never arrives; NCCL's barrier is a collective on this rank's card. The
    group's timeout is long (``TIMEOUT``): host phases such as evaluation
    skew the ranks by minutes."""
    if not dist.is_initialized():
        return
    name = '{0}_{1}'.format(tag, _BARRIER_SEQ['n'])
    _BARRIER_SEQ['n'] += 1
    logging.info('barrier %s: rank %d waiting', name, dist.get_rank())
    if dist.get_backend() == 'gloo':
        dist.monitored_barrier(timeout=TIMEOUT)
    else:
        dist.barrier(device_ids=[torch.cuda.current_device()])
    logging.info('barrier %s: rank %d released', name, dist.get_rank())


def warm_collectives(device_type: str = 'cuda') -> None:
    """A 1-element ``all_reduce`` right after the group forms, while the
    ranks are in step: the backend sets up its communicator here instead
    of at the first gradient all-reduce, after ranks may have drifted
    apart by a network build or a loader start."""
    if not dist.is_initialized():
        return
    dev = (torch.device('cuda', torch.cuda.current_device())
           if device_type == 'cuda' else torch.device('cpu'))
    one = torch.ones(1, device=dev)
    dist.all_reduce(one)
    if int(one.item()) != dist.get_world_size():
        raise RuntimeError('warm-up all_reduce gave {0} over {1} ranks'
                           .format(one.item(), dist.get_world_size()))


def finalize_distributed(ok: bool = True) -> None:
    """A last barrier, then the group is destroyed (no-op without one), so
    no rank leaves while another still writes. ``ok`` False (a rank that
    failed): no barrier, since the others may never reach it."""
    if not dist.is_initialized():
        return
    if ok:
        barrier('pre-exit')
    dist.destroy_process_group()
    _LAYOUT.update(host=0, hosts=1, local_rank=0, local_size=1)


def launch_local_ranks(entry, args, local_size: int) -> None:
    """Run ``entry(local_rank, *args)`` in ``local_size`` started processes
    (spawned: a fresh interpreter each, CUDA-safe) and wait for them. A
    rank that raises or dies makes the others stop and this call raise, so
    the run exits non-zero instead of hanging in a collective."""
    import torch.multiprocessing as tmp
    tmp.start_processes(entry, args=tuple(args), nprocs=local_size,
                        join=True, start_method='spawn')


def shard_manifest_rows(n_rows: int, process_index: int,
                        process_count: int):
    """Row-strided per-host shard of a manifest: host i reads rows
    i, i+P, i+2P, ... — strided (not contiguous) so ordered manifests
    (e.g. grouped by site/class) stay balanced across hosts."""
    if process_count <= 1:
        return list(range(n_rows))
    return list(range(process_index, n_rows, process_count))
