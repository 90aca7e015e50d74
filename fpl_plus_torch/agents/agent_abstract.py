"""Abstract agent: lifecycle, datasets, seeding.

Parity with the reference abstract agents
(PyMIC/pymic/net_run_dsbn/agent_abstract.py:13-357) and the JAX package's
``agents/agent_abstract.py``: ``run()`` drives create_dataset ->
create_network -> train_valid (train stage) or infer (test stage). The
dual-domain train stage reads the ``{d}_train`` / ``{d}_valid`` manifests
(d = 1, 2; ``train_csv`` / ``valid_csv`` otherwise) into one shuffled train
loader per domain, seeded ``random_seed + d``, and one in-order valid
loader per domain. Determinism = seeded python/numpy/torch RNGs + per-item
loader seeding.

The train loaders produce their items in worker processes
(``io/loader.py``): ``[dataset] num_workder`` (or ``num_worker``), 8 by
default, clamped to ``cpu_count - 1`` as in the JAX package
(``agents/agent_abstract.py:124-127`` there); 0 keeps them in the main
process. The valid and test loaders run in the main process. ``run()``
shuts the pools down at its end and on error.

Scale-out (the JAX package's ``agents/agent_abstract.py:66-81,150-195``):
``get_mesh()`` is the stage's mesh over the ranks of the run
(``parallel/mesh.py`` ``stage_mesh``), None on one device. With several
hosts each host's train loaders read its row-strided manifest share
(``host_shard``) in batches of ``train_batch_size / hosts`` (the global
batch must divide), and every rank of a host runs the same seeded loaders
and keeps its rows of that host batch (``parallel/mesh.py``
``shard_batch``); on one host the ranks therefore train on exactly the
batches of a one-card run. A host's worker budget is one process's: each
of its ranks gets ``(cpu_count - 1) // local ranks`` workers. The
segmentation agent and those built on it (SSL, WSL, NLL, CLSLSR) run
over a mesh; an agent without a data-parallel step (``data_parallel``
False: the classification agent) raises ``NotImplementedError`` under a
mesh or in a multi-process run instead of training on one device.
"""
from __future__ import annotations

import logging
import os
import random
from abc import ABC, abstractmethod

import numpy as np
import torch

from fpl_plus_torch.io.dataset import NiftyDataset
from fpl_plus_torch.io.loader import DataLoader
from fpl_plus_torch.parallel import multihost
from fpl_plus_torch.parallel.mesh import mesh_size_from_config, stage_mesh
from fpl_plus_torch.transforms.trans_dict import Compose, TransformDict


def scaled_out(config: dict, stage: str, device) -> bool:
    """True when the stage asks for more than one rank or runs in a
    multi-process group."""
    return (mesh_size_from_config(config, stage, torch.device(device).type)
            > 1 or multihost.process_info()[1] > 1
            or multihost.multihost_requested(config))


def seed_everything(seed: int) -> None:
    """Reference seed_torch analog (agent_abstract.py:13-26)."""
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))
    torch.manual_seed(seed)


NOT_DATA_PARALLEL = (
    '{0} has no data-parallel step: it runs on one device, in one process '
    '(the JAX package\'s classification agent builds no mesh either, '
    'fpl_plus_tpu/agents/agent_cls.py, and would train on one device in '
    'silence); set mesh_devices = 1 and a single-entry gpus list, without '
    'multihost')


class NetRunAgent(ABC):
    # True for an agent whose train and test stages run sharded over a mesh
    data_parallel = False

    def __init__(self, config: dict, stage: str, device: torch.device):
        if stage not in ('train', 'inference', 'test'):
            raise ValueError('Undefined stage {0!r}'.format(stage))
        self.config = config
        self.stage = 'test' if stage == 'inference' else stage
        self.device = torch.device(device)
        if not self.data_parallel and scaled_out(config, self.stage,
                                                 self.device):
            raise NotImplementedError(NOT_DATA_PARALLEL.format(
                type(self).__name__))
        self._mesh = False   # resolved by get_mesh()
        self.transform_list = []
        self.test_loader = None
        self.train_loaders = []
        self.valid_loaders = []
        self.num_domains = config.get('network', {}).get('num_domains', 1)
        self.random_seed = config.get('training', {}).get('random_seed', 1)
        if config.get('training', {}).get('deterministic', True):
            seed_everything(self.random_seed)

    def get_mesh(self):
        """The stage's mesh over the run's ranks, or None on one device
        (resolved once)."""
        if self._mesh is False:
            self._mesh = stage_mesh(self.config, self.stage, self.device)
        return self._mesh

    def barrier(self, tag: str) -> None:
        """A barrier over the stage's ranks (none on one device)."""
        if self.get_mesh() is not None:
            multihost.barrier(tag)

    def build_transform(self, stage_key: str):
        """Compose the transform chain of a stage ('train', 'valid' or
        'test'; a missing valid chain falls back to the train chain) and
        remember the test chain for the inverse transforms at inference
        (reference agent_seg.py:42-80)."""
        data_cfg = self.config['dataset']
        transform_key = stage_key + '_transform'
        if stage_key == 'valid' and transform_key not in data_cfg:
            transform_key = 'train_transform'
        names = data_cfg.get(transform_key, None)
        if not names:
            return None
        params = dict(data_cfg)
        params['task'] = self.task_type()
        transform_list = []
        for name in names:
            if name not in TransformDict:
                raise ValueError('Undefined transform {0}'.format(name))
            transform_list.append(TransformDict[name](params))
        if stage_key == 'test':
            self.transform_list = transform_list
        return Compose(transform_list)

    def train_workers(self) -> int:
        """The train loaders' worker processes: ``[dataset] num_workder``
        (the reference's spelling) or ``num_worker``, default 8, at most
        ``cpu_count - 1`` (more workers than spare cores only add IPC)
        shared by the ranks of this host."""
        data_cfg = self.config['dataset']
        wanted = int(data_cfg.get('num_workder',
                                  data_cfg.get('num_worker', 8)))
        mesh = self.get_mesh()
        ranks = mesh.local_size if mesh is not None else 1
        spare = max((os.cpu_count() or 1) - 1, 0) // ranks
        if wanted > spare:
            logging.info('num_workder %d clamped to %d ((cpu_count - 1) // '
                         '%d ranks)', wanted, spare, ranks)
        return min(wanted, spare)

    def cache_bytes(self, stage: str, workers: int = 1) -> int:
        """The cache budget of a dataset of ``stage`` (``[dataset]
        cache_gb``, default 2, 0 disables), split over the ``workers``
        processes that each hold a copy; 0 for the one-pass test stage."""
        if stage.split('_')[-1] == 'test':
            return 0
        cache_gb = self.config['dataset'].get('cache_gb', 2.0)
        return int(cache_gb * (1 << 30)) // max(workers, 1)

    def stage_dataset(self, stage: str, workers: int = 0) -> NiftyDataset:
        """The dataset of ``stage`` ('1_train', '2_valid', 'test', ...),
        read by ``workers`` processes. Train and valid stages revisit their
        rows every epoch, so they get the decoded-volume and
        transform-prefix caches (``cache_bytes``); the one-pass test stage
        gets none."""
        data_cfg = self.config['dataset']
        real_stage = stage.split('_')[-1]
        csv_file = data_cfg.get(stage + '_csv', None)
        if csv_file is None:
            csv_file = data_cfg[real_stage + '_csv']
        cache_bytes = self.cache_bytes(stage, workers)
        return NiftyDataset(root_dir=data_cfg['root_dir'], csv_file=csv_file,
                            modal_num=data_cfg.get('modal_num', 1),
                            with_label=real_stage != 'test',
                            transform=self.build_transform(real_stage),
                            cache_bytes=cache_bytes,
                            transform_cache=data_cfg.get('transform_cache',
                                                         True),
                            host_shard=self.host_shard(real_stage))

    def host_shard(self, stage: str):
        """``(host, hosts)`` for a train stage of several hosts: each host
        trains on its manifest share; valid and test stages read every
        row on every rank. None otherwise."""
        host, hosts = multihost.host_layout()
        if stage == 'train' and hosts > 1 and self.get_mesh() is not None:
            return host, hosts
        return None

    def host_batch_size(self, key: str = 'train_batch_size') -> int:
        """``[dataset] key`` (the global batch) over the hosts of a
        sharded train stage: the batch of each host's loaders."""
        bs = self.config['dataset'][key]
        if self.host_shard('train') is None:
            return bs
        hosts = multihost.host_layout()[1]
        if bs % hosts:
            raise ValueError('{0} {1} must divide across {2} hosts'.format(
                key, bs, hosts))
        return bs // hosts

    def create_dataset(self):
        data_cfg = self.config['dataset']
        if self.stage == 'train':
            workers = self.train_workers()
            for d in range(1, self.num_domains + 1):
                self.train_loaders.append(DataLoader(
                    self.stage_dataset('{0}_train'.format(d), workers),
                    batch_size=self.host_batch_size(), shuffle=True,
                    num_workers=workers, seed=self.random_seed + d))
                self.valid_loaders.append(DataLoader(
                    self.stage_dataset('{0}_valid'.format(d)),
                    batch_size=data_cfg.get('valid_batch_size', 1),
                    seed=self.random_seed))
        else:
            self.test_loader = DataLoader(
                self.stage_dataset('test'),
                batch_size=data_cfg.get('test_batch_size', 1),
                seed=self.random_seed)

    def task_type(self) -> str:
        return 'segmentation'

    @abstractmethod
    def create_network(self):
        ...

    @abstractmethod
    def train_valid(self):
        ...

    @abstractmethod
    def infer(self):
        ...

    def loaders(self):
        """Every loader of the agent (the paradigm agents add theirs)."""
        return self.train_loaders + self.valid_loaders + [
            ld for ld in (self.test_loader,) if ld is not None]

    def shutdown(self):
        """Stop the loaders' worker processes."""
        for loader in self.loaders():
            loader.shutdown()

    def run(self):
        """Reference run() (agent_abstract.py:348-357); the loaders' worker
        processes stop at its end and on error."""
        try:
            self.create_dataset()
            self.create_network()
            if self.stage == 'train':
                self.train_valid()
            else:
                self.infer()
        finally:
            self.shutdown()
