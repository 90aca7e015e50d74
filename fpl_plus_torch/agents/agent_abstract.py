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
from fpl_plus_torch.transforms.trans_dict import Compose, TransformDict


def seed_everything(seed: int) -> None:
    """Reference seed_torch analog (agent_abstract.py:13-26)."""
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))
    torch.manual_seed(seed)


class NetRunAgent(ABC):
    def __init__(self, config: dict, stage: str, device: torch.device):
        if stage not in ('train', 'inference', 'test'):
            raise ValueError('Undefined stage {0!r}'.format(stage))
        self.config = config
        self.stage = 'test' if stage == 'inference' else stage
        self.device = torch.device(device)
        self.transform_list = []
        self.test_loader = None
        self.train_loaders = []
        self.valid_loaders = []
        self.num_domains = config.get('network', {}).get('num_domains', 1)
        self.random_seed = config.get('training', {}).get('random_seed', 1)
        if config.get('training', {}).get('deterministic', True):
            seed_everything(self.random_seed)

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
        ``cpu_count - 1`` (more workers than spare cores only add IPC)."""
        data_cfg = self.config['dataset']
        wanted = int(data_cfg.get('num_workder',
                                  data_cfg.get('num_worker', 8)))
        spare = max((os.cpu_count() or 1) - 1, 0)
        if wanted > spare:
            logging.info('num_workder %d clamped to %d (cpu_count - 1)',
                         wanted, spare)
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
                                                         True))

    def create_dataset(self):
        data_cfg = self.config['dataset']
        if self.stage == 'train':
            workers = self.train_workers()
            for d in range(1, self.num_domains + 1):
                self.train_loaders.append(DataLoader(
                    self.stage_dataset('{0}_train'.format(d), workers),
                    batch_size=data_cfg['train_batch_size'], shuffle=True,
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
