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
"""
from __future__ import annotations

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

    def stage_dataset(self, stage: str) -> NiftyDataset:
        """The dataset of ``stage`` ('1_train', '2_valid', 'test', ...).
        Train and valid stages revisit their rows every epoch, so they get
        the decoded-volume and transform-prefix caches (``[dataset]
        cache_gb``, default 2, 0 disables; the loader runs in this process,
        so the JAX package's split of the budget over worker processes
        divides by 1); the one-pass test stage gets none."""
        data_cfg = self.config['dataset']
        real_stage = stage.split('_')[-1]
        csv_file = data_cfg.get(stage + '_csv', None)
        if csv_file is None:
            csv_file = data_cfg[real_stage + '_csv']
        cache_gb = data_cfg.get('cache_gb', 2.0)
        cache_bytes = int(cache_gb * (1 << 30)) if real_stage != 'test' else 0
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
            for d in range(1, self.num_domains + 1):
                self.train_loaders.append(DataLoader(
                    self.stage_dataset('{0}_train'.format(d)),
                    batch_size=data_cfg['train_batch_size'], shuffle=True,
                    seed=self.random_seed + d))
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

    def run(self):
        """Reference run() (agent_abstract.py:348-357)."""
        self.create_dataset()
        self.create_network()
        if self.stage == 'train':
            self.train_valid()
        else:
            self.infer()
