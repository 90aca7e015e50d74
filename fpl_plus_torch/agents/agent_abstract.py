"""Abstract agent: lifecycle, datasets, seeding.

Parity with the reference abstract agents
(PyMIC/pymic/net_run_dsbn/agent_abstract.py:13-357): ``run()`` drives
create_dataset -> create_network -> infer. Determinism = seeded
python/numpy/torch RNGs + per-item loader seeding. Ported so far: the test
(inference) stage; training and its dual-domain loaders belong to the
training slice (ROADMAP.md).
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
        if stage not in ('inference', 'test'):
            raise NotImplementedError(
                'stage {0!r} is not yet ported (only test/inference; see '
                'ROADMAP.md)'.format(stage))
        self.config = config
        self.stage = 'test'
        self.device = torch.device(device)
        self.transform_list = []
        self.test_loader = None
        self.random_seed = config.get('training', {}).get('random_seed', 1)
        if config.get('training', {}).get('deterministic', True):
            seed_everything(self.random_seed)

    def build_transform(self, stage_key: str):
        """Compose the transform chain for a stage and remember it for the
        inverse transforms at inference (reference agent_seg.py:42-80)."""
        data_cfg = self.config['dataset']
        names = data_cfg.get(stage_key + '_transform', None)
        if not names:
            return None
        params = dict(data_cfg)
        params['task'] = self.task_type()
        transform_list = []
        for name in names:
            if name not in TransformDict:
                raise NotImplementedError(
                    'transform {0} is not ported (ported: {1})'.format(
                        name, sorted(TransformDict)))
            transform_list.append(TransformDict[name](params))
        self.transform_list = transform_list
        return Compose(transform_list)

    def create_dataset(self):
        data_cfg = self.config['dataset']
        test_set = NiftyDataset(root_dir=data_cfg['root_dir'],
                                csv_file=data_cfg['test_csv'],
                                modal_num=data_cfg.get('modal_num', 1),
                                transform=self.build_transform('test'))
        self.test_loader = DataLoader(
            test_set, batch_size=data_cfg.get('test_batch_size', 1),
            seed=self.random_seed)

    def task_type(self) -> str:
        return 'segmentation'

    @abstractmethod
    def create_network(self):
        ...

    @abstractmethod
    def infer(self):
        ...

    def run(self):
        """Reference run() (agent_abstract.py:348-357), test stage."""
        self.create_dataset()
        self.create_network()
        self.infer()
