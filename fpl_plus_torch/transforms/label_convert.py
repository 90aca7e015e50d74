"""LabelToProbability: one-hot probability maps of the label.

Behaviour parity: reference PyMIC/pymic/transform/label_convert.py and the
JAX package's ``transforms/label_convert.py``: ``label [1, *spatial]`` ->
``label_prob [class_num, *spatial]`` f32 (segmentation).
"""
from __future__ import annotations

import numpy as np

from fpl_plus_torch.transforms.abstract import AbstractTransform


class LabelToProbability(AbstractTransform):
    def __init__(self, params):
        super().__init__(params)
        self.class_num = self.param('class_num')
        self.inverse = self.param('inverse', False)

    def cache_safe(self):
        return True

    def __call__(self, sample):
        if self.task != 'segmentation':
            raise NotImplementedError(
                'LabelToProbability is ported for segmentation only')
        label = sample['label'][0]
        label_prob = np.zeros((self.class_num,) + label.shape, np.float32)
        for i in range(self.class_num):
            label_prob[i] = (label == i)
        sample['label_prob'] = label_prob
        return sample
