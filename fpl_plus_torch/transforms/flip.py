"""RandomFlip with the flipped axes recorded.

Behaviour parity: reference PyMIC/pymic/transform/flip.py:14-73 and the JAX
package's ``transforms/flip.py``: an independent coin (``random.random() >
0.5``) per enabled axis, in the order width, height, depth; the image and
the other spatial keys flip together; the axes are recorded as
``RandomFlip_Param``; the prediction inverse flips the prediction back
along them.
"""
from __future__ import annotations

import random

import numpy as np

from fpl_plus_torch.transforms.abstract import AbstractTransform, apply_spatial


class RandomFlip(AbstractTransform):
    def __init__(self, params):
        super().__init__(params)
        self.flip_depth = self.param('flip_depth')
        self.flip_height = self.param('flip_height')
        self.flip_width = self.param('flip_width')
        self.inverse = self.param('inverse', True)

    def __call__(self, sample):
        input_dim = sample['image'].ndim - 1
        flip_axis = []
        if self.flip_width and random.random() > 0.5:
            flip_axis.append(-1)
        if self.flip_height and random.random() > 0.5:
            flip_axis.append(-2)
        if input_dim == 3 and self.flip_depth and random.random() > 0.5:
            flip_axis.append(-3)
        self.store_inverse_param(sample, flip_axis)
        if flip_axis:
            return apply_spatial(
                sample, lambda a: np.flip(a, flip_axis).copy(), self.task)
        return sample

    def inverse_transform_for_prediction(self, sample):
        flip_axis = self.load_inverse_param(sample)
        if flip_axis:
            sample['predict'] = np.flip(sample['predict'], flip_axis).copy()
        return sample
