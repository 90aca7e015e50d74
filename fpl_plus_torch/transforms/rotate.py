"""RandomRotate with the angles recorded for the inverse.

Behaviour parity: reference PyMIC/pymic/transform/rotate.py:14-100 and the
JAX package's ``transforms/rotate.py``: a uniform angle per enabled plane
(``angle_range_d`` rotates the H-W plane; ``_h`` and ``_w`` the D-W and D-H
planes of a 3D image), drawn from ``np.random`` in that order, applied with
``scipy.ndimage.rotate`` (no reshape), order 1 for the image,
``pixel_weight`` and ``image1``, order 0 for the label. The inverse rotates
the prediction back (negated angles in reverse order, order 1) on the host.
"""
from __future__ import annotations

import functools

import numpy as np
from scipy import ndimage

from fpl_plus_torch.transforms.abstract import AbstractTransform, apply_spatial


def _apply_rotations(image, rotations, order=1):
    for angle, axes in rotations:
        image = ndimage.rotate(image, angle, tuple(axes), reshape=False,
                               order=order)
    return image


class RandomRotate(AbstractTransform):
    def __init__(self, params):
        super().__init__(params)
        self.angle_range_d = self.param('angle_range_d')
        self.angle_range_h = self.param('angle_range_h')
        self.angle_range_w = self.param('angle_range_w')
        self.inverse = self.param('inverse', True)

    def __call__(self, sample):
        input_dim = sample['image'].ndim - 1
        rotations = []
        if self.angle_range_d is not None:
            rotations.append([np.random.uniform(*self.angle_range_d),
                              (-1, -2)])
        if input_dim == 3:
            if self.angle_range_h is not None:
                rotations.append([np.random.uniform(*self.angle_range_h),
                                  (-1, -3)])
            if self.angle_range_w is not None:
                rotations.append([np.random.uniform(*self.angle_range_w),
                                  (-2, -3)])
        if not rotations:
            raise ValueError('RandomRotate needs an angle range for at '
                             'least one plane of a {0}D image'.format(
                                 input_dim))
        self.store_inverse_param(sample, rotations)
        return apply_spatial(
            sample, functools.partial(_apply_rotations, rotations=rotations),
            self.task, functools.partial(_apply_rotations,
                                         rotations=rotations, order=0))

    def inverse_transform_for_prediction(self, sample):
        rotations = [[-angle, axes] for angle, axes
                     in self.load_inverse_param(sample)[::-1]]
        sample['predict'] = _apply_rotations(sample['predict'], rotations)
        return sample
