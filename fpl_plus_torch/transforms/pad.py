"""Pad transform with invertible margin recording.

Behavior parity: reference PyMIC/pymic/transform/pad.py:103-192 — reflect-pad
each spatial axis up to ``output_size`` (or the next multiple when
``ceil_mode``), record (margin_lower, margin_upper); the prediction inverse
crops the margins off: on the host (``inverse_transform_for_prediction``),
or folded into the device-label path as a selection (``inverse_selection``).
``Pad_dual`` is the same transform under the reference's second name (the
spatial keys, ``image1`` included, are padded alike).
"""
from __future__ import annotations

import math

import numpy as np

from fpl_plus_torch.transforms.abstract import AbstractTransform, apply_spatial


class Pad(AbstractTransform):
    def __init__(self, params):
        super().__init__(params)
        self.output_size = self.param('output_size')
        self.ceil_mode = self.param('ceil_mode', False)
        self.inverse = self.param('inverse', True)

    def cache_safe(self):
        return True

    def __call__(self, sample):
        input_shape = sample['image'].shape
        spatial_shape = input_shape[1:]
        assert len(self.output_size) == len(spatial_shape)
        if self.ceil_mode:
            output_size = [int(math.ceil(float(s) / o)) * o
                           for s, o in zip(spatial_shape, self.output_size)]
        else:
            output_size = self.output_size
        margin = [max(0, o - s) for o, s in zip(output_size, spatial_shape)]
        margin_lower = [m // 2 for m in margin]
        margin_upper = [m - lo for m, lo in zip(margin, margin_lower)]
        self.store_inverse_param(sample, (margin_lower, margin_upper))
        if max(margin) == 0:
            return sample
        pad = tuple([(0, 0)] + list(zip(margin_lower, margin_upper)))

        def do_pad(arr):
            return np.pad(arr, pad, 'reflect')
        return apply_spatial(sample, do_pad, self.task)

    def inverse_transform_for_prediction(self, sample):
        margin_lower, margin_upper = self.load_inverse_param(sample)
        pred = sample['predict']
        sample['predict'] = pred[(slice(None), slice(None)) + tuple(
            slice(lo, s - up) for lo, up, s in
            zip(margin_lower, margin_upper, pred.shape[2:]))]
        return sample

    def inverse_selection(self, sample):
        # the prediction inverse is exactly a crop by the recorded margins
        return tuple(self.load_inverse_param(sample))


class Pad_dual(Pad):
    """The reference's name for Pad in the dual-image chains (reference
    pad.py:13-102); it reads the ``Pad_*`` keys."""
    _param_prefix = 'Pad'
