"""Rescale and RandomRescale with the input shape recorded.

Behaviour parity: reference PyMIC/pymic/transform/rescale.py and the JAX
package's ``transforms/rescale.py`` ``Rescale``: ``ndimage.zoom`` to
``output_size`` (a ``None`` depth keeps the depth; an int scales the
shortest edge to it), order 1 for the image, ``pixel_weight`` and
``image1``, order 0 for the label. ``RandomRescale`` zooms each axis by a
ratio drawn from ``random`` in [lower_bound, upper_bound) (per axis when the
bounds are lists). The shape is recorded as ``<Name>_origin_shape``; the
prediction inverse zooms the logits back to it with order 1, on the host.
"""
from __future__ import annotations

import functools
import json
import random

from scipy import ndimage

from fpl_plus_torch.transforms.abstract import AbstractTransform, apply_spatial


class Rescale(AbstractTransform):
    def __init__(self, params):
        super().__init__(params)
        self.output_size = self.param('output_size')
        self.inverse = self.param('inverse', True)
        if not isinstance(self.output_size, (int, list, tuple)):
            raise ValueError('Rescale_output_size must be an int or a list')

    def cache_safe(self):
        return type(self) is Rescale

    def _shape_key(self):
        return '{0}_origin_shape'.format(type(self).__name__)

    def _get_scale(self, input_shape):
        input_dim = len(input_shape) - 1
        if isinstance(self.output_size, (list, tuple)):
            output_size = list(self.output_size)
            if output_size[0] is None:
                output_size[0] = input_shape[1]
            if len(output_size) != input_dim:
                raise ValueError('Rescale_output_size {0} for a {1}D image'
                                 .format(self.output_size, input_dim))
        else:
            min_edge = min(input_shape[1:])
            output_size = [self.output_size * input_shape[i + 1] / min_edge
                           for i in range(input_dim)]
        return [1.0] + [(output_size[i] + 0.0) / input_shape[1:][i]
                        for i in range(input_dim)]

    def __call__(self, sample):
        input_shape = sample['image'].shape
        scale = self._get_scale(input_shape)
        sample[self._shape_key()] = json.dumps(list(input_shape))
        return apply_spatial(
            sample, functools.partial(ndimage.zoom, zoom=scale, order=1),
            self.task, functools.partial(ndimage.zoom, zoom=scale, order=0))

    def inverse_transform_for_prediction(self, sample):
        raw = sample[self._shape_key()]
        if isinstance(raw, (list, tuple)):
            raw = raw[0]
        origin_shape = json.loads(raw)
        pred = sample['predict']
        scale = [1.0, 1.0] + [(o + 0.0) / p for o, p in
                              zip(origin_shape[1:], pred.shape[2:])]
        sample['predict'] = ndimage.zoom(pred, scale, order=1)
        return sample


class RandomRescale(Rescale):
    def __init__(self, params):
        AbstractTransform.__init__(self, params)
        self.ratio0 = self.param('lower_bound')
        self.ratio1 = self.param('upper_bound')
        self.inverse = self.param('inverse', True)

    def _get_scale(self, input_shape):
        if isinstance(self.ratio0, (list, tuple)):
            scale = [lo + random.random() * (hi - lo)
                     for lo, hi in zip(self.ratio0, self.ratio1)]
        else:
            scale = [self.ratio0 + random.random() * (self.ratio1
                                                      - self.ratio0)
                     for _ in range(len(input_shape) - 1)]
        return [1.0] + scale
