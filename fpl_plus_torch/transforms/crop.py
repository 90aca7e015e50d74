"""Crop transforms: CenterCrop, CropWithBoundingBox, RandomCrop with
foreground-focused sampling, and RandomResizedCrop.

Behaviour parity: reference PyMIC/pymic/transform/crop.py:13-245 and the
JAX package's ``transforms/crop.py``. Each crop keeps every image channel
and crops ``label``, ``pixel_weight`` and ``image1`` alike, and records
``(input shape, crop min, crop max)`` as ``<Name>_Param``; the prediction
inverse pastes the prediction into zeros of the input shape (a host
inverse: it synthesizes voxels, so it is no selection).

* CenterCrop: the centred window of ``output_size`` (a ``None`` depth keeps
  the whole depth).
* CropWithBoundingBox: the bounding box of the nonzero image, or a window
  of ``output_size`` centred on it, or from ``start``.
* RandomCrop: a uniform crop origin per axis; with ``foreground_focus`` and
  probability ``foreground_ratio`` the origin is drawn around the bounding
  box of the ``mask_label`` classes instead. The ``random`` draws come in
  the same order as there, so a seeded item gives the same crop.
"""
from __future__ import annotations

import json
import random

import numpy as np
from scipy import ndimage

from fpl_plus_torch.transforms.abstract import SPATIAL_KEYS, AbstractTransform
from fpl_plus_torch.utils.image_process import (
    crop_nd_volume_with_bounding_box as _crop, get_nd_bounding_box)


class CenterCrop(AbstractTransform):
    def __init__(self, params):
        super().__init__(params)
        self.output_size = self.param('output_size')
        self.inverse = self.param('inverse', True)

    def cache_safe(self):
        return True

    def _crop_param(self, sample):
        input_shape = sample['image'].shape
        input_dim = len(input_shape) - 1
        if input_dim != len(self.output_size):
            raise ValueError('{0}_output_size {1} for a {2}D image'.format(
                type(self).__name__, self.output_size, input_dim))
        out_size = list(self.output_size)
        if input_dim == 3 and out_size[0] is None:
            out_size[0] = input_shape[1]
        crop_min = [(input_shape[i + 1] - out_size[i]) // 2
                    for i in range(input_dim)]
        if any(m < 0 for m in crop_min):
            raise ValueError(
                'CenterCrop output_size {0} exceeds input shape {1}; pad '
                'first'.format(out_size, input_shape[1:]))
        crop_max = [lo + s for lo, s in zip(crop_min, out_size)]
        return self._record(sample, crop_min, crop_max)

    def _record(self, sample, crop_min, crop_max):
        crop_min = [0] + list(crop_min)
        crop_max = [sample['image'].shape[0]] + list(crop_max)
        self.store_inverse_param(sample, (list(sample['image'].shape),
                                          crop_min, crop_max))
        return crop_min, crop_max

    def __call__(self, sample):
        crop_min, crop_max = self._crop_param(sample)
        sample['image'] = _crop(sample['image'], crop_min, crop_max)
        if self.task == 'segmentation':
            for key in SPATIAL_KEYS:
                if key in sample:
                    cmax = [sample[key].shape[0]] + list(crop_max[1:])
                    sample[key] = _crop(sample[key], crop_min, cmax)
        return sample

    def inverse_transform_for_prediction(self, sample):
        """Paste ``predict [N, K, *crop]`` into zeros ``[N, K, *input]``."""
        origin_shape, crop_min, crop_max = self.load_inverse_param(sample)
        pred = sample['predict']
        out = np.zeros(list(pred.shape[:2]) + list(origin_shape[1:]),
                       pred.dtype)
        out[(slice(None), slice(None)) + tuple(
            slice(lo, hi) for lo, hi in zip(crop_min[1:], crop_max[1:]))] \
            = pred
        sample['predict'] = out
        return sample


class CropWithBoundingBox(CenterCrop):
    def __init__(self, params):
        AbstractTransform.__init__(self, params)
        self.start = self.param('start')
        self.output_size = self.param('output_size')
        self.inverse = self.param('inverse', True)

    def _crop_param(self, sample):
        input_dim = sample['image'].ndim - 1
        bb_min, bb_max = get_nd_bounding_box(sample['image'])
        bb_min, bb_max = bb_min[1:], bb_max[1:]
        for name, val in (('start', self.start),
                          ('output_size', self.output_size)):
            if val is not None and len(val) != input_dim:
                raise ValueError('CropWithBoundingBox_{0} {1} for a {2}D '
                                 'image'.format(name, val, input_dim))
        if self.start is None:
            if self.output_size is None:
                crop_min, crop_max = bb_min, bb_max
            else:
                crop_min = [max(0, (bb_min[i] + bb_max[i] + 1) // 2
                                - self.output_size[i] // 2)
                            for i in range(input_dim)]
                crop_max = [crop_min[i] + self.output_size[i]
                            for i in range(input_dim)]
        else:
            crop_min = list(self.start)
            if self.output_size is None:
                crop_max = [crop_min[i] + bb_max[i] - bb_min[i]
                            for i in range(input_dim)]
            else:
                crop_max = [crop_min[i] + self.output_size[i]
                            for i in range(input_dim)]
        return self._record(sample, crop_min, crop_max)


class RandomCrop(CenterCrop):
    def __init__(self, params):
        AbstractTransform.__init__(self, params)
        self.output_size = self.param('output_size')
        self.fg_focus = self.param('foreground_focus', False)
        self.fg_ratio = self.param('foreground_ratio', 0.5)
        self.mask_label = self.param('mask_label', [1])
        self.inverse = self.param('inverse', True)
        if not isinstance(self.output_size, (list, tuple)):
            raise ValueError('RandomCrop_output_size must be a list')
        if self.mask_label is not None and not isinstance(
                self.mask_label, (list, tuple)):
            raise ValueError('RandomCrop_mask_label must be a list')

    def cache_safe(self):
        return False    # a random crop origin

    def _fg_bounding_box(self, label):
        """Bounding box of the mask_label classes (no random draw)."""
        mask = np.zeros_like(label)
        for lab in self.mask_label:
            mask = np.maximum(mask, label == lab)
        if mask.sum() == 0:
            return [0] * label.ndim, list(mask.shape)
        return get_nd_bounding_box(mask)

    def precompute(self, sample):
        # the full-volume foreground scan dominates a cached item's cost:
        # stash it once per item; _crop_param reuses it with the same draws
        if self.fg_focus and 'label' in sample:
            sample['RandomCrop_fgbb'] = json.dumps(
                self._fg_bounding_box(sample['label']))
        return sample

    def _crop_param(self, sample):
        input_shape = sample['image'].shape
        input_dim = len(input_shape) - 1
        if input_dim != len(self.output_size):
            raise ValueError('RandomCrop_output_size {0} for a {1}D image'
                             .format(self.output_size, input_dim))
        out_size = list(self.output_size)
        if input_dim == 3 and out_size[0] is None:
            out_size[0] = input_shape[1]
        crop_margin = [input_shape[i + 1] - out_size[i]
                       for i in range(input_dim)]
        crop_min = [0 if m == 0 else random.randint(0, m)
                    for m in crop_margin]
        if self.fg_focus and random.random() < self.fg_ratio:
            stash = sample.get('RandomCrop_fgbb')
            if stash is not None:
                bb_min, bb_max = json.loads(stash)
            else:
                bb_min, bb_max = self._fg_bounding_box(sample['label'])
            bb_min, bb_max = bb_min[1:], bb_max[1:]
            crop_min = [random.randint(bb_min[i], bb_max[i])
                        - out_size[i] // 2 for i in range(input_dim)]
            crop_min = [max(0, v) for v in crop_min]
            crop_min = [min(crop_min[i], input_shape[i + 1] - out_size[i])
                        for i in range(input_dim)]
        crop_max = [crop_min[i] + out_size[i] for i in range(input_dim)]
        return self._record(sample, crop_min, crop_max)


class RandomResizedCrop(CenterCrop):
    """2D random crop and resize (reference crop.py:246-320)."""

    def __init__(self, params):
        AbstractTransform.__init__(self, params)
        self.output_size = self.param('output_size')
        self.scale = self.param('scale')
        self.ratio = self.param('ratio')
        self.inverse = False

    def cache_safe(self):
        return False    # a random crop, scale and ratio

    def inverse_transform_for_prediction(self, sample):
        raise ValueError('RandomResizedCrop predictions cannot be pasted '
                         'back (the crop is resized); disable its inverse')

    def _crop_param(self, sample):
        input_shape = sample['image'].shape
        if len(input_shape) != 3 or len(self.output_size) != 2:
            raise ValueError('RandomResizedCrop takes a 2D image and a 2D '
                             'output_size')
        scale = self.scale[0] + random.random() * (self.scale[1]
                                                   - self.scale[0])
        ratio = self.ratio[0] + random.random() * (self.ratio[1]
                                                   - self.ratio[0])
        crop_w = input_shape[-1] * scale
        crop_h = min(crop_w * ratio, input_shape[-2])
        out_shape = [int(crop_h), int(crop_w)]
        crop_min = [random.randint(0, input_shape[i + 1] - out_shape[i])
                    for i in range(2)]
        crop_max = [crop_min[i] + out_shape[i] for i in range(2)]
        return self._record(sample, crop_min, crop_max)

    def __call__(self, sample):
        crop_min, crop_max = self._crop_param(sample)
        image = _crop(sample['image'], crop_min, crop_max)
        zoom = [1.0] + [(self.output_size[i] + 0.0) / image.shape[1 + i]
                        for i in range(2)]
        sample['image'] = ndimage.zoom(image, zoom, order=1)
        if self.task == 'segmentation':
            for key, order in (('label', 0), ('pixel_weight', 1)):
                if key in sample:
                    cmax = [sample[key].shape[0]] + list(crop_max[1:])
                    sample[key] = ndimage.zoom(
                        _crop(sample[key], crop_min, cmax), zoom, order=order)
        return sample
