"""RandomCrop with foreground-focused sampling.

Behaviour parity: reference PyMIC/pymic/transform/crop.py:183-245 and the
JAX package's ``transforms/crop.py`` ``RandomCrop``: a uniform crop origin
per axis; with ``foreground_focus`` and probability ``foreground_ratio``
the origin is drawn around the bounding box of the ``mask_label`` classes
instead. The ``random`` draws come in the same order as there, so a seeded
item gives the same crop. The image crop keeps every channel; ``label``,
``pixel_weight`` and ``image1`` are cropped alike. The crop is recorded as
``RandomCrop_Param`` (input shape, crop min, crop max).
"""
from __future__ import annotations

import json
import random

import numpy as np

from fpl_plus_torch.transforms.abstract import AbstractTransform


def get_nd_bounding_box(volume: np.ndarray):
    """Bounding box (min, max-exclusive per axis) of the nonzero region."""
    nz = np.nonzero(volume)
    bb_min = [int(ix.min()) for ix in nz]
    bb_max = [int(ix.max()) + 1 for ix in nz]
    return bb_min, bb_max


def _crop(volume: np.ndarray, bb_min, bb_max) -> np.ndarray:
    return volume[tuple(slice(lo, hi) for lo, hi in zip(bb_min, bb_max))]


class RandomCrop(AbstractTransform):
    def __init__(self, params):
        super().__init__(params)
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
        crop_min = [0] + crop_min
        crop_max = [input_shape[0]] + crop_max
        self.store_inverse_param(sample, (list(input_shape), crop_min,
                                          crop_max))
        return crop_min, crop_max

    def __call__(self, sample):
        crop_min, crop_max = self._crop_param(sample)
        sample['image'] = _crop(sample['image'], crop_min, crop_max)
        if self.task == 'segmentation':
            for key in ('label', 'pixel_weight', 'image1'):
                if key in sample:
                    cmax = [sample[key].shape[0]] + list(crop_max[1:])
                    sample[key] = _crop(sample[key], crop_min, cmax)
        return sample
