"""Thresholding: ChannelWiseThreshold, ChannelWiseThresholdWithNormalize.

Behaviour parity: reference PyMIC/pymic/transform/threshold.py:14-131 and
the JAX package's ``transforms/threshold.py``.
"""
from __future__ import annotations

import numpy as np

from fpl_plus_torch.transforms.abstract import AbstractTransform


class ChannelWiseThreshold(AbstractTransform):
    """Per channel i: values below ``threshold_lower[i]`` become
    ``replace_lower[i]`` (the threshold itself when None), values above
    ``threshold_upper[i]`` likewise."""

    def __init__(self, params):
        super().__init__(params)
        self.channels = self.param('channels')
        self.threshold_lower = self.param('threshold_lower')
        self.threshold_upper = self.param('threshold_upper')
        self.replace_lower = self.param('replace_lower')
        self.replace_upper = self.param('replace_upper')
        self.inverse = self.param('inverse', False)

    def cache_safe(self):
        return True

    @staticmethod
    def _at(values, i):
        return None if values is None else values[i]

    def __call__(self, sample):
        image = sample['image']
        channels = (range(image.shape[0]) if self.channels is None
                    else self.channels)
        for i, chn in enumerate(channels):
            t = self._at(self.threshold_lower, i)
            if t is not None:
                r = self._at(self.replace_lower, i)
                image[chn][image[chn] < t] = t if r is None else r
            t = self._at(self.threshold_upper, i)
            if t is not None:
                r = self._at(self.replace_upper, i)
                image[chn][image[chn] > t] = t if r is None else r
        sample['image'] = image
        return sample


class ChannelWiseThresholdWithNormalize(AbstractTransform):
    """Per channel: with ``mean_std_mode``, the z-score of the voxels inside
    the thresholds and N(0, 1) noise outside; else clip to the thresholds
    and rescale to [0, 1] (from the lower threshold, or the minimum)."""

    def __init__(self, params):
        super().__init__(params)
        self.channels = self.param('channels')
        self.threshold_lower = self.param('threshold_lower')
        self.threshold_upper = self.param('threshold_upper')
        self.mean_std_mode = self.param('mean_std_mode')
        self.inverse = self.param('inverse', False)

    def cache_safe(self):
        # mean_std_mode fills out-of-threshold voxels with fresh noise
        return not self.mean_std_mode

    def __call__(self, sample):
        image = sample['image']
        channels = (range(image.shape[0]) if self.channels is None
                    else self.channels)
        for chn in channels:
            v0 = self.threshold_lower[chn]
            v1 = self.threshold_upper[chn]
            img = image[chn]
            if self.mean_std_mode:
                mask = np.ones_like(img)
                if v0 is not None:
                    mask = mask * (img > v0)
                if v1 is not None:
                    mask = mask * (img < v1)
                pixels = img[mask > 0]
                norm = (img - pixels.mean()) / pixels.std()
                rnd = np.random.normal(0, 1, size=norm.shape)
                norm[mask == 0] = rnd[mask == 0]
                image[chn] = norm
            else:
                if v0 is not None:
                    img[img < v0] = v0
                    v_min = v0
                else:
                    v_min = img.min()
                if v1 is not None:
                    img[img > v1] = v1
                image[chn] = (img - v_min) / (img.max() - v_min)
        sample['image'] = image
        return sample
