"""Intensity normalization (reference PyMIC/pymic/transform/normalize.py):
per-channel z-score with optional non-positive-region randomization
(``NormalizeWithMeanStd_dual`` normalises ``image1``, the fake-source
translation of the dual-consistency training, the same way), min-max and
percentile rescaling to [0, 1]."""
from __future__ import annotations

import numpy as np

from fpl_plus_torch.transforms.abstract import AbstractTransform


def _zscore_channels(image, chns, means, stds, ignore_non_positive):
    for i, chn in enumerate(chns):
        mean, std = means[i], stds[i]
        if mean is None:
            if ignore_non_positive:
                pixels = image[chn][image[chn] > 0]
                mean, std = pixels.mean(), pixels.std()
            else:
                mean, std = image[chn].mean(), image[chn].std()
        norm = (image[chn] - mean) / std
        if ignore_non_positive:
            rnd = np.random.normal(0, 1, size=norm.shape)
            norm[image[chn] <= 0] = rnd[image[chn] <= 0]
        image[chn] = norm
    return image


class NormalizeWithMeanStd(AbstractTransform):
    _param_prefix = 'NormalizeWithMeanStd'

    def __init__(self, params):
        super().__init__(params)
        self.chns = self.param('channels')
        self.mean = self.param('mean', None)
        self.std = self.param('std', None)
        self.ignore_np = self.param('ignore_non_positive', False)
        self.inverse = self.param('inverse', False)

    def cache_safe(self):
        # ignore_non_positive fills the background with fresh noise
        return not self.ignore_np

    def _normalize(self, image):
        chns = self.chns if self.chns is not None else range(image.shape[0])
        means = self.mean if self.mean is not None else [None] * len(list(chns))
        stds = self.std if self.std is not None else [None] * len(list(chns))
        return _zscore_channels(image, list(chns), means, stds,
                                self.ignore_np)

    def __call__(self, sample):
        sample['image'] = self._normalize(sample['image'])
        return sample


class NormalizeWithMeanStd_dual(NormalizeWithMeanStd):
    """The same z-score on ``image`` and, when present, ``image1``."""

    def __call__(self, sample):
        sample = super().__call__(sample)
        if 'image1' in sample:
            sample['image1'] = self._normalize(sample['image1'])
        return sample


class NormalizeWithMinMax(AbstractTransform):
    """Per channel: clip to [threshold_lower, threshold_upper] (the
    channel's min and max where None) and rescale to [0, 1]."""

    def __init__(self, params):
        super().__init__(params)
        self.chns = self.param('channels')
        self.thred_lower = self.param('threshold_lower')
        self.thred_upper = self.param('threshold_upper')
        self.inverse = self.param('inverse', False)

    def cache_safe(self):
        return True

    def __call__(self, sample):
        image = sample['image']
        chns = self.chns if self.chns is not None else range(image.shape[0])
        for i, chn in enumerate(chns):
            img = image[chn]
            v0, v1 = img.min(), img.max()
            if self.thred_lower is not None and \
                    self.thred_lower[i] is not None:
                v0 = self.thred_lower[i]
            if self.thred_upper is not None and \
                    self.thred_upper[i] is not None:
                v1 = self.thred_upper[i]
            image[chn] = (np.clip(img, v0, v1) - v0) / (v1 - v0)
        sample['image'] = image
        return sample


class NormalizeWithPercentiles(AbstractTransform):
    """Per channel: clip to its [percentile_lower, percentile_upper]
    percentiles and rescale to [0, 1]."""

    def __init__(self, params):
        super().__init__(params)
        self.chns = self.param('channels')
        self.percent_lower = self.param('percentile_lower')
        self.percent_upper = self.param('percentile_upper')
        self.inverse = self.param('inverse', False)

    def cache_safe(self):
        return True

    def __call__(self, sample):
        image = sample['image']
        chns = self.chns if self.chns is not None else range(image.shape[0])
        for chn in chns:
            img = image[chn]
            v0 = np.percentile(img, self.percent_lower)
            v1 = np.percentile(img, self.percent_upper)
            image[chn] = (np.clip(img, v0, v1) - v0) / (v1 - v0)
        sample['image'] = image
        return sample
