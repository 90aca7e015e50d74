"""Intensity augmentation: GammaCorrection, GaussianNoise, GrayscaleToRGB.

Behaviour parity: reference PyMIC/pymic/transform/intensity.py:14-103 and
the JAX package's ``transforms/intensity.py``; the ``random`` and
``np.random`` draws come in the same order as there, so a shared seed gives
equal outputs.
"""
from __future__ import annotations

import random

import numpy as np

from fpl_plus_torch.transforms.abstract import AbstractTransform


class GammaCorrection(AbstractTransform):
    """With probability ``probability``, per listed channel: rescale to
    [0, 1], raise to a gamma drawn in [gamma_min, gamma_max), scale back. A
    constant channel is left alone."""

    def __init__(self, params):
        super().__init__(params)
        self.channels = self.param('channels')
        self.gamma_min = self.param('gamma_min')
        self.gamma_max = self.param('gamma_max')
        self.prob = self.param('probability', 0.5)
        self.inverse = self.param('inverse', False)

    def __call__(self, sample):
        if np.random.uniform() > self.prob:
            return sample
        image = sample['image']
        for chn in self.channels:
            gamma = (random.random() * (self.gamma_max - self.gamma_min)
                     + self.gamma_min)
            img = image[chn]
            v_min, v_max = img.min(), img.max()
            if v_max <= v_min:
                continue
            img = (img - v_min) / (v_max - v_min)
            image[chn] = np.power(img, gamma) * (v_max - v_min) + v_min
        sample['image'] = image
        return sample


class GaussianNoise(AbstractTransform):
    """With probability ``probability``, add N(mean, std) noise to each
    listed channel."""

    def __init__(self, params):
        super().__init__(params)
        self.channels = self.param('channels')
        self.mean = self.param('mean')
        self.std = self.param('std')
        self.prob = self.param('probability', 0.5)
        self.inverse = self.param('inverse', False)

    def __call__(self, sample):
        if np.random.uniform() > self.prob:
            return sample
        image = sample['image']
        for chn in self.channels:
            image[chn] = image[chn] + np.random.normal(self.mean, self.std,
                                                       image[chn].shape)
        sample['image'] = image
        return sample


class GrayscaleToRGB(AbstractTransform):
    """A one-channel image repeated to three channels."""

    def __init__(self, params):
        super().__init__(params)
        self.inverse = self.param('inverse', False)

    def cache_safe(self):
        return True

    def __call__(self, sample):
        image = sample['image']
        if image.shape[0] not in (1, 3):
            raise ValueError('GrayscaleToRGB needs 1 or 3 channels, got '
                             '{0}'.format(image.shape[0]))
        if image.shape[0] == 1:
            sample['image'] = np.concatenate([image, image, image])
        return sample
