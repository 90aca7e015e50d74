"""Transform registry (parity with reference trans_dict.py:42-66), holding
the transforms ported so far: the test chain and the FPL+ training chain."""
from __future__ import annotations

from fpl_plus_torch.transforms.crop import RandomCrop
from fpl_plus_torch.transforms.flip import RandomFlip
from fpl_plus_torch.transforms.label_convert import LabelToProbability
from fpl_plus_torch.transforms.normalize import NormalizeWithMeanStd
from fpl_plus_torch.transforms.pad import Pad

TransformDict = {
    'LabelToProbability': LabelToProbability,
    'NormalizeWithMeanStd': NormalizeWithMeanStd,
    'Pad': Pad,
    'RandomCrop': RandomCrop,
    'RandomFlip': RandomFlip,
}


class Compose(object):
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, sample):
        for t in self.transforms:
            sample = t(sample)
        return sample
