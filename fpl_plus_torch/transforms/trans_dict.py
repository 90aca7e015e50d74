"""Transform registry (parity with reference trans_dict.py:42-66), holding
the transforms ported so far: the test chains (crop and non-crop
inverses), the FPL+ training chain and its dual-image variants."""
from __future__ import annotations

from fpl_plus_torch.transforms.crop import (CenterCrop, CropWithBoundingBox,
                                            RandomCrop)
from fpl_plus_torch.transforms.flip import RandomFlip
from fpl_plus_torch.transforms.label_convert import LabelToProbability
from fpl_plus_torch.transforms.normalize import (NormalizeWithMeanStd,
                                                 NormalizeWithMeanStd_dual)
from fpl_plus_torch.transforms.pad import Pad, Pad_dual
from fpl_plus_torch.transforms.rescale import Rescale

TransformDict = {
    'CenterCrop': CenterCrop,
    'CropWithBoundingBox': CropWithBoundingBox,
    'LabelToProbability': LabelToProbability,
    'NormalizeWithMeanStd': NormalizeWithMeanStd,
    'NormalizeWithMeanStd_dual': NormalizeWithMeanStd_dual,
    'Pad': Pad,
    'Pad_dual': Pad_dual,
    'RandomCrop': RandomCrop,
    'RandomFlip': RandomFlip,
    'Rescale': Rescale,
}


class Compose(object):
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, sample):
        for t in self.transforms:
            sample = t(sample)
        return sample
