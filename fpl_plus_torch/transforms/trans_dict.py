"""Transform registry (parity with reference trans_dict.py:42-66 and the
JAX package's ``transforms/trans_dict.py``, the same 24 names) and the
chain builder every stage's chain goes through (``build_transforms``; an
agent passes its own registry, ``set_transform_dict``)."""
from __future__ import annotations

from fpl_plus_torch.transforms.crop import (CenterCrop, CropWithBoundingBox,
                                            RandomCrop, RandomResizedCrop)
from fpl_plus_torch.transforms.flip import RandomFlip
from fpl_plus_torch.transforms.intensity import (GammaCorrection,
                                                 GaussianNoise, GrayscaleToRGB)
from fpl_plus_torch.transforms.label_convert import (
    LabelConvert, LabelConvertNonzero, LabelToProbability,
    PartialLabelToProbability, ReduceLabelDim)
from fpl_plus_torch.transforms.normalize import (NormalizeWithMeanStd,
                                                 NormalizeWithMeanStd_dual,
                                                 NormalizeWithMinMax,
                                                 NormalizeWithPercentiles)
from fpl_plus_torch.transforms.pad import Pad, Pad_dual
from fpl_plus_torch.transforms.rescale import RandomRescale, Rescale
from fpl_plus_torch.transforms.rotate import RandomRotate
from fpl_plus_torch.transforms.threshold import (
    ChannelWiseThreshold, ChannelWiseThresholdWithNormalize)

TransformDict = {
    'ChannelWiseThreshold': ChannelWiseThreshold,
    'ChannelWiseThresholdWithNormalize': ChannelWiseThresholdWithNormalize,
    'CropWithBoundingBox': CropWithBoundingBox,
    'CenterCrop': CenterCrop,
    'GrayscaleToRGB': GrayscaleToRGB,
    'GammaCorrection': GammaCorrection,
    'GaussianNoise': GaussianNoise,
    'LabelConvert': LabelConvert,
    'LabelConvertNonzero': LabelConvertNonzero,
    'LabelToProbability': LabelToProbability,
    'NormalizeWithMeanStd': NormalizeWithMeanStd,
    'NormalizeWithMeanStd_dual': NormalizeWithMeanStd_dual,
    'NormalizeWithMinMax': NormalizeWithMinMax,
    'NormalizeWithPercentiles': NormalizeWithPercentiles,
    'PartialLabelToProbability': PartialLabelToProbability,
    'RandomCrop': RandomCrop,
    'RandomResizedCrop': RandomResizedCrop,
    'RandomRescale': RandomRescale,
    'RandomFlip': RandomFlip,
    'RandomRotate': RandomRotate,
    'ReduceLabelDim': ReduceLabelDim,
    'Rescale': Rescale,
    'Pad': Pad,
    'Pad_dual': Pad_dual,
}


class Compose(object):
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, sample):
        for t in self.transforms:
            sample = t(sample)
        return sample


def build_transforms(names, params, registry=None):
    """Instantiate the chain ``names`` from the flat ``params`` through
    ``registry`` (default ``TransformDict``); returns ``(transform_list,
    Compose)``. An unknown name raises ``ValueError``."""
    registry = TransformDict if registry is None else registry
    transform_list = []
    for name in names:
        if name not in registry:
            raise ValueError('Undefined transform {0}'.format(name))
        transform_list.append(registry[name](params))
    return transform_list, Compose(transform_list)
