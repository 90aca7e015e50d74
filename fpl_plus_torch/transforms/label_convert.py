"""Label conversion: ReduceLabelDim, LabelConvert, LabelConvertNonzero,
LabelToProbability and PartialLabelToProbability.

Behaviour parity: reference PyMIC/pymic/transform/label_convert.py and the
JAX package's ``transforms/label_convert.py``. Segmentation labels are
``[1, *spatial]``; one-hot maps ``label_prob [class_num, *spatial]`` f32. A
classification label is an index, its ``label_prob`` a one-hot vector.
"""
from __future__ import annotations

import numpy as np

from fpl_plus_torch.transforms.abstract import AbstractTransform
from fpl_plus_torch.utils.image_process import convert_label


class _LabelTransform(AbstractTransform):
    """Every label conversion is a deterministic function of the sample."""

    def __init__(self, params):
        super().__init__(params)
        self.inverse = self.param('inverse', False)

    def cache_safe(self):
        return True


class ReduceLabelDim(_LabelTransform):
    def __call__(self, sample):
        sample['label'] = sample['label'][0]
        return sample


class LabelConvert(_LabelTransform):
    """Map label ``source_list[i]`` to ``target_list[i]`` (others to 0)."""

    def __init__(self, params):
        super().__init__(params)
        self.source_list = self.param('source_list')
        self.target_list = self.param('target_list')
        if len(self.source_list) != len(self.target_list):
            raise ValueError('LabelConvert source_list and target_list '
                             'differ in length')

    def __call__(self, sample):
        sample['label'] = convert_label(sample['label'], self.source_list,
                                        self.target_list)
        return sample


class LabelConvertNonzero(_LabelTransform):
    def __call__(self, sample):
        sample['label'] = np.asarray(sample['label'] > 0, np.uint8)
        return sample


def _one_hot(label, class_num):
    prob = np.zeros((class_num,) + label.shape, np.float32)
    for i in range(class_num):
        prob[i] = (label == i)
    return prob


class LabelToProbability(_LabelTransform):
    def __init__(self, params):
        super().__init__(params)
        self.class_num = self.param('class_num')

    def __call__(self, sample):
        if self.task == 'segmentation':
            sample['label_prob'] = _one_hot(sample['label'][0],
                                            self.class_num)
        elif self.task == 'classification':
            label_prob = np.zeros((self.class_num,), np.float32)
            label_prob[sample['label']] = 1.0
            sample['label_prob'] = label_prob
        return sample


class PartialLabelToProbability(_LabelTransform):
    """One-hot for scribble supervision: class index ``class_num`` marks
    unlabelled voxels, which get ``pixel_weight`` 0 (the WSL path)."""

    def __init__(self, params):
        super().__init__(params)
        self.class_num = self.param('class_num')

    def __call__(self, sample):
        label = sample['label'][0]
        if label.max() > self.class_num:
            raise ValueError('PartialLabelToProbability: label {0} above '
                             'class_num {1}'.format(label.max(),
                                                    self.class_num))
        sample['label_prob'] = _one_hot(label, self.class_num)
        sample['pixel_weight'] = 1.0 - np.asarray([label == self.class_num],
                                                  np.float32)
        return sample
