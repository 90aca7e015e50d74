"""PyTorch port, the transforms ported with the network zoo (intensity,
threshold, rotation, resized crop, random rescale, min-max and percentile
normalisation, label conversions) against the JAX package's transforms:
the same sample and the same ``random`` / ``np.random`` seeds give equal
outputs (exact: both sides make the same numpy and scipy calls), the
prediction inverses included. Also the registry's names.
"""
import random

import numpy as np
import pytest

from fpl_plus_torch.transforms.trans_dict import TransformDict
from tests.test_torch_port_models import one_torch_thread  # noqa: F401

PARAMS = {
    'task': 'segmentation',
    'gammacorrection_channels': [0, 1],
    'gammacorrection_gamma_min': 0.7,
    'gammacorrection_gamma_max': 1.5,
    'gammacorrection_probability': 1.0,
    'gaussiannoise_channels': [1],
    'gaussiannoise_mean': 0.0,
    'gaussiannoise_std': 0.1,
    'gaussiannoise_probability': 1.0,
    'channelwisethreshold_channels': [0, 1],
    'channelwisethreshold_threshold_lower': [1.0, None],
    'channelwisethreshold_threshold_upper': [4.0, 3.0],
    'channelwisethreshold_replace_lower': [0.0, None],
    'channelwisethreshold_replace_upper': [None, None],
    'channelwisethresholdwithnormalize_channels': [0, 1],
    'channelwisethresholdwithnormalize_threshold_lower': [1.0, None],
    'channelwisethresholdwithnormalize_threshold_upper': [4.5, 3.0],
    'channelwisethresholdwithnormalize_mean_std_mode': False,
    'randomrotate_angle_range_d': [-30, 30],
    'randomrotate_angle_range_h': [-10, 10],
    'randomrotate_angle_range_w': None,
    'randomresizedcrop_output_size': [12, 14],
    'randomresizedcrop_scale': [0.5, 0.9],
    'randomresizedcrop_ratio': [0.8, 1.2],
    'randomrescale_lower_bound': [1.0, 0.7, 0.8],
    'randomrescale_upper_bound': [1.0, 1.3, 1.2],
    'normalizewithminmax_channels': [0, 1],
    'normalizewithminmax_threshold_lower': [0.5, None],
    'normalizewithminmax_threshold_upper': [None, 2.0],
    'normalizewithpercentiles_channels': None,
    'normalizewithpercentiles_percentile_lower': 1,
    'normalizewithpercentiles_percentile_upper': 99,
    'labelconvert_source_list': [0, 1, 2],
    'labelconvert_target_list': [0, 500, 205],
    'labeltoprobability_class_num': 3,
    'partiallabeltoprobability_class_num': 2,
}
NEW = ['GammaCorrection', 'GaussianNoise', 'GrayscaleToRGB',
       'ChannelWiseThreshold', 'ChannelWiseThresholdWithNormalize',
       'RandomRotate', 'RandomResizedCrop', 'RandomRescale',
       'NormalizeWithMinMax', 'NormalizeWithPercentiles', 'ReduceLabelDim',
       'LabelConvert', 'LabelConvertNonzero', 'PartialLabelToProbability']
TWO_D = ('RandomResizedCrop', 'GrayscaleToRGB')


def _sample(name, rs):
    shape = (1, 20, 24) if name in TWO_D else (2, 9, 16, 22)
    image = rs.normal(2.0, 1.0, size=shape).astype(np.float32)
    image[..., 4:12, 5:15] += 3.0
    label = (image[:1] > 4.0).astype(np.int32) + (image[:1] > 5.5)
    return {'image': image, 'label': label,
            'pixel_weight': rs.uniform(size=(1,) + shape[1:]).astype(
                np.float32)}


def _copy(sample):
    return {k: v.copy() if isinstance(v, np.ndarray) else v
            for k, v in sample.items()}


def _seeded(transform, sample, seed):
    random.seed(seed)
    np.random.seed(seed)
    return transform(_copy(sample))


@pytest.mark.parametrize('name', NEW)
def test_transform_and_inverse_equal_jax(name):
    from fpl_plus_tpu.transforms.trans_dict import TransformDict as JaxTD
    sample = _sample(name, np.random.RandomState(len(name)))
    want = _seeded(JaxTD[name](PARAMS), sample, 3)
    port = TransformDict[name](PARAMS)
    got = _seeded(port, sample, 3)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key] == value, key
    changed = [k for k in sample if not np.array_equal(got[k], sample[k])]
    assert changed or name == 'GrayscaleToRGB', 'no key changed'
    if not port.inverse:
        return
    logits = np.random.RandomState(1).normal(
        size=(1, 2) + got['image'].shape[1:]).astype(np.float32)
    want_inv = JaxTD[name](PARAMS).inverse_transform_for_prediction(
        dict(want, predict=logits.copy()))['predict']
    got_inv = port.inverse_transform_for_prediction(
        dict(got, predict=logits.copy()))['predict']
    assert got_inv.shape[2:] == sample['image'].shape[1:]
    np.testing.assert_array_equal(got_inv, want_inv)


def test_seeded_variants_and_registry():
    """The noise-drawing variants (GammaCorrection's probability draw,
    ChannelWiseThresholdWithNormalize's mean_std_mode) equal JAX's too, a
    1-channel GrayscaleToRGB makes 3, a classification label becomes a
    one-hot vector, and the registry has JAX's names."""
    from fpl_plus_tpu.transforms.trans_dict import TransformDict as JaxTD
    sample = _sample('x', np.random.RandomState(5))
    for name, extra in (
            ('GammaCorrection', {'gammacorrection_probability': 0.5}),
            ('ChannelWiseThresholdWithNormalize',
             {'channelwisethresholdwithnormalize_mean_std_mode': True})):
        params = dict(PARAMS, **extra)
        for seed in range(4):
            want = _seeded(JaxTD[name](params), sample, seed)
            got = _seeded(TransformDict[name](params), sample, seed)
            np.testing.assert_array_equal(got['image'], want['image'])
    rgb = TransformDict['GrayscaleToRGB'](PARAMS)(
        _copy(_sample('GrayscaleToRGB', np.random.RandomState(1))))
    assert rgb['image'].shape == (3, 20, 24)
    cls = dict(PARAMS, task='classification')
    got = TransformDict['LabelToProbability'](cls)({'label': 2})
    want = JaxTD['LabelToProbability'](cls)({'label': 2})
    np.testing.assert_array_equal(got['label_prob'], want['label_prob'])
    assert got['label_prob'].tolist() == [0.0, 0.0, 1.0]
    assert sorted(TransformDict) == sorted(JaxTD)
