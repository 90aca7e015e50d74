"""PyTorch port, the test-chain transforms whose inverse runs on the host
(CenterCrop, CropWithBoundingBox, Rescale, RandomFlip, Pad), the dual-image
transforms and the dataset's ``image1`` column, against the JAX package's
transforms on the same samples. Exact: both sides are the same numpy and
scipy calls.
"""
import json
import os
import random

import numpy as np
import pytest

from fpl_plus_torch.io.dataset import NiftyDataset
from fpl_plus_torch.io.nifti import ImageGeometry, NiftiImage, write_nifti
from fpl_plus_torch.transforms.trans_dict import TransformDict
from tests.test_torch_port_models import one_torch_thread  # noqa: F401

PARAMS = {
    'task': 'segmentation',
    'centercrop_output_size': [None, 10, 12],
    'cropwithboundingbox_start': None,
    'cropwithboundingbox_output_size': [6, 8, 8],
    'rescale_output_size': [12, 20, 18],
    'randomflip_flip_depth': True,
    'randomflip_flip_height': True,
    'randomflip_flip_width': True,
    'pad_output_size': [12, 24, 28],
    'normalizewithmeanstd_channels': [0],
}


def _sample(rs):
    image = rs.normal(2.0, 1.0, size=(1, 9, 16, 22)).astype(np.float32)
    image[:, 2:7, 4:12, 5:15] += 3.0
    return {'image': image,
            'image1': rs.normal(1.0, 2.0, size=(1, 9, 16, 22)).astype(
                np.float32),
            'label': (image > 4.0).astype(np.int32),
            'pixel_weight': rs.uniform(size=(1, 9, 16, 22)).astype(
                np.float32)}


def _copy(sample):
    return {k: v.copy() if isinstance(v, np.ndarray) else v
            for k, v in sample.items()}


@pytest.mark.parametrize('name', ['CenterCrop', 'CropWithBoundingBox',
                                  'Rescale', 'RandomFlip', 'Pad', 'Pad_dual',
                                  'NormalizeWithMeanStd_dual'])
def test_transform_and_inverse_equal_jax(name):
    from fpl_plus_tpu.transforms.trans_dict import TransformDict as JaxTD
    rs = np.random.RandomState(len(name))
    sample = _sample(rs)
    random.seed(3)
    want = JaxTD[name](PARAMS)(_copy(sample))
    random.seed(3)
    port = TransformDict[name](PARAMS)
    got = port(_copy(sample))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key] == value, key
    if not port.inverse:
        return
    logits = rs.normal(size=(1, 2) + got['image'].shape[1:]).astype(
        np.float32)
    want_inv = JaxTD[name](PARAMS).inverse_transform_for_prediction(
        dict(want, predict=logits.copy()))['predict']
    got_inv = port.inverse_transform_for_prediction(
        dict(got, predict=logits.copy()))['predict']
    assert got_inv.shape == (1, 2) + sample['image'].shape[1:]
    np.testing.assert_array_equal(got_inv, want_inv)


def test_selection_only_for_crop_inverses():
    """Pad's inverse folds into the device-label path; the pasting and
    zooming inverses do not, so a chain with them takes the host path."""
    sample = _sample(np.random.RandomState(1))
    pad = TransformDict['Pad'](PARAMS)
    out = pad(_copy(sample))
    assert pad.inverse_selection(out) == ([1, 4, 3], [2, 4, 3])
    for name in ('CenterCrop', 'Rescale', 'RandomFlip'):
        t = TransformDict[name](PARAMS)
        assert t.inverse_selection(t(_copy(sample))) is None
    with pytest.raises(ValueError, match='not implemented'):
        TransformDict['NormalizeWithMeanStd'](
            PARAMS).inverse_transform_for_prediction({'predict': None})


def test_image1_column_and_fallback(tmp_path):
    """The dataset loads ``image1``; an unreadable file falls back to the
    image, as the JAX package's dataset does."""
    from fpl_plus_tpu.io.dataset import NiftyDataset as JaxDataset
    root = str(tmp_path)
    geom = ImageGeometry(origin=(0., 0., 0.), spacing=(1.0, 1.0, 1.0),
                         direction=(1, 0, 0, 0, 1, 0, 0, 0, 1))
    rs = np.random.RandomState(2)
    for n in ('img', 'fake', 'lab'):
        arr = rs.normal(size=(4, 6, 6)).astype(np.float32)
        write_nifti(NiftiImage(arr if n != 'lab' else (arr > 0).astype(
            np.int16), geom), os.path.join(root, n + '.nii.gz'))
    with open(os.path.join(root, 'm.csv'), 'w') as f:
        f.write('image,label,image1\nimg.nii.gz,lab.nii.gz,fake.nii.gz\n'
                'img.nii.gz,lab.nii.gz,missing.nii.gz\n')
    csv_file = os.path.join(root, 'm.csv')
    got = NiftyDataset(root, csv_file, with_label=True)
    want = JaxDataset(root, csv_file, with_label=True)
    for i in range(2):
        np.testing.assert_array_equal(got[i]['image1'], want[i]['image1'])
    np.testing.assert_array_equal(got[1]['image1'], got[1]['image'])
    assert not np.array_equal(got[0]['image1'], got[0]['image'])
    assert json.loads(json.dumps(got[0]['names'])) == 'img.nii.gz'
