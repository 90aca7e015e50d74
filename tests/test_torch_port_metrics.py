"""PyTorch port, evaluation: the C++ raster-scan distance, the segmentation
metrics and ``eva_main`` against the JAX package's (no JAX program is
compiled: both sides are numpy, scipy and C++).

Tolerances: the distance maps equal the JAX package's C++ library bit for
bit (the same source and arithmetic); the port's C++ agrees with its own
float64 Python loop within rtol 1e-5 (f32 sums of square roots); the
metrics and the CSV cells equal the JAX ones within rtol 1e-9 (the same
float64 sums of the same f32 maps).
"""
import csv
import os

import numpy as np
import pytest

from fpl_plus_torch import native
from fpl_plus_torch.cli import main_eval_seg
from fpl_plus_torch.io.nifti import ImageGeometry, NiftiImage, write_nifti
from fpl_plus_torch.metrics import seg_metrics
from fpl_plus_torch.metrics.evaluate import eva_main
from tests.test_torch_port_models import one_torch_thread  # noqa: F401


@pytest.mark.parametrize('shape,spacing', [
    ((9, 17, 23), (1.5, 0.4, 0.7)),
    ((31, 26), (0.8, 0.3)),
])
def test_distance_maps_equal_jax_native(shape, spacing):
    from fpl_plus_tpu.native import raster_scan_distance as jax_distance
    seeds = np.random.RandomState(len(shape)).uniform(size=shape) > 0.97
    got = native.raster_scan_distance(seeds, spacing)
    want = jax_distance(seeds, spacing)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got, want)
    assert got.max() > 0 and np.all(got[seeds] == 0)


def test_cpp_matches_its_plain_version():
    rs = np.random.RandomState(2)
    seeds = rs.uniform(size=(6, 12, 12)) > 0.95
    spacing = (1.5, 0.8, 0.3)
    got = native.raster_scan_distance(seeds, spacing)
    want = native.raster_scan_reference(seeds, spacing)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    two_d = native.raster_scan_distance(seeds[0], spacing[1:])
    np.testing.assert_allclose(
        two_d, native.raster_scan_reference(seeds[0], spacing[1:]),
        rtol=1e-5)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A library that does not build raises; nothing falls back to the
    Python loop."""
    bad = tmp_path / 'raster_scan.cpp'
    bad.write_text('this is not C++\n')
    monkeypatch.setattr(native, '_SOURCE', bad)
    monkeypatch.setattr(native, '_BUILD_DIR', tmp_path / 'build')
    native._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match='failed'):
            native.raster_scan_distance(np.ones((4, 4), bool))
    finally:
        native._library.cache_clear()


def _masks(case, rs):
    shape = (7, 14, 15)
    if case == 'empty_empty':
        return np.zeros(shape, np.uint8), np.zeros(shape, np.uint8)
    if case == 'empty_full':
        return np.zeros(shape, np.uint8), np.ones(shape, np.uint8)
    if case == 'binary':
        g = np.zeros(shape, np.uint8)
        g[2:6, 3:11, 4:12] = 1
        s = g.copy()
        s[2:4, 3:9, 5:13] = 1
        s[rs.uniform(size=shape) > 0.97] ^= 1
        return s, g
    labels = rs.randint(0, 3, size=shape).astype(np.uint8)
    g = np.zeros(shape, np.uint8)
    g[1:5, 2:9, 3:10] = 1
    g[3:7, 8:13, 6:14] = 2
    s = np.where(rs.uniform(size=shape) > 0.9, labels, g).astype(np.uint8)
    return s, g


@pytest.mark.parametrize('case', ['empty_empty', 'empty_full', 'binary',
                                  'multi', 'multi_fused'])
def test_metrics_equal_jax(case):
    from fpl_plus_tpu.metrics import seg_metrics as jax_metrics
    s, g = _masks(case, np.random.RandomState(4))
    spacing = [1.5, 0.4, 0.7]
    labels = [1, 2] if case.startswith('multi') else [1]
    fuse = case == 'multi_fused'
    for metric in ('dice', 'iou', 'assd', 'hd95', 'rve', 'volume'):
        if metric == 'rve' and not g.any():
            continue         # an empty ground truth has no relative error
        got = seg_metrics.get_multi_class_evaluation_score(
            s, g, labels, fuse, spacing, metric)
        want = jax_metrics.get_multi_class_evaluation_score(
            s, g, labels, fuse, spacing, metric)
        np.testing.assert_allclose(got, want, rtol=1e-9, err_msg=metric)
    if case == 'empty_full':
        assert seg_metrics.binary_assd(s, g, spacing) == 50.0
        assert seg_metrics.binary_hd95(s, g, spacing) == 50.0
    if case == 'empty_empty':
        assert seg_metrics.binary_assd(s, g, spacing) == 0.0


EVAL_CFG = """
[evaluation]
metric_1 = dice
metric_2 = assd
label_list = [1, 2]
organ_name = tumor
ground_truth_folder_root = {root}/gt
segmentation_folder_root = {seg}
test_evaluation_image_pair = {root}/test_pairs.csv
valid_evaluation_image_pair = {root}/valid_pairs.csv
"""


def _read(path):
    with open(path, newline='') as f:
        return list(csv.reader(f))


def test_eva_main_csvs_equal_jax(tmp_path):
    """eva_main over NIfTI pairs with an anisotropic spacing: the port's
    CSVs equal the JAX package's cell by cell; ``main_eval_seg`` (``python
    -m fpl_plus_torch.metrics``) writes the same files."""
    from fpl_plus_tpu.metrics.evaluate import eva_main as jax_eva_main
    from fpl_plus_torch.config.parser import parse_config
    root = str(tmp_path)
    rs = np.random.RandomState(6)
    geom = ImageGeometry(origin=(0., 0., 0.), spacing=(0.7, 0.4, 1.5),
                         direction=(1, 0, 0, 0, 1, 0, 0, 0, 1))
    for d in ('gt', 'seg'):
        os.makedirs(os.path.join(root, d))
    names = []
    for case in range(3):
        s, g = _masks('multi', rs)
        name = 'case{0}.nii.gz'.format(case)
        write_nifti(NiftiImage(g.astype(np.int16), geom),
                    os.path.join(root, 'gt', name))
        write_nifti(NiftiImage(s, geom), os.path.join(root, 'seg', name))
        names.append(name)
    for split, rows in (('test', names), ('valid', names[:2])):
        with open(os.path.join(root, split + '_pairs.csv'), 'w') as f:
            f.write('ground_truth,segmentation\n'
                    + ''.join('{0},{0}\n'.format(n) for n in rows))
    seg = os.path.join(root, 'seg')
    cfg_path = os.path.join(root, 'eval.cfg')
    with open(cfg_path, 'w') as f:
        f.write(EVAL_CFG.format(root=root, seg=seg))
    config = parse_config(cfg_path)
    outs = ['{0}_tumor_{1}_all.csv'.format(split, metric)
            for split in ('test', 'valid') for metric in ('dice', 'assd')]

    jax_eva_main(config)
    ref = {n: _read(os.path.join(seg, n)) for n in outs}
    for n in outs:
        os.remove(os.path.join(seg, n))
    got_results = eva_main(config)
    assert sorted(got_results) == [('test', 'assd'), ('test', 'dice'),
                                   ('valid', 'assd'), ('valid', 'dice')]
    port = {}
    for n in outs:
        got = port[n] = _read(os.path.join(seg, n))
        assert got[0] == ref[n][0] == ['image', 'class_1', 'class_2',
                                       'average']
        assert [r[0] for r in got] == [r[0] for r in ref[n]]
        assert len(got) == (3 if n.startswith('test') else 2) + 3
        np.testing.assert_allclose(
            np.asarray([r[1:] for r in got[1:]], np.float64),
            np.asarray([r[1:] for r in ref[n][1:]], np.float64),
            rtol=1e-9, err_msg=n)
    for n in outs:
        os.remove(os.path.join(seg, n))
    assert main_eval_seg([cfg_path]) == 0
    for n in outs:
        assert _read(os.path.join(seg, n)) == port[n], n
