"""PyTorch port, the FPL+ weight and data tools: ``python -m
fpl_plus_torch.fpl`` against ``python -m fpl_plus_tpu.fpl`` on the same
inputs. Both are host numpy/scipy code, so the results must be identical:
the same CSV bytes and the same NIfTI payloads (header and voxels, compared
after gzip, whose header carries a time stamp)."""
import gzip
import os

import numpy as np
import pytest

from fpl_plus_tpu.fpl.__main__ import main as jax_fpl
from fpl_plus_torch.fpl.__main__ import main as torch_fpl
from fpl_plus_torch.io.nifti import ImageGeometry, NiftiImage, write_nifti

GEOM = ImageGeometry(origin=(1.0, -2.0, 3.0), spacing=(0.5, 0.5, 3.0),
                     direction=(1, 0, 0, 0, 1, 0, 0, 0, 1))


def _write(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_nifti(NiftiImage(arr, GEOM), path)


def _inputs(root, tool):
    """Seeded inputs of one tool; returns its arguments with ``{out}`` for
    the output location."""
    rs = np.random.RandomState(50)
    if tool == 'pixel-weight':
        for case in range(3):
            a = (rs.rand(6, 10, 12) > 0.5).astype(np.int16)
            b = np.where(rs.rand(6, 10, 12) > 0.8, 1 - a, a).astype(np.int16)
            _write('{0}/pt/case{1}.nii.gz'.format(root, case), a)
            _write('{0}/pf/case{1}.nii.gz'.format(root, case), b)
        return ['pixel-weight', '--pseudo-target', root + '/pt',
                '--pseudo-fake-source', root + '/pf', '--output', '{out}']
    if tool == 'image-weight':
        # the FPL stage's layout: ascending ([uncertainty], name) pairs,
        # one volume under the boundary rule (1)
        values = [0.0031, 0.0007, 1, 0.0019]
        names = ['img/case{0}.nii.gz'.format(i) for i in range(4)]
        pairs = sorted(zip([[v] for v in values], names))
        np.save(root + '/unc.npy', np.asarray(pairs, dtype=object))
        return ['image-weight', '--uncertainty', root + '/unc.npy',
                '--output-csv', '{out}/train_weighted.csv',
                '--image-dir', 'data/img', '--pseudo-label-dir', 'res/pl',
                '--pixel-weight-dir', 'data/pw']
    if tool == 'write-csv':
        os.makedirs(root + '/imgs')
        for name in ('b_t2.nii.gz', 'a_t2.nii.gz', 'c_t1.nii.gz'):
            open(os.path.join(root, 'imgs', name), 'w').close()
        return ['write-csv', '--image-dir', root + '/imgs', '--label-dir',
                root + '/labs', '--filter', '_t2', '--output',
                '{out}/pairs.csv']
    if tool == 'split-csv':
        with open(root + '/all.csv', 'w') as f:
            f.write('image,label\n' + ''.join(
                'i{0}.nii.gz,l{0}.nii.gz\n'.format(i) for i in range(11)))
        return ['split-csv', '--input', root + '/all.csv', '--seed', '7',
                '--output', '{out}/train.csv:6', '--output',
                '{out}/valid.csv:-1']
    if tool == 'preprocess-bst':
        img = rs.normal(100, 30, (30, 12, 14)).astype(np.float32)
        lab = np.zeros((30, 12, 14), np.int16)
        lab[12:15, 4:8, 5:9] = 2
        _write(root + '/bst/img.nii.gz', img)
        _write(root + '/bst/lab.nii.gz', lab)
        return ['preprocess-bst', root + '/bst/img.nii.gz',
                root + '/bst/lab.nii.gz', '{out}/img.nii.gz',
                '{out}/lab.nii.gz']
    if tool == 'preprocess-vs-target':
        _write(root + '/t2.nii.gz',
               rs.normal(0, 1, (14, 64, 48)).astype(np.float32))
        return ['preprocess-vs-target', root + '/t2.nii.gz',
                '{out}/t2.nii.gz']
    # preprocess-vs-source: a fixed physical box, 60 slices of 3 mm
    img = rs.normal(0, 1, (60, 352, 394)).astype(np.float32)
    lab = np.zeros(img.shape, np.int16)
    lab[20:25, 200:210, 150:160] = 1
    _write(root + '/t1/img.nii.gz', img)
    _write(root + '/t1/lab.nii.gz', lab)
    return ['preprocess-vs-source', root + '/t1/img.nii.gz',
            root + '/t1/lab.nii.gz', '{out}/img.nii.gz', '{out}/lab.nii.gz']


def _read_tree(out):
    files = {}
    for dirpath, _, names in os.walk(out):
        for name in names:
            path = os.path.join(dirpath, name)
            opener = gzip.open if name.endswith('.gz') else open
            with opener(path, 'rb') as f:
                files[os.path.relpath(path, out)] = f.read()
    return files


@pytest.mark.parametrize('tool', [
    'pixel-weight', 'image-weight', 'write-csv', 'split-csv',
    'preprocess-bst', 'preprocess-vs-target', 'preprocess-vs-source'])
def test_tool_matches_jax(tmp_path, tool):
    root = str(tmp_path)
    args = _inputs(root, tool)
    outs = {}
    for tag, main in (('jax', jax_fpl), ('torch', torch_fpl)):
        out = os.path.join(root, 'out_' + tag)
        os.makedirs(out)
        assert main([a.format(out=out) for a in args]) == 0
        outs[tag] = _read_tree(out)
    assert outs['torch'] and sorted(outs['torch']) == sorted(outs['jax'])
    for name, data in outs['jax'].items():
        assert outs['torch'][name] == data, name
    if tool == 'image-weight':
        rows = outs['torch']['train_weighted.csv'].decode().split()
        assert rows[0] == 'image,label,pixel_weight,image_weight'
        assert rows[1].startswith('data/img/case1.nii.gz,res/pl/case1')
