"""PyTorch port, the paradigm and CLSLSR CLIs over 2 gloo ranks on the
CPU against one-rank runs.

Both run through ``tests/torch_cli.py`` (the CLI with tensorboard
blocked, one thread per process), the 1-rank and the 2-rank run side by
side:

* ``main_ssl train`` of MeanTeacher on ``tests/test_torch_port_ssl.py``'s
  workspace (the tiny UNet2D5 with dropout on its deep levels, 2 + 2
  crops, 2 iterations with validation after each, the auto test stage and
  ``eva_main``) at ``mesh_devices = 1`` and ``2``: the same checkpoint
  files, the parameters, statistics and ``ema_state_dict`` of the last
  checkpoint within the Adam-aware bound (2 updates at 1e-3, a sign where
  a gradient is at its noise level), and the auto test stage's labels
  equal voxel for voxel;
* ``main_nll_clslsr`` over three volumes (one of a single window, so that
  the second rank has none, two of four overlapping windows, 4-flip TTA)
  with a random tiny UNet2D5 checkpoint, at ``[testing] mesh_devices`` 1
  and 2: the ``slsr_conf/`` maps and the ``_clslsr.csv`` manifest equal.
"""
import csv
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from fpl_plus_torch.engine import ckpt as ckpt_lib
from fpl_plus_torch.io.image_io import load_image_as_nd_array
from fpl_plus_torch.io.nifti import ImageGeometry, NiftiImage, write_nifti
from fpl_plus_torch.models.registry import create_network
from tests.test_torch_port_clslsr import NET as CL_NET
from tests.test_torch_port_clslsr import cl_cfg
from tests.test_torch_port_dist import ROOT, _env
from tests.test_torch_port_ssl import SSL_CLI_CFG, write_ssl_workspace

LR = 1e-3


def _cli(*argv):
    return subprocess.Popen(
        [sys.executable, os.path.join(ROOT, 'tests', 'torch_cli.py')]
        + list(argv), cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _finish(procs, timeout=600):
    for p in procs:
        out, err = p.communicate(timeout=timeout)
        assert p.returncode == 0, (out[-2000:], err[-4000:])


def _ssl_cfg(root, run, mesh):
    text = SSL_CLI_CFG.format(root=root, method='MeanTeacher')
    for old, new in (('train_batch_size = 1', 'train_batch_size = 2'),
                     ('model/mt', 'model/' + run),
                     ('output_dir = {0}/result'.format(root),
                      'output_dir = {0}/result_{1}'.format(root, run)),
                     ('random_seed = 5', 'random_seed = 5\nmesh_devices = '
                      '{0}'.format(mesh))):
        assert old in text
        text = text.replace(old, new)
    path = os.path.join(root, run + '.cfg')
    with open(path, 'w') as f:
        f.write(text)
    return path


@pytest.fixture(scope='module')
def ssl_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('ssl_cli'))
    write_ssl_workspace(root)
    _finish([_cli('ssl', 'train', _ssl_cfg(root, run, mesh))
             for run, mesh in (('one', 1), ('two', 2))])
    return root


def test_two_rank_main_ssl_matches_one_rank(ssl_runs):
    """``main_ssl train`` of MeanTeacher at 2 ranks against 1: the
    checkpoint files, the last checkpoint's student, statistics and EMA
    teacher, and the auto test stage's labels."""
    root = ssl_runs
    files = {run: sorted(f.replace(run, '*') for f in os.listdir(
        os.path.join(root, 'model', run))) for run in ('one', 'two')}
    assert files['one'] == files['two'] and '*_2.pt' in files['one']
    ckpt = {run: torch.load(os.path.join(root, 'model', run,
                                         '{0}_2.pt'.format(run)),
                            weights_only=False) for run in ('one', 'two')}
    for part in ('model_state_dict', 'ema_state_dict'):
        want, got = ckpt['one'][part], ckpt['two'][part]
        assert want.keys() == got.keys() and len(want)
        for key, w in want.items():
            if key.endswith('num_batches_tracked'):
                assert int(got[key]) == int(w) == 2, key
                continue
            # two Adam updates, each off by at most a sign where the
            # gradient sits at its noise level
            assert float((got[key] - w).abs().max()) <= 2 * 2 * LR, key
    labels = {}
    for run in ('one', 'two'):
        out = os.path.join(root, 'result_' + run, run + '_d0_test')
        labels[run] = {n: load_image_as_nd_array(os.path.join(out, n))[
            'data_array'] for n in sorted(os.listdir(out))
            if n.endswith('.nii.gz')}
        assert os.path.isfile(os.path.join(out, 'test_cube_dice_all.csv'))
    assert labels['one'].keys() == labels['two'].keys()
    assert len(labels['one']) == 3
    for name, want in labels['one'].items():
        np.testing.assert_array_equal(labels['two'][name], want)


def _cl_workspace(root):
    """Three volumes (6x14x14: one window; 6x20x30: four overlapping
    windows), a bright block each with {0, 255} labels and a wrong
    corner, and a random tiny UNet2D5 checkpoint ``gen_2``."""
    rs = np.random.RandomState(17)
    geom = ImageGeometry(origin=(0., 0., 0.), spacing=(1., 1., 1.5),
                         direction=(1, 0, 0, 0, 1, 0, 0, 0, 1))
    for sub in ('img', 'lab'):
        os.makedirs(os.path.join(root, sub))
    rows = []
    for c, shape in enumerate([(6, 14, 14), (6, 20, 30), (6, 20, 30)]):
        vol = rs.normal(0, 1, size=shape).astype(np.float32)
        lab = np.zeros(shape, np.int16)
        lab[1:5, 3:10, 4:11] = 255
        vol[lab > 0] += 1.5
        lab[0:2, 0:4, 0:4] = 255                 # label noise
        names = ['img/case{0}.nii.gz'.format(c),
                 'lab/case{0}.nii.gz'.format(c)]
        write_nifti(NiftiImage(vol, geom), os.path.join(root, names[0]))
        write_nifti(NiftiImage(lab, geom), os.path.join(root, names[1]))
        rows.append(','.join(names))
    with open(os.path.join(root, 'train.csv'), 'w') as f:
        f.write('image,label\n' + '\n'.join(rows) + '\n')
    torch.manual_seed(41)
    net = create_network(CL_NET)
    ckpt_lib.save_checkpoint(os.path.join(root, 'model', 'gen'), 'gen', 2,
                             {'model_state_dict': net.state_dict()}, 0.0)


def test_two_rank_main_nll_clslsr_matches_one_rank(tmp_path):
    """``main_nll_clslsr`` over 2 ranks (windows sharded) writes the maps
    and the manifest of the one-rank run."""
    roots = {run: str(tmp_path / run) for run in ('one', 'two')}
    os.makedirs(roots['one'])
    _cl_workspace(roots['one'])
    shutil.copytree(roots['one'], roots['two'])
    cfgs = []
    for run, mesh in (('one', 1), ('two', 2)):
        path = cl_cfg(roots[run], 'cl.cfg')
        with open(path) as f:
            text = f.read()
        with open(path, 'w') as f:
            f.write(text.replace('sliding_window_stride = [8, 16, 16]',
                                 'sliding_window_stride = [8, 12, 12]')
                    .replace('cl_type = both', 'cl_type = both\n'
                             'mesh_devices = {0}'.format(mesh)))
        cfgs.append(path)
    _finish([_cli('nll_clslsr', 'test', cfg) for cfg in cfgs])
    rows = {}
    for run, root in roots.items():
        with open(os.path.join(root, 'train_clslsr.csv'), newline='') as f:
            rows[run] = list(csv.reader(f))
    assert rows['one'] == rows['two'] and len(rows['one']) == 4
    flagged = 0
    for c in range(3):
        name = os.path.join('slsr_conf', 'case{0}.nii.gz'.format(c))
        want = load_image_as_nd_array(os.path.join(roots['one'], name))
        got = load_image_as_nd_array(os.path.join(roots['two'], name))
        assert set(np.unique(want['data_array'])) <= {0, 255}
        np.testing.assert_array_equal(got['data_array'], want['data_array'])
        flagged += int((want['data_array'] > 0).sum())
    assert flagged > 0
    with open(os.path.join(roots['two'], 'model', 'gen',
                           'log_clslsr.txt')) as f:
        assert 'multihost: rank' not in f.read()   # rank 0's log alone
