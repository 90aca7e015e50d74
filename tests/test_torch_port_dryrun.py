"""PyTorch port, the driver entry points (``fpl_plus_torch/dryrun.py``)
against the JAX package's ``__graft_entry__.py`` and ``run.sh``.

* One dry run of the four-stage FPL+ pipeline at the JAX dry run's shapes
  (``_pipeline``: tiny UNet2D5_dsbn, 2 cases of 12x24x24 per domain), every
  stage through ``fpl_plus_torch.cli`` over 2 gloo ranks on the CPU
  (``tests/torch_cli.py dryrun``, so that the ranks block TensorBoard): the
  artifacts the JAX dry run asserts, stage by stage.
* Stage 3 on those stage-2 artifacts through the JAX package's own
  ``compute_pixel_weights`` and ``write_image_weight_csv`` (numpy, no
  compile): the same pixel-weight arrays and geometry, read back, and the
  same CSV text as the port's stage 3 (not the ``.nii.gz`` bytes: gzip
  stamps a time in its header).
* ``entry(device='cpu')``: the output shape and the parameter count of the
  JAX flagship (``__graft_entry__.py:36-41``), taken from ``jax.eval_shape``
  of the JAX module's ``init`` and ``apply`` (no weights initialised).
* ``dryrun_multichip`` raises where it cannot run: without a card unless
  ``device='cpu'``, and for more ranks than devices.
* ``fpl_plus_torch/run.sh`` has ``run.sh``'s commands in order on the
  port's modules, and every ``fpl`` command's flags parse with the port's
  parser.
"""
import json
import os
import shlex
import subprocess
import sys

import numpy as np
import pytest
import torch

from fpl_plus_torch import dryrun
from fpl_plus_torch.io.image_io import load_image_as_nd_array

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 2
NAMES = ['case0.nii.gz', 'case1.nii.gz']


def _env():
    env = dict(os.environ, PYTHONPATH=ROOT)
    for key in ('FPLX_COORDINATOR', 'FPLX_NUM_PROCESSES', 'FPLX_PROCESS_ID'):
        env.pop(key, None)
    return env


@pytest.fixture(scope='module')
def pipeline(tmp_path_factory):
    """The dry run's four stages over 2 gloo ranks; returns the workspace
    root, the stage walls and the run's standard output."""
    root = str(tmp_path_factory.mktemp('dryrun'))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, 'tests', 'torch_cli.py'),
         'dryrun', root, str(RANKS)], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-4000:])
    walls = json.loads(proc.stdout.strip().splitlines()[-1])
    return root, walls, proc.stdout


def _niftis(path):
    return sorted(n for n in os.listdir(path) if n.endswith('.nii.gz'))


def test_pipeline_writes_every_stage_artifact(pipeline):
    """JAX's assertions (``__graft_entry__.py:222-280``), each stage run
    over 2 gloo ranks."""
    root, walls, out = pipeline
    assert sorted(walls) == ['1', '2', '3', '4']
    assert out.count('multihost: rank 1/2') == 4    # 4 CLI runs, 2 ranks
    ckpt = os.path.join(root, 'model', 'dryrun')
    # stage 1: the best pointer, the target set's labels, the evaluation
    assert os.path.isfile(os.path.join(ckpt, 'dryrun_best.txt'))
    target = os.path.join(root, 'result', 'dryrun_d1_train_img')
    assert _niftis(target) == NAMES
    assert os.path.isfile(os.path.join(target, 'test_tumor_dice_all.csv'))
    # stage 2: the fake-source labels and two uncertainty entries
    assert _niftis(os.path.join(root, 'result',
                                'dryrun_d1cyc_train_img')) == NAMES
    entries = np.load(os.path.join(root, 'unc_sorted.npy'),
                      allow_pickle=True)
    assert len(entries) == 2
    assert sorted(os.path.basename(str(e[1])) for e in entries) == NAMES
    # stage 3: two pixel-weight maps and two weighted rows
    assert _niftis(os.path.join(root, 'weights', 'pixel')) == NAMES
    with open(os.path.join(root, 'd1_train_weighted.csv')) as f:
        lines = f.read().splitlines()
    assert lines[0] == 'image,label,pixel_weight,image_weight'
    assert len(lines) == 3
    # stage 4: the resume's checkpoint, the final label and its evaluation
    assert os.path.isfile(os.path.join(ckpt, 'dryrun_4.pt'))
    assert int(torch.load(os.path.join(ckpt, 'dryrun_4.pt'),
                          weights_only=False)['iteration']) == 4
    final = os.path.join(root, 'result', 'dryrun_final_test')
    assert _niftis(final) == ['case1.nii.gz']
    with open(os.path.join(final, 'test_tumor_dice_all.csv')) as f:
        rows = f.read().splitlines()
    assert rows[1].startswith('case1.nii.gz')


def test_stage3_matches_jax_weight_functions(pipeline, tmp_path):
    """The JAX package's stage 3 on the port's stage-2 artifacts writes
    what the port's stage 3 wrote."""
    from fpl_plus_tpu.fpl.weights import (compute_pixel_weights,
                                          write_image_weight_csv)
    root = pipeline[0]
    target = os.path.join(root, 'result', 'dryrun_d1_train_img')
    fake = os.path.join(root, 'result', 'dryrun_d1cyc_train_img')
    jax_pw = str(tmp_path / 'pixel')
    assert len(compute_pixel_weights(target, fake, jax_pw)) == 2
    for name in NAMES:
        got = load_image_as_nd_array(os.path.join(root, 'weights', 'pixel',
                                                  name))
        want = load_image_as_nd_array(os.path.join(jax_pw, name))
        assert got['data_array'].dtype == want['data_array'].dtype
        np.testing.assert_array_equal(got['data_array'], want['data_array'])
        for key in ('origin', 'spacing', 'direction'):
            assert got[key] == want[key], key
    jax_csv = str(tmp_path / 'weighted.csv')
    assert write_image_weight_csv(
        os.path.join(root, 'unc_sorted.npy'), jax_csv, image_dir='',
        pseudo_label_dir='result/dryrun_d1_train_img',
        pixel_weight_dir='weights/pixel') == 2
    with open(jax_csv) as f, open(os.path.join(
            root, 'd1_train_weighted.csv')) as g:
        assert g.read() == f.read()


def test_entry_matches_the_jax_flagship():
    """The port's flagship forward: JAX's output shape (channels last
    there) and parameter count, 22,140,628."""
    import jax
    import jax.numpy as jnp
    from fpl_plus_tpu.models.registry import create_network
    net_cfg = {'net_type': 'UNet2D5_dsbn', 'num_domains': 2, 'class_num': 2,
               'in_chns': 1, 'feature_chns': [32, 64, 128, 256, 512],
               'conv_dims': [2, 2, 3, 3, 3],
               'dropout': [0.0, 0.0, 0.3, 0.4, 0.5], 'bilinear': False}
    assert dryrun.NET_CFG == net_cfg
    module = create_network(net_cfg)
    rngs = {'params': jax.random.PRNGKey(0),
            'dropout': jax.random.PRNGKey(1)}
    x_jax = jax.ShapeDtypeStruct((1, 28, 128, 128, 1), jnp.float32)
    variables = jax.eval_shape(lambda x: module.init(rngs, x, 0, True),
                               x_jax)
    want = jax.eval_shape(lambda v, x: module.apply(v, x, 1, False),
                          variables, x_jax)
    jax_params = sum(int(np.prod(p.shape)) for p in
                     jax.tree_util.tree_leaves(variables['params']))

    fn, (x, domain) = dryrun.entry(device='cpu')
    assert tuple(x.shape) == (1, 1, 28, 128, 128) and domain == 1
    assert not fn.module.training
    got = fn(x, domain)
    assert want.shape == (1, 28, 128, 128, 2)
    assert tuple(got.shape) == (1, 2, 28, 128, 128)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    port_params = sum(p.numel() for p in fn.module.parameters())
    assert port_params == jax_params == 22140628


@pytest.mark.parametrize('kwargs', [{}, {'device': 'cpu', 'more': True}],
                         ids=['no-card', 'too-many-ranks'])
def test_dryrun_multichip_refuses_what_it_cannot_run(kwargs):
    """Without a card (this host) the default device raises; on the CPU a
    mesh wider than the cores raises instead of clamping."""
    n = RANKS
    if kwargs.pop('more', False):
        n = len(os.sched_getaffinity(0)) + 1
    with pytest.raises(RuntimeError):
        dryrun.dryrun_multichip(n, **kwargs)


def _commands(path):
    """The script's commands (continuation lines joined) and the stage
    comments, in order."""
    with open(path) as f:
        text = f.read().replace('\\\n', ' ')
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    stages = [ln for ln in lines if ln.startswith('# Stage')]
    return stages, [shlex.split(ln) for ln in lines
                    if not ln.startswith('#')]


def test_run_sh_mirrors_the_jax_pipeline():
    from fpl_plus_torch.fpl.__main__ import build_parser
    jax_stages, jax_cmds = _commands(os.path.join(ROOT, 'run.sh'))
    stages, cmds = _commands(os.path.join(ROOT, 'fpl_plus_torch', 'run.sh'))
    assert stages == jax_stages and len(stages) == 4
    assert cmds == [[a.replace('fpl_plus_tpu', 'fpl_plus_torch')
                     for a in c] for c in jax_cmds]
    assert [c[2] for c in cmds] == (['fpl_plus_torch.cli'] * 3
                                    + ['fpl_plus_torch.fpl'] * 2
                                    + ['fpl_plus_torch.cli'])
    parser = build_parser()
    for c in cmds:
        if c[2] == 'fpl_plus_torch.fpl':
            args = parser.parse_args(c[3:])
            assert args.cmd == c[3]
    assert os.access(os.path.join(ROOT, 'fpl_plus_torch', 'run.sh'),
                     os.X_OK)
