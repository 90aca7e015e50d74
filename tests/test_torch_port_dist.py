"""PyTorch port, data parallelism over 2 gloo ranks on the CPU, against the
JAX package's mesh and the port's one-process runs.

The ranks are started by ``tests/torch_ranks.py`` (the steps and the
Inferer, all cases in one start) and ``tests/torch_cli.py`` (the CLI),
which import ``fpl_plus_torch`` only, through the port's own launcher.
Tiny UNet2D5_dsbn (feature_chns [4,8,8,8,8]) throughout.

* The joint step on 2 ranks (2 + 2 of a 4 + 4 global batch each, dropout
  0, ``train_fpl_uda`` DiceLoss, Adam, 2 steps) against
  ``fpl_plus_tpu.parallel.make_sharded_train_step`` on a 2-device mesh:
  ``tests/test_torch_port_train_step.py``'s f32 tolerances (loss and dice
  rtol 1e-4; gradients per tensor within 1e-3 of its max |g| plus 1e-5 of
  the network's; parameters after Adam within 0.5 x the rate where the
  gradient is well above its tolerance and 4 x the rate elsewhere; the
  running statistics rtol 1e-4).
* With dropout, and for accumulation, the alternating, dual-consistency
  and discriminator steps: 2 ranks against the port's one-process step on
  the same batch and generators (the same masks: each rank keeps its rows
  of the global draw), to the same tolerances.
* The sharded Inferer (window, volume and pass sharding; TTA, overlapping
  windows) against JAX's ``Inferer(mesh=make_mesh(2))`` at dropout 0:
  logits atol 1e-4 and labels equal, as ``tests/test_mesh_product.py``
  holds JAX; with dropout, the sharded passes against the one-process
  fold: the same masks, logits atol 1e-5.
* ``cli train`` -> auto test -> ``eva_main`` at 1 and 2 ranks: case dice
  within 0.02, the same artifacts, one writer; a two-host ``FPLX_*`` test
  stage (each host pinned to one core, so each is one rank) voxel-identical
  to the one-process labels; a global batch that does not divide over the
  ranks fails the run.
"""
import csv
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_port_models import one_torch_thread  # noqa: F401
from tests.test_torch_port_train_step import (CROP, LR, TINY, TRAIN_CFG,
                                              _port_names, check_grads,
                                              check_params, jax_step,  # noqa
                                              run_jax, tiny_variables)
from tests.torch_ranks import run_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DROPOUT = [0.3, 0.3, 0.3, 0.3, 0.5]
SW = {'sliding_window_enable': True, 'sliding_window_size': [8, 16, 16],
      'sliding_window_stride': [6, 12, 12], 'tta_mode': 1, 'patch_chunk': 2}
MARGINS = ([1, 2, 2], [1, 3, 2])
STEP_CASES = ('dropout', 'accum', 'alternating', 'dual_consistency', 'dis')


def _env():
    env = dict(os.environ, PYTHONPATH=ROOT)
    for key in ('FPLX_COORDINATOR', 'FPLX_NUM_PROCESSES', 'FPLX_PROCESS_ID'):
        env.pop(key, None)
    return env


def _domain_batch(rs, n, crop, d, image1):
    x = rs.normal(size=(n, 1) + crop).astype(np.float32) + d
    y = (x[:, 0] > 0.8).astype(np.int64)
    batch = {'image': x,
             'label_prob': np.moveaxis(np.eye(2, dtype=np.float32)[y], -1, 1),
             'pixel_weight': ((rs.uniform(size=(n, 1) + crop) > 0.2)
                              * 0.8).astype(np.float32),
             'image_weight': rs.uniform(0.5, 1.0, n).astype(np.float32)}
    if image1:
        batch['image1'] = (x + 0.3 * rs.normal(size=x.shape)).astype(
            np.float32)
    return batch


def _batches(seed, n=4, steps=2, crop=CROP, image1=False, accum=1):
    """Per-step tuples of per-domain global batches (``accum``: lists of
    microbatches)."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        doms = []
        for d in range(2):
            micro = [_domain_batch(rs, n, crop, d, image1)
                     for _ in range(accum)]
            doms.append(micro if accum > 1 else micro[0])
        out.append(tuple(doms))
    return out


def _state(net_cfg, seed):
    params, stats = tiny_variables(seed, net_cfg)
    return params, stats, _port_names(params, stats)


def _infer_case(net_cfg, seed):
    params, stats, state = _state(net_cfg, seed)
    rs = np.random.RandomState(seed)
    return {'kind': 'infer', 'net': net_cfg, 'state': state, 'testing': SW,
            'volume': rs.normal(size=(1, 1, 12, 28, 40)).astype(np.float32),
            'volumes': rs.normal(size=(3, 1, 12, 28, 40)).astype(np.float32),
            'passes': 6, 'pass_seeds': list(range(40, 46)),
            'margins': MARGINS, 'jax': (params, stats)}


@pytest.fixture(scope='module')
def cases():
    """Every case, and the ranks' results of them from one start of 2
    gloo ranks."""
    cases = {}
    params, stats, state = _state(TINY, 3)
    cases['jax'] = {'kind': 'joint', 'net': TINY, 'state': state,
                    'train': TRAIN_CFG, 'batches': _batches(8),
                    'seeds': None, 'fpl_uda': True, 'jax': (params, stats)}
    drop = dict(TINY, dropout=DROPOUT)
    _, _, dstate = _state(drop, 5)
    base = {'net': drop, 'state': dstate, 'train': TRAIN_CFG,
            'fpl_uda': True}
    cases['dropout'] = dict(base, kind='joint', batches=_batches(11),
                            seeds=[[20, 21], [22, 23]])
    cases['accum'] = dict(base, kind='joint', batches=_batches(12, accum=2),
                          seeds=None, accum=2)
    cases['alternating'] = dict(base, kind='alternating',
                                batches=_batches(13), seeds=[[30, 31]] * 2)
    cases['dual_consistency'] = dict(
        base, kind='dual_consistency', batches=_batches(14, image1=True),
        seeds=[[32, 33, 34], [35, 36, 37]])
    cases['dis'] = dict(base, kind='dis', fpl_uda=False,
                        batches=_batches(15, n=2, steps=1, crop=(24, 32, 32)),
                        seeds=[[38, 39]])
    cases['infer_jax'] = _infer_case(TINY, 6)
    cases['infer_dropout'] = _infer_case(drop, 7)
    return cases


@pytest.fixture(scope='module')
def ranks(cases, tmp_path_factory):
    work = tmp_path_factory.mktemp('ranks')
    names = list(cases)
    torch.save([{k: v for k, v in cases[n].items() if k != 'jax'}
                for n in names], str(work / 'cases.pt'))
    proc = subprocess.run([sys.executable, os.path.join(ROOT, 'tests',
                                                        'torch_ranks.py'),
                           str(work), '2'], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    results = torch.load(str(work / 'results.pt'), weights_only=False)
    return dict(zip(names, results))


def _check_metrics(got, want, rtol=1e-4, atol=0.0):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_allclose(np.asarray(g[key]), np.asarray(w[key]),
                                       rtol=rtol, atol=atol, err_msg=key)


def test_two_rank_joint_step_matches_jax_sharded_step(jax_step, cases,
                                                      ranks):
    """2 ranks against the JAX package's sharded step on a 2-device mesh,
    from the same weights on the same global batches: loss, dice, the
    first step's global gradient, the parameters and both banks' running
    statistics after two Adam steps."""
    from fpl_plus_tpu.parallel import make_mesh, make_sharded_train_step
    module, optimizer, step = jax_step
    case, got = cases['jax'], ranks['jax']
    params, stats = case['jax']
    sharded = make_sharded_train_step(step, make_mesh(2),
                                      optimizer_name='Adam')
    ref_metrics, ref_grads, (ref_params, ref_stats) = run_jax(
        (module, optimizer, sharded), params, stats, case['batches'])
    keys = ('loss', 'class_dice_0', 'class_dice_1')
    _check_metrics([{k: m[k] for k in keys} for m in got['metrics']],
                   [{k: np.asarray(m[k]) for k in keys} for m in ref_metrics])
    check_grads(ref_grads, stats, got['grads'])
    check_params(ref_params, ref_stats, ref_grads, got['state'])
    assert {int(v) for k, v in got['state'].items()
            if k.endswith('num_batches_tracked')} == {2}


def _check_state(got, want, grads, lr=LR):
    """Adam-aware parameter check (``check_params``' rule) of two port
    state dicts, ``grads`` the reference's first gradients."""
    top = max(float(g.abs().max()) for g in grads.values())
    for name, w in want.items():
        g = got[name]
        if name.endswith('num_batches_tracked'):
            assert int(g) == int(w), name
            continue
        if name.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(
                g.numpy(), w.numpy(), rtol=1e-4,
                atol=1e-6 if name.endswith('var') else 0.4 * lr,
                err_msg=name)
            continue
        err = (g - w).abs().numpy()
        if name.startswith('dis.'):   # its Adam runs at 1e-4
            assert err.max() <= 4 * 1e-4, name
            continue
        mag = grads[name].abs().numpy()
        signal = mag > 10 * (1e-3 * mag.max() + 1e-5 * top)
        assert err[signal].max(initial=0) <= 0.5 * lr, name
        assert err.max() <= 4 * lr, name


@pytest.mark.parametrize('name', STEP_CASES)
def test_two_rank_step_matches_one_process(one_torch_thread, cases, ranks,  # noqa
                                           name):
    """The 2-rank step against the one-process step on the same global
    batch and generators: dropout draws the one-process masks,
    accumulation sums the microbatches' gradients, the alternating and
    dual-consistency steps update twice, the discriminator averages its
    row shares."""
    want = run_case(cases[name], None)
    got = ranks[name]
    # before any update the two agree to rounding; after one, parameters
    # are an Adam update apart, so the loss moves by ~1e-4 and the argmax
    # dice by a few voxels' flips (~1e-4 each at these crops)
    single = cases[name]['kind'] in ('joint', 'dis')
    _check_metrics(got['metrics'][:1], want['metrics'][:1],
                   rtol=1e-4 if single else 1e-3, atol=1e-6 if single
                   else 2e-3)
    _check_metrics(got['metrics'][1:], want['metrics'][1:], rtol=1e-3,
                   atol=2e-3)
    top = max(float(g.abs().max()) for g in want['grads'].values())
    # the dual-consistency step's recorded gradient is its second update's,
    # at parameters one Adam update apart (module docstring)
    rel = 1e-2 if name == 'dual_consistency' else 1e-3
    for key, g in want['grads'].items():
        tol = rel * float(g.abs().max()) + 1e-5 * top
        assert float((got['grads'][key] - g).abs().max()) <= tol, key
    _check_state(got['state'], want['state'], want['grads'])


def test_two_rank_inferer_matches_jax_mesh_inferer(cases, ranks):
    """Window sharding (``run``), volume sharding (``run_batch``) and pass
    sharding (``run_passes``, ``run_fpl_uncertainty``) against JAX's mesh
    Inferer (window-sharded ``run``, one program for every volume) on the
    same weights, at dropout 0, where every pass is the plain inference."""
    import jax.numpy as jnp
    from fpl_plus_tpu.engine.infer import Inferer as JaxInferer
    from fpl_plus_tpu.models.registry import create_network as jax_network
    from fpl_plus_tpu.parallel import make_mesh
    from fpl_plus_torch.engine.infer import fpl_uncertainty_reduce
    case, got = cases['infer_jax'], ranks['infer_jax']
    module = jax_network(case['net'])
    params, stats = case['jax']
    variables = {'params': params, 'batch_stats': stats}

    def predictor(ctx, x):
        return module.apply(ctx, x, jnp.int32(1), False)

    inferer = JaxInferer(dict(SW, class_num=2, output_mode='logits',
                              infer_shape_bucket=0), mesh=make_mesh(2))
    want = np.asarray(inferer.run(predictor, variables, case['volume']))
    np.testing.assert_allclose(got['run'], want, atol=1e-4)
    np.testing.assert_array_equal(got['run_label'], np.argmax(want, 1))
    for i in range(len(case['volumes'])):
        vol = np.asarray(inferer.run(predictor, variables,
                                     case['volumes'][i:i + 1]))
        np.testing.assert_array_equal(got['run_batch'][i],
                                      np.argmax(vol[0], 0))
    for i in range(case['passes']):
        np.testing.assert_allclose(got['passes'][i], want[0], atol=1e-4)
    vars_sum, boundary = fpl_uncertainty_reduce(
        torch.from_numpy(np.repeat(want, case['passes'], 0)), *MARGINS)
    assert got['fpl'][1] == int(boundary)
    np.testing.assert_allclose(got['fpl'][0], float(vars_sum), atol=1e-6)


def test_sharded_sliding_window_sums_every_window_once(one_torch_thread,  # noqa
                                                      cases, ranks):
    """``parallel.sharded_sliding_window`` over 2 ranks (12 windows in
    chunks of 2, no TTA): the merged output over the merged counter is the
    one-process Inferer's overlap-averaged logits, and the counter counts
    every window once."""
    from fpl_plus_torch.engine.infer import Inferer, window_grid
    case = cases['infer_jax']
    out, cnt = ranks['infer_jax']['sliding_window']
    starts = window_grid(case['volume'].shape[2:], SW['sliding_window_size'],
                         SW['sliding_window_stride'])
    assert float(cnt.sum()) == len(starts) * np.prod(
        SW['sliding_window_size'])
    from tests.torch_ranks import _network
    net = _network(case).eval()
    with torch.no_grad():
        want = Inferer(dict(SW, tta_mode=0, output_mode='logits'), 'cpu').run(
            lambda x: net(x, 1), case['volume'])
    np.testing.assert_allclose(out / cnt, want, atol=1e-5)


def test_two_rank_dropout_passes_match_one_process(one_torch_thread,  # noqa
                                                   cases, ranks):
    """With dropout, each rank makes its passes from their seeds: the
    gathered passes are the one-process fold's, and so is the reduction
    (6 passes: 3 per rank)."""
    want = run_case(cases['infer_dropout'], None)
    got = ranks['infer_dropout']
    assert float(np.var(want['passes'], 0).max()) > 1e-6   # passes differ
    np.testing.assert_allclose(got['passes'], want['passes'], atol=1e-5)
    np.testing.assert_allclose(got['run'], want['run'], atol=1e-5)
    np.testing.assert_array_equal(got['run_batch'], want['run_batch'])
    assert got['fpl'][1] == want['fpl'][1]
    np.testing.assert_allclose(got['fpl'][0], want['fpl'][0], rtol=1e-4)


# -- the CLI ------------------------------------------------------------------
CLI_EVAL = """
[evaluation]
metric_1 = dice
label_list = [1]
organ_name = cube
ground_truth_folder_root = {root}
test_evaluation_image_pair = {root}/pairs.csv
"""


def _cli_cfg(root, run, mesh, batch=4, extra=''):
    from tests.test_torch_port_train_step import CLI_CFG
    text = CLI_CFG.format(root=root, extra=(
        'mesh_devices = {0}\n{1}'.format(mesh, extra)))
    for old, new in (('model/gen', 'model/' + run),
                     ('train_batch_size = 2',
                      'train_batch_size = {0}'.format(batch)),
                     ('learning_rate = 1e-3', 'learning_rate = 1e-2'),
                     ('iter_max = 2', 'iter_max = 10'),
                     ('iter_valid = 2', 'iter_valid = 5'),
                     ('iter_save = 2', 'iter_save = 5'),
                     ('lr_milestones = [1]', 'lr_milestones = [8]'),
                     ('output_dir = {0}/result'.format(root),
                      'output_dir = {0}/result_{1}'.format(root, run))):
        assert old in text
        text = text.replace(old, new)
    path = os.path.join(root, run + '.cfg')
    with open(path, 'w') as f:
        f.write(text + CLI_EVAL.format(root=root))
    return path


def _cli(stage, cfg, env=None, preexec_fn=None):
    return subprocess.Popen(
        [sys.executable, os.path.join(ROOT, 'tests', 'torch_cli.py'), stage,
         cfg], cwd=ROOT, env=env or _env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, preexec_fn=preexec_fn)


def _finish(procs, timeout=600):
    outs = [p.communicate(timeout=timeout) for p in procs]
    return [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]


def _dice(root, run):
    path = os.path.join(root, 'result_' + run, run + '_d1_test',
                        'test_cube_dice_all.csv')
    with open(path, newline='') as f:
        return {r[0]: float(r[1]) for r in list(csv.reader(f))[1:]}


def _labels(root, run):
    from fpl_plus_torch.io.image_io import load_image_as_nd_array
    out = os.path.join(root, 'result_' + run, 'one_d1_test')
    return {name: load_image_as_nd_array(os.path.join(out, name))[
        'data_array'] for name in sorted(os.listdir(out))
        if name.endswith('.nii.gz')}


@pytest.fixture(scope='module')
def cli_runs(tmp_path_factory):
    """``cli train`` (-> auto test -> ``eva_main``) at 1 rank and at 2
    ranks (whose train loaders each start a worker pool inside the rank),
    run side by side."""
    from tests.test_torch_port_train_units import write_train_domain
    root = str(tmp_path_factory.mktemp('cli'))
    rs = np.random.RandomState(7)
    for d in (0, 1):
        write_train_domain(root, d, rs)
    with open(os.path.join(root, 'pairs.csv'), 'w') as f:
        f.write('ground_truth,segmentation\n' + ''.join(
            'd1/lab{0}.nii.gz,img{0}.nii.gz\n'.format(c) for c in range(3)))
    runs = {'one': 1, 'two': 2}
    cfgs = [_cli_cfg(root, run, mesh) for run, mesh in runs.items()]
    # the 2-rank run's loaders use worker pools, started inside the ranks
    with open(cfgs[1]) as f:
        text = f.read()
    with open(cfgs[1], 'w') as f:
        f.write(text.replace('num_workder = 0', 'num_workder = 1'))
    done = _finish([_cli('train', cfg) for cfg in cfgs])
    for (rc, out, err), run in zip(done, runs):
        assert rc == 0, (run, out[-2000:], err[-4000:])
    return root


def test_two_rank_cli_matches_one_rank(cli_runs):
    """Case dice within 0.02 of the 1-rank run, the same files in the
    checkpoint directory, every scalar row written once, and the
    checkpoints' parameters close (the same batches: each rank kept its
    rows of the one-card batch)."""
    root = cli_runs
    one, two = _dice(root, 'one'), _dice(root, 'two')
    assert one.keys() == two.keys()
    for name in one:
        assert abs(one[name] - two[name]) < 0.02, (name, one[name],
                                                   two[name])
    files = {run: sorted(f.replace(run, '*') for f in os.listdir(
        os.path.join(root, 'model', run))) for run in ('one', 'two')}
    assert files['one'] == files['two']
    for run in ('one', 'two'):
        with open(os.path.join(root, 'model', run, 'scalars.jsonl')) as f:
            tags = [(r['tag'], r['step']) for r in map(json.loads, f)]
        assert tags and len(tags) == len(set(tags)), run
    ckpt = {run: torch.load(os.path.join(root, 'model', run,
                                         '{0}_5.pt'.format(run)),
                            weights_only=False)['model_state_dict']
            for run in ('one', 'two')}
    for key, want in ckpt['one'].items():
        if key.endswith('num_batches_tracked'):
            assert int(ckpt['two'][key]) == int(want) == 5
            continue
        # 5 Adam updates at 1e-2, each off by a sign flip at most where the
        # gradient is at its noise level
        assert float((ckpt['two'][key] - want).abs().max()) <= 5 * 2e-2, key


def test_two_host_test_stage_matches_one_process(cli_runs):
    """Two ``FPLX_*`` hosts, each pinned to one core and so one rank, run
    the test stage of the 1-rank run's checkpoint: the labels the primary
    host wrote equal the one-process labels voxel for voxel."""
    from fpl_plus_torch.parallel.multihost import free_local_port
    root = cli_runs
    cfg = os.path.join(root, 'hosts.cfg')
    with open(os.path.join(root, 'one.cfg')) as f:
        text = f.read().replace('mesh_devices = 1', 'mesh_devices = -1')
    with open(cfg, 'w') as f:
        f.write(text.replace('result_one', 'result_hosts'))
    port = free_local_port()
    cores = sorted(os.sched_getaffinity(0))
    procs = []
    for host in (0, 1):
        env = dict(_env(), FPLX_COORDINATOR='localhost:{0}'.format(port),
                   FPLX_NUM_PROCESSES='2', FPLX_PROCESS_ID=str(host))
        core = {cores[host % len(cores)]}
        procs.append(_cli('test', cfg, env,
                          lambda core=core: os.sched_setaffinity(0, core)))
    for rc, out, err in _finish(procs):
        assert rc == 0, (out[-2000:], err[-4000:])
        assert 'multihost: rank' in out
    single, hosts = _labels(root, 'one'), _labels(root, 'hosts')
    assert single.keys() == hosts.keys() and len(single) == 3
    for name in single:
        np.testing.assert_array_equal(hosts[name], single[name])


def test_indivisible_global_batch_fails_the_run(tmp_path):
    """``train_batch_size = 3`` over 2 ranks: each rank raises the JAX
    package's error and the CLI exits non-zero instead of hanging."""
    from tests.test_torch_port_train_units import write_train_domain
    root = str(tmp_path)
    rs = np.random.RandomState(3)
    for d in (0, 1):
        write_train_domain(root, d, rs)
    (rc, out, err), = _finish([_cli('train', _cli_cfg(root, 'odd', 2,
                                                      batch=3))])
    assert rc != 0
    assert 'train_batch_size 3 must be divisible by the 2-device mesh' in err
