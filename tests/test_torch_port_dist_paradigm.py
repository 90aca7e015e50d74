"""PyTorch port, the SSL, WSL and NLL steps over 2 gloo ranks on the CPU,
against the port's one-process steps and the JAX package's sharded steps.

All 15 methods (SSL 6, WSL 6, NLL 3) run two steps at 2 ranks, started
once for every case by ``tests/torch_ranks.py`` (``'paradigm'`` cases),
against the same steps in one process on the same global batch and
generators, with the network's dropout, the teacher's input noise and
CCT's and URPC's train-mode draws on: each rank keeps its rows of the
one-card draws, the two streams of a forward (SSL's labelled and
unlabelled rows, DAST's clean and noisy rows) as segments of unequal
sizes. The tiny nets of ``tests/test_torch_port_ssl.py`` (UNet2D widths
[2,4,8,8], its CCT and URPC variants, BiNet and TriNet peers) fold a
depth of 2 into the batch, 16x16 slices. Each rank skews its own host
values (USTM's rotation, DMPLS's ``beta``): the step must take rank 0's.
Tolerances are ``tests/test_torch_port_dist.py``'s
(``test_two_rank_step_matches_one_process``): the first step's metrics
rtol 1e-4, the second's rtol 1e-3 / atol 2e-3 (one Adam update apart);
the first gradients within 1e-3 of each tensor's max plus 1e-5 of the
network's; the parameters Adam-aware. The ranks' parameters, EMA teachers,
small-loss masks and DAST gates are identical; the masks are the
one-process masks but where a voxel's CE sits within rounding of the keep
cutoff, the gates the one-process gates.

MeanTeacher, CoTeaching and GatedCRF: the 2 ranks' one step against the
JAX agents' steps wrapped by ``fpl_plus_tpu.parallel.make_sharded_train_step``
on a 2-device mesh (dropout 0, the teacher's noise zeroed on both sides),
by ``tests/test_torch_port_ssl.py``'s tolerances. JAX's DAST step cannot
be wrapped: it reads its scores on the host inside the outer jit.
"""
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpl_plus_torch.agents import ssl as port_ssl
from fpl_plus_torch.models.common import grouped_dropout
from fpl_plus_torch.models.multi_net import MultiNet
from fpl_plus_torch.models.registry import create_network
from fpl_plus_torch.parallel.mesh import Mesh, batch_segments, data_parallel
from tests.test_torch_port_dist import (ROOT, _check_metrics, _check_state,
                                        _env)
from tests.test_torch_port_models import one_torch_thread  # noqa: F401
from tests.test_torch_port_ssl import (LR, check_params, check_step,
                                       check_teacher, cl, images,
                                       no_noise,  # noqa: F401 (fixture)
                                       paradigm_config, run_jax,
                                       variables_and_port)
from tests.torch_ranks import run_case

SECTION = {'ssl': 'semi_supervised_learning',
           'wsl': 'weakly_supervised_learning',
           'nll': 'noisy_label_learning'}
DROPOUT = [0.05, 0.1, 0.2, 0.3]
DEPTH = 2                 # folded into the batch by the 2D nets
ITS = (5, 6)
# (paradigm, method): net_type, peers, the paradigm section's extra keys
METHODS = {
    ('ssl', 'EntropyMinimization'): ('UNet2D', 1, {}),
    ('ssl', 'MeanTeacher'): ('UNet2D', 1, {'ema_decay': 0.9}),
    ('ssl', 'UAMT'): ('UNet2D', 1, {'uamt_mcdroput_n': 2,
                                    'ema_decay': 0.9}),
    ('ssl', 'CCT'): ('UNet2D_CCT', 1, {}),
    ('ssl', 'CPS'): ('UNet2D', 2, {}),
    ('ssl', 'URPC'): ('UNet2D_URPC', 1, {}),
    ('wsl', 'EntropyMinimization'): ('UNet2D', 1, {}),
    ('wsl', 'TotalVariation'): ('UNet2D', 1, {}),
    ('wsl', 'MumfordShah'): ('UNet2D', 1, {'mumfordshahloss_lambda': 0.5}),
    ('wsl', 'GatedCRF'): ('UNet2D', 1, {'gatedcrfloss_radius': 2}),
    ('wsl', 'USTM'): ('UNet2D', 1, {'ustm_mcdroput_n': 2,
                                    'ema_decay': 0.9}),
    ('wsl', 'DMPLS'): ('UNet2D', 2, {}),
    ('nll', 'CoTeaching'): ('UNet2D', 2, {}),
    ('nll', 'TriNet'): ('UNet2D', 3, {}),
    ('nll', 'DAST'): ('UNet2D', 2, {}),
}
NLL = {'co_teaching_select_ratio': 0.8, 'dast_rank_length': 2,
       'dast_select_ratio': 0.5, 'dast_dbc_w': 0.1, 'dast_st_w': 0.1}
DAST_ITS = (0, 1, 2, 3)   # the queues of length 2 gate from the third step
NAMES = ['{0}-{1}'.format(*k) for k in METHODS]
JAX_CASES = {'jax-MeanTeacher': ('ssl', 'MeanTeacher'),
             'jax-CoTeaching': ('nll', 'CoTeaching'),
             'jax-GatedCRF': ('wsl', 'GatedCRF')}


def volumes(rs, n):
    """``n`` images ``[n, 1, DEPTH, 16, 16]`` and their one-hot labels."""
    x = rs.normal(size=(n, 1, DEPTH, 16, 16)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int64)
    return x, np.moveaxis(np.eye(2, dtype=np.float32)[y], -1, 1)


def step_batch(rs, paradigm, method):
    """One step's global batch: SSL 2 labelled + 4 unlabelled rows, DAST
    2 clean + 4 noisy (a flipped corner), the rest 4 rows; WSL with a
    scribble ``pixel_weight`` (USTM's rotation last in the tuple)."""
    if paradigm == 'ssl':
        x0, y0 = volumes(rs, 2)
        return {'lab': {'image': x0, 'label_prob': y0},
                'unlab': {'image': volumes(rs, 4)[0]}}
    if method == 'DAST':
        xc, yc = volumes(rs, 2)
        xn, yn = volumes(rs, 4)
        yn[..., :6, :6] = yn[:, ::-1, :, :6, :6]
        return {'clean': {'image': xc, 'label_prob': yc},
                'noise': {'image': xn, 'label_prob': yn.copy()}}
    x, y = volumes(rs, 4)
    batch = {'image': x, 'label_prob': y}
    if paradigm == 'wsl':
        batch['pixel_weight'] = (rs.uniform(size=(4, 1, DEPTH, 16, 16))
                                 > 0.6).astype(np.float32)
    if method == 'USTM':
        return (batch, int(rs.randint(0, 4)))
    return (batch,)


def paradigm_case(paradigm, method, seed):
    net_type, peers, extra = METHODS[(paradigm, method)]
    sec = dict(NLL, **extra) if paradigm == 'nll' else extra
    cfg = paradigm_config(SECTION[paradigm], {'net_type': net_type,
                                              'dropout': DROPOUT}, sec)
    torch.manual_seed(seed)
    net = (create_network(cfg['network']) if peers == 1
           else MultiNet(cfg['network'], peers))
    rs = np.random.RandomState(seed)
    its = DAST_ITS if method == 'DAST' else ITS
    case = {'kind': 'paradigm', 'paradigm': paradigm, 'method': method,
            'config': cfg, 'peers': peers, 'state': net.state_dict(),
            'its': its,
            'batches': [step_batch(rs, paradigm, method) for _ in its]}
    if method == 'DMPLS':
        case['hyper'] = [{'beta': 0.3}, {'beta': 0.7}]
    return case


def jax_case(paradigm, method, seed):
    """A one-step case at dropout 0 on 2D images (4 rows; MeanTeacher 2 +
    2), the teacher's noise zeroed, with the JAX variables it starts
    from."""
    extra = {'gatedcrfloss_radius': 2} if method == 'GatedCRF' else {}
    if paradigm == 'nll':
        extra = NLL
    cfg = paradigm_config(SECTION[paradigm], None, extra)
    peers = 2 if method == 'CoTeaching' else 1
    rs = np.random.RandomState(seed)
    x, y = images(rs, n=2 if paradigm == 'ssl' else 4)
    if paradigm == 'ssl':
        batch = {'lab': {'image': x, 'label_prob': y},
                 'unlab': {'image': images(rs, n=2)[0]}}
        x_init = np.concatenate([x, batch['unlab']['image']])
    else:
        batch = ({'image': x, 'label_prob': y},)
        if paradigm == 'wsl':
            batch[0]['pixel_weight'] = (rs.uniform(size=(4, 1, 16, 16))
                                        > 0.6).astype(np.float32)
        x_init = x
    module, params, stats, to_port = variables_and_port(
        cfg, peers == 2, cl(x_init), seed=seed + 1)
    return {'kind': 'paradigm', 'paradigm': paradigm, 'method': method,
            'config': cfg, 'peers': peers, 'state': to_port(params, stats),
            'its': (5,), 'batches': [batch], 'no_noise': True,
            'jax': (module, params, stats, to_port)}


@pytest.fixture(scope='module')
def cases():
    out = {name: paradigm_case(*key, seed=100 + i)
           for i, (name, key) in enumerate(zip(NAMES, METHODS))}
    out.update({name: jax_case(*key, seed=200 + i)
                for i, (name, key) in enumerate(JAX_CASES.items())})
    return out


@pytest.fixture(scope='module')
def ranks(cases, tmp_path_factory):
    """Every case from one start of 2 gloo ranks: per case, rank 0's
    result and rank 1's."""
    work = tmp_path_factory.mktemp('paradigm_ranks')
    names = list(cases)
    torch.save([{k: v for k, v in cases[n].items() if k != 'jax'}
                for n in names], str(work / 'cases.pt'))
    proc = subprocess.run([sys.executable, os.path.join(ROOT, 'tests',
                                                        'torch_ranks.py'),
                           str(work), '2'], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    results = [torch.load(str(work / f), weights_only=False)
               for f in ('results.pt', 'results.rank1.pt')]
    return {n: (results[0][i], results[1][i]) for i, n in enumerate(names)}


def test_segmented_draws_are_the_one_card_rows():
    """Under ``batch_segments`` a rank's dropout mask and teacher noise of
    a batch of two streams (folded over depth) are its rows of each
    stream in the one-card draw."""
    rs = np.random.RandomState(3)
    lab = torch.from_numpy(rs.normal(size=(4, 1, 2, 3, 3)).astype(
        np.float32))
    unlab = torch.from_numpy(rs.normal(size=(6, 1, 2, 3, 3)).astype(
        np.float32))

    def fold(x):
        return x.transpose(1, 2).reshape((-1, 1, 3, 3))

    whole = fold(torch.cat([lab, unlab]))
    want = grouped_dropout(whole, 0.5, [torch.Generator().manual_seed(9)])
    noise = port_ssl.noise_like(torch.Generator().manual_seed(8), unlab)
    for r in range(2):
        mesh = Mesh.__new__(Mesh)      # a rank and a size, no group
        mesh.rank, mesh.size = r, 2
        mine = torch.cat([lab[2 * r:2 * r + 2], unlab[3 * r:3 * r + 3]])
        with data_parallel(mesh), batch_segments((2, 3)):
            got = grouped_dropout(fold(mine), 0.5,
                                  [torch.Generator().manual_seed(9)])
        # folded rows: 2 per sample; labelled rows 0-7, unlabelled 8-19
        rows = [slice(4 * r, 4 * r + 4), slice(8 + 6 * r, 14 + 6 * r)]
        torch.testing.assert_close(got, torch.cat([want[s] for s in rows]),
                                   rtol=0, atol=0)
        with data_parallel(mesh):
            got = port_ssl.noise_like(torch.Generator().manual_seed(8),
                                      unlab[3 * r:3 * r + 3])
        torch.testing.assert_close(got, noise[3 * r:3 * r + 3], rtol=0,
                                   atol=0)


def _masks_agree(got, want, rel):
    """Equal masks of ``keep_n`` voxels, but where a voxel's CE lies
    within ``rel`` of the range of the values from the keep cutoff."""
    assert got['keep_n'] == want['keep_n']
    assert int(got['mask'].sum()) == got['keep_n']
    diff = got['mask'] != want['mask']
    if not diff.any():
        return
    values = np.sort(want['values'])
    cutoff = values[max(want['keep_n'] - 1, 0)]
    span = float(values[-1] - values[0]) or 1.0
    assert np.abs(want['values'][diff] - cutoff).max() <= rel * span


@pytest.mark.parametrize('name', NAMES)
def test_two_rank_paradigm_step_matches_one_process(one_torch_thread,  # noqa
                                                    cases, ranks, name):
    """Two steps on 2 ranks against the one-process steps: metrics, first
    gradients, parameters and statistics; both ranks' states, teachers,
    masks and gates identical, and the teacher, masks and gates the
    one-process ones."""
    want = run_case(cases[name], None)
    got, other = ranks[name]
    _check_metrics(got['metrics'][:1], want['metrics'][:1], rtol=1e-4,
                   atol=1e-6)
    _check_metrics(got['metrics'][1:], want['metrics'][1:], rtol=1e-3,
                   atol=2e-3)
    top = max(float(g.abs().max()) for g in want['grads'].values())
    for key, g in want['grads'].items():
        tol = 1e-3 * float(g.abs().max()) + 1e-5 * top
        assert float((got['grads'][key] - g).abs().max()) <= tol, key
    _check_state(got['state'], want['state'], want['grads'], lr=LR)
    for key, value in got['state'].items():
        assert torch.equal(value, other['state'][key]), key
    assert (got['teacher'] is None) == (want['teacher'] is None)
    if want['teacher'] is not None:
        alpha = 0.9
        for key, value in want['teacher'].items():
            assert torch.equal(got['teacher'][key], other['teacher'][key])
            err = float((got['teacher'][key] - value).abs().max())
            assert err <= 2 * 4 * LR * (1 - alpha) + 1e-7, key
    assert len(got['masks']) == len(want['masks']) == len(other['masks'])
    peers = cases[name]['peers']
    for i, (g, w, o) in enumerate(zip(got['masks'], want['masks'],
                                      other['masks'])):
        np.testing.assert_array_equal(g['mask'], o['mask'])
        # the first step's CE agrees to rounding, the second's to one Adam
        # update
        _masks_agree(g, w, 1e-5 if i < peers else 1e-3)
    assert got['gates'] == other['gates'] == want['gates']
    if name == 'nll-DAST':
        assert any(g != {'dbc': 0.0, 'st': 0.0} for g in want['gates'])


def _jax_sharded(name, case):
    """The JAX agent's step wrapped for a 2-device mesh, one step from the
    case's variables: its metrics, grads and state."""
    from fpl_plus_tpu.agents.nll import NLLMethodDict as JaxNLL
    from fpl_plus_tpu.agents.ssl import SSLMethodDict as JaxSSL
    from fpl_plus_tpu.agents.wsl import WSLMethodDict as JaxWSL
    from fpl_plus_tpu.engine.optim import create_optimizer as jax_optimizer
    from fpl_plus_tpu.losses import create_loss_calculator as jax_loss
    from fpl_plus_tpu.parallel import make_mesh, make_sharded_train_step
    registry = {'ssl': JaxSSL, 'wsl': JaxWSL, 'nll': JaxNLL}
    paradigm, method = JAX_CASES[name]
    module, params, stats, _ = case['jax']
    agent = registry[paradigm][method](case['config'], 'train')
    agent.module = module
    agent.variables = {'params': params, 'batch_stats': stats}
    cfg_t = case['config']['training']
    optimizer = jax_optimizer(cfg_t, dict(cfg_t, last_iter=-1))
    step = make_sharded_train_step(
        agent.build_train_step(optimizer, jax_loss(agent.config)),
        make_mesh(2), optimizer_name=cfg_t['optimizer'])

    def to_jax(tree):
        return jax.tree_util.tree_map(lambda a: jnp.asarray(cl(a)), tree)

    return run_jax(agent, module, params, stats, to_jax(case['batches'][0]),
                   step=step)


@pytest.mark.parametrize('name', list(JAX_CASES))
def test_two_rank_step_matches_jax_sharded_step(no_noise, cases, ranks,  # noqa
                                                name):
    """One step on 2 ranks against JAX's step sharded over 2 devices from
    the same variables on the same global batch: loss components,
    ``regular_w`` / ``remb_ratio``, parameters, statistics and the EMA
    teacher."""
    case = cases[name]
    got = ranks[name][0]
    ref, _, ref_grads, ref_state, _ = _jax_sharded(name, case)
    _, params, stats, to_port = case['jax']
    keys = (('loss', 'loss_no_select1', 'loss_no_select2', 'class_dice_0')
            if name == 'jax-CoTeaching'
            else ('loss', 'loss_sup', 'loss_reg', 'class_dice_0'))
    check_step({k: got['metrics'][0][k] for k in keys}, ref, keys)
    check_params(ref_state.params, ref_state.batch_stats, ref_grads,
                 got['state'], lr=LR, to_port=to_port)
    assert (got['teacher'] is not None) == (ref_state.extra is not None)
    if got['teacher'] is not None:
        alpha = min(1 - 1 / (case['config']['training']['iter_max'] + 1),
                    0.99)
        student = {k: got['state'][k] for k in got['teacher']}
        check_teacher(types.SimpleNamespace(alpha=alpha,
                                            params=got['teacher']),
                      to_port(params, stats), student, ref_state.extra,
                      ref_state.batch_stats, ref_grads, to_port)


def test_jax_dast_step_cannot_run_on_a_mesh():
    """JAX's DAST step reads its selection scores with ``float`` on the
    host after its jitted step; wrapped by ``make_sharded_train_step``,
    which jits it again, those scores are tracers, and tracing it raises a
    concretization error. The port follows the intended semantics instead
    (global scores, the same gates on every rank: the ``nll-DAST`` case
    above)."""
    from fpl_plus_tpu.agents.nll import NLLMethodDict as JaxNLL
    from fpl_plus_tpu.agents.nll import _Rank
    from fpl_plus_tpu.engine.optim import create_optimizer as jax_optimizer
    from fpl_plus_tpu.engine.train import create_train_state
    from fpl_plus_tpu.losses import create_loss_calculator as jax_loss
    from fpl_plus_tpu.models.multi_net import make_binet
    from fpl_plus_tpu.parallel import make_mesh, make_sharded_train_step
    from tests.test_torch_port_zoo import random_variables
    cfg = paradigm_config('noisy_label_learning', None, NLL)
    rs = np.random.RandomState(5)
    x, y = images(rs, n=2)
    batch = {'image': jnp.asarray(cl(x)), 'label_prob': jnp.asarray(cl(y))}
    module = make_binet(cfg['network'])
    params, stats = random_variables(module, cl(np.concatenate([x, x])), 7)
    agent = JaxNLL['DAST'](cfg, 'train')
    agent.module = module
    agent.variables = {'params': params, 'batch_stats': stats}
    agent.noisy_rank, agent.clean_rank = _Rank(2), _Rank(2)
    cfg_t = cfg['training']
    optimizer = jax_optimizer(cfg_t, dict(cfg_t, last_iter=-1))
    state = create_train_state(params, stats, optimizer)
    step = make_sharded_train_step(
        agent.build_train_step(optimizer, jax_loss(cfg)), make_mesh(2),
        optimizer_name='Adam')
    hyper = {k: jnp.float32(v) for k, v in agent.training_hyper(0).items()}
    with pytest.raises(jax.errors.ConcretizationTypeError):
        jax.eval_shape(step, state, {'clean': batch, 'noise': batch},
                       jax.random.PRNGKey(0), hyper)
