"""PyTorch port, the noisy-label agents against the JAX package's.

One step of CoTeaching and TriNet, and 6 steps of DAST, on the tiny UNet2D
of the JAX package's paradigm tests (widths [2,4,8,8], 16x16 inputs, 2
images, DiceLoss, Adam at 1e-3, dropout 0) from one set of weights (flax
variables from ``jax.eval_shape`` of the init filled from a numpy seed,
carried across by ``state_dict_from_multinet``); each case compiles the
JAX agent's jitted step once. The small-loss masks are recorded on both
sides (the JAX step through ``jax.debug.callback``) and must be equal; the
loss components rtol 1e-4; the parameters and BN statistics after the
first step as ``tests/test_torch_port_train_step.py`` holds them
(``check_params``). DAST: the gate sequence of 6 steps equal, the
selection scores rtol 1e-3 (6 Adam steps apart).

Beside the steps: the rank mask with ties and the float32 keep count at
boundary ratios, the rank queue, the ramps, DAST's noisy stream against the
JAX agent's, and ``main_nll`` through train, the auto test stage and the
evaluation on the CPU.
"""
import itertools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpl_plus_torch.agents import nll as port_nll
from fpl_plus_torch.engine.optim import create_optimizer
from fpl_plus_torch.models.multi_net import make_binet, make_trinet
from fpl_plus_torch.utils.convert import state_dict_from_multinet
from tests.test_torch_port_models import one_torch_thread  # noqa: F401
from tests.test_torch_port_ssl import (LR, SSL_CLI_CFG, cl, images,
                                       paradigm_config, run_jax,
                                       write_ssl_workspace)
from tests.test_torch_port_train_step import check_params
from tests.test_torch_port_zoo import random_variables

SECTION = 'noisy_label_learning'
NLL = {'co_teaching_select_ratio': 0.8, 'dast_rank_length': 2,
       'dast_select_ratio': 0.5, 'dast_dbc_w': 0.1, 'dast_st_w': 0.1}
DAST_STEPS = 6


def nll_config():
    return paradigm_config(SECTION, None, NLL)


@pytest.fixture
def recorded_masks(monkeypatch):
    """The small-loss masks of both sides, in the order the steps build
    them: ``{'jax': [...], 'port': [...]}``."""
    import fpl_plus_tpu.agents.nll as jax_nll
    rec = {'jax': {}, 'port': []}
    count = itertools.count()
    jax_mask = jax_nll._keep_smallest_mask

    def jax_recording(values, keep_n):
        mask = jax_mask(values, keep_n)
        i = next(count)
        jax.debug.callback(lambda m: rec['jax'].__setitem__(
            i, np.asarray(m)), mask)
        return mask

    port_mask = port_nll.keep_smallest_mask

    def port_recording(values, keep_n):
        mask = port_mask(values, keep_n)
        rec['port'].append(mask.numpy())
        return mask

    monkeypatch.setattr(jax_nll, '_keep_smallest_mask', jax_recording)
    monkeypatch.setattr(port_nll, 'keep_smallest_mask', port_recording)
    return rec


def variables(cfg, peers, x_cl, seed):
    """JAX variables of a BiNet / TriNet, its flax module, the converter."""
    from fpl_plus_tpu.models.multi_net import make_binet as jax_binet
    from fpl_plus_tpu.models.multi_net import make_trinet as jax_trinet
    module = (jax_binet if peers == 2 else jax_trinet)(cfg['network'])
    params, stats = random_variables(module, x_cl, seed)

    def to_port(p, s):
        return state_dict_from_multinet(p, s, cfg['network'])
    return module, params, stats, to_port


def port_agent(method, cfg, sd, peers):
    agent = port_nll.NLLMethodDict[method](cfg, 'train', 'cpu')
    net = (make_binet if peers == 2 else make_trinet)(cfg['network'])
    net.load_state_dict(sd, strict=True)
    agent.module = net.train()
    step = agent._build_step(create_optimizer(cfg['training'],
                                              net.parameters()), None)
    return agent, step


def batch(rs):
    x, y = images(rs)
    return ({'image': jnp.asarray(cl(x)), 'label_prob': jnp.asarray(cl(y))},
            {'image': torch.from_numpy(x), 'label_prob': torch.from_numpy(y)})


@pytest.mark.parametrize('method,peers,keys', [
    ('CoTeaching', 2, ('loss', 'loss_no_select1', 'loss_no_select2',
                       'class_dice_0')),
    ('TriNet', 3, ('loss', 'loss_no_select1', 'class_dice_0')),
])
def test_nll_step_matches_jax(method, peers, keys, recorded_masks):
    """One step: the masks equal, the loss components, the post-step
    parameters and BN statistics against the JAX agent's step."""
    from fpl_plus_tpu.agents.nll import NLLMethodDict as JaxNLL
    cfg = nll_config()
    jb, pb = batch(np.random.RandomState(11))
    module, params, stats, to_port = variables(
        cfg, peers, np.asarray(jb['image']), seed=21)
    ref, ref_hyper, ref_grads, ref_state, _ = run_jax(
        JaxNLL[method](cfg, 'train'), module, params, stats, (jb,))
    agent, step = port_agent(method, cfg, to_port(params, stats), peers)
    hyper = agent.training_hyper(5)
    np.testing.assert_allclose(hyper['remb_ratio'], ref_hyper['remb_ratio'],
                               rtol=1e-7)
    got = step((pb,), agent._step_generators(5), **hyper)
    masks_jax = [recorded_masks['jax'][i]
                 for i in sorted(recorded_masks['jax'])]
    assert len(recorded_masks['port']) == len(masks_jax) == peers
    keep_n = port_nll.keep_count(hyper['remb_ratio'], 2 * 16 * 16)
    for want, mask in zip(masks_jax, recorded_masks['port']):
        np.testing.assert_array_equal(mask, want)
        assert mask.sum() == keep_n
    for key in keys:
        np.testing.assert_allclose(np.asarray(got[key]), ref[key],
                                   rtol=1e-4, err_msg=key)
    check_params(ref_state.params, ref_state.batch_stats, ref_grads,
                 agent.module.state_dict(), lr=LR, to_port=to_port)


def test_dast_steps_and_gates_match_jax():
    """6 DAST steps from one set of weights: the gates each step reads
    (the rank queues' decisions) equal, the losses and the host selection
    scores close, the first step's parameters by ``check_params``."""
    from fpl_plus_tpu.agents.nll import NLLMethodDict as JaxNLL
    from fpl_plus_tpu.agents.nll import _Rank
    from fpl_plus_tpu.engine.optim import create_optimizer as jax_optimizer
    from fpl_plus_tpu.engine.train import create_train_state
    from fpl_plus_tpu.losses import create_loss_calculator as jax_loss
    cfg = nll_config()
    rs = np.random.RandomState(12)
    (jc, pc), (jn, pn) = batch(rs), batch(rs)
    # the noisy batch's labels: the clean rule with a flipped corner
    flip = np.asarray(jn['label_prob']).copy()
    flip[:, :6, :6] = flip[:, :6, :6, ::-1]
    jn['label_prob'] = jnp.asarray(flip)
    pn['label_prob'] = torch.from_numpy(np.moveaxis(flip, -1, 1).copy())
    module, params, stats, to_port = variables(
        cfg, 2, np.concatenate([jc['image'], jn['image']]), seed=23)

    jax_agent = JaxNLL['DAST'](cfg, 'train')
    jax_agent.noisy_rank, jax_agent.clean_rank = _Rank(2), _Rank(2)
    jax_agent.module = module
    optimizer = jax_optimizer(cfg['training'],
                              dict(cfg['training'], last_iter=-1))
    state = create_train_state(jax.tree_util.tree_map(np.array, params),
                               jax.tree_util.tree_map(np.array, stats),
                               optimizer)
    jax_step = jax_agent.build_train_step(optimizer, jax_loss(cfg))
    agent, step = port_agent('DAST', cfg, to_port(params, stats), 2)
    scores = []
    real_gates = agent.update_gates
    agent_scores = []

    def recording(loss_n, loss_c):
        agent_scores.append((loss_n, loss_c))
        real_gates(loss_n, loss_c)

    step.on_scores = recording
    hypers, ref_hypers = [], []
    for it in range(DAST_STEPS):
        ref_hyper = jax_agent.training_hyper(it)
        hyper = agent.training_hyper(it)
        ref_hypers.append(ref_hyper)
        hypers.append(hyper)
        state, ref = jax_step(state, {'clean': jc, 'noise': jn},
                              jax.random.PRNGKey(it),
                              {k: jnp.float32(v) for k, v in
                               ref_hyper.items()})
        got = step({'clean': pc, 'noise': pn}, agent._step_generators(it),
                   **hyper)
        scores.append((jax_agent.noisy_rank.vals[-1],
                       jax_agent.clean_rank.vals[-1]))
        for key in ('loss', 'loss_sup', 'class_dice_0'):
            np.testing.assert_allclose(np.asarray(got[key]), ref[key],
                                       rtol=1e-3, err_msg=key)
        if it == 0:
            from tests.test_torch_port_train_step import adam_mu
            grads = jax.tree_util.tree_map(lambda mu: np.asarray(mu) / 0.1,
                                           adam_mu(state.opt_state))
            check_params(jax.device_get(state.params),
                         jax.device_get(state.batch_stats), grads,
                         agent.module.state_dict(), lr=LR, to_port=to_port)
    np.testing.assert_allclose(agent_scores, scores, rtol=1e-3)
    gates = [(h['w_dbc'] > 0, h['w_st'] > 0) for h in hypers]
    assert gates == [(h['w_dbc'] > 0, h['w_st'] > 0) for h in ref_hypers]
    assert any(g != (False, False) for g in gates), gates
    for h, r in zip(hypers, ref_hypers):
        np.testing.assert_allclose([h['w_dbc'], h['w_st']],
                                   [r['w_dbc'], r['w_st']], rtol=1e-7)
    assert agent.gates == jax_agent._last_select


def test_rank_queue_matches_jax():
    from fpl_plus_tpu.agents.nll import _Rank
    rs = np.random.RandomState(3)
    stream = list(rs.normal(size=60)) + [0.5] * 10 + list(rs.randint(0, 3,
                                                                     20))
    ref, got = _Rank(7), port_nll.Rank(7)
    assert [got.add_val(float(v)) for v in stream] == \
        [ref.add_val(float(v)) for v in stream]


# CoTeaching's ratio at iteration 12 of a 0..100 sigmoid ramp to 0.8
RAMPED = 1.0 - 0.2 * np.exp(-5.0 * (1 - 12 / 100) ** 2)


@pytest.mark.parametrize('remb_ratio', [0.0, 0.1, 0.7, 0.9, 1.0, RAMPED])
def test_keep_smallest_mask_ties_match_jax(remb_ratio):
    """300 k voxels with values in 50 levels (ties everywhere): the float32
    keep count and the stable rank mask equal JAX's; at the ramped ratio
    the float32 product rounds up to an integer that a float64 product
    stays below."""
    from fpl_plus_tpu.agents.nll import _keep_smallest_mask
    n = 300_000
    values = np.random.RandomState(5).randint(0, 50, n).astype(np.float32)
    want_n = int((jnp.float32(remb_ratio) * n).astype(jnp.int32))
    keep_n = port_nll.keep_count(remb_ratio, n)
    assert keep_n == want_n
    if remb_ratio == RAMPED:
        assert keep_n == int(RAMPED * n) + 1 == 298751
    want = np.asarray(_keep_smallest_mask(jnp.asarray(values), want_n))
    got = port_nll.keep_smallest_mask(torch.from_numpy(values), keep_n)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.float32


@pytest.mark.parametrize('method', ['CoTeaching', 'TriNet', 'DAST'])
def test_training_hyper_matches_jax(method):
    from fpl_plus_tpu.agents.nll import NLLMethodDict as JaxNLL
    sec = dict(NLL, rampup_start=2, rampup_end=40)
    if method == 'TriNet':
        sec['trinet_select_ratio'] = 0.7
    cfg = paradigm_config(SECTION, None, sec)
    ref = JaxNLL[method](cfg, 'train')
    got = port_nll.NLLMethodDict[method](cfg, 'train', 'cpu')
    if method == 'DAST':
        ref._last_select = got.gates = {'dbc': 1.0, 'st': 0.0}
    for it in (0, 1, 2, 9, 21, 40, 77):
        want = ref.training_hyper(it)
        have = got.training_hyper(it)
        assert set(have) == set(want)
        for k in want:
            assert have[k] == pytest.approx(want[k], rel=1e-12), (it, k)


DAST_CLI_CFG = SSL_CLI_CFG.replace(
    'train_csv_unlab = {root}/unlab.csv',
    'train_csv_noise = {root}/d1_train.csv').replace(
    'train_batch_size_unlab = 2', 'train_batch_size_noise = 1').replace(
    '[semi_supervised_learning]\nssl_method', '[noisy_label_learning]\n'
    'nll_method').replace('ema_decay = 0.9', '''co_teaching_select_ratio = 0.8
dast_rank_length = 2
dast_select_ratio = 0.5''')


def write_nll_workspace(root, method):
    cfg = write_ssl_workspace(root, method)
    with open(cfg, 'w') as f:
        f.write(DAST_CLI_CFG.format(root=root, method=method))
    return cfg


def test_dast_noise_stream_matches_jax_agent(tmp_path):
    """DAST's noisy loader yields the JAX agent's stream (manifest, the
    train chain, seed ``random_seed + 200``)."""
    from fpl_plus_tpu.agents.nll import NLLDAST as JaxDAST
    from fpl_plus_tpu.config.parser import parse_config as jax_parse
    from fpl_plus_tpu.config.parser import synchronize_config as jax_sync
    from fpl_plus_torch.config.parser import (parse_config,
                                              synchronize_config)
    from fpl_plus_torch.io.loader import repeat_loader
    cfg = write_nll_workspace(str(tmp_path), 'DAST')
    ref_agent = JaxDAST(jax_sync(jax_parse(cfg)), 'train')
    ref_agent.create_dataset()
    agent = port_nll.NLLDAST(synchronize_config(parse_config(cfg)), 'train',
                             'cpu')
    agent.create_dataset()
    got = repeat_loader(agent.train_loader_noise)
    try:
        for _ in range(4):
            a, b = next(ref_agent._noise_iter), next(got)
            assert a['names'] == b['names']
            np.testing.assert_array_equal(b['image'], a['image'])
            np.testing.assert_array_equal(b['label_prob'], a['label_prob'])
    finally:
        ref_agent.shutdown()


@pytest.mark.parametrize('method', ['CoTeaching', 'DAST'])
def test_main_nll_train_test_evaluate(method, tmp_path, monkeypatch):
    """``main_nll(['train', cfg], device='cpu')``: 2 iterations with
    validation, a BiNet checkpoint, the auto test stage's labels and the
    evaluation CSV; an unknown method raises ``ValueError``."""
    from fpl_plus_torch.cli import main_nll
    from fpl_plus_torch.io.image_io import load_image_as_nd_array
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    root = str(tmp_path)
    cfg = write_nll_workspace(root, method)
    steps = []
    cls = {'CoTeaching': port_nll.CoTeachingStep,
           'DAST': port_nll.DASTStep}[method]
    real = cls.__call__

    def recording(self, batches, draws, **hyper):
        steps.append(hyper)
        return real(self, batches, draws, **hyper)

    monkeypatch.setattr(cls, '__call__', recording)
    assert main_nll(['train', cfg], device='cpu') == 0
    assert len(steps) == 2
    saved = torch.load(os.path.join(root, 'model', 'mt', 'mt_2.pt'),
                       weights_only=False)
    assert {k.split('.')[1] for k in saved['model_state_dict']} == {'0', '1'}
    out = os.path.join(root, 'result', 'mt_d0_test')
    lab = load_image_as_nd_array(os.path.join(out, 'img0.nii.gz'))
    assert lab['data_array'].shape == (1, 12, 24, 24)
    assert os.path.isfile(os.path.join(out, 'test_cube_dice_all.csv'))
    if method == 'DAST':
        assert set(steps[0]) == {'w_dbc', 'w_st'}
        return
    assert set(steps[0]) == {'remb_ratio'}
    bad = cfg.replace('ssl.cfg', 'bad.cfg')
    with open(cfg) as f, open(bad, 'w') as g:
        g.write(f.read().replace('nll_method = CoTeaching',
                                 'nll_method = NoSuchMethod'))
    with pytest.raises(ValueError, match='NoSuchMethod'):
        main_nll(['train', bad], device='cpu')
