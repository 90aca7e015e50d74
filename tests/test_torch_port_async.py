"""PyTorch port, the asynchronous serving surface and the test stage's
one-deep pipeline, against the port's synchronous entries and the JAX
package's.

* ``run_async()()``, ``run_batch_async()()``, ``run_passes_async()()`` and
  ``run_fpl_uncertainty()()`` equal ``run``, ``run_batch``, ``run_passes``
  and the reduction of ``run_passes``'s logits bit for bit (on the CPU the
  fetch returns what the dispatch computed), and JAX's counterparts
  (``engine/infer.py:990,1118,1231,1305`` there) at network dropout 0 by
  ``test_torch_port_infer.py``'s tolerance: f32 logits, atol = rtol = 1e-4
  (two convolution libraries); the FPL pair by ``test_torch_port_fpl.py``
  (e)'s: ``boundary`` equal, ``vars_sum`` to atol 1e-6. One JAX compile per
  entry. A ``UNet2D_URPC`` predictor (4 heads) goes through ``run_async``
  as well: a list of 4 fetched heads, bit-equal to ``run`` and within 1e-4
  of JAX's ``run_async``.
* ``run_mc`` dispatches every seed's inference before the first fetch, and
  its results are the rows of ``run_passes`` on a ``PassFold`` of the same
  seeds, dropout on, by ``test_torch_port_fpl.py`` (c)'s atol = rtol = 1e-5
  (one library, other batch sizes).
* The agent's volume loop with a recording Inferer: the dispatch of volume
  i+1 (or loader batch b+1, or FPL pass i+1) comes before the fetch of
  volume i, saves follow loader order, the last entry is finished after
  the loop; a fetch that raises propagates out of ``cli test`` and the
  ``profile_dir`` trace still stops.
* The pipelined ``cli test`` (device-label path, ``fpl = True`` with
  dropout on, ``test_batch_size = 2``) writes the same labels and the same
  sorted uncertainty ``.npy`` as a serial loop through the same agent
  (``run`` or ``run_batch`` or the FPL fetch, then the crop and the save,
  one volume at a time: ``chip_smoke.py``'s ``serial_infer``, which phase
  35 runs on the card). Its parity with JAX's ``cli test`` on these paths
  is held by ``test_torch_port_cli.py`` and ``test_torch_port_fpl.py``
  (e), whose stages run through the pipeline.

All on the CPU at tiny widths.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpl_plus_torch.agents.agent_seg as agent_seg
from fpl_plus_tpu.engine.infer import GroupedMCPredictor as JaxGrouped
from fpl_plus_tpu.engine.infer import Inferer as JaxInferer
from fpl_plus_tpu.models.registry import create_network as jax_create
from fpl_plus_torch.cli import main as torch_main
from fpl_plus_torch.engine import ckpt as ckpt_lib
from fpl_plus_torch.engine.infer import (Inferer, PassFold,
                                         fpl_uncertainty_reduce)
from fpl_plus_torch.models.registry import create_network
from fpl_plus_torch.utils.convert import state_dict_from_jax
from chip_smoke import serial_infer
from tests.test_torch_port_cli import _cfg, _labels, _write_workspace
from tests.test_torch_port_infer import SW, _JaxPredictor
from tests.test_torch_port_models import (SMALL, center_head,  # noqa: F401
                                         one_torch_thread)
from tests.test_torch_port_zoo import random_variables

DOMAIN = 1
NO_DROPOUT = dict(SMALL, dropout=[0.0] * 5)
SEEDS = [101, 102, 103]
MARGINS = ([1, 2, 0], [2, 0, 3])
RS = np.random.RandomState(21)
IMAGE = RS.normal(size=(1, 1, 12, 40, 44)).astype(np.float32)
VOLUMES = RS.normal(size=(2, 1, 12, 40, 44)).astype(np.float32)


@pytest.fixture(scope='module')
def nets():
    """JAX's and the port's SMALL UNet2D5_dsbn on one set of seeded
    variables (no init compile), the port's at dropout 0 and on."""
    module = jax_create(NO_DROPOUT)
    params, stats = random_variables(
        module, np.zeros((1, 8, 32, 32, 1), np.float32), seed=4)
    plain, dropout = create_network(NO_DROPOUT), create_network(SMALL)
    plain.load_state_dict(state_dict_from_jax(params, stats, NO_DROPOUT),
                          strict=True)
    probe = np.random.RandomState(20).normal(
        size=(1, 1, 8, 32, 32)).astype(np.float32)
    center_head(params, plain.eval(), probe, DOMAIN)
    dropout.load_state_dict(plain.state_dict(), strict=True)
    return module, {'params': params, 'batch_stats': stats}, plain, \
        dropout.eval()


def _predictor(net):
    def predict(x, dropout_generators=None):
        return net(x, DOMAIN, dropout_generators)
    return predict


def _jax_ctx(variables, passes=0):
    ctx = (variables, jnp.int32(DOMAIN))
    if passes:
        ctx += (jnp.stack(jax.random.split(jax.random.PRNGKey(0), passes)),)
    return ctx


@pytest.mark.parametrize('entry', ['run', 'run_batch', 'run_passes',
                                   'run_fpl_uncertainty'])
def test_async_entries_equal_sync_and_jax(nets, entry):
    module, variables, net, _ = nets
    logits = Inferer(dict(SW, output_mode='logits'), 'cpu')
    labels = Inferer(dict(SW, output_mode='label'), 'cpu')
    jax_inf = JaxInferer(dict(SW, output_mode='logits'))
    pred = _predictor(net)
    fold = PassFold(pred, SEEDS, 'cpu')
    n = len(SEEDS)
    if entry == 'run':
        fetch = logits.run_async(pred, IMAGE)
        sync = logits.run(pred, IMAGE)
        label = labels.run_async(pred, IMAGE)()
        ref = jax_inf.run_async(_JaxPredictor(module), _jax_ctx(variables),
                                IMAGE)()
    elif entry == 'run_batch':
        fetch = logits.run_batch_async(pred, VOLUMES)
        sync = logits.run_batch(pred, VOLUMES)
        label = labels.run_batch_async(pred, VOLUMES)()
        ref = jax_inf.run_batch_async(_JaxPredictor(module),
                                      _jax_ctx(variables), VOLUMES)()
    elif entry == 'run_passes':
        fetch = logits.run_passes_async(fold, IMAGE, n)
        sync = logits.run_passes(fold, IMAGE, n)
        label = labels.run_passes_async(fold, IMAGE, n)()
        ref = jax_inf.run_passes_async(JaxGrouped(module),
                                       _jax_ctx(variables, n), IMAGE, n)()
    else:
        fetch = labels.run_fpl_uncertainty(fold, IMAGE, n, MARGINS)
        assert callable(fetch)
        got = fetch()
        assert isinstance(got[0], float) and isinstance(got[1], int)
        want = fpl_uncertainty_reduce(torch.from_numpy(
            logits.run_passes(fold, IMAGE, n)), *MARGINS)
        assert got == (float(want[0]), int(want[1]))
        ref = jax_inf.run_fpl_uncertainty(
            JaxGrouped(module), _jax_ctx(variables, n), IMAGE, n, MARGINS)()
        assert got[1] == ref[1] > 0
        np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-6)
        return
    assert callable(fetch)
    got = fetch()
    assert got.dtype == np.float32 and got.shape == sync.shape
    np.testing.assert_array_equal(got, sync)
    np.testing.assert_array_equal(label, np.argmax(got, 1))
    assert 0.05 < label.mean() < 0.95          # both classes present
    assert got.shape == np.asarray(ref).shape
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-4)


URPC = {'net_type': 'UNet2D_URPC', 'in_chns': 1, 'class_num': 2,
        'feature_chns': [4, 8, 8, 16], 'dropout': [0.0, 0.0, 0.3, 0.4]}


def test_multi_head_run_async_equals_run_and_jax():
    from fpl_plus_torch.utils.convert import state_dict_from_flax
    module = jax_create(URPC)
    params, stats = random_variables(module, np.zeros((1, 3, 16, 16, 1),
                                                      np.float32), seed=6)
    net = create_network(URPC)
    net.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    net.eval()
    # the multi-head test's window (no JAX shape bucketing: ROADMAP.md
    # section 3)
    cfg = {'sliding_window_enable': True, 'sliding_window_size': [3, 16, 16],
           'sliding_window_stride': [2, 12, 12], 'tta_mode': 1,
           'infer_unroll_max': 0, 'infer_shape_bucket': 0,
           'output_mode': 'logits'}
    image = np.random.RandomState(2).normal(
        size=(1, 1, 5, 40, 44)).astype(np.float32)
    inferer = Inferer(cfg, 'cpu')
    got = inferer.run_async(lambda x: net(x), image)()
    sync = inferer.run(lambda x: net(x), image)

    class JaxHeads:
        def __call__(self, ctx, x):
            return module.apply(ctx, x, 0, False)
    ref = JaxInferer(cfg).run_async(
        JaxHeads(), {'params': params, 'batch_stats': stats}, image)()
    assert isinstance(got, list) and len(got) == len(ref) == 4
    assert [g.shape for g in got] == [(1, 2, 5, 40, 44), (1, 2, 5, 20, 22),
                                      (1, 2, 5, 10, 11), (1, 2, 5, 5, 5)]
    for g, s, r in zip(got, sync, ref):
        np.testing.assert_array_equal(g, s)
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-4, atol=1e-4)


def test_run_mc_dispatches_all_and_equals_folded_rows(nets, monkeypatch):
    _, _, _, net = nets                           # dropout on
    inferer = Inferer(dict(SW, output_mode='logits'), 'cpu')
    pred = _predictor(net)
    rows = inferer.run_passes(PassFold(pred, SEEDS, 'cpu'), IMAGE,
                              len(SEEDS))
    order = []
    run_async = Inferer.run_async

    def recording(self, predictor, image):
        fetch = run_async(self, predictor, image)
        order.append('dispatch')

        def fetched():
            order.append('fetch')
            return fetch()
        return fetched

    monkeypatch.setattr(Inferer, 'run_async', recording)
    mc = inferer.run_mc(lambda s: PassFold(pred, [s], 'cpu').take([0]),
                        IMAGE, SEEDS)
    assert order == ['dispatch'] * 3 + ['fetch'] * 3
    assert len(mc) == 3 and mc[0].shape == (1,) + rows.shape[1:]
    for i in range(3):
        np.testing.assert_allclose(mc[i][0], rows[i], rtol=1e-5, atol=1e-5,
                                   err_msg='pass {0}'.format(i))
    assert not np.allclose(mc[0], mc[1])          # the seeds' masks differ


# -- the agent's test stage -------------------------------------------------

@pytest.fixture(scope='module')
def workspace(tmp_path_factory):
    """``test_torch_port_cli.py``'s three 12x24x24 volumes and a port
    checkpoint of the SMALL net (seeded torch init; the class-1 bias shifted
    so that both classes appear)."""
    root = str(tmp_path_factory.mktemp('torch_port_async'))
    probe = _write_workspace(root)
    torch.manual_seed(3)
    net = create_network(SMALL).eval()
    with torch.no_grad():
        out = net(torch.from_numpy(probe.astype(np.float32)), DOMAIN)
        net.out_conv.bias[1] -= float(torch.median(out[:, 1] - out[:, 0]))
    ckpt_dir = os.path.join(root, 'model', 'gen')
    ckpt_lib.save_checkpoint(ckpt_dir, 'gen', 5,
                             {'model_state_dict': net.state_dict()}, 0.0)
    return root


PATHS = {'label': (1, ''),
         'batch2': (2, ''),
         'fpl': (1, 'fpl = True\nfpl_uncertainty_sorted = {root}/{tag}.npy')}


def stage_cfg(root, path, tag, extra=''):
    batch, text = PATHS[path]
    return _cfg(root, tag + '.cfg', 'out_' + tag, batch=batch,
                extra='\n'.join([text.format(root=root, tag=tag), extra]))


class RecordingInferer(Inferer):
    """The Inferer with its dispatches and fetches logged in ``log`` (one
    number per dispatch); the fetch of dispatch ``fail`` raises."""
    log: list = []
    fail = None

    def _recorded(self, fetch):
        n = sum(1 for e in self.log if e[0] == 'dispatch')
        self.log.append(('dispatch', n))

        def fetched():
            self.log.append(('fetch', n))
            if n == self.fail:
                raise RuntimeError('fetch {0} failed'.format(n))
            return fetch()
        return fetched

    def run_async(self, *args):
        return self._recorded(super().run_async(*args))

    def run_batch_async(self, *args):
        return self._recorded(super().run_batch_async(*args))

    def run_fpl_uncertainty(self, *args):
        return self._recorded(super().run_fpl_uncertainty(*args))


@pytest.fixture
def recorded(monkeypatch):
    log = []
    monkeypatch.setattr(RecordingInferer, 'log', log)
    monkeypatch.setattr(agent_seg, 'Inferer', RecordingInferer)
    save = agent_seg.SegmentationAgent.save_outputs

    def saving(self, data):
        log.append(('save', os.path.basename(agent_seg._name_of(data))))
        return save(self, data)
    monkeypatch.setattr(agent_seg.SegmentationAgent, 'save_outputs', saving)
    return log


D, F = 'dispatch', 'fetch'
CASES = ['case{0}.nii.gz'.format(i) for i in range(3)]


@pytest.mark.parametrize('path,want', [
    ('label', [(D, 0), (D, 1), (F, 0), ('save', CASES[0]), (D, 2), (F, 1),
               ('save', CASES[1]), (F, 2), ('save', CASES[2])]),
    # loader batches [case0, case1] (one batched dispatch) and [case2]
    ('batch2', [(D, 0), (D, 1), (F, 0), ('save', CASES[0]),
                ('save', CASES[1]), (F, 1), ('save', CASES[2])]),
    ('fpl', [(D, 0), (D, 1), (F, 0), (D, 2), (F, 1), (F, 2)]),
])
def test_stage_dispatches_before_it_fetches(workspace, recorded, path, want):
    root = workspace
    tag = 'order_' + path
    assert torch_main(['test', stage_cfg(root, path, tag)],
                      device='cpu') == 0
    assert recorded == want


def test_failed_fetch_propagates_and_trace_stops(workspace, recorded,
                                                 monkeypatch):
    """The trace's start and stop are recorded, not run: the test holds
    the loop's ``finally``, ``test_torch_port_profile.py`` the profiler."""
    root = workspace
    monkeypatch.setattr(agent_seg, 'start_trace',
                        lambda *args: recorded.append(('start_trace',)))
    monkeypatch.setattr(agent_seg, 'stop_trace',
                        lambda: recorded.append(('stop_trace',)))
    monkeypatch.setattr(RecordingInferer, 'fail', 1)
    cfg = stage_cfg(root, 'label', 'fail',
                    'profile_dir = {0}/trace_fail'.format(root))
    with pytest.raises(RuntimeError, match='fetch 1 failed'):
        torch_main(['test', cfg], device='cpu')
    assert recorded == [('start_trace',), (D, 0), (D, 1), (F, 0),
                        ('save', CASES[0]), (D, 2), (F, 1), ('stop_trace',)]


@pytest.mark.parametrize('path', ['label', 'batch2', 'fpl'])
def test_pipelined_stage_equals_serial_loop(workspace, monkeypatch, path):
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    root = workspace
    for tag in ('piped', 'serial'):
        if tag == 'serial':
            monkeypatch.setattr(agent_seg.SegmentationAgent, 'infer',
                                serial_infer)
        assert torch_main(['test', stage_cfg(root, path, tag + '_' + path)],
                          device='cpu') == 0
    if path == 'fpl':
        piped, serial = (np.load(os.path.join(root, t + '_fpl.npy'),
                                 allow_pickle=True)
                         for t in ('piped', 'serial'))
        assert piped.shape == (3, 2) and piped.dtype == object
        assert [str(e[1]) for e in piped] == [str(e[1]) for e in serial]
        assert [e[0] for e in piped] == [e[0] for e in serial]
        values = [e[0][0] for e in piped]
        assert values == sorted(values) and 0 < values[0] < 1
        return
    piped, serial = (_labels(root, 'out_{0}_{1}'.format(t, path))
                     for t in ('piped', 'serial'))
    assert list(piped) == list(serial) == CASES
    for name in CASES:
        assert piped[name].shape == (1, 12, 24, 24)
        np.testing.assert_array_equal(piped[name], serial[name])
        assert 0.02 < piped[name].mean() < 0.98, name
