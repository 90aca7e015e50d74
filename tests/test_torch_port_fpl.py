"""PyTorch port, the FPL uncertainty pass, batched serving and
post-processing against the JAX package.

* (a) The device reduction ``fpl_uncertainty_reduce`` against JAX
  ``_fpl_uncertainty_reduce`` on the same fixed logits (K = 2 and 3, nonzero
  margins): two 0-d tensors (f32, int64); ``vars_sum`` to rtol 1e-5 (both
  f32, summed in other orders), ``boundary`` equal.
* (b) With network dropout 0, ``Inferer.run_passes`` (6 folded passes) and
  ``Inferer.run_batch`` (2 volumes) against JAX ``run_passes_async`` /
  ``run_batch`` on the same weights: atol = rtol = 1e-4 (two convolution
  libraries).
* (c) The folded 6-pass run equals 6 sequential single-pass runs with the
  same generator seeds, dropout on: atol = rtol = 1e-5 (one library, other
  batch sizes).
* (d) Dropout statistics: the kept share is within 1% of 1 - p, kept values
  are scaled by 1 / (1 - p), rate 0 draws nothing; the ``fpl = True`` stage
  writes the same ``.npy`` for the same seed and another for another seed.
* (e) The port's ``fpl = True`` stage against the JAX CLI's with network
  dropout 0: the same names, values (atol 1e-6) and order up to ties
  within that tolerance in the ``.npy``; per volume, the same ``boundary``
  count from each side's reduction, and ``vars_sum`` about 0 on both.
  ``test_time_dropout`` and ``post_process`` run through the port's CLI.
* (f) ``KeepLargestComponent`` modes 1 and 2 against the JAX package's on
  random masks and on masks whose two largest components tie in size.

The port's masks come from ``torch.Generator``s and differ from JAX's
threefry masks, so every comparison with JAX runs at dropout 0.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpl_plus_tpu.engine.infer import GroupedMCPredictor as JaxGrouped
from fpl_plus_tpu.engine.infer import Inferer as JaxInferer
from fpl_plus_tpu.engine.infer import _fpl_uncertainty_reduce
from fpl_plus_tpu.utils.post_process import PostKeepLargestComponent as \
    JaxKeepLargest
from fpl_plus_torch.cli import main as torch_main
from fpl_plus_torch.engine.infer import Inferer, fpl_uncertainty_reduce
from fpl_plus_torch.io.image_io import load_image_as_nd_array
from fpl_plus_torch.models.common import grouped_dropout
from fpl_plus_torch.models.registry import create_network
from fpl_plus_torch.utils.image_process import label_connected_components
from fpl_plus_torch.utils.post_process import PostKeepLargestComponent
from tests.test_torch_port_cli import CFG, workspace  # noqa: F401
from tests.test_torch_port_infer import SW, _JaxPredictor
from tests.test_torch_port_models import (SMALL, center_head,  # noqa: F401
                                         jax_and_port, one_torch_thread)

DOMAIN = 1
NO_DROPOUT = dict(SMALL, dropout=[0.0] * 5)


def _gens(seeds):
    return [torch.Generator().manual_seed(int(s)) for s in seeds]


def _mc(net, gens):
    """The network with one dropout generator per contiguous batch group."""
    return functools.partial(net, domain_label=DOMAIN,
                             dropout_generators=gens)


# -- (a) the reduction ------------------------------------------------------

@pytest.mark.parametrize('k', [2, 3])
def test_reduction_matches_jax(k):
    rs = np.random.RandomState(30 + k)
    logits = (rs.normal(size=(6, k, 10, 12, 14)) * 2).astype(np.float32)
    lo, up = [1, 2, 0], [2, 0, 3]
    vars_j, boundary_j = _fpl_uncertainty_reduce(
        jnp.asarray(np.moveaxis(logits, 1, -1)), jnp.asarray(lo, jnp.int32),
        jnp.asarray(up, jnp.int32))
    vars_t, boundary_t = fpl_uncertainty_reduce(torch.from_numpy(logits),
                                                lo, up)
    # two 0-d tensors on the logits' device, read by the caller's fetch
    assert vars_t.shape == boundary_t.shape == ()
    assert (vars_t.dtype, boundary_t.dtype) == (torch.float32, torch.int64)
    vars_t, boundary_t = float(vars_t), int(boundary_t)
    np.testing.assert_allclose(vars_t, float(vars_j), rtol=1e-5)
    assert boundary_t == int(boundary_j)
    # the margins matter: an unmasked reduction counts more voxels
    assert int(fpl_uncertainty_reduce(torch.from_numpy(logits), [0] * 3,
                                      [0] * 3)[1]) > boundary_t > 0


# -- (b) folds against JAX, (c) fold against sequential ---------------------

@pytest.fixture(scope='module')
def nets():
    module, variables, net = jax_and_port(NO_DROPOUT, seed=4)
    probe = np.random.RandomState(20).normal(
        size=(1, 1, 8, 32, 32)).astype(np.float32)
    center_head(variables['params'], net, probe, DOMAIN)
    return module, variables, net


def test_folded_passes_and_batch_match_jax(nets):
    module, variables, net = nets
    rs = np.random.RandomState(23)
    image = rs.normal(size=(1, 1, 12, 40, 44)).astype(np.float32)
    keys = jnp.stack(jax.random.split(jax.random.PRNGKey(0), 6))
    ref = np.asarray(JaxInferer(dict(SW, output_mode='logits'))
                     .run_passes_async(JaxGrouped(module),
                                       (variables, jnp.int32(DOMAIN), keys),
                                       image, 6)())
    got = Inferer(dict(SW, output_mode='logits'), 'cpu').run_passes(
        _mc(net, _gens(range(6))), image, 6)
    assert got.shape == ref.shape == (6, 2, 12, 40, 44)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)

    images = rs.normal(size=(2, 1, 12, 40, 44)).astype(np.float32)
    ref = np.asarray(JaxInferer(dict(SW, output_mode='logits')).run_batch(
        _JaxPredictor(module), (variables, jnp.int32(DOMAIN)), images))
    got = Inferer(dict(SW, output_mode='logits'), 'cpu').run_batch(
        lambda x: net(x, DOMAIN), images)
    assert got.shape == ref.shape == (2, 2, 12, 40, 44)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    # the label head of the batch is the argmax of its logits
    labels = Inferer(dict(SW, output_mode='label'), 'cpu').run_batch(
        lambda x: net(x, DOMAIN), images)
    np.testing.assert_array_equal(labels, np.argmax(got, 1))


@pytest.mark.parametrize('sliding_window', [True, False])
def test_folded_passes_match_sequential(nets, sliding_window):
    _, _, net0 = nets
    net = create_network(SMALL).eval()         # dropout on
    net.load_state_dict(net0.state_dict())
    seeds = [101, 102, 103, 104, 105, 106]
    cfg = dict(SW, output_mode='logits',
               sliding_window_enable=sliding_window)
    # whole volume: 12x24x20 reflect-pads to 16x32x32
    shape = (1, 1, 12, 40, 44) if sliding_window else (1, 1, 12, 24, 20)
    image = np.random.RandomState(24).normal(size=shape).astype(np.float32)
    inferer = Inferer(cfg, 'cpu')
    folded = inferer.run_passes(_mc(net, _gens(seeds)), image, 6)
    seq = [inferer.run(_mc(net, [g]), image) for g in _gens(seeds)]
    assert folded.shape == (6, 2) + shape[2:]
    for i in range(6):
        np.testing.assert_allclose(folded[i], seq[i][0], rtol=1e-5,
                                   atol=1e-5, err_msg='pass {0}'.format(i))
    # passes differ (dropout active, distinct seeds), and differ from none
    assert not np.allclose(folded[0], folded[1])
    plain = inferer.run(lambda x: net(x, DOMAIN), image)
    assert not np.allclose(folded[0], plain[0])


# -- (d) dropout statistics -------------------------------------------------

@pytest.mark.parametrize('p', [0.3, 0.5])
def test_dropout_statistics(p):
    x = torch.ones(6, 8, 16, 16, 16)
    gens = _gens([1, 2, 3])
    y = grouped_dropout(x, p, gens)
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - p)) < 0.01
    assert torch.all(y[kept] == torch.tensor(1 / (1 - p)))
    # each group's mask is its own generator's: group 1 == one pass of it
    g1 = _gens([2])
    np.testing.assert_array_equal(y[2:4].numpy(),
                                  grouped_dropout(x[:2], p, g1).numpy())
    # bf16 stays bf16
    assert grouped_dropout(x.bfloat16(), p, _gens([1])).dtype == \
        torch.bfloat16
    # rate 0 and no generators are the identity and draw nothing
    g = torch.Generator().manual_seed(9)
    state = g.get_state()
    assert grouped_dropout(x, 0.0, [g]) is x
    assert grouped_dropout(x, p, None) is x
    assert torch.equal(g.get_state(), state)
    with pytest.raises(ValueError, match='dropout groups'):
        grouped_dropout(x, p, _gens([1, 2, 3, 4]))


# -- (d), (e) the FPL stage through the CLIs --------------------------------

def _cfg(root, name, out, dropout='0.0, 0.0, 0.3, 0.4, 0.5', seed=1,
         extra=''):
    text = CFG.replace('dropout = [0.0, 0.0, 0.3, 0.4, 0.5]',
                       'dropout = [{0}]'.format(dropout))
    text = text.replace('ckpt_save_dir = {root}/model/gen',
                        'ckpt_save_dir = {root}/model/gen\n'
                        'random_seed = ' + str(seed))
    path = os.path.join(root, name)
    with open(path, 'w') as f:
        f.write(text.format(root=root, out=out, batch=1, extra=extra))
    return path


def _fpl(root, tag):
    return 'fpl = True\nfpl_uncertainty_sorted = {0}/{1}.npy'.format(root,
                                                                    tag)


def _load(root, tag):
    entries = np.load(os.path.join(root, tag + '.npy'), allow_pickle=True)
    return ([str(e[1]) for e in entries],
            np.asarray([float(np.asarray(e[0]).reshape(-1)[0])
                        for e in entries]))


def test_fpl_stage_seeds(workspace):  # noqa: F811
    root = workspace
    for tag, seed in (('s1a', 1), ('s1b', 1), ('s2', 2)):
        assert torch_main(['test', _cfg(root, tag + '.cfg', 'out_' + tag,
                                        seed=seed, extra=_fpl(root, tag))],
                          device='cpu') == 0
    names, a = _load(root, 's1a')
    assert sorted(names) == ['d1/img/case0.nii.gz', 'd1/img/case1.nii.gz',
                             'd1/img/case2.nii.gz']
    assert np.all(np.isfinite(a)) and np.all(np.diff(a) >= 0)
    assert np.all((a > 0) & (a < 1))     # boundary >= 50, dropout varies
    assert _load(root, 's1b')[0] == names
    np.testing.assert_array_equal(_load(root, 's1b')[1], a)
    assert not np.array_equal(np.sort(_load(root, 's2')[1]), np.sort(a))
    # the stage writes no labels
    assert not os.path.isdir(os.path.join(root, 'out_s1a'))


def _recording(fn, sink, wrap):
    def recorded(*args):
        out = fn(*args)
        sink.append(wrap(out))
        return out
    return recorded


def test_fpl_stage_matches_jax_cli(workspace, monkeypatch):  # noqa: F811
    import fpl_plus_tpu.engine.infer as jax_infer
    import fpl_plus_torch.engine.infer as torch_infer
    from fpl_plus_tpu.cli import main as jax_main
    root = workspace
    zero = '0.0, 0.0, 0.0, 0.0, 0.0'
    # the (vars_sum, boundary) each stage's reduction hands its agent
    seen_j, seen_t = [], []
    monkeypatch.setattr(jax_infer, '_fpl_uncertainty_reduce', _recording(
        jax_infer._fpl_uncertainty_reduce, seen_j,
        lambda o: (float(o[0]), int(o[1]))))
    monkeypatch.setattr(torch_infer, 'fpl_uncertainty_reduce', _recording(
        torch_infer.fpl_uncertainty_reduce, seen_t,
        lambda o: (float(o[0]), int(o[1]))))
    assert jax_main(['test', _cfg(root, 'fj.cfg', 'out_fj', dropout=zero,
                                  extra=_fpl(root, 'fj'))]) == 0
    assert torch_main(['test', _cfg(root, 'ft.cfg', 'out_ft', dropout=zero,
                                    extra=_fpl(root, 'ft'))],
                      device='cpu') == 0
    # per volume, in loader order: the same boundary count under the same
    # selection margins, and no variance at dropout 0 (identical passes)
    assert len(seen_j) == len(seen_t) == 3
    assert [b for _, b in seen_t] == [b for _, b in seen_j]
    assert all(b >= 50 for _, b in seen_t)     # vars_sum / boundary rule
    np.testing.assert_allclose([v for v, _ in seen_t],
                               [v for v, _ in seen_j], rtol=0, atol=1e-6)
    names_j, ref = _load(root, 'fj')
    names_t, got = _load(root, 'ft')
    assert sorted(names_t) == sorted(names_j) and len(names_t) == 3
    by_name = dict(zip(names_j, ref))
    np.testing.assert_allclose(got, [by_name[n] for n in names_t], rtol=0,
                               atol=1e-6)
    # the same order up to ties within the tolerance: at dropout 0 the
    # passes agree, and their variance is 0 in the port and rounding noise
    # (~1e-15) in JAX, which orders tied volumes by that noise
    assert np.all(np.diff(got) >= 0)
    assert sorted(zip(np.round(got, 6), names_t)) == \
        sorted(zip(np.round(ref, 6), names_j))
    raw = np.load(os.path.join(root, 'ft.npy'), allow_pickle=True)
    assert raw.dtype == object and raw.shape == (3, 2)
    assert isinstance(raw[0][0], list) and len(raw[0][0]) == 1


def test_dropout_and_post_process_stages(workspace):  # noqa: F811
    """``test_time_dropout`` at network dropout 0 leaves the labels as
    they are; at dropout on it changes some; ``post_process`` equals
    ``KeepLargestComponent`` applied to the plain labels."""
    root = workspace
    zero = '0.0, 0.0, 0.0, 0.0, 0.0'
    runs = {'plain': (zero, ''), 'td0': (zero, 'test_time_dropout = True'),
            'td': ('0.0, 0.0, 0.3, 0.4, 0.5', 'test_time_dropout = True'),
            'pp': (zero, 'post_process = KeepLargestComponent')}
    labels = {}
    for tag, (dropout, extra) in runs.items():
        assert torch_main(['test', _cfg(root, tag + '.cfg', 'out_' + tag,
                                        dropout=dropout, extra=extra)],
                          device='cpu') == 0
        d = os.path.join(root, 'out_' + tag, 'gen_d1_test_img')
        labels[tag] = [load_image_as_nd_array(os.path.join(d, n))[
            'data_array'][0] for n in sorted(os.listdir(d))]
    keep = PostKeepLargestComponent({})
    for i, plain in enumerate(labels['plain']):
        np.testing.assert_array_equal(labels['td0'][i], plain)
        np.testing.assert_array_equal(labels['pp'][i], keep(plain))
    assert any(not np.array_equal(a, b)
               for a, b in zip(labels['td'], labels['plain']))


# -- (f) post-processing ----------------------------------------------------

def _masks(case):
    rs = np.random.RandomState(40)
    if case == 'random3d':
        return (rs.rand(10, 16, 16) > 0.6).astype(np.uint8) * \
            rs.randint(1, 3, (10, 16, 16)).astype(np.uint8)
    if case == 'random2d':
        return (rs.rand(24, 24) > 0.55).astype(np.uint8) * \
            rs.randint(1, 3, (24, 24)).astype(np.uint8)
    # two 3x3x3 components of each class tie for the largest; smaller
    # ones beside them
    seg = np.zeros((8, 16, 16), np.uint8)
    seg[4:7, 9:12, 2:5] = 1
    seg[1:4, 1:4, 1:4] = 1
    seg[1, 8, 8] = 1
    seg[5:8, 1:4, 10:13] = 2
    seg[1:4, 10:13, 10:13] = 2
    seg[6:8, 12:14, 6:7] = 2
    return seg


@pytest.mark.parametrize('mode', [1, 2])
@pytest.mark.parametrize('case', ['random3d', 'random2d', 'tie'])
def test_keep_largest_component_matches_jax(mode, case):
    seg = _masks(case)
    params = {'keeplargestcomponent_mode': mode}
    ref = JaxKeepLargest(params)(seg.copy())
    got = PostKeepLargestComponent(params)(seg.copy())
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    assert 0 < np.count_nonzero(got) < np.count_nonzero(seg)
    if case == 'tie':
        # the first tied component in raster order is the one kept
        assert got[2, 2, 2] > 0 and got[5, 10, 3] == 0
    from fpl_plus_tpu.utils.image_process import \
        label_connected_components as jax_label
    lab_j, n_j = jax_label(seg)
    lab_t, n_t = label_connected_components(seg)
    assert n_t == n_j
    np.testing.assert_array_equal(lab_t, lab_j)
