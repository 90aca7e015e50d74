"""PyTorch port, models: UNet2D5_dsbn / UNet2D5 eval forward through the
weight bridge against the flax network.

JAX variables from the flax initialiser (``init_network``'s call under one
``jax.jit``, so a file costs a handful of compiles instead of one per op;
DSBN statistics are then overwritten with random values — the init
statistics are trivially 0/1) go through
``state_dict_from_jax`` into the port with ``load_state_dict(strict=True)``.
Inputs are made with numpy from a seed. Tolerance: f32, atol = rtol = 1e-4
(two convolution libraries summing in different orders over ~20 layers).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpl_plus_tpu.models.registry import (create_network as jax_create,
                                          param_count)
from fpl_plus_torch.models.common import grouped_dropout
from fpl_plus_torch.models.dsbn import DomainBatchNorm
from fpl_plus_torch.models.multi_net import make_binet
from fpl_plus_torch.models.registry import create_network, param_count as \
    torch_param_count
from fpl_plus_torch.models.unet2d5_dsbn import ConvBlockND
from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
from fpl_plus_torch.utils.convert import state_dict_from_jax

SMALL = {'net_type': 'UNet2D5_dsbn', 'num_domains': 2, 'class_num': 2,
         'in_chns': 1, 'feature_chns': [4, 8, 16, 16, 32],
         'conv_dims': [2, 2, 3, 3, 3], 'dropout': [0, 0, 0.3, 0.4, 0.5],
         'bilinear': False}
NET_CFG = {'net_type': 'UNet2D5_dsbn', 'num_domains': 2, 'class_num': 2,
           'in_chns': 1, 'feature_chns': [32, 64, 128, 256, 512],
           'conv_dims': [2, 2, 3, 3, 3],
           'dropout': [0.0, 0.0, 0.3, 0.4, 0.5], 'bilinear': False}


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """The port's tiny CPU forwards need no thread pool; a full one per
    test worker only contends with the JAX compiles beside it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randomize_stats(batch_stats, seed):
    """Replace every DSBN mean/var with seeded random values."""
    rs = np.random.RandomState(seed)

    def f(path, leaf):
        if path[-1].key == 'var':
            return rs.uniform(0.5, 2.0, np.shape(leaf)).astype(np.float32)
        return rs.normal(0, 0.5, np.shape(leaf)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, batch_stats)


def jax_init(module, seed):
    """``init_network(module, cfg, seed)`` for the 3D nets, jitted."""
    rngs = {'params': jax.random.PRNGKey(seed),
            'dropout': jax.random.PRNGKey(seed + 1)}
    variables = jax.jit(lambda: module.init(
        rngs, jnp.zeros((1, 8, 32, 32, 1), jnp.float32), 0, True))()
    return variables['params'], variables['batch_stats']


def center_head(params, net, probe, domain=1):
    """Shift the two-class head's bias (in the JAX params and the port net
    alike) so that the class-1 minus class-0 logit has median 0 on
    ``probe``: random weights alone label nearly every voxel background,
    which would leave label comparisons vacuous."""
    with torch.inference_mode():
        out = net(torch.from_numpy(probe), domain).numpy()
    m = float(np.median(out[:, 1] - out[:, 0]))
    bias = np.asarray(params['out_conv']['bias']) + np.float32([m, -m]) / 2
    params['out_conv']['bias'] = bias
    net.out_conv.bias.data = torch.from_numpy(bias.copy())


def jax_and_port(cfg, seed=3):
    module = jax_create(cfg)
    params, stats = jax_init(module, seed)
    stats = randomize_stats(stats, seed)
    net = create_network(cfg)
    net.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), stats, cfg), strict=True)
    return module, {'params': params, 'batch_stats': stats}, net.eval()


@pytest.mark.parametrize('net_type,bilinear,depth', [
    ('UNet2D5_dsbn', False, 8),
    # depth 4 leaves one slice at the bottom level: the align-corners
    # upsample of a length-1 axis (a repeat) is exercised
    ('UNet2D5_dsbn', True, 4),
    ('UNet2D5', False, 8),
])
def test_forward_matches_flax(net_type, bilinear, depth):
    cfg = dict(SMALL, net_type=net_type, bilinear=bilinear)
    if net_type == 'UNet2D5':
        cfg.pop('num_domains')
    module, variables, net = jax_and_port(cfg)
    x = np.random.RandomState(11).normal(
        size=(2, 1, depth, 32, 32)).astype(np.float32)
    fwd = jax.jit(lambda v, xx, d: module.apply(v, xx, d, False))
    for domain in (0, 1):
        ref = np.moveaxis(np.asarray(fwd(variables, jnp.asarray(
            np.moveaxis(x, 1, -1)), jnp.int32(domain))), -1, 1)
        with torch.inference_mode():
            got = net(torch.from_numpy(x), domain).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_param_count_matches_jax_at_net_cfg():
    module = jax_create(NET_CFG)
    shapes = jax.eval_shape(lambda: module.init(
        {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1)},
        jnp.zeros((1, 8, 32, 32, 1)), 0, True))
    with torch.device('meta'):
        net = create_network(NET_CFG)
    assert torch_param_count(net) == param_count(shapes['params']) \
        == 22140628


def test_dsbn_train_mode_and_unported_nets_raise():
    """The errors that remain: DSBN's out-of-range domain and an undefined
    network (every name of the JAX registry builds)."""
    net = create_network(SMALL)
    net.train()
    with pytest.raises(ValueError, match='outside'):
        net(torch.zeros(1, 1, 8, 32, 32), 2)
    with pytest.raises(ValueError, match='Undefined network'):
        create_network(dict(SMALL, net_type='NoSuchNet'))
    # pallas_fused / flat25d are accepted and change nothing
    create_network(dict(SMALL, pallas_fused=True, flat25d=True))


def _unfolded_forward(block, x, domain, dropout_generators=None):
    """``ConvBlockND.forward`` as it was before the bias fold: every
    convolution module adds its own bias, and DSBN gets none."""
    for j, names in enumerate(block._names):
        conv, bn, relu = (getattr(block, n) for n in names)
        if j == 1:
            x = grouped_dropout(x, block.dropout_p, dropout_generators)
        x = bn(conv(x), domain, relu.weight)
    return x


def _seeded_net(net_type, seed=4):
    cfg = dict(SMALL, feature_chns=[2, 4, 4, 8, 8])
    net = make_binet(cfg) if net_type == 'BiNet' else create_network(
        dict(cfg, net_type=net_type))
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, b in net.named_buffers():
            if name.endswith('running_mean'):
                b.copy_(torch.randn(b.shape, generator=gen) * 0.5)
            elif name.endswith('running_var'):
                b.copy_(torch.rand(b.shape, generator=gen) + 0.5)
    return net


@pytest.mark.parametrize('net_type,folds', [
    ('UNet2D5_dsbn', 18), ('UNet2D5', 18), ('BiNet', 36)])
def test_eval_forward_folds_each_dsbn_conv_bias(monkeypatch, net_type,
                                                folds):
    """An eval forward hands each DSBN convolution's bias to the DSBN+PReLU
    call (one fold per launch on the card) and computes what the convolution
    modules with their bias computed, to the rounding of where the CPU
    convolution adds its bias."""
    net = _seeded_net(net_type).eval()
    x = torch.from_numpy(np.random.RandomState(12).normal(
        size=(2, 1, 8, 32, 32)).astype(np.float32))
    before = dsbn_prelu.bias_folds
    with torch.inference_mode():
        got = net(x, 1)
    assert dsbn_prelu.bias_folds - before == folds
    monkeypatch.setattr(ConvBlockND, 'forward', _unfolded_forward)
    with torch.inference_mode():
        want = net(x, 1)
    assert dsbn_prelu.bias_folds - before == folds
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_train_forward_keeps_the_conv_bias_bit_for_bit(monkeypatch):
    """Train mode folds nothing: outputs and running statistics equal those
    of the convolution modules adding their own bias, bit for bit."""
    net = _seeded_net('UNet2D5_dsbn').train()
    twin = copy.deepcopy(net)
    x = torch.from_numpy(np.random.RandomState(13).normal(
        size=(2, 1, 8, 32, 32)).astype(np.float32))
    before = dsbn_prelu.bias_folds
    got = net(x, 1, [torch.Generator().manual_seed(5)])
    assert dsbn_prelu.bias_folds == before
    monkeypatch.setattr(ConvBlockND, 'forward', _unfolded_forward)
    want = twin(x, 1, [torch.Generator().manual_seed(5)])
    assert torch.equal(got, want)
    for (name, a), (_, b) in zip(net.named_buffers(), twin.named_buffers()):
        assert torch.equal(a, b), name


def test_dsbn_conv_bias_is_added_before_the_norm():
    """``DomainBatchNorm``'s ``conv_bias`` is the preceding convolution's
    bias: in eval mode the result equals that of the module on
    ``x + conv_bias``, bit for bit, and the statistics stay as they were."""
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((2, 4, 3, 5, 5), generator=gen)
    cb = torch.randn(4, generator=gen)
    alpha = torch.tensor([0.25])
    bn = DomainBatchNorm(4, 2).eval()
    with torch.no_grad():
        bn.bns[1].running_mean.copy_(torch.randn(4, generator=gen))
    twin = copy.deepcopy(bn)
    got = bn(x, 1, alpha, cb)
    want = twin(x + cb.reshape(1, -1, 1, 1, 1), 1, alpha)
    assert torch.equal(got, want)
    for (name, a), (_, b) in zip(bn.named_buffers(), twin.named_buffers()):
        assert torch.equal(a, b), name


def test_dsbn_train_mode_refuses_a_conv_bias():
    """In train mode the convolution adds its own bias (the running mean
    tracks the biased activation), so a ``conv_bias`` is refused there and
    the bank is left as it was."""
    bn = DomainBatchNorm(4, 2).train()
    with pytest.raises(ValueError, match='eval mode only'):
        bn(torch.randn(2, 4, 3, 5, 5), 1, torch.tensor([0.25]),
           torch.zeros(4))
    assert int(bn.bns[1].num_batches_tracked) == 0


def randomize_dsbn_conv_bias(params, seed):
    """Replace the bias of every convolution that a DSBN follows (flax
    initialises it to zero) with seeded random values."""
    rs = np.random.RandomState(seed)

    def f(path, leaf):
        keys = [getattr(k, 'key', None) for k in path]
        if keys[-1] == 'bias' and keys[-2] in ('conv1', 'conv2'):
            return rs.normal(0, 0.5, np.shape(leaf)).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(f, params)


@pytest.mark.parametrize('net_type', ['UNet2D5_dsbn', 'UNet2D5'])
def test_forward_with_conv_biases_matches_flax(net_type):
    """The folded bias enters where flax adds it, before the normalisation:
    with every DSBN convolution's bias drawn from a seed, the port's eval
    forward (18 folds) matches the flax network's."""
    cfg = dict(SMALL, net_type=net_type)
    if net_type == 'UNet2D5':
        cfg.pop('num_domains')
    module = jax_create(cfg)
    params, stats = jax_init(module, 5)
    params = randomize_dsbn_conv_bias(params, 5)
    stats = randomize_stats(stats, 5)
    net = create_network(cfg)
    net.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), stats, cfg), strict=True)
    net.eval()
    folded = [getattr(m, names[0]).bias for m in net.modules()
              if isinstance(m, ConvBlockND) for names in m._names]
    assert len(folded) == 18
    assert all(bool(b.abs().min() > 0) for b in folded)
    variables = {'params': params, 'batch_stats': stats}
    x = np.random.RandomState(14).normal(
        size=(2, 1, 8, 32, 32)).astype(np.float32)
    fwd = jax.jit(lambda v, xx, d: module.apply(v, xx, d, False))
    domains = (0, 1) if net_type == 'UNet2D5_dsbn' else (0,)
    for domain in domains:
        ref = np.moveaxis(np.asarray(fwd(variables, jnp.asarray(
            np.moveaxis(x, 1, -1)), jnp.int32(domain))), -1, 1)
        before = dsbn_prelu.bias_folds
        with torch.inference_mode():
            got = net(torch.from_numpy(x), domain).numpy()
        assert dsbn_prelu.bias_folds - before == 18
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
