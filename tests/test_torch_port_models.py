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
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpl_plus_tpu.models.registry import (create_network as jax_create,
                                          param_count)
from fpl_plus_torch.models.registry import create_network, param_count as \
    torch_param_count
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
