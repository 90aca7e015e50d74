"""PyTorch port, the peer networks (``models/multi_net.py``): a BiNet or
TriNet of a registry net against the flax ``MultiNet`` through
``state_dict_from_multinet``, whose peer scopes are read off
``jax.eval_shape`` of the flax init (the tree is filled from a numpy seed:
no init compile). Eval mode: the peers' primary heads averaged over N.
Train mode: the tuple of the peers' outputs, each its own net's. 2.5D
input, f32, atol = rtol = 1e-4 (two convolution libraries).
"""
import jax
import numpy as np
import pytest
import torch

from fpl_plus_torch.models.multi_net import make_binet, make_trinet
from fpl_plus_torch.utils.convert import state_dict_from_multinet
from tests.test_torch_port_models import one_torch_thread  # noqa: F401
from tests.test_torch_port_zoo import random_variables

CASES = {
    'BiNet-UNet2D': (2, {'net_type': 'UNet2D', 'feature_chns': [4, 8, 8, 16],
                         'dropout': [0.0, 0.0, 0.3, 0.4]}),
    'TriNet-UNet2D_URPC': (3, {'net_type': 'UNet2D_URPC',
                               'feature_chns': [4, 8, 8, 16],
                               'dropout': [0.0, 0.0, 0.3, 0.4]}),
    'BiNet-UNet2D5': (2, {'net_type': 'UNet2D5', 'num_domains': 1,
                          'feature_chns': [2, 4, 4, 8, 8],
                          'conv_dims': [2, 2, 3, 3, 3],
                          'dropout': [0.0, 0.0, 0.3, 0.4, 0.5]}),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_multinet_matches_flax(case):
    from fpl_plus_tpu.models.multi_net import make_binet as jax_binet
    from fpl_plus_tpu.models.multi_net import make_trinet as jax_trinet
    n_nets, extra = CASES[case]
    cfg = dict({'class_num': 2, 'in_chns': 1}, **extra)
    x = np.random.RandomState(3).normal(size=(2, 1, 8, 16, 16)).astype(
        np.float32)
    x_cl = np.moveaxis(x, 1, -1)
    module = (jax_binet if n_nets == 2 else jax_trinet)(cfg)
    params, stats = random_variables(module, x_cl, seed=9)
    assert len(params) == n_nets
    net = (make_binet if n_nets == 2 else make_trinet)(cfg)
    net.load_state_dict(state_dict_from_multinet(params, stats, cfg),
                        strict=True)
    ref = jax.jit(lambda v, xx: module.apply(v, xx, 0, False))(
        {'params': params, 'batch_stats': stats}, x_cl)
    with torch.inference_mode():
        got = net.eval()(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(),
                                   np.moveaxis(np.asarray(ref), -1, 1),
                                   rtol=1e-4, atol=1e-4)
        peers = [p.eval()(torch.from_numpy(x)) for p in net.nets]
        heads = [p[0] if isinstance(p, list) else p for p in peers]
        torch.testing.assert_close(got, sum(heads) / n_nets)
        net.train()
        pair = net(torch.from_numpy(x), 0, [torch.Generator().manual_seed(1)])
    assert isinstance(pair, tuple) and len(pair) == n_nets
    assert net.draws_in_train == (extra['net_type'] == 'UNet2D_URPC')
