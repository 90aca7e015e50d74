"""PyTorch port, the network zoo: every segmentation net of the registry
other than the UNet2D5 pair and ``Dis`` (held in
``tests/test_torch_port_models.py`` and ``tests/test_torch_port_dis.py``)
in eval mode against its flax network through ``state_dict_from_flax``,
and the CCT perturbations.

JAX variables come without a compile: ``jax.eval_shape`` of the flax init
gives the tree, which is filled from a numpy seed at a trained net's
scales (He-normal kernels, BatchNorm affine near identity, running
statistics away from 0/1). Each case jits one forward. The 2D nets take a
2.5D input (depth folds into the batch) except where a case says 2D.
Tolerance: f32, atol = rtol = 1e-4 (two convolution libraries summing in
different orders through up to ~40 layers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpl_plus_tpu.models.registry import SegNetDict as JaxSegNetDict
from fpl_plus_tpu.models.registry import create_network as jax_create
from fpl_plus_torch.models.registry import NETS_3D, SegNetDict, create_network
from fpl_plus_torch.models.unet2d import (feature_dropout, feature_noise,
                                          row_quantile)
from fpl_plus_torch.utils.convert import state_dict_from_flax
from tests.test_torch_port_models import one_torch_thread  # noqa: F401

L4 = {'feature_chns': [4, 8, 8, 16], 'dropout': [0.0, 0.0, 0.3, 0.4]}
L5 = {'feature_chns': [4, 8, 8, 16, 16],
      'dropout': [0.0, 0.0, 0.3, 0.4, 0.5]}
X25 = (2, 1, 3, 32, 32)

# id: (net_type, extra [network] keys, levels, input shape [N, C, *sp])
CASES = {
    'UNet2D-ds': ('UNet2D', {'deep_supervise': True}, L5, X25),
    'UNet2D-deconv-2d': ('UNet2D', {'bilinear': False}, L4, (2, 1, 16, 24)),
    'UNet2D_ScSE': ('UNet2D_ScSE', {}, L4, X25),
    'UNet2D_DualBranch': ('UNet2D_DualBranch', {}, L4, X25),
    'UNet2D_URPC': ('UNet2D_URPC', {}, L5, X25),
    'UNet2D_URPC-shallow-2d': ('UNet2D_URPC', {}, L4, (2, 1, 16, 16)),
    'UNet2D_CCT': ('UNet2D_CCT', {}, L4, X25),
    'AttentionUNet2D-deconv': ('AttentionUNet2D', {'bilinear': False}, L4,
                               X25),
    'NestedUNet2D': ('NestedUNet2D', {}, L4, X25),
    'COPLENet': ('COPLENet', {}, L4, X25),
    'UNet3D-ds': ('UNet3D', {'deep_supervise': True}, L4, (1, 1, 8, 16, 16)),
    'UNet3D-deconv': ('UNet3D', {'trilinear': False}, L5,
                      (1, 1, 16, 16, 16)),
    'UNet3D_ScSE': ('UNet3D_ScSE', {}, L4, (1, 1, 8, 16, 16)),
    'AEs': ('AEs', {}, L4, (1, 1, 4, 8, 8)),
}


def net_cfg(case):
    net_type, extra, levels, _ = CASES[case]
    return dict({'net_type': net_type, 'in_chns': 1, 'class_num': 2},
                **levels, **extra)


def random_variables(module, x_cl, seed, call_args=(0, True)):
    """Flax ``(params, batch_stats)`` of ``module`` for input ``x_cl``
    (shapes from ``jax.eval_shape`` of the init, no compile), filled from
    a numpy seed."""
    rngs = {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda: module.init(
        rngs, jnp.zeros(x_cl.shape, jnp.float32), *call_args))
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        key = path[-1].key
        shape = leaf.shape
        if key == 'kernel':
            fan_in = int(np.prod(shape[:-1]))
            return rs.normal(0, (2.0 / fan_in) ** 0.5, shape)
        if key == 'scale':
            return rs.uniform(0.8, 1.2, shape)
        if key == 'var':
            return rs.uniform(0.5, 1.5, shape)
        return rs.normal(0, 0.1, shape)           # bias, mean

    variables = jax.tree_util.tree_map_with_path(
        lambda p, l: fill(p, l).astype(np.float32), shapes)
    return variables['params'], variables.get('batch_stats', {})


def jax_and_port(case, seed=5):
    cfg = net_cfg(case)
    x = np.random.RandomState(seed + 1).normal(
        size=CASES[case][3]).astype(np.float32)
    x_cl = np.moveaxis(x, 1, -1)
    module = jax_create(cfg)
    aes = cfg['net_type'] == 'AEs'
    params, stats = random_variables(module, x_cl, seed,
                                     () if aes else (0, True))
    net = create_network(cfg)
    net.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    variables = {'params': params, 'batch_stats': stats}
    return module, variables, net.eval(), x, x_cl


def _as_list(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


@pytest.mark.parametrize('case', sorted(CASES))
def test_eval_forward_matches_flax(case):
    module, variables, net, x, x_cl = jax_and_port(case)
    if CASES[case][0] == 'AEs':
        fwd = jax.jit(lambda v, xx: module.apply({'params': v['params']}, xx))
    else:
        fwd = jax.jit(lambda v, xx: module.apply(v, xx, 0, False))
    ref = [np.moveaxis(np.asarray(o), -1, 1)
           for o in _as_list(fwd(variables, jnp.asarray(x_cl)))]
    with torch.inference_mode():
        got = [o.numpy() for o in _as_list(net(torch.from_numpy(x)))]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4)
    spatial = x.shape[2:]
    if case.startswith(('UNet2D-ds', 'UNet3D-ds')):
        assert len(got) == 4 and all(g.shape[2:] == spatial for g in got)
    if case.startswith('UNet2D_URPC'):
        # p_l at scale 1/2^l of H and W; a 2.5D depth is never scaled
        assert [g.shape[-2:] for g in got] == [
            (spatial[-2] >> lvl, spatial[-1] >> lvl) for lvl in range(4)]
    if case == 'UNet2D_DualBranch':
        # eval: the mean of the two branches; train: both
        net.train()
        with torch.no_grad():
            pair = net(torch.from_numpy(x))
        assert len(pair) == 2 and pair[0].shape == got[0].shape


def test_registry_matches_jax():
    """Every JAX network, and the port's own beside them: Swin UNETR
    (``models/swin_unetr.py``), which the JAX package lacks."""
    port_only = {'SwinUNETR'}
    assert sorted(SegNetDict) == sorted(set(JaxSegNetDict) | port_only)
    from fpl_plus_tpu.models.registry import NETS_3D as JAX_NETS_3D
    assert NETS_3D == JAX_NETS_3D | port_only


def test_cct_modes_and_perturbations():
    """Eval: the main decoder's output. Train: [main, 3 aux], drawn from
    the generators only (same generators, same outputs), and refused
    without them. The perturbations against JAX's ``_feature_dropout`` /
    ``_feature_noise`` with the draws those make, and the quantile against
    numpy's."""
    from fpl_plus_tpu.models.unet2d import _feature_dropout, _feature_noise
    torch.manual_seed(0)
    net = create_network(net_cfg('UNet2D_CCT'))
    x = torch.from_numpy(np.random.RandomState(3).normal(
        size=(2, 1, 2, 16, 16)).astype(np.float32))
    net.eval()
    with torch.no_grad():
        main = net(x)
        feats = net.encoder(x.permute(0, 2, 1, 3, 4).reshape(4, 1, 16, 16))
        want = net.main_decoder(feats).reshape(2, 2, 2, 16, 16)
    torch.testing.assert_close(main, want.permute(0, 2, 1, 3, 4))
    net.train()
    with pytest.raises(ValueError, match='dropout_generators'):
        net(x)
    with torch.no_grad():
        outs = [net(x, 0, [torch.Generator().manual_seed(7)])
                for _ in range(2)]
        other = net(x, 0, [torch.Generator().manual_seed(8)])
    assert len(outs[0]) == 4
    assert all(o.shape == main.shape for o in outs[0])
    for a, b, c in zip(outs[0], outs[1], other):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(outs[0][3], other[3])

    rs = np.random.RandomState(4)
    bott = rs.normal(size=(3, 6, 5, 7)).astype(np.float32)
    bott_cl = jnp.asarray(np.moveaxis(bott, 1, -1))
    r1, r2 = jax.random.split(jax.random.PRNGKey(11))
    q = float(jax.random.uniform(r1, (), minval=0.7, maxval=0.9))
    want = np.moveaxis(np.asarray(_feature_dropout(bott_cl, r1)), -1, 1)
    got = feature_dropout(torch.from_numpy(bott),
                          torch.full((3,), q)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.05 < float(np.mean(got == 0)) < 0.4
    noise = np.moveaxis(np.array(jax.random.uniform(
        r2, bott_cl.shape, jnp.float32, -0.3, 0.3)), -1, 1)
    want = np.moveaxis(np.asarray(_feature_noise(bott_cl, r2)), -1, 1)
    got = feature_noise(torch.from_numpy(bott), torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    flat = rs.normal(size=(4, 35)).astype(np.float32)
    qs = np.float32([0.7, 0.75, 0.8, 0.9])
    np.testing.assert_allclose(
        row_quantile(torch.from_numpy(flat), torch.from_numpy(qs)).numpy(),
        [np.quantile(r, qq) for r, qq in zip(flat, qs)], rtol=1e-6)
