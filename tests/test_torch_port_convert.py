"""PyTorch port, the JAX-checkpoint converter (``utils/flax_msgpack.py``,
``utils/convert.py`` ``convert_jax_checkpoint``, ``cli convert``).

* The first-party msgpack reader against ``flax.serialization.
  msgpack_restore`` on the same bytes: every leaf equal, with its dtype
  (f32, f64, the integer widths, bool, bf16 bits, numpy scalars, and the
  16- and 32-bit container, string and extension forms); the committed
  fixture ``tests/data/jax_ckpt/jax_3.ckpt`` (written by
  ``tools/make_jax_ckpt_fixture.py``) likewise, and its conversion
  against the JAX logits stored beside it (no compile).
* The JAX package's ``save_checkpoint`` of a narrow UNet2D5_dsbn (with a
  discriminator) and of a zoo UNet2D (with an EMA teacher), variables from
  ``jax.eval_shape`` of the init filled from a numpy seed, then ``cli
  convert``, then the port's eval forward against JAX's: within 1e-5 at
  f32 (one jitted forward per net: the file's two JAX compiles).
* The reader raises on what it does not read: an unknown extension code,
  complex numbers, flax's chunked arrays, an unused type byte.
"""
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from fpl_plus_tpu.engine.ckpt import save_checkpoint as jax_save
from fpl_plus_tpu.models.registry import create_network as jax_create
from fpl_plus_tpu.models.unet2d5_dsbn import Dis as JaxDis
from fpl_plus_torch.agents.ssl import EMATeacher
from fpl_plus_torch.cli import shell
from fpl_plus_torch.config.parser import parse_config
from fpl_plus_torch.engine.ckpt import load_checkpoint
from fpl_plus_torch.models.registry import create_network
from fpl_plus_torch.models.unet2d5_dsbn import Dis
from fpl_plus_torch.utils.flax_msgpack import unpackb
from tests.test_torch_port_models import one_torch_thread  # noqa: F401
from tests.test_torch_port_zoo import random_variables

FIXTURE = 'tests/data/jax_ckpt'


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for key in sorted(tree, key=str):
            yield from leaves(tree[key], path + (key,))
    elif isinstance(tree, list):
        for i, value in enumerate(tree):
            yield from leaves(value, path + (i,))
    else:
        yield path, tree


def assert_same_tree(got, want):
    """Every leaf equal, with the same numpy dtype; bf16 by its bits."""
    got, want = list(leaves(got)), list(leaves(want))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        if isinstance(g, torch.Tensor):
            assert g.dtype == torch.bfloat16 and w.dtype.name == 'bfloat16'
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          np.asarray(w).view(np.int16))
        elif isinstance(w, (np.ndarray, np.generic)):
            assert np.asarray(g).dtype == w.dtype, path
            np.testing.assert_array_equal(g, w, err_msg=str(path))
        else:
            assert type(g) is type(w) and g == w, path


def test_reader_matches_msgpack_restore():
    rs = np.random.RandomState(3)
    tree = {
        'f32': rs.normal(size=(3, 4)).astype(np.float32),
        'big': rs.normal(size=(64, 64, 8)).astype(np.float32),   # ext32
        'f64': rs.normal(size=(5,)), 'i8': np.arange(-4, 4, dtype=np.int8),
        'i32': np.arange(12, dtype=np.int32).reshape(3, 4),
        'u16': np.arange(7, dtype=np.uint16), 'i64': np.int64([-2 ** 40]),
        'bool': np.array([True, False]), 'empty': np.zeros((0, 3),
                                                           np.float32),
        'bf16': rs.normal(size=(2, 5)).astype(jnp.bfloat16),
        'scalars': {'f32': np.float32(1.5), 'i32': np.int32(-7),
                    'bf16': np.array(0.75, jnp.bfloat16)[()]},
        'py': [0, 127, 128, -1, -32, -33, 255, 65535, 2 ** 32, -2 ** 63,
               0.25, True, False, None, 'x' * 40, b'\x00\x01'],
        'many': {str(i): np.float32(i) for i in range(20)},     # map16
        'list16': list(range(20)),                               # array16
        'nested': {'': {}, 'a': {'b': {'c': np.ones((2, 2, 2),
                                                    np.float32)}}},
    }
    data = serialization.msgpack_serialize(tree)
    assert_same_tree(unpackb(data), serialization.msgpack_restore(data))


def test_fixture_decodes_and_converts_to_the_jax_logits(tmp_path):
    """The committed JAX checkpoint (an optax Adam state included) decodes
    to the tree flax restores; converted, its forward gives the logits JAX
    gave (``window.npz``) within 1e-5, on both DSBN banks."""
    with open(FIXTURE + '/jax_3.ckpt', 'rb') as f:
        data = f.read()
    assert_same_tree(unpackb(data), serialization.msgpack_restore(data))
    out = tmp_path / 'conv_3.pt'
    assert shell(['convert', FIXTURE + '/jax_3.ckpt', FIXTURE + '/net.cfg',
                  str(out)]) == 0
    assert (tmp_path / 'conv_latest.txt').read_text() == '3'
    ckpt = load_checkpoint(str(out))
    assert ckpt['iteration'] == 3 and ckpt['valid_pred'] == 0.5
    assert 'optimizer_state_dict' not in ckpt
    net = create_network(parse_config(FIXTURE + '/net.cfg')['network'])
    net.load_state_dict(ckpt['model_state_dict'], strict=True)
    window = np.load(FIXTURE + '/window.npz')
    with torch.inference_mode():
        for domain in (0, 1):
            got = net.eval()(torch.from_numpy(window['x']), domain).numpy()
            np.testing.assert_allclose(
                got, window['logits_d{0}'.format(domain)], rtol=1e-5,
                atol=1e-5)


NET5 = {'net_type': 'UNet2D5_dsbn', 'num_domains': 2, 'class_num': 2,
        'in_chns': 1, 'feature_chns': [4, 8, 8, 16, 16],
        'conv_dims': [2, 2, 3, 3, 3], 'dropout': [0.0, 0.0, 0.3, 0.4, 0.5],
        'bilinear': False}
ZOO = {'net_type': 'UNet2D', 'in_chns': 1, 'class_num': 2,
       'feature_chns': [4, 8, 8, 16], 'dropout': [0.0, 0.0, 0.3, 0.4],
       'bilinear': False}


def write_cfg(path, net_cfg):
    path.write_text('[network]\n' + ''.join(
        '{0} = {1}\n'.format(k, v) for k, v in net_cfg.items()))
    return str(path)


@pytest.mark.parametrize('case', ['UNet2D5_dsbn+dis', 'UNet2D+teacher'])
def test_jax_checkpoint_converts_to_the_same_forward(case, tmp_path):
    net_cfg = NET5 if case.startswith('UNet2D5') else ZOO
    x = np.random.RandomState(8).normal(
        size=(1, 1, 8, 32, 32) if net_cfg is NET5 else (2, 1, 16, 24)
    ).astype(np.float32)
    x_cl = np.moveaxis(x, 1, -1)
    module = jax_create(net_cfg)
    params, stats = random_variables(module, x_cl, seed=4)
    state = {'params': params, 'batch_stats': stats,
             'opt_state': {'0': {'count': np.int32(7)}, '1': {}}}
    if case.endswith('dis'):
        dis_shapes = jax.eval_shape(lambda: JaxDis().init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8, 32, 32, 2))))['params']
        rs = np.random.RandomState(9)
        state['extra'] = {'dis_params': jax.tree_util.tree_map(
            lambda s: rs.normal(0, 0.02, s.shape).astype(np.float32),
            dis_shapes), 'dis_opt': {}}
    else:
        state['extra'] = jax.tree_util.tree_map(lambda p: p * 0.5, params)
    src = jax_save(str(tmp_path / 'jax'), 'gen', 12, state, 0.25)
    out = tmp_path / 'port' / 'gen_12.pt'
    assert shell(['convert', src, write_cfg(tmp_path / 'net.cfg', net_cfg),
                  str(out)]) == 0
    ckpt = load_checkpoint(str(out))
    net = create_network(net_cfg)
    net.load_state_dict(ckpt['model_state_dict'], strict=True)
    if case.endswith('dis'):
        Dis(2).load_state_dict(ckpt['dis_state_dict'], strict=True)
        fwd = jax.jit(lambda v, xx: module.apply(v, xx, 1, False))
        with torch.inference_mode():
            got = net.eval()(torch.from_numpy(x), 1).numpy()
    else:
        teacher = EMATeacher(net, 0.99)
        teacher.load_state_dict(ckpt['ema_state_dict'])
        torch.testing.assert_close(
            teacher.params['decoder.out_conv.weight'],
            net.state_dict()['decoder.out_conv.weight'] * 0.5)
        fwd = jax.jit(lambda v, xx: module.apply(v, xx, 0, False))
        with torch.inference_mode():
            got = net.eval()(torch.from_numpy(x)).numpy()
    want = np.moveaxis(np.asarray(fwd({'params': params,
                                       'batch_stats': stats},
                                      jnp.asarray(x_cl))), -1, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('case', ['ext7', 'complex', 'chunked', 'c1'])
def test_reader_raises_on_what_it_does_not_read(case):
    if case == 'ext7':
        data = msgpack.packb({'a': msgpack.ExtType(7, b'xyz')})
        match = 'extension code 7'
    elif case == 'complex':
        data = serialization.msgpack_serialize({'z': 1 + 2j})
        match = 'extension code 2'
    elif case == 'chunked':
        data = msgpack.packb({'w': {'__msgpack_chunked_array__': True,
                                    'shape': [2]}})
        match = 'chunked'
    else:
        data = b'\x81\xa1a\xc1'
        match = 'type byte 0xc1'
    with pytest.raises(ValueError, match=match):
        unpackb(data)
