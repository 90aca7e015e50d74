"""PyTorch port, inference engine: the port's sliding window + flip TTA
against JAX ``Inferer.run`` on the same weights and volume.

The 12x40x44 volume with window 8x16x16 and stride 6x12x12 forces clamped
windows in every axis (and duplicate clamped starts in none, by contrast
with the whole-volume case below, which exercises the reflect autopad to a
multiple of 16). Tolerance: logits in f32, atol = rtol = 1e-4 (different
convolution libraries); labels compared exactly between the port's own
output modes.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest

from fpl_plus_tpu.engine.infer import Inferer as JaxInferer
from fpl_plus_torch.engine.infer import (Inferer, dim_start_lists,
                                         window_grid)
from fpl_plus_torch.utils.precision import cast_infer_module
from tests.test_torch_port_models import (SMALL, center_head,  # noqa: F401
                                         jax_and_port, one_torch_thread)

SW = {'sliding_window_enable': True, 'sliding_window_size': [8, 16, 16],
      'sliding_window_stride': [6, 12, 12], 'tta_mode': 1,
      # JAX compile knob (scan-carried accumulation: one small program);
      # the port reads no such key
      'infer_unroll_max': 0}
DOMAIN = 1


class _JaxPredictor:
    def __init__(self, module):
        self.module = module

    def __call__(self, ctx, x):
        return self.module.apply(ctx[0], x, ctx[1], False)


@pytest.fixture(scope='module')
def nets():
    module, variables, net = jax_and_port(SMALL, seed=4)
    probe = np.random.RandomState(20).normal(
        size=(1, 1, 8, 32, 32)).astype(np.float32)
    center_head(variables['params'], net, probe, DOMAIN)
    return module, variables, net


def _run_both(nets, cfg, image):
    module, variables, net = nets
    ref = JaxInferer(dict(cfg, output_mode='logits')).run(
        _JaxPredictor(module), (variables, jnp.int32(DOMAIN)), image)
    got = Inferer(dict(cfg, output_mode='logits'), 'cpu').run(
        lambda x: net(x, DOMAIN), image)
    return np.asarray(ref), got


def test_grid_is_clamped():
    starts = window_grid((12, 40, 44), [8, 16, 16], [6, 12, 12])
    assert dim_start_lists((12, 40, 44), [8, 16, 16], [6, 12, 12]) == (
        (0, 4), (0, 12, 24, 24), (0, 12, 24, 28))
    assert len(starts) == 32 and starts.max(0).tolist() == [4, 24, 28]


def test_sliding_window_tta_matches_jax(nets):
    image = np.random.RandomState(21).normal(
        size=(1, 1, 12, 40, 44)).astype(np.float32)
    ref, got = _run_both(nets, SW, image)
    assert got.shape == ref.shape == (1, 2, 12, 40, 44)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)

    _, _, net = nets
    pred = lambda x: net(x, DOMAIN)   # noqa: E731
    label = Inferer(dict(SW, output_mode='label'), 'cpu').run(pred, image)
    packed = Inferer(dict(SW, output_mode='packed_label'), 'cpu').run(
        pred, image)
    prob = Inferer(dict(SW, output_mode='prob'), 'cpu').run(pred, image)
    assert label.dtype == np.uint8 and label.shape == (1, 12, 40, 44)
    assert 0.2 < label.mean() < 0.8        # both classes present
    np.testing.assert_array_equal(packed, label)
    np.testing.assert_array_equal(label[0], np.argmax(got[0], 0))
    np.testing.assert_allclose(prob.sum(1), 1.0, rtol=1e-5)
    # bf16 serving: host-cast volume, bf16 params, f32 accumulation
    net16 = cast_infer_module(copy.deepcopy(net), 'bfloat16')
    bf16 = Inferer(dict(SW, output_mode='logits', precision='bfloat16'),
                   'cpu').run(lambda x: net16(x, DOMAIN), image)
    assert bf16.dtype == np.float32 and np.isfinite(bf16).all()
    assert np.mean(np.argmax(bf16[0], 0) == label[0]) > 0.95


def test_whole_volume_autopad_matches_jax(nets):
    # 12x24x20 pads (reflect) to 16x32x32, then crops back
    image = np.random.RandomState(22).normal(
        size=(1, 1, 12, 24, 20)).astype(np.float32)
    ref, got = _run_both(nets, {'sliding_window_enable': False,
                                'tta_mode': 1}, image)
    assert got.shape == ref.shape == (1, 2, 12, 24, 20)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
