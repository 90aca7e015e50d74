"""PyTorch port, the FPL stage's host fallback (the test chain's inverse is
not a crop, or ``infer_device_label = False``): per pass the logits cross
back, the inverse transforms and the softmax run on the host, and
``fpl_host_reduce`` gives ``(vars_sum, boundary)``.

* Against the JAX agent: both CLIs run the ``fpl = True`` stage on a
  ``[NormalizeWithMeanStd, CenterCrop]`` chain with the folded passes
  replaced by the same seeded logits (six per volume), so the two
  reductions are fed the same maps; no sliding-window program is compiled.
  Tolerance: the saved uncertainties rtol 1e-6 (the same f32 numpy).
* Against the device reduction: on the crop-only chain the host fallback
  (``infer_device_label = False``) and the device path reduce the same
  seeded MC-dropout passes to uncertainties within rtol 1e-5 (f32 sums in
  other orders).
"""
import numpy as np
import pytest

from fpl_plus_torch.cli import main as torch_main
from fpl_plus_torch.engine.infer import Inferer
from tests.test_torch_port_host_inverse import (host_cfg,  # noqa: F401
                                                host_workspace,
                                                skip_jax_init)
from tests.test_torch_port_models import one_torch_thread  # noqa: F401

PASSES = 6
CROP = (12, 16, 20)


def _fpl_extra(root, tag):
    npy = '{0}/{1}.npy'.format(root, tag)
    return 'fpl = True\nfpl_uncertainty_sorted = ' + npy, npy


def _values(npy):
    pairs = np.load(npy, allow_pickle=True)
    return {str(p[1]): float(np.asarray(p[0]).reshape(-1)[0]) for p in pairs}


def test_host_reduction_matches_jax_agent(host_workspace, monkeypatch):
    from fpl_plus_tpu.cli import main as jax_main
    from fpl_plus_tpu.engine.infer import Inferer as JaxInferer
    root = host_workspace
    skip_jax_init(monkeypatch)
    rs = np.random.RandomState(12)
    logits = [(rs.normal(size=(PASSES, 2) + CROP) * 2).astype(np.float32)
              for _ in range(3)]
    served = {'jax': [], 'torch': []}

    def jax_passes(self, group_predictor, ctx, image, n_passes, **kw):
        assert n_passes == PASSES and image.shape[2:] == CROP
        out = logits[len(served['jax'])]
        served['jax'].append(1)
        return lambda: out

    def port_passes(self, group_predictor, image, n_passes):
        assert n_passes == PASSES and image.shape[2:] == CROP
        out = logits[len(served['torch'])]
        served['torch'].append(1)
        return out

    monkeypatch.setattr(JaxInferer, 'run_passes_async', jax_passes)
    monkeypatch.setattr(Inferer, 'run_passes', port_passes)
    extra, jax_npy = _fpl_extra(root, 'fpl_jax')
    assert jax_main(['test', host_cfg(root, 'fpl_jax', extra=extra)]) == 0
    extra, port_npy = _fpl_extra(root, 'fpl_torch')
    assert torch_main(['test', host_cfg(root, 'fpl_torch', extra=extra)],
                      device='cpu') == 0
    assert len(served['jax']) == len(served['torch']) == 3
    ref, got = _values(jax_npy), _values(port_npy)
    assert sorted(got) == sorted(ref) and len(ref) == 3
    for name in ref:
        assert ref[name] != 1 and got[name] == pytest.approx(ref[name],
                                                             rel=1e-6)


def test_host_reduction_equals_device_reduction(host_workspace):
    root = host_workspace
    chain = '[NormalizeWithMeanStd, Pad]'
    extra, dev_npy = _fpl_extra(root, 'fpl_dev')
    assert torch_main(['test', host_cfg(root, 'fpl_dev', chain,
                                        extra=extra)], device='cpu') == 0
    extra, host_npy = _fpl_extra(root, 'fpl_host')
    assert torch_main(['test', host_cfg(
        root, 'fpl_host', chain, extra=extra + '\ninfer_device_label = '
        'False')], device='cpu') == 0
    dev, host = _values(dev_npy), _values(host_npy)
    assert sorted(dev) == sorted(host) and len(dev) == 3
    for name in dev:
        assert dev[name] != 1 and host[name] == pytest.approx(dev[name],
                                                              rel=1e-5)
