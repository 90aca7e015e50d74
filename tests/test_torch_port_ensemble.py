"""PyTorch port, checkpoint ensembles (``ckpt_mode = 3``) through the
port's CLI against the JAX CLI over the same two checkpoints of
``test_torch_port_host_inverse.py``'s workspace: the logits averaged over
the checkpoints (after the inverse transforms, as ``save_outputs`` gets
them) and the labels. The JAX CLI runs once (its folded two-checkpoint
program). Tolerances: averaged logits within 1e-4 x max |logit| (f32
convolutions in other orders through ~20 layers); labels equal.
"""
import os

import numpy as np

from fpl_plus_torch.agents.agent_seg import SegmentationAgent
from fpl_plus_torch.cli import main as torch_main
from tests.test_torch_port_host_inverse import (JAX_EXTRA,  # noqa: F401
                                                host_cfg, host_labels,
                                                host_workspace,
                                                skip_jax_init)
from tests.test_torch_port_models import one_torch_thread  # noqa: F401

CHAIN = '[NormalizeWithMeanStd, Pad]'


def _names(root, ext, its):
    return 'ckpt_name = [{0}]'.format(', '.join(
        os.path.join(root, 'model', 'gen', 'gen_{0}.{1}'.format(i, ext))
        for i in its))


def _recording(cls, monkeypatch):
    seen = []
    real = cls.save_outputs

    def save_outputs(self, data):
        seen.append(np.array(data['predict']))
        return real(self, data)

    monkeypatch.setattr(cls, 'save_outputs', save_outputs)
    return seen


def test_ensemble_matches_jax_cli(host_workspace, monkeypatch):
    from fpl_plus_tpu.agents.agent_seg import SegmentationAgent as JaxAgent
    from fpl_plus_tpu.cli import main as jax_main
    root = host_workspace
    skip_jax_init(monkeypatch)
    ref_logits = _recording(JaxAgent, monkeypatch)
    got_logits = _recording(SegmentationAgent, monkeypatch)
    assert jax_main(['test', host_cfg(
        root, 'ens_jax', CHAIN, mode=3, ckpt_name=_names(root, 'ckpt', (5, 6)),
        extra=JAX_EXTRA)]) == 0
    assert torch_main(['test', host_cfg(
        root, 'ens_torch', CHAIN, mode=3,
        ckpt_name=_names(root, 'pt', (5, 6)))], device='cpu') == 0
    assert len(got_logits) == len(ref_logits) == 3
    for got, ref in zip(got_logits, ref_logits):
        assert got.shape == ref.shape == (1, 2, 12, 24, 24)
        scale = float(np.abs(ref).max())
        assert float(np.abs(got - ref).max()) <= 1e-4 * scale
    ref, got = host_labels(root, 'ens_jax'), host_labels(root, 'ens_torch')
    assert list(got) == list(ref) and len(ref) == 3
    for name in ref:
        np.testing.assert_array_equal(got[name], ref[name])


def test_ensemble_of_one_checkpoint_twice(host_workspace):
    """An ensemble of the same checkpoint twice labels as that checkpoint
    alone (ckpt_mode 2) on the host path, which the ensemble always takes
    (the mean of two equal f32 logits is exact)."""
    root = host_workspace
    assert torch_main(['test', host_cfg(
        root, 'ens_aa', CHAIN, mode=3, ckpt_name=_names(root, 'pt', (5, 5)))],
        device='cpu') == 0
    single = 'ckpt_name = ' + os.path.join(root, 'model', 'gen', 'gen_5.pt')
    assert torch_main(['test', host_cfg(root, 'single', CHAIN, mode=2,
                                        ckpt_name=single,
                                        extra='infer_device_label = False')],
                      device='cpu') == 0
    ens, one = host_labels(root, 'ens_aa'), host_labels(root, 'single')
    assert list(ens) == list(one) and len(one) == 3
    for name in one:
        np.testing.assert_array_equal(ens[name], one[name])
