"""PyTorch port, the test stage's host path with a ``Rescale`` chain (the
inverse zooms the logits back with ``ndimage.zoom`` order 1) through the
port's CLI against the JAX CLI, on ``test_torch_port_host_inverse.py``'s
workspace. The JAX CLI runs once (one sliding-window program). Tolerance:
labels equal on at least 99.99% of voxels (expected: identical; a label
can flip only where the two logits tie to ~1e-5).
"""
import numpy as np

from fpl_plus_torch.cli import main as torch_main
from tests.test_torch_port_host_inverse import (AGREE, JAX_EXTRA,  # noqa
                                                host_cfg, host_labels,
                                                host_workspace,
                                                skip_jax_init)
from tests.test_torch_port_models import one_torch_thread  # noqa: F401

CHAIN = '[NormalizeWithMeanStd, Rescale]'


def test_rescale_chain_matches_jax_cli(host_workspace, monkeypatch):
    from fpl_plus_tpu.cli import main as jax_main
    root = host_workspace
    skip_jax_init(monkeypatch)
    assert jax_main(['test', host_cfg(root, 'zoom_jax', CHAIN,
                                      extra=JAX_EXTRA)]) == 0
    assert torch_main(['test', host_cfg(root, 'zoom_torch', CHAIN)],
                      device='cpu') == 0
    ref, got = host_labels(root, 'zoom_jax'), host_labels(root, 'zoom_torch')
    assert list(got) == list(ref) and len(ref) == 3
    for name in ref:
        assert got[name].shape == ref[name].shape == (1, 12, 24, 24)
        assert 0.05 < got[name].mean() < 0.95, name
        assert np.mean(got[name] == ref[name]) >= AGREE, name
