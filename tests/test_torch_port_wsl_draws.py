"""PyTorch port, the WSL methods that draw per iteration on the host
against the JAX package's: one step of USTM at each rotation ``k`` in 0-3
(one JAX step compiled for all four: ``k`` is an argument of the step) and
of DMPLS at a fixed ``beta``, by the check and tolerances of
``tests/test_torch_port_wsl.py`` (a file of its own so that two test workers
share the JAX step compiles); and where both draw from the seeded
process-wide numpy RNG.
"""
import numpy as np
import pytest

from fpl_plus_torch.agents import wsl as port_wsl
from tests.test_torch_port_models import one_torch_thread  # noqa: F401
from tests.test_torch_port_ssl import no_noise, paradigm_config  # noqa: F401
from tests.test_torch_port_wsl import wsl_step_matches_jax


@pytest.mark.parametrize('case', ['USTM-k0', 'USTM-k1', 'USTM-k2', 'USTM-k3',
                                  'DMPLS'])
def test_wsl_step_matches_jax(case, no_noise):  # noqa: F811
    """One step of each case against the JAX agent's step."""
    wsl_step_matches_jax(case)


def test_dmpls_beta_and_ustm_rotation_draws(monkeypatch):
    """DMPLS draws ``beta`` in ``training_hyper`` and USTM its rotation in
    the batch producer, each from the seeded process-wide numpy RNG, as
    the JAX agents do."""
    cfg = paradigm_config('weakly_supervised_learning')
    agent = port_wsl.WSLDMPLS(cfg, 'train', 'cpu')
    np.random.seed(9)
    want = np.random.RandomState(9).random_sample()
    assert agent.training_hyper(3)['beta'] == want
    ustm = port_wsl.WSLUSTM(cfg, 'train', 'cpu')
    monkeypatch.setattr(port_wsl.WSLSegAgent, '_train_batches',
                        lambda self: iter([({'image': None},)] * 2))
    np.random.seed(9)
    ks = [b[1] for b in ustm._train_batches()]
    ref = np.random.RandomState(9)
    assert ks == [ref.randint(0, 4), ref.randint(0, 4)]
