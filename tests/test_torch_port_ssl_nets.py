"""PyTorch port, the SSL methods with their own networks against the JAX
package's: one step of CCT (UNet2D_CCT), CPS (a BiNet) and URPC
(UNet2D_URPC), by the check and tolerances of
``tests/test_torch_port_ssl.py`` (a file of its own so that two test
workers share the JAX step compiles).
"""
import pytest

from tests.test_torch_port_models import one_torch_thread  # noqa: F401
from tests.test_torch_port_ssl import (no_noise, shared_draws,  # noqa: F401
                                       ssl_step_matches_jax)


@pytest.mark.parametrize('method', ['CCT', 'CPS', 'URPC'])
def test_ssl_step_matches_jax(method, no_noise, shared_draws):  # noqa: F811
    """One step of each method against the JAX agent's step."""
    ssl_step_matches_jax(method)
