"""PyTorch port, console scripts: each ``fpl_torch_*`` entry of
``pyproject.toml``'s ``[project.scripts]`` names a callable of
``fpl_plus_torch.cli``, beside the JAX package's ``fpl_*`` entries of the
same names."""
import importlib
import os
import tomllib

import pytest

PYPROJECT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'pyproject.toml')
PORT = ('run', 'ssl', 'wsl', 'nll', 'nll_clslsr', 'eval_seg', 'convert',
        'eval_cls')


def scripts():
    with open(PYPROJECT, 'rb') as f:
        return tomllib.load(f)['project']['scripts']


@pytest.mark.parametrize('name', PORT)
def test_port_script_imports_its_target(name):
    table = scripts()
    target = table['fpl_torch_' + name]
    module, attr = target.split(':')
    assert module == 'fpl_plus_torch.cli'
    assert callable(getattr(importlib.import_module(module), attr))
    # the JAX package's script of the same name calls the same function
    assert table['fpl_' + name] == 'fpl_plus_tpu.cli:' + attr
