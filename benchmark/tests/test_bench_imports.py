"""Nothing of the benchmark imports JAX, the JAX package or the smoke
scripts; the reference imports nothing of the program. Module names are
compared whole, by their top-level part."""
import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'fpl_plus_tpu', 'bench', 'chip_smoke'}


def sources(sub=''):
    for root, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(root, f)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


@pytest.mark.parametrize('path', sorted(sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


def test_the_prefix_is_not_the_name():
    assert 'fpl_plus_torch'.split('.')[0] not in FORBIDDEN


@pytest.mark.parametrize('path', sorted(sources('reference')),
                         ids=os.path.basename)
def test_reference_is_independent_of_the_program(path):
    assert 'fpl_plus_torch' not in set(top_level_imports(path))


@pytest.mark.parametrize('path', sorted(sources('harness')),
                         ids=os.path.basename)
def test_the_harness_imports_no_network(path):
    """A configuration's network comes from the file its ``reference``
    key names; the harness imports none by name."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or '')
            names.update('{0}.{1}'.format(node.module, a.name)
                         for a in node.names)
    assert not any('unet2d5_dsbn' in n for n in names), names
