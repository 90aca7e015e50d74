"""PyTorch port, ``matmul_precision``: every accepted value sets both TF32
flags, so a later stage of one process does not inherit an earlier
stage's value; an unknown value raises.

The values are JAX's three levels and their aliases
(``jax_default_matmul_precision``); XLA's dot-algorithm names, which JAX
also takes, have no PyTorch counterpart and raise. The flags are
process-wide, so every test restores them.
"""
import pytest
import torch

from fpl_plus_torch.utils.precision import apply_matmul_precision

# (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
EXPECTED = {'highest': (False, False), 'float32': (False, False),
            'high': (True, True), 'tensorfloat32': (True, True),
            'default': (True, False), 'bfloat16': (True, False)}
DEFAULTS = (True, False)            # PyTorch's own


def flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture(autouse=True)
def restore_flags():
    before = flags()
    yield
    torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32 = before


def cfg(section, value):
    return {section: {'matmul_precision': value}}


@pytest.mark.parametrize('value', sorted(EXPECTED))
@pytest.mark.parametrize('start', [(False, False), (True, True)])
def test_each_value_sets_both_flags(value, start):
    torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32 = start
    apply_matmul_precision(cfg('testing', value), 'test')
    assert flags() == EXPECTED[value]


def test_highest_then_default_restores_the_defaults():
    """Two stages of one process, as ``dryrun._pipeline`` runs them."""
    apply_matmul_precision(cfg('training', 'highest'), 'train')
    assert flags() == (False, False)
    apply_matmul_precision(cfg('testing', 'default'), 'test')
    assert flags() == DEFAULTS
    apply_matmul_precision(cfg('training', 'high'), 'train')
    assert flags() == (True, True)
    apply_matmul_precision(cfg('training', 'default'), 'train')
    assert flags() == DEFAULTS


@pytest.mark.parametrize('value', ['fastest', 'BF16_BF16_F32_X3', 'tf32'])
def test_unknown_value_raises_and_leaves_the_flags(value):
    before = flags()
    with pytest.raises(ValueError, match='highest'):
        apply_matmul_precision(cfg('testing', value), 'test')
    assert flags() == before


def test_the_running_stage_section_wins():
    both = {'training': {'matmul_precision': 'highest'},
            'testing': {'matmul_precision': 'high'}}
    apply_matmul_precision(both, 'train')
    assert flags() == (False, False)
    apply_matmul_precision(both, 'test')
    assert flags() == (True, True)
    apply_matmul_precision(both, 'inference')
    assert flags() == (True, True)


def test_no_value_changes_nothing():
    torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32 = (False, True)
    apply_matmul_precision({'training': {}, 'testing': {}}, 'train')
    apply_matmul_precision({'testing': {'matmul_precision': ''}}, 'test')
    assert flags() == (False, True)
