"""PyTorch port, ops: the plain DSBN+PReLU version (and the wrapper on a CPU
tensor) against the JAX Pallas kernel in interpret mode.

The cases of tests/test_pallas_ops.py, moved from channels-last to the
port's channels-first layout, for both domains. Tolerance: f32,
atol = rtol = 1e-5 (the same arithmetic in another order of rsqrt rounding).
The Triton kernel itself runs only on the card; chip_smoke.py holds it
against the plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpl_plus_tpu.ops import dsbn_prelu as jax_dsbn_prelu
from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu, dsbn_prelu_reference


def _tables(rs, c):
    return (rs.uniform(0.5, 2, (2, c)).astype(np.float32),
            rs.normal(size=(2, c)).astype(np.float32),
            rs.normal(size=(2, c)).astype(np.float32),
            rs.uniform(0.5, 2, (2, c)).astype(np.float32))


@pytest.mark.parametrize('shape,c', [
    ((2, 4, 8), 16),
    ((3, 7), 128),       # non-tile-aligned rows in the TPU kernel
    ((1, 300), 128),
])
def test_plain_version_matches_pallas_interpret(shape, c):
    rs = np.random.RandomState(c + len(shape))
    x = rs.normal(size=shape + (c,)).astype(np.float32)
    tables = _tables(rs, c)
    alpha = np.float32(0.25)
    # channels-last [N, *S, C] -> the port's [N, C, *S]
    x_t = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))
    t_tables = [torch.from_numpy(t) for t in tables]
    a_t = torch.tensor([alpha])
    for d in (0, 1):
        ref = np.moveaxis(np.asarray(jax_dsbn_prelu(
            jnp.asarray(x), *map(jnp.asarray, tables), jnp.int32(d),
            jnp.float32(alpha), interpret=True)), -1, 1)
        plain = dsbn_prelu_reference(x_t, *t_tables, d, a_t).numpy()
        wrapped = dsbn_prelu(x_t, *t_tables, d, a_t).numpy()
        np.testing.assert_allclose(plain, ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(wrapped, plain)


def test_bf16_input_keeps_dtype_with_f32_math():
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.normal(size=(2, 8, 3, 5)).astype(np.float32))
    tables = [torch.from_numpy(t) for t in _tables(rs, 8)]
    # bf16 parameters (precision = bfloat16) with f32 running statistics
    tables[0], tables[1] = tables[0].bfloat16(), tables[1].bfloat16()
    alpha = torch.tensor([0.25], dtype=torch.bfloat16)
    y = dsbn_prelu(x.bfloat16(), *tables, 1, alpha)
    assert y.dtype == torch.bfloat16
    g, b = tables[0][1].float(), tables[1][1].float()
    m, v = tables[2][1], tables[3][1]
    z = ((x.bfloat16().float() - m[:, None, None])
         * torch.rsqrt(v + 1e-5)[:, None, None] * g[:, None, None]
         + b[:, None, None])
    want = torch.where(z >= 0, z, 0.25 * z).bfloat16()
    torch.testing.assert_close(y, want, rtol=0, atol=0)


def test_wrapper_rejects_bad_inputs():
    rs = np.random.RandomState(6)
    tables = [torch.from_numpy(t) for t in _tables(rs, 4)]
    alpha = torch.tensor([0.25])
    x = torch.zeros(2, 4, 6, 6)
    with pytest.raises(ValueError, match='contiguous'):
        dsbn_prelu(x.transpose(2, 3), *tables, 0, alpha)
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        dsbn_prelu(x.double(), *tables, 0, alpha)
    with pytest.raises(ValueError, match='C=3'):
        dsbn_prelu(torch.zeros(2, 3, 6, 6), *tables, 0, alpha)
    with pytest.raises(ValueError, match='domain 2'):
        dsbn_prelu(x, *tables, 2, alpha)
    before = dsbn_prelu.launches
    dsbn_prelu(x, *tables, 1, alpha)
    assert dsbn_prelu.launches == before   # the CPU path launches nothing
