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


def _conv_bias_case(shape, seed):
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.normal(size=shape).astype(np.float32))
    tables = [torch.from_numpy(t) for t in _tables(rs, shape[1])]
    cb = torch.from_numpy(rs.normal(size=shape[1]).astype(np.float32))
    view = (1, -1) + (1,) * (len(shape) - 2)
    return x, tables, cb, view


@pytest.mark.parametrize('shape', [(3, 16, 5, 7), (2, 8, 3, 4, 5)])
def test_conv_bias_equals_adding_it_first_at_f32(shape):
    """The convolution's bias folded into the call equals the two-pass
    route, ``x + conv_bias`` and then the call without it, bit for bit."""
    x, tables, cb, view = _conv_bias_case(shape, len(shape))
    alpha = torch.tensor([0.25])
    two_pass = x + cb.reshape(view)
    for d in (0, 1):
        want = dsbn_prelu_reference(two_pass, *tables, d, alpha)
        plain = dsbn_prelu_reference(x, *tables, d, alpha, conv_bias=cb)
        folds = dsbn_prelu.bias_folds
        wrapped = dsbn_prelu(x, *tables, d, alpha, conv_bias=cb)
        assert dsbn_prelu.bias_folds == folds + 1
        assert torch.equal(plain, want) and torch.equal(wrapped, want)
        assert torch.equal(dsbn_prelu(two_pass, *tables, d, alpha), want)
    assert dsbn_prelu.bias_folds == folds + 1   # no conv_bias, no fold


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16])
def test_conv_bias_at_half_types_within_one_rounding(dtype):
    """At bf16 / f16 the fold adds the bias in f32 and rounds once, at the
    output; the two-pass route also rounds ``x + conv_bias`` to the input
    type first. They differ by at most one output ulp plus that rounding
    carried through the affine scale ``scale * rsqrt(var + eps)``."""
    x, tables, cb, view = _conv_bias_case((2, 8, 3, 4, 5), 7)
    x = x.to(dtype)
    tables[0], tables[1] = tables[0].to(dtype), tables[1].to(dtype)
    cb = cb.to(dtype)
    alpha = torch.tensor([0.25], dtype=dtype)
    exact = x.float() + cb.float().reshape(view)
    two_pass = x + cb.reshape(view)
    for d in (0, 1):
        got = dsbn_prelu(x, *tables, d, alpha, conv_bias=cb)
        assert got.dtype == dtype
        assert torch.equal(got, dsbn_prelu_reference(
            x, *tables, d, alpha, conv_bias=cb))
        want = dsbn_prelu_reference(two_pass, *tables, d, alpha).float()
        gain = (tables[0][d].float() * torch.rsqrt(tables[3][d] + 1e-5)
                ).abs().reshape(view)
        _, e = torch.frexp(torch.maximum(got.float().abs(), want.abs()))
        ulp = torch.finfo(dtype).eps * torch.exp2(e.float() - 1)
        tol = ulp + gain * (two_pass.float() - exact).abs()
        assert bool(((got.float() - want).abs() <= tol).all())


def test_wrapper_rejects_bad_conv_bias():
    rs = np.random.RandomState(8)
    tables = [torch.from_numpy(t) for t in _tables(rs, 4)]
    alpha = torch.tensor([0.25])
    x = torch.zeros(2, 4, 6, 6)
    for cb in (torch.zeros(3), torch.zeros(1, 4), torch.zeros(4, 1)):
        with pytest.raises(ValueError, match=r'conv_bias must be \[C=4\]'):
            dsbn_prelu(x, *tables, 0, alpha, conv_bias=cb)
    with pytest.raises(ValueError, match='conv_bias must be'):
        dsbn_prelu(x, *tables, 0, alpha,
                   conv_bias=torch.zeros(4, device='meta'))


def test_grad_refusal_covers_the_conv_bias():
    """The card's kernel has no backward: the wrapper refuses a call whose
    inputs, the convolution's bias among them, would need one."""
    from fpl_plus_torch.ops.dsbn_prelu import _needs_backward
    x = torch.zeros(2, 4, 6)
    tables = [torch.ones(2, 4) for _ in range(4)]
    alpha = torch.tensor([0.25])
    bias = torch.nn.Parameter(torch.zeros(4))
    assert _needs_backward(x, *tables, alpha, bias)
    assert not _needs_backward(x, *tables, alpha, bias.detach())
    assert not _needs_backward(x, *tables, alpha, None)
    with torch.no_grad():
        assert not _needs_backward(x, *tables, alpha, bias)


@pytest.mark.parametrize('shape', [(3, 16, 5, 7), (2, 8, 3, 4, 5)])
def test_conv_bias_matches_the_jax_reference_of_x_plus_bias(shape):
    """The fold against the JAX package's unfused reference computed on
    ``x + conv_bias``, where the convolution there adds its bias."""
    from fpl_plus_tpu.ops import dsbn_prelu_reference as jax_reference
    x, tables, cb, view = _conv_bias_case(shape, 9 + len(shape))
    alpha = torch.tensor([0.25])
    # the port's [N, C, *S] -> channels-last [N, *S, C]
    x_cl = np.moveaxis((x + cb.reshape(view)).numpy(), 1, -1)
    for d in (0, 1):
        ref = np.moveaxis(np.asarray(jax_reference(
            jnp.asarray(x_cl), *(jnp.asarray(t.numpy()) for t in tables),
            jnp.int32(d), jnp.float32(0.25))), -1, 1)
        got = dsbn_prelu(x, *tables, d, alpha, conv_bias=cb).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
