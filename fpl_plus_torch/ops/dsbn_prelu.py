"""Fused eval-mode DSBN + PReLU: a hand-written Triton kernel for Hopper.

    y = prelu((x - mean[d]) * rsqrt(var[d] + eps) * scale[d] + bias[d])

Replaces the TPU kernel ``fpl_plus_tpu/ops/pallas_fused.py:_dsbn_prelu_pallas``
(one Pallas VMEM pass over a channels-last ``[rows, C]`` view with the domain
as a scalar prefetch). UNet2D5_dsbn runs it after every convolution: 18
launches per forward.

Bound on the card: the bytes it moves. It reads ``x`` once and writes ``y``
once, 2 x numel x itemsize bytes of device-memory traffic; the arithmetic is
six flops an element and uses no tensor core. The design therefore makes one
pass with no intermediates in device memory, and keeps the layout the
convolutions produce: no channels-last transpose, no row padding.

* Input: a contiguous ``[B, C, *spatial]`` tensor (NCDHW, or the folded
  ``[N*D, C, H, W]`` of the 2D levels), S = prod(spatial). The grid is
  ``(B*C, cdiv(S, BLOCK))``: each program owns one channel row, loads that
  channel's four f32 parameters once, computes ``rsqrt(var + eps)`` in f32,
  streams BLOCK contiguous elements (masked ragged tail) in f32 and stores in
  the input dtype: f32, bf16 or f16, rounded once at the store (the TPU
  kernel's f32 math inside, and its f32 / bf16 / f16 in and out). One
  ``@triton.jit`` source; Triton specialises it per input dtype.
* The domain ``d`` is a Python int; the wrapper selects the table row with a
  view (``scale[d]``), so nothing syncs with the host.
* Scale and bias may be bf16 or f16 parameters under ``[testing] precision
  = bfloat16`` or ``float16``; the wrapper upcasts them to f32, as the TPU
  kernel does. The running statistics stay f32 buffers.

``dsbn_prelu`` takes the plain version ``dsbn_prelu_reference`` only for a
CPU tensor. For a CUDA tensor it launches the kernel or raises. The kernel
has no backward (the TPU kernel has none either: train-mode DSBN never
reaches it), so a CUDA call with grad mode on and any input that requires
grad raises instead of returning a tensor whose affine parameters and slope
would silently get no gradient. Eval forwards run under ``torch.no_grad()``
or ``torch.inference_mode()``.
"""
from __future__ import annotations

import functools
import operator
import os
from pathlib import Path

import torch

_TRITON_CACHE = Path(__file__).resolve().parents[2] / 'build' / 'triton'
_MAX_BLOCK = 4096


def _check(x, scale, bias, mean, var, domain, alpha):
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError('dsbn_prelu takes float16, float32 or bfloat16, got '
                        '{0}'.format(x.dtype))
    if x.dim() < 2:
        raise ValueError('dsbn_prelu takes [B, C, *spatial], got shape {0}'
                         .format(tuple(x.shape)))
    if not x.is_contiguous():
        raise ValueError('dsbn_prelu needs a contiguous input')
    c = x.shape[1]
    for name, t in (('scale', scale), ('bias', bias), ('mean', mean),
                    ('var', var)):
        if t.dim() != 2 or t.shape[1] != c:
            raise ValueError('{0} must be [n_domains, C={1}], got {2}'.format(
                name, c, tuple(t.shape)))
        if t.device != x.device:
            raise ValueError('{0} is on {1}, x on {2}'.format(
                name, t.device, x.device))
    if alpha.numel() != 1 or alpha.device != x.device:
        raise ValueError('alpha must be one slope on the device of x')
    d = operator.index(domain)
    if not 0 <= d < scale.shape[0]:
        raise ValueError('domain {0} outside [0, {1})'.format(
            d, scale.shape[0]))
    return d


def dsbn_prelu_reference(x, scale, bias, mean, var, domain, alpha,
                         eps: float = 1e-5):
    """Plain PyTorch version of the kernel's arithmetic on ``[B, C, ...]``:
    f32 math, output cast to the input dtype. At f32 it equals the JAX
    package's unfused ``dsbn_prelu_reference``."""
    d = operator.index(domain)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    g = scale[d].float().reshape(shape)
    b = bias[d].float().reshape(shape)
    m = mean[d].float().reshape(shape)
    inv = torch.rsqrt(var[d].float() + eps).reshape(shape)
    y = (x.float() - m) * inv * g + b
    y = torch.where(y >= 0, y, alpha.float().reshape(()) * y)
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    """Compile-on-first-use Triton kernel (Triton exists only on the card's
    host, so it is imported here, never at module import). Its cache lives
    under ``build/triton`` in the checkout."""
    os.environ.setdefault('TRITON_CACHE_DIR', str(_TRITON_CACHE))
    import triton
    import triton.language as tl

    @triton.jit
    def dsbn_prelu_kernel(x_ptr, y_ptr, g_ptr, b_ptr, m_ptr, v_ptr, a_ptr,
                          C, S, eps, BLOCK: tl.constexpr):
        row = tl.program_id(0)            # one (sample, channel) row
        c = row % C
        g = tl.load(g_ptr + c)
        b = tl.load(b_ptr + c)
        m = tl.load(m_ptr + c)
        inv = 1.0 / tl.sqrt(tl.load(v_ptr + c) + eps)
        a = tl.load(a_ptr)
        offs = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < S
        base = row.to(tl.int64) * S
        x = tl.load(x_ptr + base + offs, mask=mask).to(tl.float32)
        y = (x - m) * inv * g + b
        y = tl.where(y >= 0, y, a * y)
        tl.store(y_ptr + base + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

    return triton, dsbn_prelu_kernel


def dsbn_prelu(x, scale, bias, mean, var, domain, alpha, eps: float = 1e-5):
    """Fused eval DSBN + PReLU on ``x [B, C, *spatial]`` with per-domain
    tables ``[n_domains, C]``, a Python-int ``domain`` and a one-element
    slope ``alpha``. CPU tensor: the plain version. CUDA tensor: the Triton
    kernel (counted in ``dsbn_prelu.launches``); it raises when autograd
    would need its backward."""
    d = _check(x, scale, bias, mean, var, domain, alpha)
    if x.device.type == 'cpu':
        return dsbn_prelu_reference(x, scale, bias, mean, var, d, alpha, eps)
    if x.device.type != 'cuda':
        raise ValueError('dsbn_prelu runs on cpu or cuda, got {0}'.format(
            x.device))
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, scale, bias, mean, var, alpha)):
        raise RuntimeError(
            'the dsbn_prelu kernel has no backward: run the eval forward '
            'under torch.no_grad() (train mode uses batch statistics and '
            'never reaches the kernel)')
    triton, kernel = _kernel()
    c = x.shape[1]
    rows = x.shape[0] * c
    s = x.numel() // rows if rows else 0
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    tables = [t[d].float().contiguous() for t in (scale, bias, mean, var)]
    block = min(_MAX_BLOCK, triton.next_power_of_2(s))
    grid = (rows, triton.cdiv(s, block))
    kernel[grid](x, y, *tables, alpha.float(), c, s, float(eps),
                 BLOCK=block, num_warps=4)
    dsbn_prelu.launches += 1
    return y


dsbn_prelu.launches = 0
