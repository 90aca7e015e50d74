"""Fused eval-mode window self-attention of Swin UNETR: a hand-written
Triton kernel for Hopper.

    out = softmax(q k^T / sqrt(d) + B_rel + M_shift) v     per (window, head)

Replaces no TPU kernel: the JAX package has no Swin network. It was added
with ``models/swin_unetr.py`` because a plain attention writes every score
tensor to device memory and reads it back three times (bias, mask,
softmax): at the benchmark's window and batch 8 that is 9.4 GB of f32
scores a forward, against 1.8 GB of q, k, v and output.

Bound on the card: at float32 with PyTorch's default flags (no TF32 for
matrix products) its operations, 4 x tokens x C x window tokens a block
(QK^T and PV, head size 16), against the 67 TFLOP/s of f32 outside the
tensor cores; at bf16 and f16 the bytes of q, k, v and the output. The
design keeps the scores out of device memory altogether:

* One launch per Swin block, grid ``(windows x batch, heads, query
  blocks)``. Each program holds BLOCK_M query rows of one head and walks
  over the window's keys in blocks of BLOCK_N with an online softmax (the
  running max and sum in f32), so a score never leaves the registers.
* q, k and v are read where the qkv linear wrote them, ``[Bw, n, 3C]``
  with q, k, v and the heads side by side in the last axis; the output is
  written as ``[Bw, n, C]``, heads side by side, ready for ``proj``.
* The relative-position bias: the table ``[(2w0-1)(2w1-1)(2w2-1), heads]``
  indexed by MONAI's relative index of the module's window ``(w0, w1, w2)``
  sliced ``[:n, :n]``. The kernel computes that index from the token
  numbers (a token's key minus another's plus a constant) instead of
  reading the ``n x n`` index from memory, and gathers the bias from the
  table, which stays in the cache.
* The shift mask: MONAI's ``compute_mask`` gives -100 between tokens of two
  regions of a shifted window. The kernel takes each window's region ids
  ``[nW, n]`` (window ``b % nW`` of a sample) and adds -100 where two
  differ.
* Softmax in f32. QK^T and PV run in TF32 only while
  ``torch.backends.cuda.matmul.allow_tf32`` is set, as cuBLAS would run the
  plain version's products, and in full f32 otherwise. bf16 and f16 inputs
  go through the tensor cores with f32 sums; the probabilities are rounded
  to the input dtype before PV, as MONAI's ``attn.to(v.dtype)`` does.

``window_attention`` takes the plain version ``window_attention_reference``
only for a CPU tensor; for a CUDA tensor it launches the kernel or raises.
The kernel has no backward: a CUDA call with grad mode on and an input that
requires grad raises. Train mode uses the plain version, which autograd
differentiates. Launches are counted in ``window_attention.launches``, and
those with a shift mask also in ``window_attention.shifted``.
"""
from __future__ import annotations

import functools
import os
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

_TRITON_CACHE = Path(__file__).resolve().parents[2] / 'build' / 'triton'
# query block, key block, warps and pipeline stages of a program, by input
# dtype: the fastest of those tried at the four stage shapes of the
# benchmark's forward on an H100 (PERF.md, section 6, PR 20). One stage
# (no software pipelining of the key blocks) took half the time of three
# at f32, where the products run on the FMA units
_BLOCKS = {torch.float32: (128, 16, 2, 1), torch.bfloat16: (128, 16, 4, 1),
           torch.float16: (128, 16, 4, 1)}


@functools.lru_cache(maxsize=8)
def relative_position_index(window: Tuple[int, int, int]) -> torch.Tensor:
    """MONAI's relative position index of a window ``(w0, w1, w2)``: ``[W,
    W]`` int64 (W = w0 w1 w2), the row of the bias table for each pair of
    the window's tokens, tokens numbered depth-major."""
    coords = torch.stack(torch.meshgrid(
        *[torch.arange(w) for w in window], indexing='ij')).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + torch.tensor([w - 1 for w in window])
    rel = rel * torch.tensor([(2 * window[1] - 1) * (2 * window[2] - 1),
                              2 * window[2] - 1, 1])
    return rel.sum(-1)


def _check(qkv, table, num_heads, window, regions):
    if qkv.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError('window_attention takes float16, float32 or bfloat16, '
                        'got {0}'.format(qkv.dtype))
    if qkv.dim() != 3 or qkv.shape[2] % (3 * num_heads):
        raise ValueError('window_attention takes qkv [windows, n, 3C] with C '
                         'a multiple of {0} heads, got {1}'.format(
                             num_heads, tuple(qkv.shape)))
    window = tuple(int(w) for w in window)
    n = qkv.shape[1]
    cells = 1
    for w in window:
        cells *= w
    if len(window) != 3 or n > cells:
        raise ValueError('a window of {0} tokens does not fit the window {1}'
                         .format(n, window))
    rows = (2 * window[0] - 1) * (2 * window[1] - 1) * (2 * window[2] - 1)
    if tuple(table.shape) != (rows, num_heads) or table.device != qkv.device:
        raise ValueError('table must be [{0}, {1}] on {2}, got {3} on {4}'
                         .format(rows, num_heads, qkv.device,
                                 tuple(table.shape), table.device))
    if regions is not None and (
            regions.dim() != 2 or regions.shape[1] != n
            or qkv.shape[0] % regions.shape[0]
            or regions.device != qkv.device):
        raise ValueError('regions must be [nW, {0}] on {1} with nW dividing '
                         '{2} windows, got {3} on {4}'.format(
                             n, qkv.device, qkv.shape[0],
                             tuple(regions.shape), regions.device))
    return window


def window_attention_reference(qkv, table, num_heads: int,
                               window: Sequence[int], regions=None):
    """Plain PyTorch version of the kernel's arithmetic: the scores and the
    softmax in f32, the probabilities rounded to the input dtype before PV,
    PV in f32, the output cast to the input dtype. ``qkv [Bw, n, 3C]``,
    ``table [(2w0-1)(2w1-1)(2w2-1), heads]``, ``regions [nW, n]`` or None;
    returns ``[Bw, n, C]``. Differentiable."""
    window = _check(qkv, table, num_heads, window, regions)
    bw, n, c3 = qkv.shape
    c = c3 // 3
    hd = c // num_heads
    q, k, v = qkv.float().reshape(bw, n, 3, num_heads, hd).permute(
        2, 0, 3, 1, 4)
    attn = (q * hd ** -0.5) @ k.transpose(-2, -1)
    index = relative_position_index(window)[:n, :n].to(qkv.device)
    bias = table[index.reshape(-1)].float().reshape(n, n, num_heads)
    attn = attn + bias.permute(2, 0, 1).unsqueeze(0)
    if regions is not None:
        nw = regions.shape[0]
        mask = (regions[:, :, None] != regions[:, None, :]).float() * -100.0
        attn = (attn.view(bw // nw, nw, num_heads, n, n)
                + mask[None, :, None]).view(bw, num_heads, n, n)
    p = attn.softmax(-1).to(qkv.dtype).float()
    return (p @ v).transpose(1, 2).reshape(bw, n, c).to(qkv.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    """Compile-on-first-use Triton kernel (Triton exists only on the card's
    host, so it is imported here, never at module import). Its cache lives
    under ``build/triton`` in the checkout."""
    os.environ.setdefault('TRITON_CACHE_DIR', str(_TRITON_CACHE))
    import triton
    import triton.language as tl

    @triton.jit
    def window_attention_kernel(qkv_ptr, out_ptr, table_ptr, region_ptr,
                                N, NW, HEADS, scale, OFFSET,
                                C: tl.constexpr, HD: tl.constexpr,
                                W1: tl.constexpr, W2: tl.constexpr,
                                T1: tl.constexpr, T2: tl.constexpr,
                                MASKED: tl.constexpr,
                                PRECISION: tl.constexpr,
                                BLOCK_M: tl.constexpr,
                                BLOCK_N: tl.constexpr):
        bw = tl.program_id(0)              # (sample, window)
        h = tl.program_id(1)
        offs_m = tl.program_id(2) * BLOCK_M + tl.arange(0, BLOCK_M)
        offs_d = tl.arange(0, HD)
        row = 3 * C
        base = bw.to(tl.int64) * N * row + h * HD
        m_ok = offs_m < N
        q = tl.load(qkv_ptr + base + offs_m[:, None] * row + offs_d[None, :],
                    mask=m_ok[:, None], other=0.0)
        # a token's key: its place in the module's window, so that key_i -
        # key_j + OFFSET is MONAI's relative index of the pair
        key_m = ((offs_m // (W1 * W2)) * (T1 * T2)
                 + ((offs_m // W2) % W1) * T2 + offs_m % W2)
        if MASKED:
            r_m = tl.load(region_ptr + (bw % NW) * N + offs_m, mask=m_ok,
                          other=-1)
        m_i = tl.full([BLOCK_M], float('-inf'), tl.float32)
        l_i = tl.zeros([BLOCK_M], tl.float32)
        acc = tl.zeros([BLOCK_M, HD], tl.float32)
        for start in range(0, N, BLOCK_N):
            offs_n = start + tl.arange(0, BLOCK_N)
            n_ok = offs_n < N
            kv = qkv_ptr + base + offs_n[:, None] * row + offs_d[None, :]
            k = tl.load(kv + C, mask=n_ok[:, None], other=0.0)
            v = tl.load(kv + 2 * C, mask=n_ok[:, None], other=0.0)
            s = tl.dot(q, tl.trans(k), input_precision=PRECISION) * scale
            key_n = ((offs_n // (W1 * W2)) * (T1 * T2)
                     + ((offs_n // W2) % W1) * T2 + offs_n % W2)
            rel = key_m[:, None] - key_n[None, :] + OFFSET
            both = m_ok[:, None] & n_ok[None, :]
            s += tl.load(table_ptr + rel * HEADS + h, mask=both,
                         other=0.0).to(tl.float32)
            if MASKED:
                r_n = tl.load(region_ptr + (bw % NW) * N + offs_n, mask=n_ok,
                              other=-1)
                s = tl.where(r_m[:, None] == r_n[None, :], s, s - 100.0)
            s = tl.where(n_ok[None, :], s, float('-inf'))
            m_new = tl.maximum(m_i, tl.max(s, 1))
            alpha = tl.exp(m_i - m_new)
            p = tl.exp(s - m_new[:, None])
            l_i = l_i * alpha + tl.sum(p, 1)
            acc = acc * alpha[:, None] + tl.dot(
                p.to(v.dtype), v, input_precision=PRECISION)
            m_i = m_new
        out = acc / l_i[:, None]
        tl.store(out_ptr + bw.to(tl.int64) * N * C + offs_m[:, None] * C
                 + h * HD + offs_d[None, :],
                 out.to(out_ptr.dtype.element_ty), mask=m_ok[:, None])

    return triton, window_attention_kernel


def window_attention(qkv, table, num_heads: int, window: Sequence[int],
                     regions: Optional[torch.Tensor] = None):
    """Window self-attention of ``qkv [Bw, n, 3C]`` (the qkv linear's
    output, Bw = batch x windows) with the bias ``table`` of the module's
    ``window`` and, for a shifted block, the region ids ``regions [nW, n]``
    of a sample's windows; returns ``[Bw, n, C]`` in qkv's dtype. CPU
    tensor: the plain version. CUDA tensor: the Triton kernel (counted in
    ``window_attention.launches``, with a mask also in
    ``window_attention.shifted``); it raises when autograd would need its
    backward."""
    if qkv.device.type == 'cpu':
        return window_attention_reference(qkv, table, num_heads, window,
                                          regions)
    if qkv.device.type != 'cuda':
        raise ValueError('window_attention runs on cpu or cuda, got {0}'
                         .format(qkv.device))
    window = _check(qkv, table, num_heads, window, regions)
    if torch.is_grad_enabled() and (qkv.requires_grad or table.requires_grad):
        raise RuntimeError(
            'the window_attention kernel has no backward: run the eval '
            'forward under torch.no_grad() (train mode uses the plain '
            'version)')
    bw, n, c3 = qkv.shape
    c = c3 // 3
    hd = c // num_heads
    if hd < 16 or hd & (hd - 1):
        raise ValueError('the kernel takes a head size that is a power of two '
                         'of at least 16, got {0}'.format(hd))
    if not qkv.is_contiguous():
        raise ValueError('window_attention needs a contiguous qkv')
    triton, kernel = _kernel()
    out = torch.empty((bw, n, c), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    w0, w1, w2 = window
    t1, t2 = 2 * w1 - 1, 2 * w2 - 1
    offset = (w0 - 1) * t1 * t2 + (w1 - 1) * t2 + (w2 - 1)
    masked = regions is not None
    region = regions.to(torch.int32).contiguous() if masked else table
    precision = ('tf32' if qkv.dtype == torch.float32
                 and torch.backends.cuda.matmul.allow_tf32 else 'ieee')
    block_m, block_n, warps, stages = _BLOCKS[qkv.dtype]
    grid = (bw, num_heads, triton.cdiv(n, block_m))
    kernel[grid](qkv, out, table.contiguous(), region, n,
                 regions.shape[0] if masked else 1, num_heads,
                 float(hd ** -0.5), offset, C=c, HD=hd, W1=w1, W2=w2,
                 T1=t1, T2=t2, MASKED=masked, PRECISION=precision,
                 BLOCK_M=block_m, BLOCK_N=block_n, num_warps=warps,
                 num_stages=stages)
    window_attention.launches += 1
    if masked:
        window_attention.shifted += 1
    return out


window_attention.launches = 0
window_attention.shifted = 0
