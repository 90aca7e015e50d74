"""Domain-Specific Batch Normalization (DSBN).

Reference semantics (PyMIC/pymic/net_run_dsbn/dsbn.py:4-64): a bank of
independent BatchNorm layers, one per domain; the whole batch belongs to one
domain and ``bns[domain]`` is selected. Parameters and running statistics
keep the reference key names ``bns.{d}.weight/bias/running_mean/
running_var/num_batches_tracked``; statistics are f32 buffers, eps 1e-5.

* Eval mode normalises with the running statistics and applies the
  following PReLU in the same fused kernel (``ops/dsbn_prelu.py``). A
  ``conv_bias`` handed to the forward is the preceding convolution's bias,
  left out of that convolution: the kernel adds it to ``x`` before it
  normalises, in the same pass (UNet2D5's ``ConvBlockND`` does this in
  eval mode). Train mode takes none: there the convolution adds its own
  bias, so the running mean tracks the biased activation.
* Train mode normalises with the batch statistics (over every axis but
  channels, accumulated in f32 even for a bf16 or f16 input; biased
  variance) and updates only the selected bank: momentum 0.1, unbiased
  variance ``n / (n - 1)`` with n the batch times spatial size, and
  ``num_batches_tracked`` + 1, as torch's BatchNorm does. PReLU then runs as
  a second plain step, as in the JAX package's ``_norm_act``. Both steps are
  PyTorch's own ``batch_norm`` and ``prelu``: the JAX package computes the
  variance as ``E[x^2] - E[x]^2`` clamped at 0, which equals torch's to f32
  rounding. The affine parameters enter ``batch_norm`` in the dtype of the
  running statistics, f32 (the mixed-type form torch accepts for a bf16
  or f16 input), so a bf16 or f16 forward normalises in f32 and rounds
  once; JAX rounds the affine terms to the input's dtype first.

``BatchNorm`` is the plain one-bank BatchNorm of the other networks (the JAX
package's ``models/dsbn.py:76-81``): the same f32 statistics, momentum and
unbiased running variance, keys ``weight/bias/running_mean/running_var/
num_batches_tracked``, and ``F.batch_norm`` in both modes (no fused kernel:
its activation is LeakyReLU, applied by the caller).

Within a data-parallel train step (``parallel/mesh.py`` ``active_mesh``)
both take the train-mode statistics over the global batch, as the JAX
package's sharded step does (XLA computes its mean over the global batch):
the per-channel sum, sum of squares and count of this rank's rows go
through one differentiable all-reduce, the variance is the JAX package's
``E[x^2] - E[x]^2`` clamped at 0 (``models/dsbn.py:50-60`` there), in
f32, and the running variance takes the global unbiased variance.
``torch.nn.SyncBatchNorm`` would do this on the card only; this runs on
the CPU's gloo ranks as well.

``InstanceNorm`` (the discriminator's normalisation, the JAX package's
``models/dsbn.py:84-93``): per sample and channel over the spatial axes,
biased variance, eps 1e-5, no affine terms and no running statistics; that
is ``nn.InstanceNorm3d(affine=False)``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
from fpl_plus_torch.parallel.mesh import active_mesh, all_reduce_sum


def global_batch_norm(x: torch.Tensor, bank: nn.Module, momentum: float,
                      eps: float, mesh) -> torch.Tensor:
    """Train-mode batch norm of ``x [B, C, ...]`` (this rank's rows) with
    the statistics of the global batch over ``mesh``, and the update of
    ``bank``'s running statistics (see the module docstring). Returns
    ``x``'s dtype."""
    c = x.shape[1]
    dims = [0] + list(range(2, x.dim()))
    xf = x.float()
    count = torch.full((1,), float(x.numel() // c), device=x.device)
    stats = all_reduce_sum(torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                                      count]), mesh)
    n = stats[2 * c].detach()
    mean = stats[:c] / n
    var = torch.clamp(stats[c:2 * c] / n - mean * mean, min=0.0)
    with torch.no_grad():
        bank.running_mean.mul_(1 - momentum).add_(momentum * mean)
        bank.running_var.mul_(1 - momentum).add_(
            momentum * var * n / (n - 1))
    scale = bank.weight.float() * torch.rsqrt(var + eps)
    shift = bank.bias.float() - mean * scale
    view = (1, c) + (1,) * (x.dim() - 2)
    return (xf * scale.reshape(view) + shift.reshape(view)).to(x.dtype)


class _Bank(nn.Module):
    """One domain's affine parameters and f32 running statistics."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('running_mean', torch.zeros(features))
        self.register_buffer('running_var', torch.ones(features))
        self.register_buffer('num_batches_tracked',
                             torch.zeros((), dtype=torch.long))


class DomainBatchNorm(nn.Module):
    momentum = 0.1

    def __init__(self, features: int, num_domains: int = 2,
                 eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.bns = nn.ModuleList(_Bank(features) for _ in range(num_domains))

    def forward(self, x: torch.Tensor, domain: int,
                prelu_alpha: torch.Tensor,
                conv_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """DSBN of ``x [B, C, ...]`` (plus the per-channel ``conv_bias``,
        when given) with bank ``domain``, followed by PReLU with slope
        ``prelu_alpha``: one fused kernel on the card in eval mode; batch
        statistics, the bank update and a separate PReLU in train mode."""
        if not self.training:
            tables = [torch.stack([getattr(b, k) for b in self.bns])
                      for k in ('weight', 'bias', 'running_mean',
                                'running_var')]
            return dsbn_prelu(x, *tables, domain, prelu_alpha, self.eps,
                              conv_bias)
        if conv_bias is not None:
            raise ValueError('conv_bias is folded in eval mode only: in train '
                             'mode the convolution adds its own bias')
        if not 0 <= domain < len(self.bns):
            raise ValueError('domain {0} outside [0, {1})'.format(
                domain, len(self.bns)))
        bank = self.bns[domain]
        mesh = active_mesh()
        if mesh is not None:
            y = global_batch_norm(x, bank, self.momentum, self.eps, mesh)
        else:
            stats = bank.running_mean.dtype
            y = F.batch_norm(x, bank.running_mean, bank.running_var,
                             bank.weight.to(stats), bank.bias.to(stats),
                             True, self.momentum, self.eps)
        bank.num_batches_tracked.add_(1)
        return F.prelu(y, prelu_alpha.to(y.dtype))


class BatchNorm(_Bank):
    """BatchNorm over the channel axis 1 of ``x [B, C, ...]``: batch
    statistics and a running-statistics update in train mode, the running
    statistics in eval mode."""
    momentum = 0.1

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__(features)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stats = self.running_mean.dtype
        if self.training:
            self.num_batches_tracked.add_(1)
            mesh = active_mesh()
            if mesh is not None:
                return global_batch_norm(x, self, self.momentum, self.eps,
                                         mesh)
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight.to(stats), self.bias.to(stats),
                            self.training, self.momentum, self.eps)


class InstanceNorm(nn.InstanceNorm3d):
    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__(features, eps=eps, affine=False,
                         track_running_stats=False)
