"""Domain-Specific Batch Normalization (DSBN), eval mode.

Reference semantics (PyMIC/pymic/net_run_dsbn/dsbn.py:4-64): a bank of
independent BatchNorm layers, one per domain; the whole batch belongs to one
domain and ``bns[domain]`` is selected. Parameters and running statistics
keep the reference key names ``bns.{d}.weight/bias/running_mean/
running_var/num_batches_tracked``; statistics are f32 buffers, eps 1e-5.

Only the eval path is ported: it normalises with the running statistics and
applies the following PReLU in the same fused kernel. Train mode (batch
statistics and the momentum update of the selected bank) belongs to the
training slice in ROADMAP.md.
"""
from __future__ import annotations

import torch
from torch import nn

from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu


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
    def __init__(self, features: int, num_domains: int = 2,
                 eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.bns = nn.ModuleList(_Bank(features) for _ in range(num_domains))

    def forward(self, x: torch.Tensor, domain: int,
                prelu_alpha: torch.Tensor) -> torch.Tensor:
        """Eval DSBN of ``x [B, C, ...]`` with bank ``domain``, followed by
        PReLU with slope ``prelu_alpha`` (one fused kernel on the card)."""
        if self.training:
            raise NotImplementedError(
                'DSBN train mode is not yet ported (training slice, '
                'ROADMAP.md); call model.eval()')
        tables = [torch.stack([getattr(b, k) for b in self.bns])
                  for k in ('weight', 'bias', 'running_mean', 'running_var')]
        return dsbn_prelu(x, *tables, domain, prelu_alpha, self.eps)
