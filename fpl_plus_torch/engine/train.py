"""The dual-domain joint training step (DSBN).

Replicates the JAX package's ``make_train_step`` joint path
(``engine/train.py:180-241`` there) and the reference ``training_all``
(PyMIC/pymic/net_run_dsbn/agent_seg.py:415-508): per iteration, forward
domain 0 then domain 1 (each in train mode, so each updates only its own
DSBN bank), the per-domain loss with ``pixel_weight`` / ``image_weight``
when ``train_fpl_uda``, the joint loss ``mean_d loss_d``, one backward and
one optimizer step; train-time metrics are the classwise dice of the one-hot
argmax per domain (``class_dice_{d}``).

* The domains run one after the other. The JAX package's
  ``fused_domain_forward`` (one vmap over a stacked domain axis) is an exact
  schedule of the same sums, so the port accepts the key and ignores it.
* Dropout draws from the ``torch.Generator`` given for each domain's forward
  (``models/common.py`` ``grouped_dropout``).
* ``compute_dtype`` (``[training] precision = bfloat16``) mirrors the JAX
  package's policy (``utils/precision.py`` ``cast_apply_fn``): bf16 copies
  of every parameter (the DSBN affine and the PReLU slope included) and of
  the input feed the forward through ``torch.func.functional_call``, so the
  f32 masters stay untouched and receive f32 gradients; the DSBN running
  statistics stay f32 buffers and the batch statistics accumulate in f32;
  the logits are cast to f32 before the loss. ``torch.autocast`` would keep
  the affine terms and slope in f32 and choose per op, which is another
  policy.

Metrics stay on the device; the caller converts them once per block.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from fpl_plus_torch.engine.optim import count_update, set_scheduled_lr
from fpl_plus_torch.losses.util import get_classwise_dice, reshape_to_2d


def train_dice(logits: torch.Tensor, label_prob: torch.Tensor
               ) -> torch.Tensor:
    """Classwise dice of the one-hot argmax of ``logits [N, K, *sp]``
    against the one-hot ``label_prob`` (reference agent_seg.py:362-372)."""
    k = logits.shape[1]
    hard = F.one_hot(logits.argmax(1), k).to(torch.float32)
    return get_classwise_dice(hard.reshape(-1, k), reshape_to_2d(label_prob))


class JointTrainStep:
    """``step(batches, generators) -> metrics``: one joint iteration.

    ``batches``: one dict per domain of device tensors ``image [N, C, *sp]``,
    ``label_prob [N, K, *sp]`` and, for ``fpl_uda``, ``pixel_weight
    [N, 1, *sp]`` and ``image_weight [N]``. ``generators``: one list of
    dropout generators per domain (or None). The module must be in train
    mode."""

    def __init__(self, module: nn.Module, loss_calculator: Callable,
                 optimizer: torch.optim.Optimizer,
                 schedule: Optional[Callable[[int], float]] = None,
                 num_domains: int = 2, fpl_uda: bool = False,
                 compute_dtype: Optional[torch.dtype] = None):
        self.module = module
        self.loss_calculator = loss_calculator
        self.optimizer = optimizer
        self.schedule = schedule
        self.num_domains = num_domains
        self.fpl_uda = fpl_uda
        self.compute_dtype = compute_dtype

    def _forward(self, params, x, domain, generators):
        if self.compute_dtype is None:
            return self.module(x, domain, generators)
        return functional_call(self.module, params,
                               (x.to(self.compute_dtype), domain),
                               {'dropout_generators': generators}).float()

    def _loss_input(self, out, batch):
        loss_input = {'prediction': out, 'ground_truth': batch['label_prob']}
        if self.fpl_uda and 'pixel_weight' in batch:
            loss_input['pixel_weight'] = batch['pixel_weight']
            if 'image_weight' in batch:
                loss_input['image_weight'] = batch['image_weight']
        return loss_input

    def __call__(self, batches: Sequence[Dict[str, torch.Tensor]],
                 generators: Sequence[Optional[List[torch.Generator]]]
                 ) -> Dict[str, torch.Tensor]:
        if len(batches) != self.num_domains:
            raise ValueError('{0} domain batches for {1} domains'.format(
                len(batches), self.num_domains))
        params = None
        if self.compute_dtype is not None:
            params = {k: p.to(self.compute_dtype)
                      for k, p in self.module.named_parameters()}
        total, logits_all = 0.0, []
        for d, batch in enumerate(batches):
            out = self._forward(params, batch['image'], d, generators[d])
            total = total + self.loss_calculator(self._loss_input(out, batch))
            logits_all.append(out.detach())
        loss = total / self.num_domains
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        set_scheduled_lr(self.optimizer, self.schedule)
        self.optimizer.step()
        count_update(self.optimizer)
        metrics = {'loss': loss.detach()}
        with torch.no_grad():
            for d, batch in enumerate(batches):
                metrics['class_dice_{0}'.format(d)] = train_dice(
                    logits_all[d], batch['label_prob'])
        return metrics
