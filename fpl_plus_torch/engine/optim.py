"""Optimizer and learning-rate schedule factory (``torch.optim``).

Parity with the reference factory (PyMIC/pymic/net_run/get_optimizer.py:9-57)
and the JAX package's ``engine/optim.py``:

* optimizers: the reference's names map onto ``torch.optim`` with
  ``learning_rate`` / ``momentum`` / ``weight_decay``. Adam takes betas
  (0.9, 0.999) and eps 1e-8 added outside the square root of the second
  moment (optax's and torch's form alike); weight decay is additive L2 on
  the gradient. SparseAdam maps to Adam and ASGD to SGD, as in the JAX
  package. The others keep ``torch.optim``'s defaults, which are the
  reference's (the JAX package's optax choices differ for Adagrad's initial
  accumulator and RMSprop's decay). LBFGS needs a closure the step loop does
  not give, so it raises.
* schedules: MultiStepLR over training iterations (milestones x gamma,
  with the resume offset of a fresh optimizer, ``last_iter``), and the
  host-side ``PlateauScheduler`` (ReduceLROnPlateau in max mode on
  validation dice), copied from the JAX package. The steps that update the
  parameters twice per iteration (the alternating and dual-consistency
  steps) read the schedule at ``update_count // updates_per_iteration``,
  as the JAX package does (``engine/optim.py:146-156`` there); Adam's own
  ``step`` counts updates.

The update count the schedule reads rides in the optimizer's first param
group (``update_count``), so ``optimizer.state_dict()`` saves it and a
resume restores it with the moments.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

_OPTIMIZERS = {
    'sgd': torch.optim.SGD, 'asgd': torch.optim.SGD,
    'adam': torch.optim.Adam, 'sparseadam': torch.optim.Adam,
    'adadelta': torch.optim.Adadelta, 'adagrad': torch.optim.Adagrad,
    'adamax': torch.optim.Adamax, 'rmsprop': torch.optim.RMSprop,
    'rprop': torch.optim.Rprop,
}


def _keyword_match(a: str, b: str) -> bool:
    return a.lower() == b.lower()


def create_optimizer(optim_cfg: dict, params) -> torch.optim.Optimizer:
    """``[training]`` optimizer over ``params``."""
    name = optim_cfg['optimizer']
    key = name.lower()
    if key == 'lbfgs':
        raise NotImplementedError(
            'LBFGS is not ported: torch.optim.LBFGS needs a closure per step')
    if key not in _OPTIMIZERS:
        raise ValueError('unsupported optimizer {0}'.format(name))
    kwargs = {'lr': optim_cfg['learning_rate']}
    weight_decay = optim_cfg.get('weight_decay', 0.0) or 0.0
    if key != 'rprop':               # torch's Rprop takes no weight decay
        kwargs['weight_decay'] = weight_decay
    if key in ('sgd', 'rmsprop'):
        kwargs['momentum'] = optim_cfg.get('momentum', 0.0) or 0.0
    if key in ('adam', 'sparseadam'):
        kwargs.update(betas=(0.9, 0.999), eps=1e-8)
    opt = _OPTIMIZERS[key](params, **kwargs)
    opt.param_groups[0]['update_count'] = 0
    return opt


def create_lr_schedule(sched_params: dict, updates_per_iteration: int = 1
                       ) -> Optional[Callable[[int], float]]:
    """MultiStepLR as ``lr(update_count)``; None for ReduceLROnPlateau
    (``PlateauScheduler``) or when no scheduler is set. Update k (0-based)
    belongs to iteration ``i = k // updates_per_iteration``, whose rate is
    scaled by ``lr_gamma`` once per milestone ``m <= i + offset``;
    ``offset`` is ``last_iter + 1`` for a positive ``last_iter`` (a fresh
    optimizer resumed at iteration ``last_iter + 1``), else 0."""
    name = sched_params.get('lr_scheduler', None)
    if name is None or _keyword_match(name, 'ReduceLROnPlateau'):
        return None
    if not _keyword_match(name, 'MultiStepLR'):
        raise ValueError('unsupported lr scheduler {0}'.format(name))
    lr = sched_params['learning_rate']
    gamma = sched_params['lr_gamma']
    milestones = sched_params['lr_milestones']
    if not isinstance(milestones, (list, tuple)):
        milestones = [milestones]
    milestones = sorted({int(m) for m in milestones})
    last_iter = sched_params.get('last_iter', -1) or -1
    offset = last_iter + 1 if last_iter > 0 else 0

    def schedule(count: int) -> float:
        it = count // updates_per_iteration + offset
        return lr * gamma ** sum(it >= m for m in milestones)

    return schedule


def set_scheduled_lr(optimizer: torch.optim.Optimizer,
                     schedule: Optional[Callable[[int], float]]) -> None:
    """Set every group's rate for the coming update from the schedule (no
    schedule: the rate stays as it is, e.g. the plateau's)."""
    if schedule is None:
        return
    lr = schedule(optimizer.param_groups[0]['update_count'])
    for group in optimizer.param_groups:
        group['lr'] = lr


def count_update(optimizer: torch.optim.Optimizer) -> None:
    optimizer.param_groups[0]['update_count'] += 1


class PlateauScheduler:
    """Host-side ReduceLROnPlateau (max mode on validation dice), parity
    with the reference wiring (get_optimizer.py:44-50: patience =
    ReduceLROnPlateau_patience / iter_valid, factor = lr_gamma) AND with
    torch.optim.lr_scheduler.ReduceLROnPlateau's full semantics: relative
    improvement threshold (torch default 1e-4 — micro-improvements below it
    count as plateau steps), post-reduction cooldown, and a min_lr floor.
    Optional config keys (iteration-denominated like patience):
    ``reducelronplateau_threshold`` / ``_cooldown`` / ``_min_lr``."""

    def __init__(self, sched_params: dict):
        name = sched_params.get('lr_scheduler', None)
        self.enabled = name is not None and _keyword_match(
            name, 'ReduceLROnPlateau')
        if not self.enabled:
            return
        self.factor = sched_params['lr_gamma']
        iter_valid = sched_params['iter_valid']
        patience_it = sched_params['reducelronplateau_patience']
        self.patience = patience_it / iter_valid
        self.threshold = sched_params.get('reducelronplateau_threshold',
                                          1e-4)
        cooldown_it = sched_params.get('reducelronplateau_cooldown', 0)
        self.cooldown = cooldown_it / iter_valid
        base_lr = sched_params.get('learning_rate', 0.0)
        min_lr = sched_params.get('reducelronplateau_min_lr', 0.0)
        self.min_scale = (min_lr / base_lr) if base_lr else 0.0
        self.best = float('-inf')
        self.num_bad = 0
        self.cooldown_counter = 0.0
        self.scale = 1.0

    def _is_better(self, metric: float) -> bool:
        """torch mode='max', threshold_mode='rel':
        a > best * (1 + threshold)."""
        if self.best == float('-inf'):
            return True
        return metric > self.best * (1.0 + self.threshold)

    def step(self, metric: float) -> float:
        """Feed a validation metric; returns the current LR scale."""
        if not self.enabled:
            return 1.0
        if self._is_better(metric):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            self.scale = max(self.scale * self.factor, self.min_scale)
            self.cooldown_counter = self.cooldown
            self.num_bad = 0
        return self.scale
