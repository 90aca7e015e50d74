"""Optimizer and learning-rate schedule factory (``torch.optim``).

Parity with the reference factory (PyMIC/pymic/net_run/get_optimizer.py:9-57)
and the JAX package's ``engine/optim.py``:

* optimizers: the reference's names map onto ``torch.optim`` with
  ``learning_rate`` / ``momentum`` / ``weight_decay``. Adam takes betas
  (0.9, 0.999) and eps 1e-8 added outside the square root of the second
  moment (optax's and torch's form alike); weight decay is additive L2 on
  the gradient. SparseAdam maps to Adam and ASGD to SGD, as in the JAX
  package. The others keep ``torch.optim``'s defaults, which are the
  reference's and the contract the JAX module's docstring names (its optax
  choices differ for Adagrad's initial accumulator and RMSprop's decay).
  LBFGS is ``LBFGS`` below: optax's ``lbfgs(lr, linesearch=None)``, which
  the JAX package runs; ``torch.optim.LBFGS`` would need a closure per
  step.
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


class LBFGS(torch.optim.Optimizer):
    """optax 0.2.6's ``lbfgs(lr, linesearch=None)``: ``scale_by_lbfgs``
    (memory 10, ``scale_init_precond``) then ``-lr``, so the update is
    ``-lr`` times the two-loop direction of the gradient; no line search,
    so ``step()`` needs no closure, and no weight decay, as in the JAX
    package.

    All parameters form one flat vector (the inner products run over the
    whole network, as optax's tree ``vdot`` does). Per step, with w the
    parameters and g the gradient: from the second step the pair
    ``(w - w_prev, g - g_prev)`` and its weight ``1 / <dg, dw>`` (0 where
    that is 0) enter the ring slot of the previous step; the initial
    inverse Hessian is ``<dg, dw> / |dg|^2`` times the identity (1 where
    ``|dg|`` is 0), at the first step ``min(1, 1 / |g|)``; then the two
    loops over the ring, oldest pair innermost."""

    def __init__(self, params, lr: float, memory_size: int = 10):
        super().__init__(params, {'lr': lr})
        if len(self.param_groups) != 1:
            raise ValueError('LBFGS takes one parameter group')
        self.memory_size = memory_size

    def _flat(self, grads: bool) -> torch.Tensor:
        return torch.cat([(p.grad if grads else p).detach().reshape(-1)
                          for p in self.param_groups[0]['params']])

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        group = self.param_groups[0]
        params = group['params']
        w, g = self._flat(False), self._flat(True)
        m = self.memory_size
        state = self.state[params[0]]
        if not state:
            state.update(count=0, w_prev=torch.zeros_like(w),
                         g_prev=torch.zeros_like(g),
                         dw=torch.zeros((m,) + w.shape, dtype=w.dtype,
                                        device=w.device),
                         dg=torch.zeros((m,) + w.shape, dtype=w.dtype,
                                        device=w.device),
                         rho=torch.zeros(m, dtype=w.dtype, device=w.device))
        count = int(state['count'])
        dw, dg, rho = state['dw'], state['dg'], state['rho']
        if count > 0:
            prev = (count - 1) % m
            dw[prev] = w - state['w_prev']
            dg[prev] = g - state['g_prev']
            curv = torch.dot(dg[prev], dw[prev])
            rho[prev] = torch.where(curv == 0, torch.zeros_like(curv),
                                    1.0 / curv)
            den = torch.dot(dg[prev], dg[prev])
            gamma = torch.where(den > 0, curv / den, torch.ones_like(den))
        else:
            gamma = torch.clamp(1.0 / torch.linalg.vector_norm(g), max=1.0)
        order = [(count + j) % m for j in range(m)]
        vec, alphas = g.clone(), {}
        for i in reversed(order):
            alphas[i] = rho[i] * torch.dot(dw[i], vec)
            vec -= alphas[i] * dg[i]
        vec *= gamma
        for i in order:
            beta = rho[i] * torch.dot(dg[i], vec)
            vec += (alphas[i] - beta) * dw[i]
        state['w_prev'], state['g_prev'] = w, g
        state['count'] = count + 1
        offset = 0
        for p in params:
            n = p.numel()
            p.add_(vec[offset:offset + n].view_as(p), alpha=-group['lr'])
            offset += n
        return loss

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
        opt = LBFGS(params, lr=optim_cfg['learning_rate'])
        opt.param_groups[0]['update_count'] = 0
        return opt
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
