"""The DSBN training steps: joint (with gradient accumulation), alternating,
dual-consistency, and the discriminator step.

Replicates the JAX package's ``engine/train.py`` (``make_train_step`` and
``make_dual_consistency_step``) and its agent's discriminator step
(``agents/agent_seg.py:308-353`` there), which follow the reference
(PyMIC/pymic/net_run_dsbn/agent_seg.py):

* ``JointTrainStep`` (``dual = True``, reference ``training_all``): forward
  domain 0 then domain 1 (each in train mode, so each updates only its own
  DSBN bank), the per-domain loss with ``pixel_weight`` / ``image_weight``
  when ``train_fpl_uda``, the joint loss ``mean_d loss_d``, one backward
  and one optimizer step. With ``accum_steps > 1`` every microbatch
  differentiates the same parameters, the DSBN running statistics thread
  through the microbatches in order, the gradient, loss and dice are the
  means over the microbatches, and the optimizer updates once.
* ``AlternatingTrainStep`` (``dual = False``): per domain, forward, the
  loss plus ``entropy_coeff x entropy_log2``, backward and one optimizer
  step, so domain 1 sees the parameters after domain 0's update.
* ``DualConsistencyStep``: a domain-0 update on ``(x0, y0)`` plus the
  fake-source translation ``(image1, y1)`` through bank 0, then a domain-1
  update on ``(x1, y1)`` plus ``consis_gate x mean((fake - logits1)^2)``,
  where ``fake`` is an eval-mode, no-gradient domain-0 forward of
  ``image1`` with the parameters after the first update; the entropy term
  on both.
* ``DiscriminatorStep``: eval-mode, no-gradient forwards of each domain's
  batch through the f32 segmenter, softmax, and one LSGAN update of the
  discriminator alone (domain-0 maps and the one-hot labels are real,
  domain-1 maps fake); no adversarial term reaches the segmenter.

Every eval-mode forward inside a step switches the module to ``eval()``
and back to ``train()`` under ``torch.no_grad()``: on the card it runs the
eval DSBN+PReLU kernel, which has no backward. Train-time metrics are the
classwise dice of the one-hot argmax per domain (``class_dice_{d}``).

* The domains run one after the other. The JAX package's
  ``fused_domain_forward`` (one vmap over a stacked domain axis) is an exact
  schedule of the same sums, so the port accepts the key and ignores it.
* Dropout draws from the ``torch.Generator`` given for each forward
  (``models/common.py`` ``grouped_dropout``).
* ``compute_dtype`` (``[training] precision = bfloat16`` or ``float16``)
  mirrors the JAX package's policy (``utils/precision.py``
  ``cast_apply_fn``): copies in that dtype of every parameter (the DSBN
  affine and the PReLU slope included) and of the input feed the forward
  through ``torch.func.functional_call``, so the f32 masters stay
  untouched and receive f32 gradients; the DSBN running
  statistics stay f32 buffers and the batch statistics accumulate in f32;
  the logits are cast to f32 before the loss. ``torch.autocast`` would keep
  the affine terms and slope in f32 and choose per op, which is another
  policy. As in the JAX package there is no loss scaling at f16.

A multi-head network (deep supervision, DualBranch, URPC, CCT) returns a
list: the loss gets the whole list, and the train dice, the entropy term,
the consistency term and the discriminator the primary head ``out[0]``, as
in the JAX package (``engine/train.py:95-106`` there).

Data parallelism (``parallel/mesh.py`` ``make_sharded_train_step``): a
step whose ``mesh`` is set holds this rank's rows of each batch. Every
loss, with its dice, entropy and consistency terms, is evaluated on the
global batch: the prediction is gathered (differentiably; the backward
keeps this rank's rows of a gradient that every rank computes alike) and
so are ``label_prob``, ``pixel_weight`` and ``image_weight``; an eval-mode
forward's output is gathered too. The 13 losses run unchanged. Before each
update the parameter gradients are summed over the ranks, which gives the
global batch's gradient, so every rank takes the same update and reports
the same metrics. The discriminator's LSGAN loss is a mean of per-sample
terms: each rank takes its rows' mean and the gradients are averaged.

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
from fpl_plus_torch.parallel.mesh import gather_segments
from fpl_plus_torch.utils.trace_metrics import span

Batch = Dict[str, torch.Tensor]
Generators = Optional[List[torch.Generator]]
# the batch entries a loss reads beside the prediction: gathered to the
# global batch under a mesh
TARGETS = ('label_prob', 'pixel_weight', 'image_weight')


def sum_gradients(params, mesh) -> None:
    """Sum ``.grad`` of every parameter over the ranks of ``mesh`` (one
    all-reduce of their concatenation)."""
    grads = [p.grad for p in params]
    flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def train_dice(logits: torch.Tensor, label_prob: torch.Tensor
               ) -> torch.Tensor:
    """Classwise dice of the one-hot argmax of ``logits [N, K, *sp]``
    against the one-hot ``label_prob`` (reference agent_seg.py:362-372)."""
    k = logits.shape[1]
    hard = F.one_hot(logits.argmax(1), k).to(torch.float32)
    return get_classwise_dice(hard.reshape(-1, k), reshape_to_2d(label_prob))


def primary_head(out):
    """The first head of a multi-head output, else the output itself."""
    return out[0] if isinstance(out, (list, tuple)) else out


def entropy_log2(logits: torch.Tensor) -> torch.Tensor:
    """The reference's entropy regulariser (agent_seg.py:352-354): the
    summed voxel entropy in bits of the softmax over the class axis of
    ``logits [N, K, *sp]``, divided by N x spatial size."""
    p = torch.softmax(logits, 1)
    ent = -(p * torch.log2(p + 1e-10)).sum()
    return ent / (logits.numel() // logits.shape[1])


class _Step:
    """What the steps share: the (cast) forward, the loss of one domain
    batch and one optimizer update."""

    def __init__(self, module: nn.Module, loss_calculator: Callable,
                 optimizer: torch.optim.Optimizer,
                 schedule: Optional[Callable[[int], float]] = None,
                 fpl_uda: bool = False,
                 compute_dtype: Optional[torch.dtype] = None):
        self.module = module
        self.loss_calculator = loss_calculator
        self.optimizer = optimizer
        self.schedule = schedule
        self.fpl_uda = fpl_uda
        self.compute_dtype = compute_dtype
        self.mesh = None    # set by parallel.mesh.make_sharded_train_step

    def _global_targets(self, batch):
        """``batch`` with its loss targets gathered over the mesh (this
        rank's ``image`` / ``image1`` stay); nested sequences of batches
        (microbatches) map; the batch itself without a mesh."""
        if self.mesh is None:
            return batch
        if isinstance(batch, (list, tuple)):
            return type(batch)(self._global_targets(b) for b in batch)
        return {k: self.mesh.gather_rows(v) if k in TARGETS else v
                for k, v in batch.items()}

    def _gather(self, out, segments=None):
        """The gathered global-batch prediction (each head, each peer's)
        in the one-card order: of a batch of consecutive ``segments``
        (``parallel/mesh.py`` ``gather_segments``; None: one); itself
        without a mesh."""
        if self.mesh is None:
            return out
        if isinstance(out, (list, tuple)):
            return type(out)(self._gather(o, segments) for o in out)
        return gather_segments(out, segments or (out.shape[0],), self.mesh)

    def _params(self):
        """Copies of the parameters in the compute dtype (None at f32: the
        module's own)."""
        if self.compute_dtype is None:
            return None
        return {k: p.to(self.compute_dtype)
                for k, p in self.module.named_parameters()}

    def _forward(self, params, x, domain, generators):
        if self.compute_dtype is None:
            return self.module(x, domain, generators)
        out = functional_call(self.module, params,
                              (x.to(self.compute_dtype), domain),
                              {'dropout_generators': generators})
        if isinstance(out, (list, tuple)):
            return [o.float() for o in out]
        return out.float()

    def _domain_loss(self, params, batch: Batch, domain: int,
                     generators: Generators):
        """(loss, primary-head logits) of one train-mode domain forward;
        under a mesh ``batch`` holds the global targets and both are the
        global batch's."""
        out = self._gather(self._forward(params, batch['image'], domain,
                                         generators))
        loss_input = {'prediction': out, 'ground_truth': batch['label_prob']}
        if self.fpl_uda and 'pixel_weight' in batch:
            loss_input['pixel_weight'] = batch['pixel_weight']
            if 'image_weight' in batch:
                loss_input['image_weight'] = batch['image_weight']
        return self.loss_calculator(loss_input), primary_head(out)

    def _eval_forward(self, params, x, domain):
        """An eval-mode (running statistics, no dropout), no-gradient
        forward of the primary head; the module returns to train mode."""
        self.module.eval()
        try:
            with torch.no_grad():
                out = primary_head(self._forward(params, x, domain,
                                                 None)).float()
                return out if self.mesh is None else \
                    self.mesh.gather_rows(out)
        finally:
            self.module.train()

    def _zero_grads(self) -> None:
        """Zero gradients for every parameter, also those this update's
        loss does not reach (the other domain's DSBN bank): the optimizer
        then steps every parameter on every update, with a zero gradient
        where there is none, as optax does (its Adam decays those moments,
        moves the parameter on them, and keeps one update count for all
        parameters); ``torch.optim`` would skip a parameter whose gradient
        is None."""
        self.optimizer.zero_grad(set_to_none=False)
        for group in self.optimizer.param_groups:
            for p in group['params']:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)

    def _update(self, loss: Optional[torch.Tensor]) -> None:
        """One optimizer update: from ``loss`` (backward first), or from
        the gradients already in ``.grad`` when ``loss`` is None."""
        if loss is not None:
            self._zero_grads()
            loss.backward()
        if self.mesh is not None:
            sum_gradients([p for g in self.optimizer.param_groups
                           for p in g['params']], self.mesh)
        set_scheduled_lr(self.optimizer, self.schedule)
        with span('optimizer_step'):
            self.optimizer.step()
        count_update(self.optimizer)


class JointTrainStep(_Step):
    """``step(batches, generators) -> metrics``: one joint iteration.

    ``batches``: one dict per domain of device tensors ``image [N, C, *sp]``,
    ``label_prob [N, K, *sp]`` and, for ``fpl_uda``, ``pixel_weight
    [N, 1, *sp]`` and ``image_weight [N]``. ``generators``: one list of
    dropout generators per domain (or None). With ``accum_steps`` > 1 each
    domain's entry is a sequence of ``accum_steps`` such dicts
    (generators: of such lists), microbatch m of every domain forming
    microbatch m. The module must be in train mode."""

    def __init__(self, module, loss_calculator, optimizer, schedule=None,
                 num_domains: int = 2, fpl_uda: bool = False,
                 compute_dtype=None, accum_steps: int = 1):
        super().__init__(module, loss_calculator, optimizer, schedule,
                         fpl_uda, compute_dtype)
        if accum_steps < 1:
            raise ValueError('accum_steps must be >= 1, got {0}'.format(
                accum_steps))
        self.num_domains = num_domains
        self.accum_steps = accum_steps

    def _joint(self, batches, generators):
        """Joint loss and per-domain logits of one (micro)batch."""
        params = self._params()
        total, logits_all = 0.0, []
        for d, batch in enumerate(batches):
            loss_d, out = self._domain_loss(params, batch, d, generators[d])
            total = total + loss_d
            logits_all.append(out.detach())
        return total / self.num_domains, logits_all

    def __call__(self, batches: Sequence, generators: Sequence
                 ) -> Dict[str, torch.Tensor]:
        if len(batches) != self.num_domains:
            raise ValueError('{0} domain batches for {1} domains'.format(
                len(batches), self.num_domains))
        batches = [self._global_targets(b) for b in batches]
        if self.accum_steps == 1:
            micro, micro_gens = [batches], [generators]
        else:
            for d, b in enumerate(batches):
                if len(b) != self.accum_steps:
                    raise ValueError('domain {0}: {1} microbatches for '
                                     'accum_steps {2}'.format(
                                         d, len(b), self.accum_steps))
            micro = list(zip(*batches))
            micro_gens = list(zip(*[g if g is not None
                                    else [None] * self.accum_steps
                                    for g in generators]))
        self._zero_grads()
        losses, dices = [], []
        for mb, mg in zip(micro, micro_gens):
            loss, logits_all = self._joint(mb, mg)
            loss.backward()
            losses.append(loss.detach())
            with torch.no_grad():
                dices.append([train_dice(logits_all[d], mb[d]['label_prob'])
                              for d in range(self.num_domains)])
        if self.accum_steps > 1:
            for p in self.module.parameters():
                p.grad.mul_(1.0 / self.accum_steps)
        self._update(None)
        metrics = {'loss': torch.stack(losses).mean()}
        for d in range(self.num_domains):
            metrics['class_dice_{0}'.format(d)] = torch.stack(
                [dc[d] for dc in dices]).mean(0)
        return metrics


class AlternatingTrainStep(_Step):
    """``step(batches, generators) -> metrics``: per domain in order, the
    loss (plus ``entropy_coeff`` x ``entropy_log2`` of its logits) and one
    optimizer update; the metric ``loss`` is the mean of the domains'."""

    def __init__(self, module, loss_calculator, optimizer, schedule=None,
                 num_domains: int = 2, fpl_uda: bool = False,
                 compute_dtype=None, entropy_coeff: float = 0.0):
        super().__init__(module, loss_calculator, optimizer, schedule,
                         fpl_uda, compute_dtype)
        self.num_domains = num_domains
        self.entropy_coeff = entropy_coeff

    def __call__(self, batches: Sequence[Batch],
                 generators: Sequence[Generators]) -> Dict[str, torch.Tensor]:
        if len(batches) != self.num_domains:
            raise ValueError('{0} domain batches for {1} domains'.format(
                len(batches), self.num_domains))
        metrics, losses = {}, []
        for d, batch in enumerate(map(self._global_targets, batches)):
            loss, out = self._domain_loss(self._params(), batch, d,
                                          generators[d])
            if self.entropy_coeff:
                loss = loss + self.entropy_coeff * entropy_log2(out)
            self._update(loss)
            losses.append(loss.detach())
            with torch.no_grad():
                metrics['class_dice_{0}'.format(d)] = train_dice(
                    out.detach(), batch['label_prob'])
        metrics['loss'] = torch.stack(losses).mean()
        return metrics


class DualConsistencyStep(_Step):
    """``step((batch0, batch1), generators, consis_gate) -> metrics``.
    ``batch1`` carries ``image1``; ``generators``: three lists (or None),
    for the domain-0 forward, the fake-source forward and the domain-1
    forward. Metrics: ``loss`` (the mean of the two updates' losses),
    ``class_dice_0``, ``class_dice_1`` and ``loss_consis``."""

    def __init__(self, module, loss_calculator, optimizer, schedule=None,
                 fpl_uda: bool = False, compute_dtype=None,
                 entropy_coeff: float = 1.0):
        super().__init__(module, loss_calculator, optimizer, schedule,
                         fpl_uda, compute_dtype)
        self.entropy_coeff = entropy_coeff

    def _entropy(self, logits):
        return self.entropy_coeff * entropy_log2(logits) \
            if self.entropy_coeff else 0.0

    def __call__(self, batches: Sequence[Batch],
                 generators: Sequence[Generators], consis_gate: float
                 ) -> Dict[str, torch.Tensor]:
        batch0, batch1 = map(self._global_targets, batches)
        if 'image1' not in batch1:
            raise ValueError('the dual-consistency step needs image1 in the '
                             'domain-1 batch (an image1 manifest column)')
        # domain-0 update: (x0, y0) and the fake source (image1, y1)
        params = self._params()
        l0, logits0 = self._domain_loss(params, batch0, 0, generators[0])
        fake_batch = dict(batch1, image=batch1['image1'])
        l_fake, _ = self._domain_loss(params, fake_batch, 0, generators[1])
        loss0 = l0 + l_fake + self._entropy(logits0)
        self._update(loss0)
        # domain-1 update against the new parameters' eval-mode view of
        # the fake source
        params = self._params()
        fake = self._eval_forward(params, batch1['image1'], 0)
        l1, logits1 = self._domain_loss(params, batch1, 1, generators[2])
        consis = torch.mean(torch.square(fake - logits1))
        loss1 = l1 + consis_gate * consis + self._entropy(logits1)
        self._update(loss1)
        with torch.no_grad():
            return {'loss': (loss0.detach() + loss1.detach()) / 2,
                    'class_dice_0': train_dice(logits0.detach(),
                                               batch0['label_prob']),
                    'class_dice_1': train_dice(logits1.detach(),
                                               batch1['label_prob']),
                    'loss_consis': consis.detach()}


class DiscriminatorStep:
    """``step(batches) -> {'loss_dis'}``: the LSGAN update of ``dis``
    (reference agent_seg.py:96-102,373-400) on the softmax maps of eval-mode,
    no-gradient forwards of the f32 segmenter ``module``, one per domain
    batch."""

    def __init__(self, module: nn.Module, dis: nn.Module,
                 optimizer: torch.optim.Optimizer):
        self.module = module
        self.dis = dis
        self.optimizer = optimizer
        self.mesh = None    # set by parallel.mesh.make_sharded_train_step

    def __call__(self, batches: Sequence[Batch]) -> Dict[str, torch.Tensor]:
        self.module.eval()
        try:
            with torch.no_grad():
                outs = [torch.softmax(primary_head(
                    self.module(b['image'], d)).float(), 1)
                    for d, b in enumerate(batches)]
        finally:
            self.module.train()
        pred_real = self.dis(outs[0])
        real = self.dis(batches[0]['label_prob'])
        loss = (torch.mean((pred_real - 1.0) ** 2)
                + torch.mean((real - 1.0) ** 2)) / 2.0
        if len(outs) > 1:
            loss = loss + torch.mean(self.dis(outs[1]) ** 2)
        self.optimizer.zero_grad()
        loss.backward()
        loss = loss.detach()
        if self.mesh is not None:
            # means over equal row shares: the global mean is their mean
            params = list(self.dis.parameters())
            sum_gradients(params, self.mesh)
            for p in params:
                p.grad.div_(self.mesh.size)
            loss = self.mesh.all_reduce(loss.clone()) / self.mesh.size
        self.optimizer.step()
        return {'loss_dis': loss}
