"""Semi-supervised segmentation agents (reference PyMIC/pymic/net_run_ssl/,
the JAX package's ``agents/ssl.py``): EntropyMinimization (ssl_em.py),
MeanTeacher (ssl_mt.py), UAMT (ssl_uamt.py), CCT (ssl_cct.py), CPS
(ssl_cps.py) and URPC (ssl_urpc.py); registry ``SSLMethodDict``
(ssl_main.py:15-20).

``ParadigmAgent`` is what these and the WSL agents (``agents/wsl.py``)
share on top of ``SegmentationAgent``, whose training loop they run:

* ``training_hyper``: ``regular_w = regularize_w x`` the sigmoid ramp
  between ``rampup_start`` (default 0) and ``rampup_end`` (default
  ``iter_max``) of the paradigm's section;
* one step object per method (``ParadigmStep``, in the style of
  ``engine/train.py``'s steps): every forward is a train-mode domain-0
  forward; one optimizer update; the metrics ``loss``, ``loss_sup``,
  ``loss_reg`` and ``class_dice_0`` of the labelled rows' primary head;
* the EMA teacher of MeanTeacher, UAMT and USTM (``EMATeacher``): a second
  parameter set, ``ema = alpha ema + (1 - alpha) student`` after each
  update with ``alpha = min(1 - 1 / (iter_max + 1), ema_decay)``, saved in
  each checkpoint (``ema_state_dict``) and restored on resume. A teacher
  forward runs the student's module in train mode on the teacher's
  parameters and on copies of the student's running statistics, so its
  batch-norm updates are discarded (the JAX package's ``ema_out, _ =``);
* the random draws of iteration ``it`` (``Draws``): forward k's dropout
  from a ``torch.Generator`` seeded ``SeedSequence([random_seed, it, k])``
  and its input noise (N(0, 0.1^2) clipped to +-0.2, ``noise_like``) from
  ``SeedSequence([random_seed, it, k, 1])``. Student forward 0, teacher
  forward 1, MC-dropout passes 2 .. T+1. They never equal the JAX
  package's threefry draws;
* gradient accumulation raises ``ValueError``, as in the JAX package;
* data parallelism (``parallel/mesh.py``, the segmentation agent's
  training loop): each rank holds its rows of every stream (the
  unlabelled batch, ``train_batch_size_unlab``, must divide over the ranks
  as the labelled one does); a forward of both streams in one batch runs
  under ``batch_segments``, so its dropout masks are the one-card masks'
  rows of this rank, and every output is gathered in the one-card order
  (``gather_segments``: all labelled rows, then all unlabelled rows), the
  loss targets too (``_Step._global_targets``), and so is the teacher's
  output; the input noise draws the global stream's and keeps the rank's
  rows. So every loss, mask and metric is the global batch's, the ranks'
  gradients sum to the one-card gradient, every rank takes the same
  update, and the teacher, updated from the replicated student, stays the
  same on every rank. A host value a step reads (USTM's rotation, DMPLS's
  ``beta``) is rank 0's (``ParadigmStep.shared``).

The SSL agents read ``[semi_supervised_learning]`` and a second train
stream, the unlabelled manifest ``train_csv_unlab`` with
``train_transform_unlab`` in batches of ``train_batch_size_unlab``,
shuffled with seed ``random_seed + 100`` and produced by the train loaders'
worker processes; each iteration concatenates the
labelled and the unlabelled images into one student forward.
"""
from __future__ import annotations

import logging
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from fpl_plus_torch.agents.agent_seg import SegmentationAgent, _host_batch
from fpl_plus_torch.engine.train import _Step, primary_head, train_dice
from fpl_plus_torch.io.dataset import NiftyDataset
from fpl_plus_torch.io.loader import DataLoader, repeat_loader
from fpl_plus_torch.losses import create_loss_calculator
from fpl_plus_torch.losses.seg import EntropyLoss
from fpl_plus_torch.models.common import resize_linear
from fpl_plus_torch.models.multi_net import make_binet
from fpl_plus_torch.models.registry import param_count
from fpl_plus_torch.parallel.mesh import active_mesh, batch_segments
from fpl_plus_torch.transforms.trans_dict import build_transforms
from fpl_plus_torch.utils.ramps import get_rampup_ratio


def noise_like(generator: torch.Generator, x: torch.Tensor) -> torch.Tensor:
    """Teacher input noise: N(0, 0.1^2) per voxel, clipped to +-0.2.
    Within a data-parallel step ``x`` is this rank's rows of a stream: the
    generator draws the global stream's noise and the rank keeps its rows,
    as ``models/common.py`` ``group_rand`` does."""
    mesh = active_mesh()
    n = x.shape[0]
    rows = n if mesh is None else n * mesh.size
    noise = torch.randn((rows,) + tuple(x.shape[1:]), generator=generator,
                        device=x.device, dtype=x.dtype)
    if mesh is not None:
        noise = noise[mesh.rank * n:(mesh.rank + 1) * n]
    return torch.clamp(noise * 0.1, -0.2, 0.2)


def one_hot_argmax(logits: torch.Tensor) -> torch.Tensor:
    """One-hot ``[N, K, *sp]`` f32 of the argmax over the class axis."""
    return F.one_hot(logits.argmax(1), logits.shape[1]).movedim(
        -1, 1).to(torch.float32)


def head_rows(out, rows: slice):
    """Rows ``rows`` of every head of ``out``."""
    if isinstance(out, (list, tuple)):
        return [o[rows] for o in out]
    return out[rows]


class Draws:
    """The random streams of one training iteration (module docstring)."""

    def __init__(self, device, seed: int, iteration: int, dropout: bool):
        self.device = torch.device(device)
        self.seed = int(seed)
        self.iteration = int(iteration)
        self.with_dropout = dropout

    def generator(self, *tail: int) -> torch.Generator:
        seed = np.random.SeedSequence([self.seed, self.iteration, *tail]
                                      ).generate_state(1)[0]
        return torch.Generator(self.device).manual_seed(int(seed))

    def dropout(self, k: int):
        """Forward k's dropout generators (None: the net draws nothing)."""
        return [self.generator(k)] if self.with_dropout else None

    def noise(self, k: int) -> torch.Generator:
        return self.generator(k, 1)


class EMATeacher:
    """The mean teacher's parameters (reference ssl_mt.py:108-112), named
    as the student's ``named_parameters``."""

    def __init__(self, module: torch.nn.Module, alpha: float):
        self.alpha = float(alpha)
        self.params = {k: p.detach().clone()
                       for k, p in module.named_parameters()}

    @torch.no_grad()
    def update(self, module: torch.nn.Module) -> None:
        student = dict(module.named_parameters())
        ema = list(self.params.values())
        torch._foreach_mul_(ema, self.alpha)
        torch._foreach_add_(ema, [student[k].detach() for k in self.params],
                            alpha=1.0 - self.alpha)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return dict(self.params)

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        if set(state) != set(self.params):
            raise ValueError('teacher state names differ from the network')
        for k, v in self.params.items():
            v.copy_(state[k])


class ParadigmStep(_Step):
    """What the SSL and WSL steps share. ``step(batches, draws,
    regular_w, ...) -> metrics``; the module must be in train mode.
    ``weighted``: the supervised loss takes the batch's ``pixel_weight``
    (the WSL scribbles)."""

    def __init__(self, module, loss_calculator, optimizer, schedule=None,
                 compute_dtype=None, teacher: EMATeacher = None,
                 weighted: bool = False):
        super().__init__(module, loss_calculator, optimizer, schedule,
                         compute_dtype=compute_dtype)
        self.teacher = teacher
        self.weighted = weighted

    def student(self, x, generators, segments=None):
        """The train-mode domain-0 forward (f32 logits) of ``x``, a batch
        of consecutive ``segments`` (None: one); under a mesh ``x`` holds
        this rank's rows of each and the output is the global batch's in
        the one-card order."""
        with batch_segments(segments):
            out = self._forward(self._params(), x, 0, generators)
        return self._gather(out, segments)

    def shared(self, value: float) -> float:
        """A host value of the step as rank 0 holds it (itself without a
        mesh): every rank then computes alike and runs the same
        collectives."""
        if self.mesh is None:
            return value
        t = torch.tensor([float(value)], dtype=torch.float64,
                         device=self.mesh.device)
        return float(self.mesh.broadcast(t).item())

    def global_batch(self, batch, image: bool = False):
        """``batch`` with its loss targets (and, with ``image``, its image)
        gathered to the global batch under a mesh; itself without one."""
        out = self._global_targets(batch)
        if image and self.mesh is not None:
            out = dict(out, image=self.mesh.gather_rows(batch['image']))
        return out

    def ssl_inputs(self, batches):
        """The labelled batch (its targets global), the labelled and
        unlabelled images in one batch, the count of labelled rows in the
        global batch and the two streams' row counts here."""
        lab, unlab = batches['lab'], batches['unlab']
        n0, n1 = lab['image'].shape[0], unlab['image'].shape[0]
        ranks = 1 if self.mesh is None else self.mesh.size
        return (self._global_targets(lab),
                torch.cat([lab['image'], unlab['image']]), n0 * ranks,
                (n0, n1))

    def teacher_head(self, x, generators) -> torch.Tensor:
        """The primary head of the teacher's train-mode forward, without
        gradient (gathered to the global batch under a mesh); its
        batch-norm updates land on copies of the running statistics
        (functional_call would otherwise update the student's buffers in
        place)."""
        params = self.teacher.params
        if self.compute_dtype is not None:
            params = {k: v.to(self.compute_dtype) for k, v in params.items()}
            x = x.to(self.compute_dtype)
        state = dict(params)
        state.update((k, b.clone()) for k, b in self.module.named_buffers())
        with torch.no_grad():
            out = functional_call(self.module, state, (x, 0),
                                  {'dropout_generators': generators})
            head = primary_head(out).float()
            return head if self.mesh is None else self.mesh.gather_rows(head)

    def sup(self, prediction, batch) -> torch.Tensor:
        loss_input = {'prediction': prediction,
                      'ground_truth': batch['label_prob']}
        if self.weighted and 'pixel_weight' in batch:
            loss_input['pixel_weight'] = batch['pixel_weight']
        return self.loss_calculator(loss_input)

    def finish(self, loss, loss_sup, loss_reg, logits, label_prob):
        """One update from ``loss``, then the teacher's; the metrics."""
        self._update(loss)
        if self.teacher is not None:
            self.teacher.update(self.module)
        with torch.no_grad():
            return {'loss': loss.detach(), 'loss_sup': loss_sup.detach(),
                    'loss_reg': loss_reg.detach(),
                    'class_dice_0': train_dice(logits.detach(), label_prob)}


class UncertainTeacherStep(ParadigmStep):
    """What UAMT and USTM share: the teacher on its noised input, and the
    voxels where T noised MC-dropout passes of the teacher are certain."""

    def __init__(self, *args, passes: int = 8, base_w: float = 0.1,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.passes = passes
        self.base_w = base_w

    def teacher_and_mask(self, x, draws, regular_w):
        """The teacher's softmax of ``x`` (forward 1) and the certainty
        mask of its MC passes (forwards 2 .. T+1)."""
        soft = torch.softmax(self.teacher_head(
            x + noise_like(draws.noise(1), x), draws.dropout(1)), 1)
        mc = 0.0
        for t in range(self.passes):
            mc = mc + torch.softmax(self.teacher_head(
                x + noise_like(draws.noise(2 + t), x),
                draws.dropout(2 + t)), 1)
        mean = mc / self.passes
        entropy = -torch.sum(mean * torch.log(mean + 1e-6), 1, keepdim=True)
        # the threshold ramps with regular_w = base_w x ratio: (0.75 +
        # 0.25 ratio) log K (NaN at base_w 0: no voxel passes then)
        ratio = regular_w / self.base_w if self.base_w else float('nan')
        threshold = (0.75 + 0.25 * ratio) * math.log(mean.shape[1])
        return soft, (entropy < threshold).to(torch.float32)

    @staticmethod
    def masked_mse(student_soft, teacher_soft, mask):
        sq = torch.square(student_soft - teacher_soft)
        return torch.sum(mask * sq) / (2 * torch.sum(mask) + 1e-16)


class EntropyMinimizationStep(ParadigmStep):
    """ssl_em.py:16-109: the supervised loss of the labelled rows plus the
    ramped entropy of the whole batch."""

    def __call__(self, batches, draws, regular_w):
        lab, x, n0, seg = self.ssl_inputs(batches)
        out = self.student(x, draws.dropout(0), seg)
        loss_sup = self.sup(head_rows(out, slice(0, n0)), lab)
        loss_reg = EntropyLoss({})({'prediction': out})
        return self.finish(loss_sup + regular_w * loss_reg, loss_sup,
                           loss_reg, primary_head(out)[:n0],
                           lab['label_prob'])


class MeanTeacherStep(ParadigmStep):
    """ssl_mt.py:16-134: the MSE between the student's and the teacher's
    softmax on the unlabelled rows (the teacher's input noised)."""

    def __call__(self, batches, draws, regular_w):
        lab, x, n0, seg = self.ssl_inputs(batches)
        x1 = batches['unlab']['image']
        soft_ema = torch.softmax(self.teacher_head(
            x1 + noise_like(draws.noise(1), x1), draws.dropout(1)), 1)
        primary = primary_head(self.student(x, draws.dropout(0), seg))
        loss_sup = self.sup(primary[:n0], lab)
        loss_reg = torch.mean(torch.square(torch.softmax(primary[n0:], 1)
                                           - soft_ema))
        return self.finish(loss_sup + regular_w * loss_reg, loss_sup,
                           loss_reg, primary[:n0], lab['label_prob'])


class UAMTStep(UncertainTeacherStep):
    """ssl_uamt.py:16-137: Mean Teacher whose consistency counts only the
    voxels where T noised MC-dropout passes of the teacher are certain."""

    def __call__(self, batches, draws, regular_w):
        lab, x, n0, seg = self.ssl_inputs(batches)
        soft_ema, mask = self.teacher_and_mask(batches['unlab']['image'],
                                               draws, regular_w)
        primary = primary_head(self.student(x, draws.dropout(0), seg))
        loss_sup = self.sup(primary[:n0], lab)
        loss_reg = self.masked_mse(torch.softmax(primary[n0:], 1), soft_ema,
                                   mask)
        return self.finish(loss_sup + regular_w * loss_reg, loss_sup,
                           loss_reg, primary[:n0], lab['label_prob'])


class CCTStep(ParadigmStep):
    """ssl_cct.py:63-165: the main head supervised; each auxiliary head
    consistent (MSE, or ``KL``) with the detached main softmax on the
    unlabelled rows."""

    def __init__(self, *args, unsupervised_loss: str = 'MSE', **kwargs):
        super().__init__(*args, **kwargs)
        self.kl = unsupervised_loss == 'KL'

    def unsup(self, aux_logits, target):
        if self.kl:
            return torch.mean(torch.sum(target * (
                torch.log(target + 1e-10)
                - torch.log_softmax(aux_logits, 1)), 1))
        return torch.mean(torch.square(torch.softmax(aux_logits, 1)
                                       - target))

    def __call__(self, batches, draws, regular_w):
        lab, x, n0, seg = self.ssl_inputs(batches)
        out = self.student(x, draws.dropout(0), seg)
        main, aux = out[0], out[1:]
        loss_sup = self.sup(main[:n0], lab)
        target = torch.softmax(main[n0:].detach(), 1)
        loss_reg = sum(self.unsup(a[n0:], target) for a in aux) / len(aux)
        return self.finish(loss_sup + regular_w * loss_reg, loss_sup,
                           loss_reg, main[:n0], lab['label_prob'])


class CPSStep(ParadigmStep):
    """ssl_cps.py:33-176: two peers (BiNet), each supervised on the
    labelled rows and by the other's argmax on the unlabelled rows."""

    def __call__(self, batches, draws, regular_w):
        lab, x, n0, seg = self.ssl_inputs(batches)
        out1, out2 = self.student(x, draws.dropout(0), seg)
        o1, o2 = primary_head(out1), primary_head(out2)
        sup1, sup2 = self.sup(o1[:n0], lab), self.sup(o2[:n0], lab)
        pse1 = one_hot_argmax(o1[n0:].detach())
        pse2 = one_hot_argmax(o2[n0:].detach())
        pse_sup1 = self.loss_calculator({'prediction': o1[n0:],
                                         'ground_truth': pse2})
        pse_sup2 = self.loss_calculator({'prediction': o2[n0:],
                                         'ground_truth': pse1})
        loss = (sup1 + regular_w * pse_sup1) + (sup2 + regular_w * pse_sup2)
        return self.finish(loss, sup1 + sup2, pse_sup1 + pse_sup2, o1[:n0],
                           lab['label_prob'])


class URPCStep(ParadigmStep):
    """ssl_urpc.py:17-122: uncertainty-rectified consistency of the
    pyramid heads (resized to the finest by ``resize_linear``) with their
    mean on the unlabelled rows."""

    def __call__(self, batches, draws, regular_w):
        lab, x, n0, seg = self.ssl_inputs(batches)
        outs = self.student(x, draws.dropout(0), seg)
        loss_sup = self.sup([o[:n0] for o in outs], lab)
        softs = [torch.softmax(o[n0:], 1) for o in outs]
        spatial = softs[0].shape[2:]
        softs = [s if s.shape[2:] == spatial else resize_linear(s, spatial)
                 for s in softs]
        p_avg = sum(softs) / len(softs) * 0.99 + 0.005
        loss_reg = 0.0
        for s in softs:
            p_i = s * 0.99 + 0.005
            var = torch.sum(p_avg * (torch.log(p_avg + 1e-10)
                                     - torch.log(p_i)), 1, keepdim=True)
            exp_var = torch.exp(-var)
            loss_reg = loss_reg + (
                torch.mean(torch.square(p_avg - p_i) * exp_var)
                / (torch.mean(exp_var) + 1e-8) + torch.mean(var))
        loss_reg = loss_reg / len(softs)
        return self.finish(loss_sup + regular_w * loss_reg, loss_sup,
                           loss_reg, outs[0][:n0], lab['label_prob'])


class ParadigmAgent(SegmentationAgent):
    """The training hooks the SSL and WSL agents share (module
    docstring). A subclass names its section, its step class and, when it
    has a teacher, sets ``uses_teacher``."""

    paradigm_section = ''
    step_class = None
    uses_teacher = False

    def __init__(self, config: dict, stage: str, device):
        super().__init__(config, stage, device)
        if self.stage == 'train' and self.accum > 1:
            raise ValueError(
                'grad_accum_steps > 1 is only supported by the supervised '
                'segmentation agent (the SSL/WSL/NLL paradigm steps have no '
                'accumulation path); got agent {0}'.format(
                    type(self).__name__))
        self.teacher = None
        self._saved_teacher = None

    def _paradigm_cfg(self) -> dict:
        return self.config[self.paradigm_section]

    def training_hyper(self, iteration: int) -> Dict[str, float]:
        cfg = self._paradigm_cfg()
        iter_max = self.config['training']['iter_max']
        ratio = get_rampup_ratio(iteration, cfg.get('rampup_start', 0),
                                 cfg.get('rampup_end', iter_max), 'sigmoid')
        return {'regular_w': cfg.get('regularize_w', 0.1) * ratio}

    def _step_generators(self, iteration: int) -> Draws:
        dropout = (any(self.config['network'].get('dropout', []))
                   or getattr(self.module, 'draws_in_train', False))
        return Draws(self.device, self.random_seed, iteration, dropout)

    def step_kwargs(self) -> dict:
        """The method's own keyword arguments of its step."""
        return {}

    def _make_teacher(self) -> EMATeacher:
        """The teacher from the student as it starts training (after a
        resume's load), then the checkpoint's teacher when it has one."""
        iter_max = self.config['training']['iter_max']
        alpha = min(1 - 1 / (iter_max + 1),
                    self._paradigm_cfg().get('ema_decay', 0.99))
        self.teacher = EMATeacher(self.module, alpha)
        if self._saved_teacher is not None:
            self.teacher.load_state_dict(self._saved_teacher)
        return self.teacher

    def _build_step(self, optimizer, schedule):
        teacher = self._make_teacher() if self.uses_teacher else None
        return self.step_class(self.module, create_loss_calculator(
            self.config, self.loss_dict), optimizer, schedule,
            compute_dtype=self.train_dtype, teacher=teacher,
            **self.step_kwargs())

    def _ckpt_state(self, model_state, optimizer):
        state = super()._ckpt_state(model_state, optimizer)
        if self.teacher is not None:
            state['ema_state_dict'] = self.teacher.state_dict()
        return state

    def _restore_extra(self, loaded, path):
        super()._restore_extra(loaded, path)
        if not self.uses_teacher:
            return
        self._saved_teacher = loaded.get('ema_state_dict', None)
        if self._saved_teacher is None:
            logging.info('checkpoint has no EMA teacher; the resumed '
                         'student starts it')
        else:
            logging.info('restored the EMA teacher from %s', path)


class BiNetAgent:
    """Mixin: the network is a BiNet of the ``[network]`` net."""

    def create_network(self):
        if self.module is None:
            self.module = make_binet(self.config['network'])
        logging.info('parameter number %d', param_count(self.module))


class SSLSegAgent(ParadigmAgent):
    """The SSL agents' data: the labelled stream and the unlabelled one
    (reference ssl_abstract.py:16-107)."""

    paradigm_section = 'semi_supervised_learning'
    batch_size_keys = ('train_batch_size', 'train_batch_size_unlab')

    def __init__(self, config: dict, stage: str, device):
        super().__init__(config, stage, device)
        self.train_loader_unlab = None

    def create_dataset(self):
        super().create_dataset()
        if self.stage != 'train':
            return
        data_cfg = self.config['dataset']
        names = data_cfg.get('train_transform_unlab', None)
        transform = None
        if names:
            transform = build_transforms(
                names, dict(data_cfg, task=self.task_type()),
                self.transform_dict)[1]
        workers = self.train_workers()
        dataset = NiftyDataset(
            root_dir=data_cfg['root_dir'],
            csv_file=data_cfg['train_csv_unlab'],
            modal_num=data_cfg.get('modal_num', 1), with_label=False,
            transform=transform,
            cache_bytes=self.cache_bytes('train', workers),
            transform_cache=data_cfg.get('transform_cache', True),
            host_shard=self.host_shard('train'))
        self.train_loader_unlab = DataLoader(
            dataset, batch_size=self.host_batch_size('train_batch_size_unlab'),
            shuffle=True, num_workers=workers, seed=self.random_seed + 100)

    def loaders(self):
        return super().loaders() + [
            ld for ld in (self.train_loader_unlab,) if ld is not None]

    def _train_batches(self):
        """Endless ``{'lab': batch, 'unlab': {'image'}}`` host batches."""
        pin = self.device.type == 'cuda'
        lab = repeat_loader(self.train_loaders[0])
        unlab = repeat_loader(self.train_loader_unlab)
        while True:
            batch = _host_batch(next(lab), self.fpl_uda, pin)
            image = torch.from_numpy(np.ascontiguousarray(
                next(unlab)['image'], np.float32))
            yield {'lab': batch,
                   'unlab': {'image': image.pin_memory() if pin else image}}


class SSLEntropyMinimization(SSLSegAgent):
    step_class = EntropyMinimizationStep


class SSLMeanTeacher(SSLSegAgent):
    step_class = MeanTeacherStep
    uses_teacher = True


class SSLUAMT(SSLSegAgent):
    step_class = UAMTStep
    uses_teacher = True

    def step_kwargs(self):
        cfg = self._paradigm_cfg()
        return {'passes': cfg.get('uamt_mcdroput_n', 8),
                'base_w': cfg.get('regularize_w', 0.1)}


class SSLCCT(SSLSegAgent):
    step_class = CCTStep

    def step_kwargs(self):
        return {'unsupervised_loss': self._paradigm_cfg().get(
            'unsupervised_loss', 'MSE')}


class SSLCPS(BiNetAgent, SSLSegAgent):
    step_class = CPSStep


class SSLURPC(SSLSegAgent):
    step_class = URPCStep


SSLMethodDict = {
    'EntropyMinimization': SSLEntropyMinimization,
    'MeanTeacher': SSLMeanTeacher,
    'UAMT': SSLUAMT,
    'CCT': SSLCCT,
    'CPS': SSLCPS,
    'URPC': SSLURPC,
}
