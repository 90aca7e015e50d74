"""Segmentation agent: the FPL+ training stage in all its variants and the
test stages (pseudo labels, checkpoint ensembles and the FPL uncertainty
pass).

Parity with the reference SegmentationAgent
(PyMIC/pymic/net_run_dsbn/agent_seg.py) and the JAX package's
``SegmentationAgent`` (``agents/agent_seg.py`` there).

Training (``train_valid``, reference :689-831, JAX :417-803):

* the step per iteration (``engine/train.py``), picked as the JAX
  package's ``build_train_step`` picks it: ``dual_consistency = True`` the
  dual-consistency step (gate ``it > consistency_start``, default 1000);
  else ``dual = True`` the joint step, with ``grad_accum_steps``
  microbatches per domain; else the alternating per-domain step with the
  entropy term (``[training] entropy_reg``, default on there). ``dis =
  True`` adds the discriminator step after the segmenter's; its network
  starts from ``random_seed + 7`` and its state rides in every checkpoint.
  Accumulation with ``dual = False``, ``dis`` or ``dual_consistency``
  raises ``ValueError``, as there;
* Adam or another ``torch.optim`` optimizer, MultiStepLR over iterations
  (two updates per iteration for the alternating and dual-consistency
  steps) or the plateau controller, ``[training] precision`` f32, bf16
  or f16;
* the per-domain train streams are produced by the loaders' worker
  processes and collated, pinned and paired in a thread (``prefetch_iter``)
  while the card steps; the time the loop waits on
  them is logged and written as the ``host_wait`` scalar;
* every ``iter_valid`` iterations: per-domain whole-volume validation
  through the Inferer (``val_t1`` / ``val_t2`` select the domain that
  counts), the plateau step, best tracking, ``iter_save`` checkpoints and
  early stopping; then the final checkpoint (also when ``iter_valid`` does
  not divide the run) and the best one, written asynchronously
  (``engine/ckpt.py``), and the best pointer;
* resume: ``iter_start > 0`` loads ``{prefix}_{iter_start}.pt``, with its
  optimizer state and schedule position when it has them, else a fresh
  optimizer whose MultiStepLR is offset by ``iter_start``; the
  discriminator's state when it has it, else a fresh discriminator.

Dropout randomness in training: iteration ``it`` draws the masks of its
forward k (per domain, per microbatch, or the dual-consistency step's
three forwards) from a ``torch.Generator`` on the device seeded from
``np.random.SeedSequence([random_seed, it, k...])``, so the masks never
equal the JAX package's.

Inference (reference :834-1083, JAX :806-1117): load the checkpoint, run
sliding-window + flip-TTA inference on the configured domain's DSBN bank,
undo the test transforms and save label NIfTIs with the source geometry.

* The device-label path: when every active inverse of the test chain is a
  crop (``_selection_margins``), softmax is monotonic, so the argmax of the
  logits runs on the device and a uint8 label map crosses back, cropped
  there. ``post_process`` then runs on the host.
* The host path, for an inverse that is not a crop (``CenterCrop``,
  ``Rescale``, ...) or ``[testing] infer_device_label = False``: the logits
  cross back, the inverse transforms run on the host and ``save_outputs``
  takes softmax then argmax.
* ``test_batch_size > 1``: the loader batch runs as one batched sliding
  window (``Inferer.run_batch``) when neither ``fpl`` nor
  ``test_time_dropout`` is set and the device-label path applies.
* ``fpl = True``: per volume, 6 MC-dropout passes fold into one batched
  inference, reduced on the device to ``(vars_sum, boundary)`` on the
  device-label path, or on the host after the per-pass inverse transforms
  (``fpl_host_reduce``); the volume's uncertainty is ``1 if boundary < 50
  else vars_sum / boundary``. The stage writes no labels; it saves
  ``fpl_uncertainty_sorted``, the ascending ``(uncertainty, name)`` pairs,
  for ``python -m fpl_plus_torch.fpl image-weight``.
* ``ckpt_mode = 3``: one forward per checkpoint of ``[testing]
  ckpt_name``, the logits averaged, then the host inverse and the save.
* ``test_time_dropout = True``: one dropout pass.
* The volume loop is the JAX agent's one-deep pipeline (JAX :849-1055):
  each volume (or loader batch, or FPL pass) is dispatched through the
  Inferer's ``*_async`` entries, and only then is the previous one's fetch
  read, cropped or inverted and saved (its uncertainty recorded); the last
  entries are finished after the loop. Saves stay in loader order. The FPL
  host fallback fetches at once, as JAX's does. ``ckpt_mode = 3``
  dispatches every checkpoint's forward of a volume before its one fetch.

Dropout randomness at test time: volume i of the stage draws its pass seeds
from ``np.random.SeedSequence([random_seed, i])`` and gets one
``torch.Generator`` on the device per pass (``engine/infer.py``
``PassFold``). The masks therefore differ from the JAX package's (threefry
keys split from ``random_seed``), and on the card from the CPU's: the two
agree in distribution, not in value.

Data parallelism (``get_mesh()``, the JAX package's
``agents/agent_seg.py:500-519,695,812,1053,1125``): ``train_valid``
broadcasts rank 0's network (and discriminator), wraps the steps with
``parallel.make_sharded_train_step`` and hands each rank its rows of the
host batch (``train_batch_size``, and the batch of every further train
stream a subclass names in ``batch_size_keys``, is global and must divide
over the ranks; the SSL, WSL and NLL agents run this loop with their
steps); validation and the test stage run the sharded Inferer, so
every rank computes the same dice, picks the same best iteration and
reaches the same labels; only global rank 0 writes checkpoints, pointers,
scalars, predictions and the FPL list, and barriers separate its writes
from the other ranks' reads (after the train stage's pointers, before the
test stage resolves its checkpoint).

Customization hooks (the JAX package's ``agents/agent_seg.py:80,105-107,
496,752-758,834-835,1069``): the train and validation losses come from
``loss_dict`` (default ``SegLossDict``, ``set_loss_dict``); an Inferer
given through ``set_inferer`` is the logits Inferer of validation, the FPL
pass, the host path and ensembles, while the device-label save path keeps
its own label Inferer; a module assigned to ``agent.module`` before
``create_network`` is kept. ``net_dict`` is not read, as in JAX: a network
of one's own is set as ``agent.module``.

Profiling (the JAX package's ``agents/agent_seg.py:548-550,618-621`` and
``:845-847,1050-1051``; ``utils/trace_metrics.py``): ``[training]
profile_dir`` traces the train loop from before its batch thread starts to
the end of the first block's ``iter_valid`` iterations and scalars, before
the first validation; ``[testing] profile_dir`` traces the test stage's
volume loop (not ``ckpt_mode = 3``). The step calls run inside the spans
``train_step`` and ``dis_step``, each validation volume's forward inside
``validation_forward``, and the Inferer's entries inside their own
(``infer_run``, ...). Under a mesh each rank writes its own trace.
"""
from __future__ import annotations

import copy
import logging
import math
import os
import time
from typing import Dict, List

import numpy as np
import scipy.special
import torch

from fpl_plus_torch.agents.agent_abstract import NetRunAgent
from fpl_plus_torch.engine import ckpt as ckpt_lib
from fpl_plus_torch.engine.infer import Inferer, PassFold
from fpl_plus_torch.engine.optim import (PlateauScheduler, create_lr_schedule,
                                         create_optimizer, set_scheduled_lr)
from fpl_plus_torch.engine.train import (AlternatingTrainStep,
                                         DiscriminatorStep,
                                         DualConsistencyStep, JointTrainStep,
                                         primary_head, train_dice)
from fpl_plus_torch.io.image_io import save_nd_array_as_image
from fpl_plus_torch.io.loader import prefetch_iter, repeat_loader
from fpl_plus_torch.losses import SegLossDict, create_loss_calculator
from fpl_plus_torch.models.registry import create_network, param_count
from fpl_plus_torch.models.unet2d5_dsbn import Dis
from fpl_plus_torch.parallel import (make_sharded_train_step, replicate,
                                     shard_batch)
from fpl_plus_torch.parallel.multihost import is_primary_host, process_info
from fpl_plus_torch.utils.image_process import convert_label
from fpl_plus_torch.utils.post_process import PostProcessDict
from fpl_plus_torch.utils.precision import cast_infer_module, resolve_dtype
from fpl_plus_torch.utils.scalar_writer import ScalarWriter
from fpl_plus_torch.utils.trace_metrics import span, start_trace, stop_trace

FPL_PASSES = 6
DIS_LR, DIS_BETAS = 1e-4, (0.5, 0.999)


def _split_batch(batch):
    """Yield per-sample dicts (batch dim kept at 1) from a collated batch —
    the Inferer and the inverse-transform bookkeeping are per-volume."""
    n = batch['image'].shape[0]
    if n == 1:
        yield batch
        return
    for i in range(n):
        item = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray) and v.ndim > 0 and v.shape[0] == n:
                item[k] = v[i:i + 1]
            elif isinstance(v, (list, tuple)) and len(v) == n:
                item[k] = [v[i]]
            else:
                item[k] = v
        yield item


def _name_of(data) -> str:
    name = data['names'][0]
    return name[0] if isinstance(name, (list, tuple)) else name


def _crop(label: np.ndarray, margins) -> np.ndarray:
    """Crop the spatial axes of ``label [N, *img]`` by ``(lo, up)``."""
    lo, up = margins
    return label[(slice(None),) + tuple(
        slice(a, s - b) for a, b, s in zip(lo, up, label.shape[1:]))]


def grad_accum_steps(cfg_t: dict) -> int:
    """``[training] grad_accum_steps``, checked against the step it needs:
    accumulation is the joint supervised path's (the JAX package raises
    the same ``ValueError`` s, ``engine/train.py:141-145`` and
    ``agents/agent_seg.py:274-279`` there)."""
    accum = int(cfg_t.get('grad_accum_steps', 1))
    if accum < 1:
        raise ValueError('[training] grad_accum_steps must be >= 1, got '
                         '{0}'.format(accum))
    if accum > 1 and (cfg_t.get('dual_consistency', False)
                      or cfg_t.get('dis', False)):
        raise ValueError('grad_accum_steps > 1 is only supported on the '
                         'plain joint supervised path (not dual_consistency '
                         '/ dis)')
    if accum > 1 and not cfg_t.get('dual', False):
        raise ValueError('grad_accum_steps > 1 requires the joint (dual = '
                         'True) training path; the alternating per-domain '
                         'step updates per domain and has no accumulation')
    return accum


def fpl_host_reduce(maps: np.ndarray):
    """The FPL image-level uncertainty of per-pass probability maps ``[P,
    K, *img]`` on the host (reference agent_seg.py:921-929; the JAX
    package's host fallback, ``agents/agent_seg.py:1004-1013``): the
    variance over passes summed over classes and voxels, and the count of
    voxels whose mean-probability entropy term exceeds 0.01 (K == 2: the
    class-1 term only; K > 2: the full entropy). Returns ``(vars_sum,
    boundary)``."""
    vars_ = maps.var(axis=0).sum()
    if maps.shape[1] == 2:
        means = np.mean(maps[:, 1], axis=0)
        uncertainty = -1.0 * (means * np.log(means + 1e-6))
    else:
        means = np.mean(maps, axis=0)
        uncertainty = -np.sum(means * np.log(means + 1e-6), axis=0)
    return float(vars_), int(np.where(uncertainty > 0.01, 1, 0).sum())


def _host_batch(data: dict, fpl_uda: bool,
                pin: bool) -> Dict[str, torch.Tensor]:
    """Loader batch -> the step's CPU tensors (pinned for an asynchronous
    copy to the card): image, label_prob, image1 when the manifest has it
    and, with ``fpl_uda``, the weights."""
    keys = ['image', 'label_prob']
    if data.get('image1', None) is not None:
        keys.append('image1')
    if fpl_uda and data.get('pixel_weight', None) is not None:
        keys.append('pixel_weight')
        if data.get('image_weight', None) is not None:
            keys.append('image_weight')
    out = {k: torch.from_numpy(np.ascontiguousarray(data[k], np.float32))
           for k in keys}
    return {k: v.pin_memory() for k, v in out.items()} if pin else out


def _check_micro_keys(micros) -> None:
    """Every microbatch of an accumulated iteration has the same keys: a
    manifest whose rows differ in optional columns would otherwise drop a
    weighting term or fail mid-run."""
    keys = set(micros[0])
    for i, m in enumerate(micros[1:], 1):
        if set(m) != keys:
            raise ValueError(
                'grad-accum microbatch {0} has keys {1} but microbatch 0 '
                'has {2}: all accum microbatches must share one key set '
                '(check that every manifest row carries the same optional '
                'columns)'.format(i, sorted(m), sorted(keys)))


def _to_device(tree, device):
    """Tensors of a nested batch to ``device``; host numbers stay."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device, non_blocking=True)
    if isinstance(tree, (int, float)):
        return tree
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return type(tree)(_to_device(v, device) for v in tree)


def head_predictor(module: torch.nn.Module, domain_label: int):
    """The test stage's predictor: the network's primary head (``out[0]``
    of a multi-head network, as the JAX agent's ``_patch_forward``)."""
    def predict(x, dropout_generators=None):
        return primary_head(module(x, domain_label, dropout_generators))
    return predict


def init_dis(dis: torch.nn.Module, seed: int) -> torch.nn.Module:
    """torch's default convolution initialisation (kaiming-uniform weights
    with a = sqrt(5), uniform biases within 1/sqrt(fan_in)) drawn from a
    ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in dis.modules():
            if isinstance(m, torch.nn.Conv3d):
                torch.nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5),
                                               generator=gen)
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                m.bias.uniform_(-bound, bound, generator=gen)
    return dis


class SegmentationAgent(NetRunAgent):
    data_parallel = True
    # the [dataset] batch sizes of the train streams: global, each must
    # divide over a mesh
    batch_size_keys = ('train_batch_size',)

    def __init__(self, config: dict, stage: str, device: torch.device):
        super().__init__(config, stage, device)
        self.loss_dict = SegLossDict
        self.module = None
        self.postprocessor = None
        self._valid_loss = None
        train_cfg = config.get('training', {})
        self.fpl_uda = train_cfg.get('train_fpl_uda', False)
        self.train_dtype = resolve_dtype(train_cfg.get('precision',
                                                       'float32'))
        self.infer_precision = config['testing'].get('precision', 'float32')
        self.dis = self.dis_optimizer = None
        if self.stage == 'train':
            self.accum = grad_accum_steps(train_cfg)

    def create_network(self):
        if self.module is None:
            self.module = create_network(self.config['network'])
        logging.info('parameter number %d', param_count(self.module))

    # -- training -----------------------------------------------------------
    def _train_generators(self, iteration: int, tails):
        """One list with one dropout generator per forward of ``iteration``
        (None when the network has no dropout and draws nothing else in
        train mode), forward k seeded from ``SeedSequence([random_seed,
        iteration, *tails[k]])``."""
        if not (any(self.config['network'].get('dropout', []))
                or getattr(self.module, 'draws_in_train', False)):
            return [None] * len(tails)
        return [[torch.Generator(self.device).manual_seed(int(
            np.random.SeedSequence([int(self.random_seed), iteration, *t])
            .generate_state(1)[0]))] for t in tails]

    def _step_generators(self, iteration: int):
        cfg_t = self.config['training']
        if cfg_t.get('dual_consistency', False):
            return self._train_generators(iteration, [(0,), (1,), (2,)])
        if self.accum > 1:
            return [self._train_generators(iteration, [
                (d, m) for m in range(self.accum)])
                for d in range(self.num_domains)]
        return self._train_generators(
            iteration, [(d,) for d in range(self.num_domains)])

    def _train_batches(self):
        """Endless tuples of per-domain host batches (with accumulation:
        of per-domain lists of ``accum`` microbatches)."""
        pin = self.device.type == 'cuda'
        streams = [repeat_loader(ld) for ld in self.train_loaders]
        while True:
            if self.accum == 1:
                yield tuple(_host_batch(next(s), self.fpl_uda, pin)
                            for s in streams)
                continue
            out = []
            for s in streams:
                micros = [_host_batch(next(s), self.fpl_uda, pin)
                          for _ in range(self.accum)]
                _check_micro_keys(micros)
                out.append(micros)
            yield tuple(out)

    def _build_step(self, optimizer, schedule):
        """The segmenter's step, picked as the JAX package's
        ``build_train_step`` picks it."""
        cfg_t = self.config['training']
        loss = create_loss_calculator(self.config, self.loss_dict)
        common = dict(fpl_uda=self.fpl_uda, compute_dtype=self.train_dtype)
        if cfg_t.get('dual_consistency', False):
            return DualConsistencyStep(self.module, loss, optimizer, schedule,
                                       entropy_coeff=1.0, **common)
        if cfg_t.get('dual', False):
            return JointTrainStep(self.module, loss, optimizer, schedule,
                                  self.num_domains, accum_steps=self.accum,
                                  **common)
        # the reference's per-domain training() adds the entropy term
        # (agent_seg.py:352-354): on by default, [training] entropy_reg
        # overrides
        entropy = cfg_t.get('entropy_reg', True)
        return AlternatingTrainStep(self.module, loss, optimizer, schedule,
                                    self.num_domains,
                                    entropy_coeff=1.0 if entropy else 0.0,
                                    **common)

    def updates_per_iteration(self) -> int:
        """Optimizer updates per iteration: one per domain for the
        alternating step, two for the dual-consistency step, else one."""
        cfg_t = self.config['training']
        if cfg_t.get('dual_consistency', False):
            return 2
        if not cfg_t.get('dual', False) and self.num_domains > 1:
            return self.num_domains
        return 1

    def training_hyper(self, iteration: int) -> Dict[str, float]:
        """Per-iteration values fed to the step (the consistency gate)."""
        cfg_t = self.config['training']
        if cfg_t.get('dual_consistency', False):
            start = cfg_t.get('consistency_start', 1000)
            return {'consis_gate': float(iteration > start)}
        return {}

    def _create_dis(self):
        """The discriminator of ``dis = True`` and its Adam, fresh."""
        self.dis = init_dis(Dis(self.config['network']['class_num']),
                            int(self.random_seed) + 7).to(self.device)
        self.dis_optimizer = torch.optim.Adam(self.dis.parameters(),
                                              lr=DIS_LR, betas=DIS_BETAS)

    def _ckpt_state(self, model_state, optimizer):
        state = {'model_state_dict': model_state,
                 'optimizer_state_dict': optimizer.state_dict()}
        if self.dis is not None:
            state['dis_state_dict'] = self.dis.state_dict()
            state['dis_optimizer_state_dict'] = \
                self.dis_optimizer.state_dict()
        return state

    def _resume(self, module, ckpt_dir, prefix, iter_start, sched_params):
        """Load ``{prefix}_{iter_start}.pt`` into ``module`` (and the
        discriminator when it has one); returns its optimizer state (None:
        the schedule is offset instead) and the loaded weights."""
        path = ckpt_lib.checkpoint_path(ckpt_dir, prefix, iter_start)
        loaded = ckpt_lib.load_checkpoint(path)
        module.load_state_dict(loaded['model_state_dict'], strict=True)
        opt_state = loaded.get('optimizer_state_dict', None)
        if opt_state is None:
            # torch convention: the last completed iteration (reference
            # agent_abstract.py:334: iteration - 1)
            sched_params['last_iter'] = iter_start - 1
            logging.info('checkpoint has no optimizer state; fresh '
                         'optimizer with schedule offset %d', iter_start)
        self._restore_extra(loaded, path)
        logging.info('resumed from %s', path)
        return opt_state, loaded['model_state_dict']

    def _restore_extra(self, loaded, path):
        """The state a checkpoint carries beside the network and its
        optimizer: here the discriminator's."""
        if self.dis is None:
            return
        if 'dis_state_dict' in loaded:
            self.dis.load_state_dict(loaded['dis_state_dict'])
            # a checkpoint converted from the JAX package has no optimizer
            # state: the discriminator's Adam starts fresh
            if 'dis_optimizer_state_dict' in loaded:
                self.dis_optimizer.load_state_dict(
                    loaded['dis_optimizer_state_dict'])
            logging.info('restored the discriminator from %s', path)
        else:
            logging.info('checkpoint has no discriminator state; fresh '
                         'discriminator kept')

    def train_valid(self):
        cfg_t = self.config['training']
        ckpt_dir = cfg_t['ckpt_save_dir']
        prefix = ckpt_lib.ckpt_prefix_of(self.config)
        iter_start = cfg_t.get('iter_start', 0)
        iter_max = cfg_t['iter_max']
        iter_valid = cfg_t['iter_valid']
        iter_save = cfg_t.get('iter_save', None)
        early_stop_it = cfg_t.get('early_stop_patience', None)
        if iter_save is None:
            iter_save_list = [iter_max]
        elif isinstance(iter_save, (tuple, list)):
            iter_save_list = iter_save
        else:
            iter_save_list = list(range(0, iter_max + 1, iter_save))

        module = self.module.to(self.device)
        if cfg_t.get('dis', False):
            self._create_dis()
        mesh = self.get_mesh()
        if mesh is not None:
            for key in self.batch_size_keys:
                bs = self.config['dataset'][key]
                if bs % mesh.size:
                    raise ValueError(
                        '{0} {1} must be divisible by the {2}-device '
                        'mesh'.format(key, bs, mesh.size))
        sched_params = dict(cfg_t)
        sched_params['last_iter'] = -1
        # the dsbn reference zeroes the restored valid_pred on resume
        # (agent_seg.py:721-723): best tracking restarts at 0
        max_val_dice, max_val_it, best_state = 0.0, iter_start, None
        opt_state = None
        if iter_start > 0:
            opt_state, best_state = self._resume(module, ckpt_dir, prefix,
                                                 iter_start, sched_params)
        if mesh is not None:
            # rank 0's state everywhere, before a step copies any of it (an
            # EMA teacher); a resume loaded the same file on every rank, so
            # the optimizer states agree already
            for net in (module, self.dis):
                if net is not None:
                    replicate(net, mesh)
        optimizer = create_optimizer(cfg_t, module.parameters())
        if opt_state is not None:
            optimizer.load_state_dict(opt_state)
            # a reference optimizer state has no update count: take the
            # moments' step count
            first = next(iter(optimizer.state.values()), {})
            optimizer.param_groups[0].setdefault(
                'update_count', int(first.get('step', 0)))
        schedule = create_lr_schedule(sched_params,
                                      self.updates_per_iteration())
        set_scheduled_lr(optimizer, schedule)
        step = self._build_step(optimizer, schedule)
        dis_step = (DiscriminatorStep(module, self.dis, self.dis_optimizer)
                    if self.dis is not None else None)
        if mesh is not None:
            step = make_sharded_train_step(step, mesh)
            if dis_step is not None:
                dis_step = make_sharded_train_step(dis_step, mesh)
            logging.info('data-parallel training over %d ranks (rank %d)',
                         mesh.size, mesh.rank)
        plateau = PlateauScheduler(sched_params)
        class_num = self.config['network']['class_num']
        writer = ScalarWriter(ckpt_dir)
        ckpt_writer = ckpt_lib.CheckpointWriter()
        # the first block's iterations, not its validation (JAX :618-622)
        profile_dir = cfg_t.get('profile_dir', None)
        if profile_dir:
            start_trace(profile_dir, self.device, self._trace_rank())
        batches = prefetch_iter(self._train_batches(), depth=2)
        glob_it = iter_start
        module.train()
        try:
            for block_start in range(iter_start, iter_max, iter_valid):
                lr_value = optimizer.param_groups[0]['lr']
                t0 = time.time()
                wait = 0.0
                acc: Dict[str, List] = {}
                for sub_it in range(iter_valid):
                    it = block_start + sub_it
                    tw = time.time()
                    host = next(batches)
                    wait += time.time() - tw
                    if mesh is not None:
                        host = shard_batch(host, mesh)
                    dev = _to_device(host, self.device)
                    hyper = self.training_hyper(it)
                    with span('train_step'):
                        metrics = step(dev, self._step_generators(it),
                                       **hyper)
                    if dis_step is not None:
                        with span('dis_step'):
                            metrics.update(dis_step(dev))
                    for k, v in list(metrics.items()) + list(hyper.items()):
                        acc.setdefault(k, []).append(v)
                train_scalars = {
                    k: float(np.mean([float(x) for x in v]))
                    for k, v in acc.items() if not k.startswith('class_dice')}
                cls_dice = np.mean([torch.stack(v).mean(0).cpu().numpy()
                                    for k, v in acc.items()
                                    if k.startswith('class_dice')], axis=0)
                train_scalars['avg_dice'] = float(cls_dice.mean())
                train_scalars['class_dice'] = cls_dice
                t1 = time.time()
                if profile_dir:
                    stop_trace()
                    profile_dir = None
                valid_scalars = self.validation()
                t2 = time.time()
                glob_it = block_start + iter_valid

                scale = plateau.step(valid_scalars['plateau_metric'])
                if plateau.enabled:
                    for group in optimizer.param_groups:
                        group['lr'] = cfg_t['learning_rate'] * scale

                logging.info('it %d', glob_it)
                logging.info('learning rate %s', lr_value)
                logging.info('training/validation time: %.2fs/%.2fs; host '
                             'wait %.4fs per iteration', t1 - t0, t2 - t1,
                             wait / iter_valid)
                self._write_scalars(writer, train_scalars, valid_scalars,
                                    lr_value, glob_it, class_num)
                writer.add_scalars('time', {'train': t1 - t0,
                                            'valid': t2 - t1}, glob_it)
                writer.add_scalar('host_wait', wait / iter_valid, glob_it)

                if valid_scalars['avg_dice'] > max_val_dice:
                    max_val_dice = valid_scalars['avg_dice']
                    max_val_it = glob_it
                    best_state = ckpt_lib.snapshot(module.state_dict())
                stop_now = (early_stop_it is not None
                            and glob_it - max_val_it > early_stop_it)
                if glob_it in iter_save_list or stop_now:
                    ckpt_writer.submit(ckpt_dir, prefix, glob_it,
                                       self._ckpt_state(module.state_dict(),
                                                        optimizer),
                                       valid_scalars['avg_dice'])
                if stop_now:
                    logging.info('The training is early stopped')
                    break
            # a final checkpoint and latest pointer also when iter_valid
            # does not divide the run (the reference then saves none)
            if glob_it > iter_start and glob_it not in iter_save_list:
                ckpt_writer.submit(ckpt_dir, prefix, glob_it,
                                   self._ckpt_state(module.state_dict(),
                                                    optimizer),
                                   max_val_dice)
            # the best-performing checkpoint (reference :809-828)
            if best_state is not None:
                ckpt_writer.submit(ckpt_dir, prefix, max_val_it,
                                   self._ckpt_state(best_state, optimizer),
                                   max_val_dice, update_latest=False)
            ckpt_writer.close()   # artifacts durable before the pointer
        finally:
            batches.close()       # stops the producer thread
            writer.close()
            try:
                ckpt_writer.close()   # no-op on the success path
            except Exception:
                logging.exception('checkpoint writer close failed during '
                                  'unwind')
            if profile_dir:       # the first block raised
                stop_trace()
        ckpt_lib.write_best_pointer(ckpt_dir, prefix, max_val_it)
        # the test stage's readers resolve pointers only after rank 0
        # wrote them
        self.barrier('train-ckpt-written')
        logging.info('The best performing iter is %d, valid dice %s',
                     max_val_it, max_val_dice)

    @staticmethod
    def _trace_rank():
        """The global rank, for the trace file's name, in a run of several
        processes; None in one process."""
        rank, world = process_info()[:2]
        return rank if world > 1 else None

    def _write_scalars(self, writer, train_scalars, valid_scalars, lr_value,
                       glob_it, class_num):
        writer.add_scalars('loss', {'train': train_scalars['loss'],
                                    'valid': valid_scalars['loss']}, glob_it)
        writer.add_scalars('dice', {'train': train_scalars['avg_dice'],
                                    'valid': valid_scalars['avg_dice']},
                           glob_it)
        writer.add_scalar('lr', lr_value, glob_it)
        # the variants' own terms (loss_dis, loss_consis, consis_gate)
        extra = {k: v for k, v in train_scalars.items()
                 if k not in ('loss', 'avg_dice', 'class_dice')}
        for key, value in extra.items():
            writer.add_scalars(key, {'train': value}, glob_it)
        for c in range(class_num):
            writer.add_scalars('class_{0}_dice'.format(c), {
                'train': float(train_scalars['class_dice'][c]),
                'valid': float(valid_scalars['class_dice'][c])}, glob_it)
        logging.info('train loss %.4f, avg foreground dice %.4f %s %s',
                     train_scalars['loss'], train_scalars['avg_dice'],
                     train_scalars['class_dice'], extra or '')
        logging.info('valid loss %.4f, avg foreground dice %.4f %s',
                     valid_scalars['loss'], valid_scalars['avg_dice'],
                     valid_scalars['class_dice'])

    def validation(self) -> Dict:
        """Per-domain whole-volume validation through the Inferer
        (reference :509-604) with the training module in eval mode. The
        volume is rounded per ``[testing] precision`` as the Inferer does
        and the network computes in f32 (the module is never cast). A
        multi-head network's heads all go through the Inferer: the loss gets
        the list, so a deep-supervision loss applies, and the dice the
        primary head (the JAX agent's validation predictor keeps the first
        head only, on which its deep-supervision loss raises: ROADMAP.md,
        section 3)."""
        inferer = self._logits_inferer()
        if self._valid_loss is None:
            self._valid_loss = create_loss_calculator(self.config,
                                                      self.loss_dict)
        module = self.module
        per_domain = []
        module.eval()
        try:
            for d, loader in enumerate(self.valid_loaders):
                def predictor(x, d=d):
                    return module(x.float(), d)
                losses, dices = [], []
                for data in loader:
                    images = np.asarray(data['image'], np.float32)
                    label_prob = torch.from_numpy(np.asarray(
                        data['label_prob'], np.float32)).to(self.device)
                    for i in range(images.shape[0]):
                        with span('validation_forward'):
                            pred = inferer.run_logits(predictor,
                                                      images[i:i + 1])
                        with torch.inference_mode():
                            y = label_prob[i:i + 1]
                            losses.append(self._valid_loss(
                                {'prediction': pred, 'ground_truth': y}))
                            dices.append(train_dice(primary_head(pred), y))
                per_domain.append((float(torch.stack(losses).mean()),
                                   torch.stack(dices).mean(0).cpu().numpy()))
        finally:
            module.train()

        loss0, cls_dice0 = per_domain[0]
        if len(per_domain) == 2:
            loss1, cls_dice1 = per_domain[1]
            avg_loss = (loss0 + loss1) / 2
            avg_cls_dice = (cls_dice0 + cls_dice1) / 2
        else:
            loss1, cls_dice1 = loss0, cls_dice0
            avg_loss, avg_cls_dice = loss0, cls_dice0
        cfg_t = self.config['training']
        if cfg_t.get('val_t2', False) and len(per_domain) == 2:
            sel = {'loss': loss1, 'avg_dice': float(cls_dice1.mean()),
                   'class_dice': cls_dice1}
        elif cfg_t.get('val_t1', False):
            sel = {'loss': loss0, 'avg_dice': float(cls_dice0.mean()),
                   'class_dice': cls_dice0}
        else:
            sel = {'loss': avg_loss, 'avg_dice': float(avg_cls_dice.mean()),
                   'class_dice': avg_cls_dice}
        sel['plateau_metric'] = float(avg_cls_dice.mean())
        return sel

    def _selection_margins(self, data, dim):
        """Compose the test chain's inverse transforms into one spatial
        selection ``(margin_lower, margin_upper)`` when every active inverse
        is a pure crop (the production chain is [NormalizeWithMeanStd, Pad],
        whose only inverse, Pad's, crops); None otherwise. Successive crops
        compose by adding margins."""
        lo = [0] * dim
        up = [0] * dim
        for transform in self.transform_list[::-1]:
            if not transform.inverse:
                continue
            sel = transform.inverse_selection(data)
            if sel is None:
                return None
            ml, mu = sel
            lo = [a + int(b) for a, b in zip(lo, ml)]
            up = [a + int(b) for a, b in zip(up, mu)]
        return lo, up

    def _pass_fold(self, predictor, volume_index: int, n: int) -> PassFold:
        """``n`` dropout passes of ``predictor`` on the device for the
        stage's volume ``volume_index``, seeded from ``random_seed`` and
        that index."""
        return PassFold(predictor, np.random.SeedSequence(
            [int(self.random_seed), volume_index]).generate_state(n),
            self.device)

    def _host_inverse(self, data: Dict) -> Dict:
        """Undo the test chain on ``data['predict']`` (logits ``[N, K,
        *img]``) on the host, last transform first."""
        for transform in self.transform_list[::-1]:
            if transform.inverse:
                data = transform.inverse_transform_for_prediction(data)
        return data

    def _loaded_module(self, ckpt_name: str):
        """A copy of the network with the checkpoint's weights, on the
        device, in eval mode, cast per ``[testing] precision``."""
        loaded = ckpt_lib.load_checkpoint(ckpt_name)
        module = copy.deepcopy(self.module)
        module.load_state_dict(loaded['model_state_dict'], strict=True)
        logging.info('loaded checkpoint %s (iteration %d)', ckpt_name,
                     int(loaded['iteration']))
        return cast_infer_module(module.to(self.device).eval(),
                                 self.infer_precision)

    def _logits_inferer(self) -> Inferer:
        """The logits Inferer of validation, the FPL pass, the host path and
        ensembles: the one ``set_inferer`` gave, else the stage's own, kept
        in ``self.inferer`` (the JAX package's ``_make_inferer``,
        ``agents/agent_seg.py:752-753,834-835,1069`` there)."""
        if self.inferer is None:
            self.inferer = Inferer(dict(self.config['testing'],
                                        output_mode='logits'), self.device,
                                   mesh=self.get_mesh())
        return self.inferer

    def _inferers(self):
        """The device-label save path's own label Inferer (JAX's
        ``_label_inferer``, never replaced by ``set_inferer``) and the
        logits Inferer (``_logits_inferer``)."""
        return (Inferer(dict(self.config['testing'], output_mode='label'),
                        self.device, mesh=self.get_mesh()),
                self._logits_inferer())

    # -- inference ------------------------------------------------------------
    def infer(self):
        cfg_test = self.config['testing']
        domain_label = cfg_test.get('domian_label', 0)   # (sic) reference key
        fpl = cfg_test.get('fpl', False)
        tt_dropout = cfg_test.get('test_time_dropout', False) or fpl
        device_label = cfg_test.get('infer_device_label', True)

        self.barrier('pre-ckpt-resolve')   # a prior stage's writes settle
        ckpt_name = ckpt_lib.get_checkpoint_name(self.config)
        postpro_name = cfg_test.get('post_process', None)
        if self.postprocessor is None and postpro_name is not None:
            self.postprocessor = PostProcessDict[postpro_name](cfg_test)
        if cfg_test['ckpt_mode'] == 3:
            return self.infer_with_multiple_checkpoints(ckpt_name,
                                                        domain_label)
        module = self._loaded_module(ckpt_name)
        label_inf, logits_inf = self._inferers()
        predictor = head_predictor(module, domain_label)

        def margins_of(data, dim):
            return self._selection_margins(data, dim) if device_label \
                else None

        infer_times, uncertainty = [], {}

        def record_fpl(name, vars_, boundary, t0):
            uncer_one = 1 if boundary < 50 else vars_ / boundary
            uncertainty[name] = [uncer_one]
            logging.info('%s %s', name, uncer_one)
            infer_times.append(time.time() - t0)

        # the one-deep pipeline (JAX :849-1048): volume i+1, or loader batch
        # b+1, is dispatched before volume i's fetch, crop or host inverse
        # and save, so the host's work on i overlaps the card's on i+1
        pending = None       # ('volume' | 'batch', fetch, data, t0, margins)
        pending_fpl = None   # (fetch, name, t0): a device-reduced FPL pass

        def finish(entry):
            kind, fetch, p_data, p_t0, p_margins = entry
            if kind == 'batch':
                labels = fetch()
                for i, (data, m) in enumerate(zip(p_data, p_margins)):
                    data['predict_label'] = _crop(labels[i:i + 1], m)
                    self.save_outputs(data)
                # per volume: the batch's time over its volumes
                infer_times.extend([(time.time() - p_t0) / len(p_data)]
                                   * len(p_data))
                return
            if p_margins is not None:
                p_data['predict_label'] = _crop(fetch(), p_margins)
                self.save_outputs(p_data)
            else:
                p_data['predict'] = fetch()
                self.save_outputs(self._host_inverse(p_data))
            infer_times.append(time.time() - p_t0)

        def finish_fpl(entry):
            fetch, name, p_t0 = entry
            record_fpl(name, *fetch(), p_t0)

        volume_index = 0
        # the volume loop (JAX :845-847,1050-1051)
        profile_dir = cfg_test.get('profile_dir', None)
        if profile_dir:
            start_trace(profile_dir, self.device, self._trace_rank())
        try:
            for batch_data in prefetch_iter(self.test_loader):
                samples = list(_split_batch(batch_data))
                if len(samples) > 1 and not tt_dropout:
                    # batched serving: a collated batch is same-shape, so its
                    # volumes share one sliding window on the device-label path
                    images = np.asarray(batch_data['image'], np.float32)
                    margins = [margins_of(d, images.ndim - 2) for d in samples]
                    if all(m is not None for m in margins):
                        t0 = time.time()
                        fetch = label_inf.run_batch_async(predictor, images)
                        if pending is not None:
                            finish(pending)
                        pending = ('batch', fetch, samples, t0, margins)
                        volume_index += len(samples)
                        continue
                for data in samples:
                    images = np.asarray(data['image'], np.float32)
                    margins = margins_of(data, images.ndim - 2)
                    t0 = time.time()
                    pred = predictor
                    if tt_dropout:
                        fold = self._pass_fold(predictor, volume_index,
                                               FPL_PASSES if fpl else 1)
                        pred = fold if fpl else fold.take([0])
                    volume_index += 1
                    if fpl and margins is not None:
                        fetch = logits_inf.run_fpl_uncertainty(
                            pred, images, FPL_PASSES, margins)
                        if pending_fpl is not None:
                            finish_fpl(pending_fpl)
                        pending_fpl = (fetch, _name_of(data), t0)
                    elif fpl:
                        # host fallback, fetched at once (JAX :972-1016):
                        # per-pass logits, inverse and softmax on the host
                        passes = logits_inf.run_passes(pred, images,
                                                       FPL_PASSES)
                        maps = np.concatenate([scipy.special.softmax(
                            self._host_inverse(dict(
                                data, predict=passes[i:i + 1]))['predict'],
                            axis=1) for i in range(FPL_PASSES)])
                        record_fpl(_name_of(data), *fpl_host_reduce(maps), t0)
                    else:
                        inferer = label_inf if margins is not None \
                            else logits_inf
                        fetch = inferer.run_async(pred, images)
                        if pending is not None:
                            finish(pending)
                        pending = ('volume', fetch, data, t0, margins)
            if pending is not None:
                finish(pending)
            if pending_fpl is not None:
                finish_fpl(pending_fpl)
        finally:
            if profile_dir:
                stop_trace()
        if fpl and is_primary_host():   # computed everywhere, written once
            pairs = sorted(zip(uncertainty.values(), uncertainty.keys()))
            np.save(cfg_test['fpl_uncertainty_sorted'],
                    np.asarray(pairs, dtype=object))
            logging.info('FPL uncertainty list saved (%d volumes)',
                         len(pairs))
        if infer_times:
            arr = np.asarray(infer_times)
            logging.info('testing time %s +/- %s', arr.mean(), arr.std())

    def infer_with_multiple_checkpoints(self, ckpt_names: List[str],
                                        domain_label: int):
        """``ckpt_mode = 3`` (reference :966-1020): per volume, one forward
        per checkpoint, the logits averaged over the checkpoints, then the
        host inverse and the save."""
        modules = [self._loaded_module(name) for name in ckpt_names]
        _, logits_inf = self._inferers()
        infer_times = []
        for batch_data in prefetch_iter(self.test_loader):
            for data in _split_batch(batch_data):
                images = np.asarray(data['image'], np.float32)
                t0 = time.time()
                # every checkpoint's forward is dispatched before the one
                # fetch below (JAX :1104-1110; its fold of the checkpoints
                # into one dispatch, :1083-1099, is not followed: ROADMAP.md
                # section 3)
                with torch.inference_mode():
                    logits = torch.stack([logits_inf.run_logits(
                        head_predictor(m, domain_label), images)
                        for m in modules]).mean(0)
                data['predict'] = logits.cpu().numpy()
                self.save_outputs(self._host_inverse(data))
                infer_times.append(time.time() - t0)
        if infer_times:
            arr = np.asarray(infer_times)
            logging.info('testing time %s +/- %s', arr.mean(), arr.std())

    def save_outputs(self, data: Dict):
        """Labels (``predict_label``, or softmax then argmax of the logits
        ``predict``) -> label convert -> post-process -> save NIfTI with
        metadata from the source image (reference :1022-1083), into
        ``output_dir/(ckpt_dir + '_' + test_csv_stem)``. Every rank
        computes the labels; global rank 0 writes them."""
        if not is_primary_host():
            return
        cfg_test = self.config['testing']
        output_dir = cfg_test['output_dir']
        ignore_dir = cfg_test.get('filename_ignore_dir', True)
        label_source = cfg_test.get('label_source', None)
        label_target = cfg_test.get('label_target', None)
        fname_src = cfg_test.get('filename_replace_source', None)
        fname_tgt = cfg_test.get('filename_replace_target', None)
        ckpt_dir = self.config['training']['ckpt_save_dir'].split('/')[-1]
        subset = self.config['dataset']['test_csv'].split('/')[-1][:-4]
        output_dir = os.path.join(output_dir, ckpt_dir + '_' + subset)
        os.makedirs(output_dir, exist_ok=True)

        names = data['names']
        if 'predict_label' in data:
            output = np.asarray(data['predict_label'], np.uint8)
        else:
            prob = scipy.special.softmax(np.asarray(data['predict']), axis=1)
            output = np.asarray(np.argmax(prob, axis=1), np.uint8)
        if label_source is not None and label_target is not None:
            output = convert_label(output, label_source, label_target)
        if self.postprocessor is not None:
            for i in range(output.shape[0]):
                output[i] = self.postprocessor(output[i])
        root_dir = self.config['dataset']['root_dir']
        for i in range(output.shape[0]):
            name = names[i]
            if isinstance(name, (list, tuple)):
                name = name[0]
            save_name = name.split('/')[-1] if ignore_dir else \
                name.replace('/', '_')
            if fname_src is not None and fname_tgt is not None:
                save_name = save_name.replace(fname_src, fname_tgt)
            save_path = '{0}/{1}'.format(output_dir, save_name)
            save_nd_array_as_image(output[i], save_path,
                                   root_dir + '/' + name)
