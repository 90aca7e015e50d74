"""Weakly-supervised (scribble) segmentation agents (reference
PyMIC/pymic/net_run_wsl/, the JAX package's ``agents/wsl.py``):
EntropyMinimization (wsl_em.py), TotalVariation (wsl_tv.py), MumfordShah
(wsl_mumford_shah.py), GatedCRF (wsl_gatedcrf.py), USTM (wsl_ustm.py) and
DMPLS (wsl_dmpls.py); registry ``WSLMethodDict`` (wsl_main.py:15-21).

Scribbles reach the supervised loss through ``PartialLabelToProbability``
(``pixel_weight`` 0 on unlabelled voxels), which the agent always puts in
the batch; each method adds a ramped regulariser, read from
``[weakly_supervised_learning]``. The hooks they share with the SSL agents
are ``agents/ssl.py``'s ``ParadigmAgent``. Each iteration steps on the
first domain's batch. USTM's rotation ``k`` and DMPLS's mixing ``beta``
are drawn per iteration from the process-wide numpy RNG, as in the JAX
package: ``k`` in the train-batch producer right after the batch, ``beta``
in ``training_hyper``; both under the loaders' lock (``io/loader.py``
``host_random``), so neither lands inside an item's transforms. With the
train loaders' worker processes (``num_workder > 0``) the items are seeded
in the workers, so the draws no longer share the process RNG with them.

Under a mesh (``agents/ssl.py``'s data parallelism) the supervised loss
reads the gathered ``label_prob`` and scribble ``pixel_weight``, the
regulariser the gathered batch with its image (MumfordShah and GatedCRF
read the image), and USTM's ``k`` and DMPLS's ``beta`` are rank 0's draws,
broadcast in the step, so that every rank rotates and mixes alike.
"""
from __future__ import annotations

import numpy as np
import torch

from fpl_plus_torch.agents.agent_seg import _host_batch
from fpl_plus_torch.agents.ssl import (BiNetAgent, ParadigmAgent,
                                       ParadigmStep, UncertainTeacherStep,
                                       noise_like, one_hot_argmax)
from fpl_plus_torch.engine.train import primary_head
from fpl_plus_torch.io.loader import host_random, repeat_loader
from fpl_plus_torch.losses.gatedcrf import GatedCRFLoss
from fpl_plus_torch.losses.seg import (DiceLoss, EntropyLoss,
                                       MumfordShahLoss, TotalVariationLoss)
from fpl_plus_torch.models.common import fold_depth_to_batch


class RegularizedStep(ParadigmStep):
    """The single-forward WSL step: ``loss_sup + regular_w x
    reg_fn(out, batch)`` (the JAX package's ``_make_reg_step``)."""

    def __init__(self, *args, reg_fn=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.reg_fn = reg_fn

    def __call__(self, batches, draws, regular_w):
        out = self.student(batches[0]['image'], draws.dropout(0))
        batch = self.global_batch(batches[0], image=True)
        loss_sup = self.sup(out, batch)
        loss_reg = self.reg_fn(out, batch)
        return self.finish(loss_sup + regular_w * loss_reg, loss_sup,
                           loss_reg, primary_head(out), batch['label_prob'])


def rot90_hw(x: torch.Tensor, k: int) -> torch.Tensor:
    """Rotate the last two (H, W) axes by ``k`` quarter turns, from H
    towards W (``jnp.rot90`` over the channels-last H and W axes)."""
    return torch.rot90(x, k, (-2, -1)) if k % 4 else x


class USTMStep(UncertainTeacherStep):
    """wsl_ustm.py:18-153: the student on its noised input; the teacher on
    the input rotated by ``k`` and noised, gated by the certainty of T
    noised MC-dropout teacher passes; the MSE between the rotated student
    softmax and the teacher's. ``batches = (batch, k)``."""

    def __call__(self, batches, draws, regular_w):
        batch, k = self.global_batch(batches[0]), int(self.shared(batches[1]))
        x = batch['image']
        soft_ema, mask = self.teacher_and_mask(rot90_hw(x, k), draws,
                                               regular_w)
        out = self.student(x + noise_like(draws.noise(0), x),
                           draws.dropout(0))
        primary = primary_head(out)
        loss_sup = self.sup(out, batch)
        loss_reg = self.masked_mse(rot90_hw(torch.softmax(primary, 1), k),
                                   soft_ema, mask)
        return self.finish(loss_sup + regular_w * loss_reg, loss_sup,
                           loss_reg, primary, batch['label_prob'])


class DMPLSStep(ParadigmStep):
    """wsl_dmpls.py:19-118: a BiNet supervised by the scribbles and by the
    argmax of the ``beta``-mix of its peers' detached softmax (Dice)."""

    dice = DiceLoss({})

    def __call__(self, batches, draws, regular_w, beta):
        batch, beta = self.global_batch(batches[0]), self.shared(beta)
        out1, out2 = self.student(batch['image'], draws.dropout(0))
        o1, o2 = primary_head(out1), primary_head(out2)
        loss_sup = 0.5 * (self.sup(o1, batch) + self.sup(o2, batch))
        mixed = (beta * torch.softmax(o1.detach(), 1)
                 + (1.0 - beta) * torch.softmax(o2.detach(), 1))
        pseudo = one_hot_argmax(mixed)
        loss_reg = 0.5 * (self.dice({'prediction': o1, 'ground_truth': pseudo})
                          + self.dice({'prediction': o2,
                                       'ground_truth': pseudo}))
        return self.finish(loss_sup + regular_w * loss_reg, loss_sup,
                           loss_reg, o1, batch['label_prob'])


class WSLSegAgent(ParadigmAgent):
    """The WSL agents' data: every domain's batch with its
    ``pixel_weight`` (reference wsl_abstract.py:12-44)."""

    paradigm_section = 'weakly_supervised_learning'
    step_class = RegularizedStep

    def _train_batches(self):
        pin = self.device.type == 'cuda'
        streams = [repeat_loader(ld) for ld in self.train_loaders]
        while True:
            yield tuple(_host_batch(next(s), True, pin) for s in streams)

    def step_kwargs(self):
        return {'weighted': True, 'reg_fn': self.regularizer()}

    def regularizer(self):
        """``reg_fn(out, batch) -> scalar`` of the method."""
        raise NotImplementedError


class WSLEntropyMinimization(WSLSegAgent):
    def regularizer(self):
        return lambda out, batch: EntropyLoss({})({'prediction': out})


class WSLTotalVariation(WSLSegAgent):
    def regularizer(self):
        return lambda out, batch: TotalVariationLoss({})({'prediction': out})


class WSLMumfordShah(WSLSegAgent):
    def regularizer(self):
        loss = MumfordShahLoss(self._paradigm_cfg())
        return lambda out, batch: loss({'prediction': out,
                                        'image': batch['image']})


class WSLGatedCRF(WSLSegAgent):
    """wsl_gatedcrf.py:16-125: the gated CRF over an XY + intensity kernel
    and an XY kernel (``gatedcrfloss_{w0,xy0,rgb,w1,xy1,radius}``); a
    volume folds slice-wise (reference :87-97)."""

    def regularizer(self):
        cfg = self._paradigm_cfg()
        kernels = [{'weight': cfg.get('gatedcrfloss_w0', 1.0),
                    'xy': cfg.get('gatedcrfloss_xy0', 5),
                    'rgb': cfg.get('gatedcrfloss_rgb', 0.1)},
                   {'weight': cfg.get('gatedcrfloss_w1', 1.0),
                    'xy': cfg.get('gatedcrfloss_xy1', 3)}]
        radius = int(cfg.get('gatedcrfloss_radius', 5.0))
        crf = GatedCRFLoss()

        def reg_fn(out, batch):
            soft = torch.softmax(primary_head(out), 1)
            image = batch['image']
            if soft.dim() == 5:
                soft, image = fold_depth_to_batch(soft)[0], \
                    fold_depth_to_batch(image)[0]
            h, w = image.shape[2:]
            return crf(soft, kernels, radius, {'rgb': image}, h, w)['loss']

        return reg_fn


class WSLUSTM(WSLSegAgent):
    step_class = USTMStep
    uses_teacher = True

    def _train_batches(self):
        for batches in super()._train_batches():
            yield batches + (host_random(lambda: np.random.randint(0, 4)),)

    def step_kwargs(self):
        cfg = self._paradigm_cfg()
        return {'weighted': True, 'passes': cfg.get('ustm_mcdroput_n', 8),
                'base_w': cfg.get('regularize_w', 0.1)}


class WSLDMPLS(BiNetAgent, WSLSegAgent):
    step_class = DMPLSStep

    def training_hyper(self, iteration):
        hyper = super().training_hyper(iteration)
        hyper['beta'] = float(host_random(np.random.random))
        return hyper

    def step_kwargs(self):
        return {'weighted': True}


WSLMethodDict = {
    'EntropyMinimization': WSLEntropyMinimization,
    'GatedCRF': WSLGatedCRF,
    'MumfordShah': WSLMumfordShah,
    'TotalVariation': WSLTotalVariation,
    'USTM': WSLUSTM,
    'DMPLS': WSLDMPLS,
}
