"""Noisy-label segmentation agents (reference PyMIC/pymic/net_run_nll/,
the JAX package's ``agents/nll.py``): CoTeaching (nll_co_teaching.py),
TriNet (nll_trinet.py) and DAST (nll_dast.py); registry ``NLLMethodDict``
(nll_main.py:12-14). The CLSLSR confidence-map stage is
``agents/nll_clslsr.py``.

They run on ``agents/ssl.py``'s ``ParadigmAgent`` (the segmentation
agent's training loop, one train-mode domain-0 forward per iteration and
one optimizer update) with their networks' peers (``BiNetAgent``, or a
TriNet), and read ``[noisy_label_learning]``:

* the small-loss selection is a rank mask: a voxel is kept when its rank
  in the ascending order of the per-voxel CE is below ``keep_n``, two
  stable ``argsort`` calls over the batch's voxels in the channels-last
  order of the JAX package, so that ties break as there; ``keep_n`` is the
  float32 product ``remb_ratio x n`` truncated, as the JAX package's traced
  product is;
* ``remb_ratio = 1 - (1 - select_ratio) x`` the sigmoid ramp between
  ``rampup_start`` (default 0) and ``rampup_end`` (default ``iter_max``);
* DAST: a second train stream (``train_csv_noise``, batches of
  ``train_batch_size_noise``, shuffled with seed ``random_seed + 200``,
  produced by ``num_workder`` worker processes, default 8, not clamped to
  the spare cores, as in the JAX package). The step
  reads its two selection scores on the host after the update, one
  device-to-host sync per step that the method needs; the rank queues,
  host Python, set the NEXT iteration's DBC and ST gates.
"""
from __future__ import annotations

import logging
from typing import Dict, List

import numpy as np
import torch

from fpl_plus_torch.agents.agent_seg import _host_batch
from fpl_plus_torch.agents.nll_clslsr import get_confident_map_quantile
from fpl_plus_torch.agents.ssl import (BiNetAgent, ParadigmAgent,
                                       ParadigmStep, one_hot_argmax)
from fpl_plus_torch.engine.train import primary_head, train_dice
from fpl_plus_torch.io.dataset import NiftyDataset
from fpl_plus_torch.io.loader import DataLoader, repeat_loader
from fpl_plus_torch.models.multi_net import make_trinet
from fpl_plus_torch.models.registry import param_count
from fpl_plus_torch.utils.ramps import get_rampup_ratio


def voxel_ce(logits: torch.Tensor, y_soft: torch.Tensor) -> torch.Tensor:
    """Per-voxel CE ``[N x spatial]`` of ``logits [N, K, *sp]`` against the
    soft labels, with the reference's stabilisation
    (nll_co_teaching.py:100-113: softmax x 0.999 + 5e-4), voxels in the
    channels-last order."""
    k = logits.shape[1]
    prob = torch.softmax(logits, 1) * 0.999 + 5e-4
    return torch.sum(-y_soft.movedim(1, -1).reshape(-1, k)
                     * torch.log(prob.movedim(1, -1).reshape(-1, k)), -1)


def keep_count(remb_ratio: float, n: int) -> int:
    """The JAX package's ``(remb_ratio * n).astype(int32)`` on its float32
    ``remb_ratio``: a float32 product, truncated."""
    return int(np.float32(remb_ratio) * np.float32(n))


def keep_smallest_mask(values: torch.Tensor, keep_n: int) -> torch.Tensor:
    """f32 mask, 1 for the ``keep_n`` smallest values (ties: the earlier
    voxel first)."""
    order = torch.argsort(values, stable=True)
    ranks = torch.argsort(order, stable=True)
    return (ranks < keep_n).to(torch.float32)


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(values * mask) / (torch.sum(mask) + 1e-16)


def kl_map(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """KL(q || p) per voxel over the class axis."""
    return torch.sum(q * (torch.log(q + 1e-16) - torch.log(p + 1e-16)), 1)


class _SelectStep(ParadigmStep):
    """The peers' forward and each peer's per-voxel CE and small-loss mask
    (masks without gradient)."""

    def peers(self, batch, draws, remb_ratio):
        outs = self.student(batch['image'], draws.dropout(0))
        heads = [primary_head(o) for o in outs]
        y = batch['label_prob']
        losses = [voxel_ce(h, y) for h in heads]
        keep_n = keep_count(remb_ratio, losses[0].shape[0])
        masks = [keep_smallest_mask(li.detach(), keep_n) for li in losses]
        return heads, losses, masks

    def finish(self, loss, heads, label_prob, **extra):
        self._update(loss)
        with torch.no_grad():
            metrics = {'loss': loss.detach()}
            metrics.update((k, v.detach()) for k, v in extra.items())
            metrics['class_dice_0'] = train_dice(heads[0].detach(),
                                                 label_prob)
            return metrics


class CoTeachingStep(_SelectStep):
    """nll_co_teaching.py:23-182: each of two peers learns on the voxels
    its PEER kept."""

    def __call__(self, batches, draws, remb_ratio):
        batch = batches[0]
        heads, (loss1, loss2), (mask1, mask2) = self.peers(batch, draws,
                                                           remb_ratio)
        loss = masked_mean(loss1, mask2) + masked_mean(loss2, mask1)
        return self.finish(loss, heads, batch['label_prob'],
                           loss_no_select1=loss1.mean(),
                           loss_no_select2=loss2.mean())


class TriNetStep(_SelectStep):
    """nll_trinet.py:39-179: peer i learns on the union of the other two
    peers' masks."""

    def __call__(self, batches, draws, remb_ratio):
        batch = batches[0]
        heads, losses, masks = self.peers(batch, draws, remb_ratio)
        pair = [torch.maximum(masks[1], masks[2]),
                torch.maximum(masks[0], masks[2]),
                torch.maximum(masks[0], masks[1])]
        loss = sum(masked_mean(li, mi) for li, mi in zip(losses, pair))
        return self.finish(loss, heads, batch['label_prob'],
                           loss_no_select1=losses[0].mean())


class DASTStep(ParadigmStep):
    """nll_dast.py:91-275: one forward of the clean and the noisy batch
    through the two branches; the supervised term (clean branch on the
    clean rows, noisy branch on the noisy rows), the symmetric-KL DBC term
    and the ST term (a sharpened mix of both branches' argmax and the noisy
    label supervising the clean branch) on the noisy rows, gated by
    ``w_dbc`` / ``w_st``. After the update the selection scores go to
    ``on_scores(sel_n, sel_c)`` as host floats."""

    def __init__(self, *args, on_scores=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.on_scores = on_scores

    def __call__(self, batches, draws, w_dbc, w_st):
        clean, noise = batches['clean'], batches['noise']
        n0 = clean['image'].shape[0]
        y1 = noise['label_prob']
        b0, b1 = (primary_head(o) for o in self.student(
            torch.cat([clean['image'], noise['image']]), draws.dropout(0)))
        loss_sup = 0.5 * (
            self.loss_calculator({'prediction': b0[:n0],
                                  'ground_truth': clean['label_prob']})
            + self.loss_calculator({'prediction': b1[n0:],
                                    'ground_truth': y1}))
        p0 = torch.softmax(b0[n0:], 1)
        p1 = torch.softmax(b1[n0:], 1)
        loss_dbc = 0.5 * (torch.mean(kl_map(p0, p1.detach()))
                          + torch.mean(kl_map(p1, p0.detach())))
        pseudo = ((one_hot_argmax(b0[n0:].detach())
                   + one_hot_argmax(b1[n0:].detach()) + y1) / 3)
        t = 0.5
        sharp = pseudo ** (1 / t) / (pseudo ** (1 / t)
                                     + (1 - pseudo) ** (1 / t))
        loss_st = torch.mean(torch.abs(p0 - sharp))
        loss = loss_sup + w_dbc * loss_dbc + w_st * loss_st
        with torch.no_grad():
            exp_var = torch.exp(-16 * (0.5 * (kl_map(p1, p0)
                                              + kl_map(p0, p1)))).reshape(-1)
            ce_n = voxel_ce(b1[n0:], y1)
            ce_c = voxel_ce(b0[n0:], y1)
            sel_n = torch.mean(ce_c * exp_var)
            sel_c = torch.mean(ce_n * exp_var)
        self._update(loss)
        if self.on_scores is not None:
            self.on_scores(float(sel_n), float(sel_c))
        with torch.no_grad():
            return {'loss': loss.detach(), 'loss_sup': loss_sup.detach(),
                    'class_dice_0': train_dice(b0[:n0].detach(),
                                               clean['label_prob'])}


class Rank:
    """The sliding queue of the last ``queue_length`` scores (reference
    nll_dast.py:17-43): -1 while it fills, then the rank of the newest
    score among them."""

    def __init__(self, queue_length: int = 100):
        self.vals: List[float] = []
        self.queue_length = queue_length

    def add_val(self, val: float) -> int:
        if len(self.vals) < self.queue_length:
            self.vals.append(val)
            return -1
        self.vals.pop(0)
        self.vals.append(val)
        idxes = np.argsort(self.vals)
        return int(np.where(idxes == self.queue_length - 1)[0][0])


class NLLAgent(ParadigmAgent):
    """What the NLL agents share: their section and the ramped keep
    ratio of ``select_ratio()``."""

    paradigm_section = 'noisy_label_learning'

    def select_ratio(self) -> float:
        return self._paradigm_cfg()['co_teaching_select_ratio']

    def training_hyper(self, iteration: int) -> Dict[str, float]:
        cfg = self._paradigm_cfg()
        iter_max = self.config['training']['iter_max']
        ratio = get_rampup_ratio(iteration, cfg.get('rampup_start', 0),
                                 cfg.get('rampup_end', iter_max), 'sigmoid')
        return {'remb_ratio': 1.0 - (1 - self.select_ratio()) * ratio}


class NLLCoTeaching(BiNetAgent, NLLAgent):
    step_class = CoTeachingStep


class NLLTriNet(NLLAgent):
    step_class = TriNetStep

    def create_network(self):
        if self.module is None:
            self.module = make_trinet(self.config['network'])
        logging.info('parameter number %d', param_count(self.module))

    def select_ratio(self) -> float:
        cfg = self._paradigm_cfg()
        return cfg.get('trinet_select_ratio',
                       cfg.get('co_teaching_select_ratio', 0.9))


class NLLDAST(BiNetAgent, NLLAgent):
    """DAST: the clean and the noisy stream, the rank queues and their
    gates."""

    step_class = DASTStep

    def __init__(self, config: dict, stage: str, device):
        super().__init__(config, stage, device)
        self.train_loader_noise = None
        rank_len = self._paradigm_cfg().get('dast_rank_length', 20)
        self.noisy_rank = Rank(rank_len)
        self.clean_rank = Rank(rank_len)
        self.gates = None

    def create_dataset(self):
        super().create_dataset()
        if self.stage != 'train':
            return
        data_cfg = self.config['dataset']
        # not clamped to the spare cores, as in the JAX package
        # (agents/nll.py:232-239 there)
        workers = int(data_cfg.get('num_workder',
                                   data_cfg.get('num_worker', 8)))
        dataset = NiftyDataset(
            root_dir=data_cfg['root_dir'],
            csv_file=data_cfg['train_csv_noise'],
            modal_num=data_cfg.get('modal_num', 1), with_label=True,
            transform=self.build_transform('train'),
            cache_bytes=self.cache_bytes('train', workers),
            transform_cache=data_cfg.get('transform_cache', True))
        self.train_loader_noise = DataLoader(
            dataset, batch_size=data_cfg['train_batch_size_noise'],
            shuffle=True, num_workers=workers, seed=self.random_seed + 200)

    def loaders(self):
        return super().loaders() + [
            ld for ld in (self.train_loader_noise,) if ld is not None]

    def _train_batches(self):
        """Endless ``{'clean': batch, 'noise': batch}`` host batches."""
        pin = self.device.type == 'cuda'
        clean = repeat_loader(self.train_loaders[0])
        noise = repeat_loader(self.train_loader_noise)
        while True:
            yield {'clean': _host_batch(next(clean), self.fpl_uda, pin),
                   'noise': _host_batch(next(noise), self.fpl_uda, pin)}

    def training_hyper(self, iteration: int) -> Dict[str, float]:
        cfg = self._paradigm_cfg()
        iter_max = self.config['training']['iter_max']
        ratio = get_rampup_ratio(iteration, cfg.get('rampup_start', 0),
                                 cfg.get('rampup_end', iter_max), 'sigmoid')
        gates = self.gates or {'dbc': 0.0, 'st': 0.0}
        return {'w_dbc': cfg.get('dast_dbc_w', 0.1) * ratio * gates['dbc'],
                'w_st': cfg.get('dast_st_w', 0.1) * ratio * gates['st']}

    def update_gates(self, loss_n: float, loss_c: float) -> None:
        """The rank queues' gates of the next iteration
        (nll_dast.py:228-250)."""
        cfg = self._paradigm_cfg()
        rank_len = cfg.get('dast_rank_length', 20)
        select_ratio = cfg.get('dast_select_ratio', 0.2)
        rank_n = self.noisy_rank.add_val(loss_n)
        rank_c = self.clean_rank.add_val(loss_c)
        gates = {'dbc': 0.0, 'st': 0.0}
        if loss_n < loss_c:
            if rank_c >= rank_len * (1 - select_ratio):
                gates['dbc'] = 1.0
            if 0 <= rank_n <= rank_len * select_ratio:
                gates['st'] = 1.0
        self.gates = gates

    def step_kwargs(self):
        return {'on_scores': self.update_gates}


# the JAX package's name for the CE-quantile fallback
get_confident_map = get_confident_map_quantile

NLLMethodDict = {
    'CoTeaching': NLLCoTeaching,
    'TriNet': NLLTriNet,
    'DAST': NLLDAST,
}
