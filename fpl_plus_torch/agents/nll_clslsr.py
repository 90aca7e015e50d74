"""CLSLSR confidence maps for noisy-label learning (reference
PyMIC/pymic/net_run_nll/nll_clslsr.py:19-205, the JAX package's
``agents/nll_clslsr.py``).

The network trained on noisy labels runs over the TRAINING manifest; a
per-voxel noise mask from confident learning (Northcutt et al., JAIR 2021;
the cleanlab-1.x rules the reference calls) is written as ``slsr_conf/``
weight maps next to the dataset, and ``<train_csv>_clslsr.csv`` names them
in its ``pixel_weight`` column for a retrain with ``SLSRLoss``.

The confident-learning functions are host numpy, copied from the JAX
package:

* confident joint: class j's threshold is the mean p(j) over the examples
  labelled j (float64 accumulation, compared in the caller's float dtype,
  with cleanlab's ``- 1e-6`` slack); an example is confidently class k if
  p(k) reaches that threshold, its guess is its most probable confident
  class, and the (given, guessed) pairs are counted;
* calibration: rows rescaled to the observed label counts;
* ``prune_by_class``: per class j, the ``count_j - cj[j, j]`` examples
  labelled j of lowest p(j); ``prune_by_noise_rate``: per (j, k), the
  ``cj[j, k]`` examples labelled j of highest p(k); ``both``: the
  intersection.

The agent (``NLLCLSLSR``) infers through the port's Inferer over the
train manifest with its labels and the valid chain, undoes the chain on the
host, and compares the prediction with the label volume read from disk in
its original geometry, after the chain's ``LabelConvert`` /
``LabelConvertNonzero`` only. With ``[testing] test_time_dropout`` the
dropout of volume i comes from a ``torch.Generator`` seeded from
``SeedSequence([random_seed, i])``, so its masks never equal the JAX
package's threefry draws.

Over a mesh (the test stage's, ``[testing]`` then ``[training]``
``mesh_devices`` / ``gpus`` / ``multihost``; the JAX package's
``agents/nll_clslsr.py:299-315,355-393``) every rank infers each volume
through the window-sharded Inferer, so every rank holds the same
predictions and computes the same noise mask; rank 0 alone writes the
``slsr_conf/`` maps and the manifest, and a barrier follows, so that no
rank reads them before they are written. With ``test_time_dropout`` each
rank draws its windows' masks, so the maps differ from a one-rank run's in
value, not in distribution, as the segmentation test stage's do.
"""
from __future__ import annotations

import csv
import logging
import os
import time
from typing import List

import numpy as np
import scipy.special
import torch

from fpl_plus_torch.agents.agent_seg import SegmentationAgent, head_predictor
from fpl_plus_torch.engine import ckpt as ckpt_lib
from fpl_plus_torch.engine.infer import Inferer
from fpl_plus_torch.io.dataset import NiftyDataset
from fpl_plus_torch.io.image_io import (load_image_as_nd_array,
                                        save_nd_array_as_image)
from fpl_plus_torch.io.loader import DataLoader, prefetch_iter
from fpl_plus_torch.parallel.multihost import is_primary_host


# -- confident learning (host numpy) ----------------------------------------

def compute_confident_joint(labels: np.ndarray,
                            probs: np.ndarray) -> np.ndarray:
    """[C, C] count of (given label, confidently guessed label) pairs.
    ``labels`` int [N], ``probs`` float [N, C]; a class absent from
    ``labels`` gets a +inf threshold. Only the threshold means accumulate
    in float64: the voxel arrays stay in the caller's dtype."""
    labels = np.asarray(labels).reshape(-1)
    probs = np.asarray(probs)
    k = probs.shape[1]
    thresholds = np.full(k, np.inf)
    for j in range(k):
        sel = labels == j
        if np.any(sel):
            thresholds[j] = probs[sel, j].mean(dtype=np.float64)
    thresholds = thresholds.astype(probs.dtype, copy=False)
    # cleanlab 1.x compares `psx >= thresholds - 1e-6`
    above = probs >= thresholds[None, :] - 1e-6
    masked = np.where(above, probs, -np.inf)
    guess = masked.argmax(axis=1)
    valid = above.any(axis=1)
    cj = np.zeros((k, k), np.int64)
    np.add.at(cj, (labels[valid], guess[valid]), 1)
    return cj


def calibrate_confident_joint(cj: np.ndarray,
                              labels: np.ndarray) -> np.ndarray:
    """Rows rescaled so that they sum to the observed per-class counts."""
    labels = np.asarray(labels).reshape(-1)
    k = cj.shape[0]
    counts = np.bincount(labels, minlength=k).astype(np.float64)
    row_sums = np.clip(cj.sum(axis=1).astype(np.float64), 1.0, None)
    cal = cj * (counts / row_sums)[:, None]
    return np.round(cal).astype(np.int64)


def _prune_by_class_mask(labels, probs, cj) -> np.ndarray:
    mask = np.zeros(labels.shape[0], bool)
    k = cj.shape[0]
    counts = np.bincount(labels, minlength=k)
    for j in range(k):
        num_noisy = int(counts[j] - cj[j, j])
        if num_noisy <= 0:
            continue
        idx = np.flatnonzero(labels == j)
        order = np.argsort(probs[idx, j])          # lowest self-confidence
        mask[idx[order[:num_noisy]]] = True
    return mask


def _prune_by_noise_rate_mask(labels, probs, cj) -> np.ndarray:
    mask = np.zeros(labels.shape[0], bool)
    k = cj.shape[0]
    for j in range(k):
        idx = np.flatnonzero(labels == j)
        if idx.size == 0:
            continue
        for kk in range(k):
            if kk == j:
                continue
            num = int(cj[j, kk])
            if num <= 0:
                continue
            order = np.argsort(probs[idx, kk])     # highest p(other class)
            mask[idx[order[-num:]]] = True
    return mask


def get_noise_mask(labels: np.ndarray, probs: np.ndarray,
                   prune_method: str = 'both') -> np.ndarray:
    """Boolean [N] noise mask (True: the given label looks wrong)."""
    labels = np.asarray(labels).reshape(-1).astype(np.int64)
    probs = np.asarray(probs)
    cj = calibrate_confident_joint(
        compute_confident_joint(labels, probs), labels)
    if prune_method == 'prune_by_class':
        return _prune_by_class_mask(labels, probs, cj)
    if prune_method == 'prune_by_noise_rate':
        return _prune_by_noise_rate_mask(labels, probs, cj)
    if prune_method == 'both':
        return (_prune_by_class_mask(labels, probs, cj)
                & _prune_by_noise_rate_mask(labels, probs, cj))
    raise ValueError('Undefined prune_method {0}'.format(prune_method))


def get_confident_map(gt: np.ndarray, pred: np.ndarray,
                      cl_type: str = 'both') -> np.ndarray:
    """The reference's entry (nll_clslsr.py:19-46): ``gt`` int [N],
    ``pred`` logits [N, C]; ``cl_type`` in {'both', 'Qij', 'Cij',
    'intersection', 'union', 'prune_by_class', 'prune_by_noise_rate'}.
    'Cij' prunes on the raw logits, as the reference hands them to
    cleanlab. Returns a boolean noise mask."""
    pred = np.asarray(pred, np.float32)
    prob = scipy.special.softmax(pred, axis=1)
    if cl_type in ('both', 'Qij'):
        return get_noise_mask(gt, prob, 'both')
    if cl_type == 'Cij':
        return get_noise_mask(gt, pred, 'both')
    if cl_type == 'intersection':
        return (get_noise_mask(gt, prob, 'both')
                & get_noise_mask(gt, pred, 'both'))
    if cl_type == 'union':
        return (get_noise_mask(gt, prob, 'both')
                | get_noise_mask(gt, pred, 'both'))
    if cl_type in ('prune_by_class', 'prune_by_noise_rate'):
        return get_noise_mask(gt, prob, cl_type)
    raise ValueError('Undefined CL_type {0}'.format(cl_type))


def get_confident_map_quantile(labels_prob, pred_logits,
                               ratio: float = 0.3) -> np.ndarray:
    """CE-quantile fallback (no class statistics): float32 [N] flags of
    the voxels whose CE is at or above the ``1 - ratio`` quantile.
    Channels-last inputs ``[..., K]``; f32 arithmetic and the linear
    interpolation of ``jnp.quantile`` (position ``q (n - 1)`` in f32, the
    weights ``1 - frac`` and ``frac``)."""
    logits = torch.as_tensor(np.asarray(pred_logits, np.float32))
    k = logits.shape[-1]
    prob = torch.softmax(logits, -1) * 0.999 + 5e-4
    y = torch.as_tensor(np.asarray(labels_prob, np.float32))
    ce = torch.sum(-y.reshape(-1, k) * torch.log(prob.reshape(-1, k)), -1)
    ordered = torch.sort(ce).values
    n = ordered.shape[0]
    pos = np.float32(1.0 - ratio) * np.float32(n - 1)
    low = np.floor(pos)
    high_w = np.float32(pos - low)
    low_w = np.float32(1.0) - high_w
    lo = int(np.clip(low, 0, n - 1))
    hi = int(np.clip(np.ceil(pos), 0, n - 1))
    threshold = ordered[lo] * float(low_w) + ordered[hi] * float(high_w)
    return (ce >= threshold).numpy().astype(np.float32)


# -- the confidence-map agent ------------------------------------------------

class NLLCLSLSR(SegmentationAgent):
    """Confidence-map inference over the TRAIN manifest (reference
    NLLCLSLSR, nll_clslsr.py:48-147). ``[dataset] train_csv`` is the
    manifest audited, ``valid_transform`` the inference chain; ``[testing]``
    names the checkpoint (ckpt_mode 0-2), the window and TTA,
    ``test_time_dropout`` and ``cl_type`` (default ``both``); over a mesh
    the windows are sharded (module docstring)."""

    def __init__(self, config: dict, device):
        super().__init__(config, 'test', device)

    def create_dataset(self):
        """The loader reads the train manifest with its labels through the
        valid chain, whose inverses undo it on the prediction."""
        data_cfg = self.config['dataset']
        transform = self.build_transform('valid')
        self.transform_list = (transform.transforms
                               if transform is not None else [])
        dataset = NiftyDataset(root_dir=data_cfg['root_dir'],
                               csv_file=data_cfg['train_csv'],
                               modal_num=data_cfg.get('modal_num', 1),
                               with_label=True, transform=transform)
        self.test_loader = DataLoader(dataset, batch_size=1,
                                      seed=self.random_seed)

    def infer(self):
        self.infer_with_cl()

    def _label_paths(self) -> List[str]:
        """The manifest's label column; two labels that share a basename
        would write the same ``slsr_conf/`` map, so that raises."""
        with open(self.config['dataset']['train_csv'], newline='') as f:
            paths = [r['label'] for r in csv.DictReader(f)]
        seen = {}
        for p in paths:
            base = os.path.basename(p)
            if base in seen and seen[base] != p:
                raise ValueError(
                    'CLSLSR: label basename collision: %r and %r both map '
                    'to slsr_conf/%s; rename one or split the manifest'
                    % (seen[base], p, base))
            seen[base] = p
        return paths

    def _convert_label_for_cl(self, lab: np.ndarray) -> np.ndarray:
        """The chain's label remapping (LabelConvert, LabelConvertNonzero)
        on the on-disk label, so that the confident joint compares in the
        label space the network was trained on."""
        sample = {'label': lab}
        for transform in self.transform_list:
            if type(transform).__name__ in ('LabelConvert',
                                            'LabelConvertNonzero'):
                sample = transform(sample)
        return np.asarray(sample['label'])

    def infer_with_cl(self):
        cfg_test = self.config['testing']
        domain_label = cfg_test.get('domian_label', 0)   # (sic) reference key
        tt_dropout = cfg_test.get('test_time_dropout', False)
        root_dir = self.config['dataset']['root_dir']
        ckpt_name = ckpt_lib.get_checkpoint_name(self.config)
        if isinstance(ckpt_name, (tuple, list)):
            raise ValueError('CLSLSR inference uses a single checkpoint '
                             '(ckpt_mode 0/1/2)')
        module = self._loaded_module(ckpt_name)
        inferer = Inferer(dict(cfg_test, output_mode='logits'), self.device,
                          mesh=self.get_mesh())
        predictor = head_predictor(module, domain_label)

        label_paths = self._label_paths()
        pred_list, gt_list, shapes = [], [], []
        t0 = time.time()
        vol_idx = 0
        for data in prefetch_iter(self.test_loader):
            images = np.asarray(data['image'], np.float32)
            pred = predictor
            if tt_dropout:
                pred = self._pass_fold(predictor, vol_idx, 1).take([0])
            data['predict'] = inferer.run(pred, images)
            pred = np.asarray(self._host_inverse(data)['predict'])
            k = pred.shape[1]
            lab = load_image_as_nd_array(
                os.path.join(root_dir, label_paths[vol_idx]))['data_array']
            lab = self._convert_label_for_cl(lab).reshape(-1).astype(np.int64)
            if int(lab.max(initial=0)) >= k:
                raise ValueError(
                    'CLSLSR: label %s has values >= class_num %d after the '
                    'configured label conversions; add LabelConvert/'
                    'LabelConvertNonzero to valid_transform so the label '
                    'space matches the network heads'
                    % (label_paths[vol_idx], k))
            pred_2d = np.moveaxis(pred, 1, -1).reshape(-1, k)
            if pred_2d.shape[0] != lab.shape[0]:
                raise ValueError('prediction/label voxel mismatch for '
                                 '{0}'.format(label_paths[vol_idx]))
            pred_list.append(pred_2d.astype(np.float32))
            gt_list.append(lab)
            shapes.append(pred.shape[2:])
            vol_idx += 1
        logging.info('CL inference over %d volumes in %.1fs', vol_idx,
                     time.time() - t0)

        conf = get_confident_map(np.concatenate(gt_list),
                                 np.concatenate(pred_list),
                                 cfg_test.get('cl_type', 'both'))
        logging.info('confident learning flagged %d / %d voxels (%.2f%%)',
                     int(conf.sum()), conf.size,
                     100.0 * conf.sum() / max(conf.size, 1))
        if not is_primary_host():   # computed everywhere, written once
            return
        save_dir = os.path.join(root_dir, 'slsr_conf')
        os.makedirs(save_dir, exist_ok=True)
        offset = 0
        for shape, lab_path in zip(shapes, label_paths):
            n_vox = int(np.prod(shape))
            conf_map = (conf[offset:offset + n_vox].reshape(shape)
                        .astype(np.uint8) * 255)
            offset += n_vox
            save_nd_array_as_image(
                conf_map, os.path.join(save_dir, os.path.basename(lab_path)),
                reference_name=os.path.join(root_dir, lab_path))
        logging.info('wrote %d confidence maps to %s', len(shapes), save_dir)


def run_get_confidence_map(config: dict, device) -> str:
    """The reference's ``get_confidence_map`` main (nll_clslsr.py:149-204):
    the CLSLSR agent over the train manifest, then the ``_clslsr.csv``
    retrain manifest (image, pixel_weight -> ``slsr_conf/<label basename>``,
    label), written with the ``csv`` module in the JAX package's pandas
    columns and order. Returns the manifest path. Over a mesh rank 0 writes
    the maps and the manifest, and every rank returns after a barrier."""
    agent = NLLCLSLSR(config, device)
    agent.run()
    csv_file = config['dataset']['train_csv']
    train_cl_csv = csv_file.replace('.csv', '_clslsr.csv')
    if is_primary_host():
        with open(csv_file, newline='') as f:
            rows = list(csv.DictReader(f))
        with open(train_cl_csv, 'w', newline='') as f:
            writer = csv.writer(f, lineterminator='\n')
            writer.writerow(['image', 'pixel_weight', 'label'])
            for r in rows:
                writer.writerow([r['image'],
                                 'slsr_conf/' + r['label'].split('/')[-1],
                                 r['label']])
        logging.info('wrote CLSLSR retrain manifest %s', train_cl_csv)
    agent.barrier('clslsr-written')   # rank 0's maps and manifest settle
    return train_cl_csv
