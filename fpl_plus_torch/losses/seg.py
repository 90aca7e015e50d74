"""Segmentation losses of the FPL+ training stages (channels-first).

Every loss is a callable ``loss(loss_input_dict) -> scalar``; the dict holds
``prediction`` (logits or probabilities ``[N, C, *spatial]``), ``ground_truth``
(one-hot, same shape), optional ``pixel_weight`` (``[N, 1, *spatial]``) and
``image_weight`` (``[N]``). Numerical parity with the reference losses and
the JAX package's ``losses/seg.py``:

  DiceLoss         PyMIC/pymic/loss/seg/dice.py:9-57
  DiceLoss_weight  dice.py:95-128 (per-sample dice x image_weight)
  CrossEntropyLoss ce.py:9-47 (p*0.999+5e-4 stabilisation, weight-normalised)
  CombinedLoss     combined.py:8-39
"""
from __future__ import annotations

import torch

from fpl_plus_torch.losses.util import (get_classwise_dice, reshape_to_2d,
                                        softmax_if)


class AbstractSegLoss:
    def __init__(self, params=None):
        params = params or {}
        self.params = params
        self.softmax = params.get('loss_softmax', True)

    def __call__(self, loss_input_dict):
        raise NotImplementedError


class DiceLoss(AbstractSegLoss):
    def __call__(self, d):
        predict = reshape_to_2d(softmax_if(d['prediction'], self.softmax))
        soft_y = reshape_to_2d(d['ground_truth'])
        pix_w = d.get('pixel_weight', None)
        if pix_w is not None:
            pix_w = reshape_to_2d(pix_w)
        dice = get_classwise_dice(predict, soft_y, pix_w)
        return 1.0 - dice.mean()


class DiceLossWeight(AbstractSegLoss):
    """Per-sample weighted dice: mean_i image_weight[i] * (1 - dice_i), the
    FPL+ image and pixel weighting. Validation passes no weights: they are
    then 1 (the JAX package's version raises there)."""

    def __call__(self, d):
        predict = softmax_if(d['prediction'], self.softmax)
        n = predict.shape[0]

        def per_sample(x):   # [N, K, *sp] -> [N, voxels, K]
            return x.movedim(1, -1).reshape(n, -1, x.shape[1])

        p, y = per_sample(predict), per_sample(d['ground_truth'])
        pix_w = d.get('pixel_weight', None)
        w = per_sample(pix_w) if pix_w is not None else 1.0
        intersect = (y * p * w).sum(1)
        dice = (2.0 * intersect + 1e-5) / (
            (y * w).sum(1) + (p * w).sum(1) + 1e-5)            # [N, K]
        losses = 1.0 - dice.mean(1)
        img_w = d.get('image_weight', None)
        if img_w is not None:
            losses = losses * img_w
        return torch.sum(losses) / n


class CrossEntropyLoss(AbstractSegLoss):
    def __call__(self, d):
        predict = reshape_to_2d(softmax_if(d['prediction'], self.softmax))
        soft_y = reshape_to_2d(d['ground_truth'])
        predict = predict * 0.999 + 5e-4   # reference ce.py:38 stabilisation
        ce = torch.sum(-soft_y * torch.log(predict), 1)
        pix_w = d.get('pixel_weight', None)
        if pix_w is None:
            return ce.mean()
        pix_w = reshape_to_2d(pix_w)[:, 0]
        return torch.sum(pix_w * ce) / (pix_w.sum() + 1e-5)


class CombinedLoss(AbstractSegLoss):
    def __init__(self, params, loss_dict):
        super().__init__(params)
        names = params['loss_type']
        self.loss_weight = params['loss_weight']
        if len(names) != len(self.loss_weight):
            raise ValueError('loss_type has {0} entries, loss_weight {1}'
                             .format(len(names), len(self.loss_weight)))
        self.loss_list = []
        for name in names:
            if name not in loss_dict:
                raise ValueError('{0} is not defined in the loss dictionary'
                                 .format(name))
            self.loss_list.append(loss_dict[name](params))

    def __call__(self, d):
        value = 0.0
        for w, loss in zip(self.loss_weight, self.loss_list):
            value += w * loss(d)
        return value
