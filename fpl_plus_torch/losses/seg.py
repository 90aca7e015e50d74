"""Segmentation losses (channels-first).

Every loss is a callable ``loss(loss_input_dict) -> scalar``; the dict holds
``prediction`` (logits or probabilities ``[N, C, *spatial]``, or a list of
them from a multi-head net: all but ``DeepSuperviseLoss`` read the first),
``ground_truth`` (one-hot, same shape), optional ``pixel_weight`` (``[N, 1,
*spatial]``), ``image_weight`` (``[N]``) and, for ``MumfordShahLoss``,
``image``. Numerical parity with the reference losses and the JAX package's
``losses/seg.py``:

  DiceLoss            PyMIC/pymic/loss/seg/dice.py:9-57
  DiceLoss_weight     dice.py:95-128 (per-sample dice x image_weight)
  FocalDiceLoss       dice.py:130-162 (dice ** 1/beta)
  NoiseRobustDiceLoss dice.py:164-199 (|p-y|^gamma / (p+y))
  CrossEntropyLoss    ce.py:9-47 (p*0.999+5e-4 stabilisation,
                      weight-normalised)
  GeneralizedCELoss   ce.py:49-90 (q-GCE)
  ExpLogLoss          exp_log.py
  MSELoss / MAELoss   mse.py
  SLSRLoss            slsr.py (label smoothing where pixel_weight > 0)
  EntropyLoss         ssl.py:10-44 (mean voxel entropy / log C)
  TotalVariationLoss  ssl.py:46-83 (stride-1 min-then-max pool contour)
  MumfordShahLoss     mumford_shah.py:7-100 (2D; volumes fold slice-wise)
  CombinedLoss        combined.py:8-39
  DeepSuperviseLoss   deep_sup.py:7-41
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


class FocalDiceLoss(AbstractSegLoss):
    def __init__(self, params):
        super().__init__(params)
        self.beta = params['focaldiceloss_beta']

    def __call__(self, d):
        predict = reshape_to_2d(softmax_if(d['prediction'], self.softmax))
        soft_y = reshape_to_2d(d['ground_truth'])
        dice = get_classwise_dice(predict, soft_y) ** (1.0 / self.beta)
        return 1.0 - dice.mean()


class NoiseRobustDiceLoss(AbstractSegLoss):
    def __init__(self, params):
        super().__init__(params)
        self.gamma = params['noiserobustdiceloss_gamma']

    def __call__(self, d):
        predict = reshape_to_2d(softmax_if(d['prediction'], self.softmax))
        soft_y = reshape_to_2d(d['ground_truth'])
        numer = torch.sum(torch.abs(predict - soft_y) ** self.gamma, 0)
        denom = torch.sum(predict + soft_y, 0)
        return torch.mean(numer / (denom + 1e-5))


class GeneralizedCELoss(AbstractSegLoss):
    def __init__(self, params):
        super().__init__(params)
        self.q = params.get('loss_gce_q', 0.5)
        self.enable_pix_weight = params.get('loss_with_pixel_weight', False)
        self.cls_weight = params.get('loss_class_weight', None)

    def __call__(self, d):
        predict = reshape_to_2d(softmax_if(d['prediction'], self.softmax))
        soft_y = reshape_to_2d(d['ground_truth'])
        gce = (1.0 - predict ** self.q) / self.q * soft_y
        if self.cls_weight is not None:
            gce = gce * torch.as_tensor(self.cls_weight, dtype=gce.dtype,
                                        device=gce.device)
        gce = gce.sum(1)
        if self.enable_pix_weight:
            pix_w = d.get('pixel_weight', None)
            if pix_w is None:
                raise ValueError('Pixel weight is enabled but not defined')
            pix_w = reshape_to_2d(pix_w)[:, 0]
            return torch.sum(gce * pix_w) / torch.sum(pix_w)
        return gce.mean()


class ExpLogLoss(AbstractSegLoss):
    def __init__(self, params):
        super().__init__(params)
        self.w_dice = params['explogloss_w_dice']
        self.gamma = params['explogloss_gamma']

    def __call__(self, d):
        predict = reshape_to_2d(softmax_if(d['prediction'], self.softmax))
        soft_y = reshape_to_2d(d['ground_truth'])
        dice = get_classwise_dice(predict, soft_y) * 0.99 + 0.005
        exp_dice = torch.mean((-torch.log(dice)) ** self.gamma)
        predict = predict * 0.99 + 0.005
        wc = (1.0 / (soft_y.mean(0) + 0.1)) ** 0.5
        exp_ce = wc * (-torch.log(predict)) ** self.gamma
        exp_ce = torch.mean(torch.sum(soft_y * exp_ce, 1))
        return exp_dice * self.w_dice + exp_ce * (1.0 - self.w_dice)


class MSELoss(AbstractSegLoss):
    def __call__(self, d):
        predict = softmax_if(d['prediction'], self.softmax)
        return torch.mean(torch.square(predict - d['ground_truth']))


class MAELoss(AbstractSegLoss):
    def __call__(self, d):
        predict = softmax_if(d['prediction'], self.softmax)
        return torch.mean(torch.abs(predict - d['ground_truth']))


class SLSRLoss(AbstractSegLoss):
    def __init__(self, params=None):
        super().__init__(params)
        self.epsilon = (params or {}).get('slsrloss_epsilon', 0.25)

    def __call__(self, d):
        predict = reshape_to_2d(softmax_if(d['prediction'], self.softmax))
        soft_y = reshape_to_2d(d['ground_truth'])
        pix_w = d.get('pixel_weight', None)
        if pix_w is not None:
            pix_w = (reshape_to_2d(pix_w) > 0).to(torch.float32)
            smooth_y = (soft_y - 0.5) * (0.5 - self.epsilon) / 0.5 + 0.5
            smooth_y = pix_w * smooth_y + (1 - pix_w) * soft_y
        else:
            smooth_y = soft_y
        predict = predict * 0.999 + 5e-4
        return torch.mean(torch.sum(-smooth_y * torch.log(predict), 1))


class EntropyLoss(AbstractSegLoss):
    """Mean per-voxel entropy normalised by log(C) (SSL regulariser)."""

    def __call__(self, d):
        predict = softmax_if(d['prediction'], self.softmax) * 0.999 + 5e-4
        ent = torch.sum(-predict * torch.log(predict), 1) / math.log(
            predict.shape[1])
        return ent.mean()


def _max_pool3(x: torch.Tensor) -> torch.Tensor:
    """Stride-1 3^d max pooling, padding 1 that never wins (-inf)."""
    pool = F.max_pool3d if x.dim() == 5 else F.max_pool2d
    return pool(x, 3, stride=1, padding=1)


class TotalVariationLoss(AbstractSegLoss):
    def __call__(self, d):
        predict = softmax_if(d['prediction'], self.softmax) * 0.999 + 5e-4
        pred_min = -_max_pool3(-predict)
        pred_max = _max_pool3(pred_min)
        return torch.relu(pred_max - pred_min).mean()


class MumfordShahLoss(AbstractSegLoss):
    """Level-set piecewise-constant loss (reference mumford_shah.py:7-100;
    2D, a volume ``[N, C, D, H, W]`` folds slice-wise). Needs ``image``."""

    def __init__(self, params=None):
        super().__init__(params)
        params = params or {}
        self.penalty = params.get('mumfordshahloss_penalty', 'l1')
        self.grad_w = params.get('mumfordshahloss_lambda', 1.0)

    def __call__(self, d):
        predict = softmax_if(d['prediction'], self.softmax)
        image = d['image']
        if predict.dim() == 5:   # [N, C, D, H, W] -> [N*D, C, H, W]
            predict = predict.movedim(2, 1).flatten(0, 1)
            image = image.movedim(2, 1).flatten(0, 1)
        loss0 = 0.0
        for ich in range(image.shape[1]):
            tgt = image[:, ich:ich + 1]
            centroid = (torch.sum(tgt * predict, (2, 3), keepdim=True)
                        / torch.sum(predict, (2, 3), keepdim=True))
            plevel = tgt - centroid
            loss0 = loss0 + torch.sum(plevel * plevel * predict)
        dh = torch.abs(predict[:, :, 1:, :] - predict[:, :, :-1, :])
        dw = torch.abs(predict[:, :, :, 1:] - predict[:, :, :, :-1])
        if self.penalty == 'l2':
            dh, dw = dh * dh, dw * dw
        loss1 = torch.sum(dh) + torch.sum(dw)
        return (loss0 + self.grad_w * loss1) / predict.numel()


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


class DeepSuperviseLoss(AbstractSegLoss):
    """The weighted mean of ``base_loss`` over a list of predictions
    (``deep_suervise_weight``, the reference's spelling; default all 1)."""

    def __init__(self, params):
        super().__init__(params)
        self.deep_sup_weight = params.get('deep_suervise_weight', None)
        self.base_loss = params['base_loss']

    def __call__(self, d):
        predict = d['prediction']
        if not isinstance(predict, (list, tuple)):
            raise ValueError('deep supervision needs a list prediction')
        weights = self.deep_sup_weight or [1.0] * len(predict)
        if len(weights) != len(predict):
            raise ValueError('{0} deep-supervision weights for {1} '
                             'predictions'.format(len(weights), len(predict)))
        loss_sum, w_sum = 0.0, 0.0
        for w, p in zip(weights, predict):
            loss_sum = loss_sum + w * self.base_loss(dict(d, prediction=p))
            w_sum += w
        return loss_sum / w_sum
