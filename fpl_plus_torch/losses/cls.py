"""Classification losses (reference PyMIC/pymic/loss/cls/basic.py:7-110,
the JAX package's ``losses/cls.py``).

``loss_input_dict``: ``prediction`` logits ``[N, C]``, ``ground_truth``
integer labels ``[N]`` (or ``[N, C]`` multi-hot for SigmoidCELoss).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


class AbstractClassificationLoss:
    def __init__(self, params=None):
        self.params = params or {}

    def __call__(self, d):
        raise NotImplementedError


def _labels(d) -> torch.Tensor:
    return torch.as_tensor(d['ground_truth']).to(torch.int64).reshape(-1)


class CrossEntropyLoss(AbstractClassificationLoss):
    def __call__(self, d):
        logp = torch.log_softmax(d['prediction'], -1)
        labels = _labels(d).to(logp.device)
        return -torch.mean(torch.gather(logp, 1, labels[:, None]))


class SigmoidCELoss(AbstractClassificationLoss):
    def __call__(self, d):
        predict = torch.sigmoid(d['prediction']) * 0.999 + 5e-4
        labels = torch.as_tensor(d['ground_truth']).to(predict)
        loss = (-labels * torch.log(predict)
                - (1 - labels) * torch.log(1 - predict))
        return torch.mean(loss)


def _softmax_and_one_hot(d):
    predict = torch.softmax(d['prediction'], -1)
    labels = _labels(d).to(predict.device)
    return predict, F.one_hot(labels, predict.shape[-1]).to(predict.dtype)


class L1Loss(AbstractClassificationLoss):
    def __call__(self, d):
        predict, soft_y = _softmax_and_one_hot(d)
        return torch.mean(torch.abs(predict - soft_y))


class MSELoss(AbstractClassificationLoss):
    def __call__(self, d):
        predict, soft_y = _softmax_and_one_hot(d)
        return torch.mean(torch.square(predict - soft_y))


class NLLLoss(AbstractClassificationLoss):
    def __call__(self, d):
        # the reference applies log-softmax then NLL: CE on the logits
        return CrossEntropyLoss()(d)


ClsLossDict = {
    'CrossEntropyLoss': CrossEntropyLoss,
    'SigmoidCELoss': SigmoidCELoss,
    'L1Loss': L1Loss,
    'MSELoss': MSELoss,
    'NLLLoss': NLLLoss,
}
