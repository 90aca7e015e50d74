"""Classification metrics and their evaluation (reference
PyMIC/pymic/util/evaluation_cls.py:21-192; the JAX package's
``metrics/cls_metrics.py``, copied, with the CSVs read by the ``csv``
module instead of pandas).

Binary and non-exclusive evaluation over ground-truth / probability CSVs:
accuracy, recall (sensitivity), specificity, precision and the rank AUC,
in closed form (host numpy). ``python -m fpl_plus_torch.metrics.cls_metrics
cfg`` runs the ``[evaluation]`` section (the reference's ``pymic_eval_cls``)
and writes its report.
"""
from __future__ import annotations

import csv
import logging

import numpy as np


def _read_values(path: str) -> np.ndarray:
    """Every column of a CSV but the first (the image name), header
    dropped, as float64 ``[rows, columns - 1]``."""
    with open(path, newline='') as f:
        rows = [r for r in csv.reader(f)][1:]
    return np.asarray([[float(v) for v in r[1:]] for r in rows if r],
                      np.float64)


def accuracy(gt_label, pred_label) -> float:
    return float((np.asarray(gt_label) == np.asarray(pred_label)).mean())


def recall(gt_label, pred_label) -> float:
    gt = np.asarray(gt_label)
    return float((gt * np.asarray(pred_label)).sum() / (gt.sum() + 0.0))


sensitivity = recall


def specificity(gt_label, pred_label) -> float:
    return recall(1 - np.asarray(gt_label), 1 - np.asarray(pred_label))


def precision(gt_label, pred_label) -> float:
    pred = np.asarray(pred_label)
    tp = (np.asarray(gt_label) * pred).sum()
    return float(tp / (pred.sum() + 1e-12))


def roc_auc(gt_label, pred_score) -> float:
    """Rank-based AUC (Mann-Whitney U)."""
    gt = np.asarray(gt_label)
    score = np.asarray(pred_score, np.float64)
    order = np.argsort(score, kind='mergesort')
    ranks = np.empty_like(order, np.float64)
    ranks[order] = np.arange(1, len(score) + 1)
    # average ranks for ties
    for v in np.unique(score):
        sel = score == v
        ranks[sel] = ranks[sel].mean()
    n_pos = gt.sum()
    n_neg = len(gt) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[gt == 1].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def get_evaluation_score(gt_label, pred_prob, metric: str) -> float:
    gt = np.asarray(gt_label)
    prob = np.asarray(pred_prob)
    pred = np.argmax(prob, axis=1)
    if metric == 'accuracy':
        return accuracy(gt, pred)
    if metric in ('recall', 'sensitivity'):
        return recall(gt, pred)
    if metric == 'specificity':
        return specificity(gt, pred)
    if metric == 'precision':
        return precision(gt, pred)
    if metric == 'auc':
        return roc_auc(gt, prob[:, 1])
    raise ValueError('undefined metric: {0}'.format(metric))


def binary_evaluation(config: dict) -> dict:
    """reference evaluation_cls.py:72-106: metric list over gt/pred CSVs."""
    metric_list = config['metric_list']
    if not isinstance(metric_list, (list, tuple)):
        metric_list = [metric_list]
    gt_csv = config['ground_truth_csv']
    prob_csv = config['predict_prob_csv']
    gt = _read_values(gt_csv)[:, -1].astype(np.int64)
    prob = _read_values(prob_csv)
    if len(gt) != len(prob):
        raise ValueError('{0} has {1} rows, {2} has {3}'.format(
            gt_csv, len(gt), prob_csv, len(prob)))
    scores = {}
    for metric in metric_list:
        scores[metric] = get_evaluation_score(gt, prob, metric)
        logging.info('%s: %.4f', metric, scores[metric])
    return scores


def nexcl_evaluation(config: dict) -> dict:
    """Non-exclusive (multi-label) evaluation: per-class binary metrics
    (reference evaluation_cls.py:108-157)."""
    metric_list = config['metric_list']
    if not isinstance(metric_list, (list, tuple)):
        metric_list = [metric_list]
    gt = _read_values(config['ground_truth_csv']).astype(np.int64)
    prob = _read_values(config['predict_prob_csv'])
    class_num = gt.shape[1]
    scores = {}
    for metric in metric_list:
        per_class = []
        for c in range(class_num):
            two_col = np.stack([1 - prob[:, c], prob[:, c]], axis=1)
            per_class.append(get_evaluation_score(gt[:, c], two_col, metric))
        scores[metric] = per_class
        logging.info('%s: %s', metric, per_class)
    return scores


def write_report(scores: dict, path: str) -> None:
    """``metric,value`` rows (non-exclusive: ``metric,class0,class1,..``)."""
    with open(path, 'w', newline='') as f:
        writer = csv.writer(f, lineterminator='\n')
        for metric, value in scores.items():
            writer.writerow([metric] + list(np.atleast_1d(value)))


def main_eval_cls(argv=None) -> int:
    """``python -m fpl_plus_torch.metrics.cls_metrics cfg``: the
    ``[evaluation]`` metrics, binary (``task_type = cls``, the default) or
    non-exclusive, logged and written beside the probability CSV, its name
    with ``_eval`` before ``.csv``; host only."""
    import argparse
    import sys

    from fpl_plus_torch.config.parser import parse_config
    parser = argparse.ArgumentParser(
        prog='python -m fpl_plus_torch.metrics.cls_metrics')
    parser.add_argument('cfg')
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    logging.basicConfig(level=logging.INFO)
    config = parse_config(args.cfg)['evaluation']
    if config.get('task_type', 'cls') == 'cls':
        scores = binary_evaluation(config)
    else:
        scores = nexcl_evaluation(config)
    report = config['predict_prob_csv'][:-len('.csv')] + '_eval.csv'
    write_report(scores, report)
    logging.info('wrote %s', report)
    return 0


if __name__ == '__main__':
    raise SystemExit(main_eval_cls())
