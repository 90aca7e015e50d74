"""eva_main: the evaluation reports after the test stage.

Parity with the reference evaluation (PyMIC/pymic/util/evaluation_seg_train.py:
263-582) and the JAX package's ``metrics/evaluate.py``: for each of
``metric_1`` / ``metric_2``, score every (ground truth, segmentation) pair
of the test and valid pair manifests and write
``{seg_root}/{split}_{organ}_{metric}_all.csv``: a header, one row per case
and the mean and std rows. The pair manifests are read with the ``csv``
module; their first row is a header, as ``pd.read_csv`` takes it.

The segmentation root: a config with a ``[testing]`` section (the
evaluation after training) uses the test stage's output folder,
``output_dir/(basename(ckpt_save_dir) + '_' + stem(test_csv))``, as the
reference does (:295-300, where ``segmentation_folder_root`` is commented
out); an evaluation-only config without ``[testing]`` uses
``[evaluation] segmentation_folder_root``.
"""
from __future__ import annotations

import csv
import logging
import os

import numpy as np

from fpl_plus_torch.io.image_io import load_image_as_nd_array
from fpl_plus_torch.metrics.seg_metrics import get_multi_class_evaluation_score
from fpl_plus_torch.utils.image_process import convert_label


def _seg_root(config) -> str:
    output_dir = config['testing']['output_dir']
    ckpt_dir = config['training']['ckpt_save_dir'].split('/')[-1]
    subset = config['dataset']['test_csv'].split('/')[-1][:-4]
    return os.path.join(output_dir, ckpt_dir + '_' + subset)


def _read_pairs(pair_csv):
    """(ground truth, segmentation) names of each row after the header."""
    with open(pair_csv, newline='') as f:
        rows = [r for r in csv.reader(f) if r]
    for i, row in enumerate(rows[1:], 1):
        if len(row) < 2:
            raise ValueError('{0} row {1} has no segmentation column'.format(
                pair_csv, i))
    return [(r[0], r[1]) for r in rows[1:]]


def _evaluate_pairs(config, metric, pair_csv, split_name, seg_root):
    eval_cfg = config['evaluation']
    label_list = eval_cfg['label_list']
    if not isinstance(label_list, (list, tuple)):
        label_list = [label_list]
    label_fuse = eval_cfg.get('label_fuse', False)
    organ_name = eval_cfg['organ_name']
    gt_root = eval_cfg['ground_truth_folder_root']
    g_convert_s = eval_cfg.get('ground_truth_label_convert_source', None)
    g_convert_t = eval_cfg.get('ground_truth_label_convert_target', None)
    s_convert_s = eval_cfg.get('segmentation_label_convert_source', None)
    s_convert_t = eval_cfg.get('segmentation_label_convert_target', None)

    score_all, rows = [], []
    for gt_name, seg_name in _read_pairs(pair_csv):
        g_dict = load_image_as_nd_array(os.path.join(gt_root, gt_name))
        s_dict = load_image_as_nd_array(os.path.join(seg_root, seg_name))
        g_volume, s_volume = g_dict['data_array'], s_dict['data_array']
        spacing = s_dict['spacing']
        if g_convert_s is not None and g_convert_t is not None:
            g_volume = convert_label(g_volume, g_convert_s, g_convert_t)
        if s_convert_s is not None and s_convert_t is not None:
            s_volume = convert_label(s_volume, s_convert_s, s_convert_t)
        scores = get_multi_class_evaluation_score(
            s_volume, g_volume, label_list, label_fuse, spacing, metric)
        if len(label_list) > 1:
            scores.append(float(np.mean(scores)))
        score_all.append(scores)
        rows.append([seg_name] + scores)

    score_all = np.asarray(score_all)
    mean, std = score_all.mean(axis=0), score_all.std(axis=0)
    rows.append(['mean'] + list(mean))
    rows.append(['std'] + list(std))

    out_csv = '{0}/{1}_{2}_{3}_all.csv'.format(seg_root, split_name,
                                               organ_name, metric)
    with open(out_csv, 'w', newline='') as f:
        writer = csv.writer(f, delimiter=',', quotechar='"',
                            quoting=csv.QUOTE_MINIMAL)
        head = ['image'] + ['class_{0}'.format(i) for i in label_list]
        if len(label_list) > 1:
            head += ['average']
        writer.writerow(head)
        for row in rows:
            writer.writerow(row)
    logging.info('%s data: %s mean %s', split_name, metric, mean)
    logging.info('%s data: %s std  %s', split_name, metric, std)
    return mean, std


def eva_main(config):
    """Score ``metric_1`` and ``metric_2`` over the test and valid pair
    manifests; returns ``{(split, metric): (mean, std)}``."""
    eval_cfg = config['evaluation']
    explicit = eval_cfg.get('segmentation_folder_root', None)
    if explicit is not None and 'testing' not in config:
        seg_root = explicit
    else:
        seg_root = _seg_root(config)
    results = {}
    for key in ('metric_1', 'metric_2'):
        metric = eval_cfg.get(key, None)
        if metric is None:
            continue
        for split, csv_key in (('test', 'test_evaluation_image_pair'),
                               ('valid', 'valid_evaluation_image_pair')):
            pair_csv = eval_cfg.get(csv_key, None)
            if pair_csv is None:
                continue
            results[(split, metric)] = _evaluate_pairs(
                config, metric, pair_csv, split, seg_root)
    return results
