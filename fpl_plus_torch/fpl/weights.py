"""FPL filtering weight tools.

Replaces the reference's standalone scripts with parameterized functions
(the scripts hardcode experiment paths):

* ``compute_pixel_weights`` — reference data/get_pixel_weight.py:12-28 and
  merge_pixelw.py:13-29: pseudo-labels of the real target images and of
  their CycleGAN fake-source translations are compared; disagreeing voxels
  get weight 0.5, agreeing voxels 1.0 (``1 - 0.5 * XOR``), written as NIfTI
  weight maps.
* ``write_image_weight_csv`` — reference "data/get image_weight.py" (space
  in the original filename): loads the sorted uncertainty ``.npy`` emitted
  by the FPL inference pass, min-max inverts the non-1 weights to
  ``(0,1] + 0.01`` (low uncertainty -> high weight) and writes the weighted
  train CSV with ``image,label,pixel_weight,image_weight`` columns.
"""
from __future__ import annotations

import csv
import logging
import os
from typing import List

import numpy as np

from fpl_plus_torch.io.image_io import (load_image_as_nd_array,
                                      save_nd_array_as_image)


def compute_pixel_weights(pseudo_target_dir: str,
                          pseudo_fake_source_dir: str,
                          output_dir: str) -> List[str]:
    os.makedirs(output_dir, exist_ok=True)
    names = sorted(n for n in os.listdir(pseudo_target_dir)
                   if '.nii.gz' in n)
    cyc_names = sorted(n for n in os.listdir(pseudo_fake_source_dir)
                       if '.nii.gz' in n)
    assert len(names) == len(cyc_names)
    written = []
    for name in names:
        a = load_image_as_nd_array(
            os.path.join(pseudo_target_dir, name))['data_array'][0]
        b = load_image_as_nd_array(
            os.path.join(pseudo_fake_source_dir, name))['data_array'][0]
        assert a.shape == b.shape
        # label disagreement: (a != b) — identical to the reference's
        # binary XOR (min(a+b,1) - a*b) on {0,1} labels, and the correct
        # generalization for multi-class (MMWHS-style) pseudo-labels
        disagree = (a != b)
        weight = np.where(disagree, np.float32(0.5), np.float32(1.0))
        out_path = os.path.join(output_dir, name)
        save_nd_array_as_image(weight, out_path,
                               os.path.join(pseudo_target_dir, name))
        written.append(out_path)
    logging.info('wrote %d pixel-weight maps to %s', len(written), output_dir)
    return written


def write_image_weight_csv(uncertainty_npy: str,
                           output_csv: str,
                           image_dir: str,
                           pseudo_label_dir: str,
                           pixel_weight_dir: str) -> int:
    """Build the weighted train CSV from the sorted FPL uncertainty list.

    The ``.npy`` holds ``[(uncertainty, image_path), ...]`` sorted ascending
    (agent FPL pass). Entries with uncertainty == 1 (tiny-boundary volumes)
    are excluded from the min/max normalisation but still listed, exactly
    like the reference script.
    """
    entries = np.load(uncertainty_npy, allow_pickle=True)
    weights = [float(np.asarray(e[0]).reshape(-1)[0]) for e in entries]
    non_one = [w for w in weights if w != 1]
    if not non_one:
        non_one = [1.0]
    w_max, w_min = max(non_one), min(non_one)
    logging.info('max weight value: %s ; min weight value: %s', w_max, w_min)

    rows = []
    for e, w in zip(entries, weights):
        path = str(np.asarray(e[1]).reshape(-1)[0])
        base = path.split('/')[-1]
        # empty image_dir keeps the paths recorded in the npy
        img_name = os.path.join(image_dir, base) if image_dir else path
        lab_name = os.path.join(pseudo_label_dir, base)
        pw_name = os.path.join(pixel_weight_dir, base)
        w = min(w, w_max)
        image_weight = abs((w_max - w) / (w_max - w_min + 1e-12)) + 0.01
        rows.append([img_name, lab_name, pw_name, image_weight])

    os.makedirs(os.path.dirname(output_csv) or '.', exist_ok=True)
    with open(output_csv, 'w') as f:
        writer = csv.writer(f, delimiter=',', quotechar='"',
                            quoting=csv.QUOTE_MINIMAL)
        writer.writerow(['image', 'label', 'pixel_weight', 'image_weight'])
        writer.writerows(rows)
    logging.info('wrote %d weighted rows to %s', len(rows), output_csv)
    return len(rows)
