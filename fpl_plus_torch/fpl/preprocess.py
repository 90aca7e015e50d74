"""Dataset preprocessing (reference data/preprocess_vs.py:61-135 and
data/preprocess_bst.py:1-49; data/preprocess_mmwhs.py is empty in the
reference snapshot — the MMWHS recipe here follows the same crop+window
pattern the paper describes).

All functions are parameterized (the reference scripts hardcode paths) and
use the framework's own NIfTI codec instead of SimpleITK.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np
from scipy import ndimage

from fpl_plus_torch.io.nifti import read_image, write_image, NiftiImage


def winadj_mri(array: np.ndarray) -> np.ndarray:
    """Percentile windowing + [-1, 1] rescale. NOTE: the reference uses
    ``np.percentile(array, 999)`` which raises in modern numpy — the intent
    (and the behaviour on numpy<=1.21 after clipping) is the 99.9th
    percentile (preprocess_bst.py:6-14)."""
    array = np.asarray(array, np.float32).copy()
    v0 = np.percentile(array, 1)
    v1 = np.percentile(array, 99.9)
    array[array < v0] = v0
    array[array > v1] = v1
    v0, v1 = array.min(), array.max()
    return (array - v0) / (v1 - v0) * 2.0 - 1.0


def crop_depth_around_label(img: np.ndarray, lab: np.ndarray,
                            margin: int = 16) -> Tuple[np.ndarray, np.ndarray]:
    """Depth-crop +-margin slices around the labelled region
    (preprocess_bst.py:15-21)."""
    d = img.shape[0]
    indices = np.where(lab > 0)
    d0, d1 = indices[0].min(), indices[0].max()
    sl = slice(max(d0 - margin, 0), min(d1 + margin, d))
    return img[sl], lab[sl]


def preprocess_bst_case(image_path: str, label_path: str,
                        out_image_path: str, out_label_path: str) -> None:
    """BraTS: binarize labels, window intensities, depth-crop around tumor
    (preprocess_bst.py:35-49)."""
    img_obj = read_image(image_path)
    lab_obj = read_image(label_path)
    lab = np.asarray(lab_obj.data)
    lab[lab > 0] = 1
    img, lab = crop_depth_around_label(np.asarray(img_obj.data), lab)
    img = winadj_mri(img)
    for path in (out_image_path, out_label_path):
        os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    write_image(NiftiImage(img, img_obj.geometry), out_image_path)
    write_image(NiftiImage(lab.astype(np.int16), lab_obj.geometry),
                out_label_path)


def vs_source_crop(image_path: str, label_path: str, out_image_path: str,
                   out_label_path: str) -> None:
    """VS ceT1 source crop with the fixed physical bounding box
    (preprocess_vs.py:63-98): depth window 93-153mm from the top,
    H 190:350, W 120:392; asserts no labeled voxel is cropped away."""
    img_obj = read_image(image_path)
    lab_obj = read_image(label_path)
    img, lab = np.asarray(img_obj.data), np.asarray(lab_obj.data)
    d_total = img.shape[0]
    sz = img_obj.geometry.spacing[2]
    d0 = int(d_total - 153 / sz)
    d1 = int(d_total - 93 / sz)
    img_sub = img[d0:d1, 190:350, 120:392]
    lab_sub = lab[d0:d1, 190:350, 120:392]
    assert lab_sub.sum() == lab.sum(), 'label voxels cropped away'
    for path in (out_image_path, out_label_path):
        os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    write_image(NiftiImage(img_sub, img_obj.geometry), out_image_path)
    write_image(NiftiImage(lab_sub, lab_obj.geometry), out_label_path)


def vs_target_crop(image_path: str, out_image_path: str) -> None:
    """VS hrT2 target crop + zoom to 256x256 with spacing fixed to 0.4102
    (preprocess_vs.py:100-135): depth rules by slice count/spacing,
    H/W window 120:376 scaled by resolution/512."""
    img_obj = read_image(image_path)
    img = np.asarray(img_obj.data)
    d, h, w = img.shape
    sz = img_obj.geometry.spacing[2]
    if d < 50:
        d0, d1 = 5, d - 5
    elif sz in (1.0, 1.5):
        d0, d1 = 8, 48
    else:
        raise ValueError('undefined case')
    h0, h1 = int(120 * h / 512), int(376 * h / 512)
    w0, w1 = int(120 * w / 512), int(376 * w / 512)
    img_sub = img[d0:d1, h0:h1, w0:w1]
    hs, ws = img_sub.shape[1:]
    img_sub = ndimage.zoom(img_sub, [1.0, 256.0 / hs, 256.0 / ws])
    geom = img_obj.geometry
    geom = type(geom)(origin=geom.origin, spacing=(0.4102, 0.4102, sz),
                      direction=geom.direction)
    os.makedirs(os.path.dirname(out_image_path) or '.', exist_ok=True)
    write_image(NiftiImage(img_sub.astype(np.float32), geom), out_image_path)
