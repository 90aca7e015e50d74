"""Host-side label utilities (reference PyMIC/pymic/util/image_process.py),
trimmed to what the test stage uses. Connected components use scipy's
face-connectivity labeling, renumbered 1..n by decreasing size with ties in
order of first appearance (the order of the JAX package's C++ labeling)."""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
from scipy import ndimage


def convert_label(label: np.ndarray, source_list: Sequence[int],
                  target_list: Sequence[int]) -> np.ndarray:
    assert len(source_list) == len(target_list)
    # the output dtype must hold every target code: uint8 argmax maps
    # converted to MMWHS raw codes (205..820) overflow their own dtype
    out_dtype = np.result_type(label.dtype,
                               np.min_scalar_type(int(max(target_list))),
                               np.min_scalar_type(int(min(target_list))))
    out = np.zeros(label.shape, out_dtype)
    for src, tgt in zip(source_list, target_list):
        out[label == src] = tgt
    return out


def label_connected_components(image: np.ndarray) -> Tuple[np.ndarray, int]:
    """Label the face-connected components of ``image > 0`` (2D or 3D).
    Components are numbered 1..n by decreasing size (1 = largest; a tie
    keeps raster-scan order). Returns (labels int32, n)."""
    mask = np.ascontiguousarray(image) > 0
    struct = ndimage.generate_binary_structure(mask.ndim, 1)
    lab, n = ndimage.label(mask, structure=struct)
    if n > 0:
        sizes = np.bincount(lab.reshape(-1))[1:]
        order = np.argsort(-sizes, kind='stable')
        remap = np.zeros(n + 1, np.int32)
        remap[1 + order] = np.arange(1, n + 1, dtype=np.int32)
        lab = remap[lab]
    return lab.astype(np.int32), int(n)


def get_largest_k_components(image: np.ndarray, k: int = 1) -> np.ndarray:
    if image.sum() == 0:
        return image
    if image.ndim not in (2, 3):
        raise ValueError('the dimension number should be 2 or 3')
    labeled, n = label_connected_components(image)
    if n == 0:
        return np.zeros_like(image)
    return ((labeled > 0) & (labeled <= min(k, n))).astype(np.uint8)
