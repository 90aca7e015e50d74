"""Host-side ND image utilities (reference PyMIC/pymic/util/image_process.py,
the JAX package's ``utils/image_process.py``): bounding boxes, crops and
pastes, centred crop-and-pad, label conversion, connected components, the
signed Euclidean distance map and resampling between spacings. Connected
components use scipy's face-connectivity labeling, renumbered 1..n by
decreasing size with ties in order of first appearance (the order of the
JAX package's C++ labeling)."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
from scipy import ndimage


def get_nd_bounding_box(volume: np.ndarray, margin: Sequence[int] = None
                        ) -> Tuple[List[int], List[int]]:
    """Bounding box (min, max-exclusive per axis) of the nonzero region,
    widened by ``margin`` voxels per axis within the volume."""
    if margin is None:
        margin = [0] * volume.ndim
    if len(margin) != volume.ndim:
        raise ValueError('{0} margins for a {1}D volume'.format(
            len(margin), volume.ndim))
    nz = np.nonzero(volume)
    bb_min = [max(int(ix.min()) - m, 0) for ix, m in zip(nz, margin)]
    bb_max = [min(int(ix.max()) + 1 + m, s)
              for ix, m, s in zip(nz, margin, volume.shape)]
    return bb_min, bb_max


def crop_nd_volume_with_bounding_box(volume: np.ndarray,
                                     bb_min: Sequence[int],
                                     bb_max: Sequence[int]) -> np.ndarray:
    """The view of ``volume`` inside [bb_min, bb_max) (leading axes that
    the box does not name are kept whole)."""
    return volume[tuple(slice(lo, hi) for lo, hi in zip(bb_min, bb_max))]


def set_nd_volume_roi_with_bounding_box_range(
        volume: np.ndarray, bb_min: Sequence[int], bb_max: Sequence[int],
        sub_volume: np.ndarray, addition: bool = True) -> np.ndarray:
    """Add ``sub_volume`` into (or, without ``addition``, write it over)
    the box [bb_min, bb_max) of ``volume``, in place; returns ``volume``."""
    slicer = tuple(slice(lo, hi) for lo, hi in zip(bb_min, bb_max))
    if addition:
        volume[slicer] += sub_volume
    else:
        volume[slicer] = sub_volume
    return volume


def crop_and_pad_nd_array_to_desired_shape(image: np.ndarray,
                                           out_shape: Sequence[int],
                                           pad_mode: str) -> np.ndarray:
    """Centre-crop the axes longer than ``out_shape`` and centre-pad (numpy
    ``pad_mode``) the shorter ones."""
    crop_shape = [min(o, i) for o, i in zip(out_shape, image.shape)]
    ml = [(i - c) // 2 for i, c in zip(image.shape, crop_shape)]
    cropped = image[tuple(slice(m, m + c) for m, c in zip(ml, crop_shape))]
    pads = [((o - c) // 2, (o - c) - (o - c) // 2)
            for o, c in zip(out_shape, crop_shape)]
    if any(lo or hi for lo, hi in pads):
        cropped = np.pad(cropped, pads, pad_mode)
    return cropped


def get_euclidean_distance(image: np.ndarray, dim: int = 3,
                           spacing: Sequence[float] = (1.0, 1.0, 1.0)
                           ) -> np.ndarray:
    """Signed Euclidean distance map of a 3D mask (positive outside,
    negative inside; exact, in voxels: ``spacing`` is accepted and not
    applied, as in the JAX package)."""
    if image.ndim != 3 or dim != 3:
        raise ValueError('only 3D distance maps are implemented')
    fg = ndimage.distance_transform_edt(image > 0.5)
    bg = ndimage.distance_transform_edt(image <= 0.5)
    return bg - fg


def resample_to_spacing(data: np.ndarray, spacing_in: Sequence[float],
                        spacing_out: Sequence[float], order: int = 1
                        ) -> np.ndarray:
    """Resample a [D,H,W] volume between voxel spacings (z, y, x order)
    with a spline of ``order``."""
    zoom = [si / so for si, so in zip(spacing_in, spacing_out)]
    return ndimage.zoom(data, zoom, order=order)


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
