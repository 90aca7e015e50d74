"""Synthetic label-noise generators for NLL experiments
(reference PyMIC/pymic/util/make_noise.py:7-290; the JAX package's
``utils/make_noise.py``, copied: host numpy and scipy, the same
``np.random.RandomState`` streams, so a seed gives the same noisy labels).

``make_roi_mask`` / ``make_noise_masks_2d`` / ``make_noise_masks_3d``: box
masks that blank or jigsaw-shuffle one-hot labels. The second (tensor-based)
``make_noise_masks_3d`` variant of the reference — random erode/dilate
patches at the lesion boundary — is ``corrupt_label_boundary`` here (pure
numpy, no torch/CUDA round-trips).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
from scipy import ndimage

from fpl_plus_torch.utils.image_process import get_largest_k_components


def make_roi_mask(labels: np.ndarray, roi_type: str = 'entire',
                  margin: int = 0) -> np.ndarray:
    """Binary ROI mask around the labelled region (reference :7-48)."""
    mask = np.zeros_like(labels, np.uint8)
    if roi_type == 'entire':
        mask[:] = 1
        return mask
    nz = np.nonzero(labels)
    if len(nz[0]) == 0:
        return mask
    slicer = tuple(slice(max(ix.min() - margin, 0),
                         min(ix.max() + 1 + margin, s))
                   for ix, s in zip(nz, labels.shape))
    mask[slicer] = 1
    return mask


def _noise_boxes(shape_spatial, mask_params, rng,
                 is_num_fixed, is_size_fixed):
    num = mask_params[1] if is_num_fixed else rng.randint(
        1, mask_params[1] + 1)
    for _ in range(num):
        r = mask_params[0] if is_size_fixed else rng.randint(
            1, mask_params[0] + 1)
        centers = [rng.randint(r + 1, s - r - 1) for s in shape_spatial]
        yield r, centers


def make_noise_masks_2d(shape, mask_type, mask_params, is_num_masks_fixed,
                        is_size_masks_fixed, nlabels, labels_1hot=None,
                        rng=None) -> Tuple[np.ndarray, np.ndarray]:
    """[N,H,W,C]-shaped blank/wrong-label masks (reference :50-118)."""
    rng = rng or np.random
    blank = np.ones(shape)
    wrong = np.zeros(shape)
    for i in range(shape[0]):
        for r, (cx, cy) in _noise_boxes(shape[1:3], mask_params, rng,
                                        is_num_masks_fixed,
                                        is_size_masks_fixed):
            box = (i, slice(cx - r, cx + r), slice(cy - r, cy + r))
            blank[box[0], box[1], box[2], :] = 0
            if mask_type == 'squares_jigsaw':
                sx = rng.randint(r + 1, shape[1] - r - 1)
                sy = rng.randint(r + 1, shape[2] - r - 1)
                wrong[box[0], box[1], box[2], :] = labels_1hot[
                    i, sx - r:sx + r, sy - r:sy + r, :]
            elif mask_type == 'squares_zeros':
                wrong[box[0], box[1], box[2], 0] = 1
    return blank, wrong


def make_noise_masks_3d(shape, mask_type, mask_params, nlabels,
                        labels_1hot=None, is_num_masks_fixed=False,
                        is_size_masks_fixed=False, rng=None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """[N,D,H,W,C]-shaped blank/wrong-label masks (reference :119-168)."""
    rng = rng or np.random
    blank = np.ones(shape)
    wrong = np.zeros(shape)
    for r, (cx, cy, cz) in _noise_boxes(shape[1:4], mask_params, rng,
                                        is_num_masks_fixed,
                                        is_size_masks_fixed):
        box = (slice(None), slice(cx - r, cx + r), slice(cy - r, cy + r),
               slice(cz - r, cz + r))
        blank[box] = 0
        if mask_type == 'squares_jigsaw':
            sx = rng.randint(r + 1, shape[1] - r - 1)
            sy = rng.randint(r + 1, shape[2] - r - 1)
            sz = rng.randint(r + 1, shape[3] - r - 1)
            wrong[box] = labels_1hot[:, sx - r:sx + r, sy - r:sy + r,
                                     sz - r:sz + r, :]
        elif mask_type == 'squares_zeros':
            wrong[box + (0,)] = 1
    return blank, wrong


def corrupt_label_boundary(lab: np.ndarray,
                           patch_size: Sequence[int] = (6, 16, 16),
                           patch_num: int = 5, rng=None) -> np.ndarray:
    """Randomly erode/dilate boundary patches of the largest component
    (reference's tensor-based make_noise_masks_3d, :259-290), on a [D,H,W]
    integer label volume."""
    rng = rng or np.random
    out = lab.copy()
    comp = get_largest_k_components(np.asarray(lab > 0, np.uint8))
    if comp.sum() < 20:
        return out
    n_patches = rng.randint(0, patch_num) if patch_num > 1 else patch_num
    struct = np.ones((3, 3, 3), bool)
    for _ in range(n_patches):
        idx = np.where(comp > 0)
        d1 = rng.randint(idx[0].min(), max(idx[0].max(), idx[0].min() + 1))
        idx2 = np.where(comp[d1] > 0)
        if len(idx2[0]) == 0:
            continue
        w1 = rng.randint(idx2[0].min(), max(idx2[0].max(),
                                            idx2[0].min() + 1))
        idx3 = np.where(comp[d1, w1] > 0)
        if len(idx3[0]) == 0:
            continue
        for h_anchor in (idx3[0].min(), idx3[0].max()):
            sl = tuple(slice(max(int(c - p / 2), 0), int(c + p / 2))
                       for c, p in zip((d1, w1, h_anchor), patch_size))
            patch = out[sl]
            if patch.size == 0 or min(patch.shape) < 3:
                continue
            if rng.randint(0, 2) == 0:
                patch = ndimage.binary_erosion(patch > 0, struct)
            else:
                patch = ndimage.binary_dilation(patch > 0, struct)
            out[sl] = patch.astype(out.dtype)
    return out


def main(argv=None):
    """CLI over ``corrupt_label_boundary`` (the reference runs its noise
    maker from a notebook-style __main__): corrupt every label volume of a
    directory into simulated noisy annotations for the NLL paradigms."""
    import argparse
    import os
    import sys

    from fpl_plus_torch.io.image_io import (load_image_as_nd_array,
                                            save_nd_array_as_image)

    ap = argparse.ArgumentParser(prog='python -m '
                                      'fpl_plus_torch.utils.make_noise')
    ap.add_argument('label_dir')
    ap.add_argument('output_dir')
    ap.add_argument('--patch-size', type=int, nargs=3, default=[6, 16, 16])
    ap.add_argument('--patch-num', type=int, default=5)
    ap.add_argument('--seed', type=int, default=2024)
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
    rng = np.random.RandomState(args.seed)
    os.makedirs(args.output_dir, exist_ok=True)
    names = sorted(n for n in os.listdir(args.label_dir)
                   if n.endswith(('.nii', '.nii.gz', '.mha')))
    for name in names:
        src = os.path.join(args.label_dir, name)
        lab = load_image_as_nd_array(src)['data_array'][0]
        noisy = corrupt_label_boundary(lab, tuple(args.patch_size),
                                       args.patch_num, rng)
        save_nd_array_as_image(noisy.astype(np.int16),
                               os.path.join(args.output_dir, name), src)
    print('corrupted {0} label volumes -> {1}'.format(len(names),
                                                      args.output_dir))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
