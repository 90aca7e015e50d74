"""Plain reference of the test stage: the test chain, the sliding window
with flip test-time augmentation, and the FPL MC-dropout reduction.

The same semantics as the published Inferer (PyMIC/pymic/net_run_dsbn/
infer_func.py) and agent (agent_seg.py:834-964), written without the
program:

* the test chain ``[NormalizeWithMeanStd, Pad]``: the z-score of the
  volume, then a reflect pad up to the window where the volume is
  smaller; its inverse crops the pad away;
* the window grid: per axis the starts ``0, stride, 2 stride, ...`` below
  the size, each clamped to ``size - window``; W outermost, then H, then
  D; every window's logits added into an accumulator, divided by the
  count of windows covering each voxel;
* four variants (identity, flip H, flip W, flip H and W), each un-flipped
  and averaged;
* FPL: per pass the softmax of those logits; the variance over passes
  summed over classes and voxels, and the count of voxels whose class-1
  term ``-m log(m + 1e-6)`` of the passes' mean exceeds 0.01; the
  uncertainty ``vars_sum / boundary``, or 1 when ``boundary < 50``.

Dropout masks: pass m of volume i draws from a generator seeded with
``SeedSequence([random_seed, i]).generate_state(6)[m]``, in forwards of
``patch_chunk`` windows of the four variants each (rows variant-major),
layer after layer: the draws the program makes for that pass.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

FLIPS = ((), (-2,), (-1,), (-2, -1))


def preprocess(volume: np.ndarray, window: Sequence[int]):
    """``(image [1, D', H', W'] f32, (lower, upper) pad margins)``."""
    img = np.asarray(volume, np.float32)[None]
    chn = img[0]
    img[0] = (chn - chn.mean()) / chn.std()
    margin = [max(0, w - s) for w, s in zip(window, img.shape[1:])]
    lo = [m // 2 for m in margin]
    up = [m - a for m, a in zip(margin, lo)]
    if any(margin):
        img = np.pad(img, [(0, 0)] + list(zip(lo, up)), 'reflect')
    return img, (lo, up)


def grid(shape: Sequence[int], window: Sequence[int],
         stride: Sequence[int]) -> List[tuple]:
    win = [min(w, s) for w, s in zip(window, shape)]
    std = [min(t, w) for t, w in zip(stride, win)]
    starts = []
    for w in range(0, shape[2], std[2]):
        for h in range(0, shape[1], std[1]):
            for d in range(0, shape[0], std[0]):
                starts.append((min(d, shape[0] - win[0]),
                               min(h, shape[1] - win[1]),
                               min(w, shape[2] - win[2])))
    return starts, win


def _box(start, win):
    return (slice(None), slice(None)) + tuple(
        slice(s, s + w) for s, w in zip(start, win))


def window_logits(net, image: torch.Tensor, domain: int, window, stride,
                  chunk: int, generators_of=None) -> torch.Tensor:
    """TTA- and overlap-averaged logits ``[K, *img]`` f32 of ``image [1,
    C, *img]`` on its device. ``generators_of``: None (no dropout) or a
    list of one generator per forward, consumed in order: forwards carry
    ``chunk`` windows of the four variants, variant-major."""
    shape = tuple(image.shape[2:])
    starts, win = grid(shape, window, stride)
    variants = torch.cat([image.flip(ax) if ax else image for ax in FLIPS])
    acc = cnt = None
    for i in range(0, len(starts), chunk):
        sts = starts[i:i + chunk]
        patches = torch.stack([variants[_box(s, win)] for s in sts], 1)
        gens = None if generators_of is None else generators_of
        out = net(patches.flatten(0, 1), domain, generators=gens).float()
        out = out.reshape((len(FLIPS), len(sts)) + tuple(out.shape[1:]))
        if acc is None:
            acc = torch.zeros((len(FLIPS), out.shape[2]) + shape,
                              device=image.device)
            cnt = torch.zeros(shape, device=image.device)
        for j, s in enumerate(sts):
            acc[_box(s, win)] += out[:, j]
            cnt[_box(s, win)[2:]] += 1.0
    acc = acc / cnt
    un = [acc[v].flip(ax) if ax else acc[v] for v, ax in enumerate(FLIPS)]
    return sum(un) / len(FLIPS)


def crop(x: torch.Tensor, margins) -> torch.Tensor:
    """The pad's inverse on the last ``len(margins[0])`` axes of ``x``."""
    lo, up = margins
    return x[(Ellipsis,) + tuple(slice(a, s - b) for a, b, s in zip(
        lo, up, x.shape[-len(lo):]))]


def fpl_pass_logits(net, image: torch.Tensor, domain: int, window, stride,
                    chunk: int, seeds: Sequence[int]) -> torch.Tensor:
    """The passes' TTA- and overlap-averaged logits ``[P, K, *img]`` f32,
    pass m drawing its dropout masks from a generator seeded ``seeds[m]``
    on the device of ``image``."""
    out = []
    for s in seeds:
        gen = torch.Generator(device=image.device)
        gen.manual_seed(int(s))
        out.append(window_logits(net, image, domain, window, stride, chunk,
                                 [gen]))
    return torch.stack(out)


def fpl_reduce(logits: torch.Tensor, margins, dtype=torch.float32):
    """``(vars_sum, boundary, uncertainty)`` of the passes' logits ``[P, K,
    *img]``, inside the crop ``margins``, computed in ``dtype``."""
    p = crop(torch.softmax(logits.to(dtype), 1), margins)   # [P, K, *img]
    vars_sum = float(p.var(0, correction=0).sum())
    if p.shape[1] == 2:
        m = p[:, 1].mean(0)
        unc = -(m * torch.log(m + 1e-6))
    else:
        m = p.mean(0)
        unc = -torch.sum(m * torch.log(m + 1e-6), 0)
    boundary = int((unc > 0.01).sum())
    return vars_sum, boundary, 1.0 if boundary < 50 else vars_sum / boundary


def fpl_seeds(random_seed: int, volume_index: int, passes: int):
    return np.random.SeedSequence(
        [int(random_seed), int(volume_index)]).generate_state(passes)
