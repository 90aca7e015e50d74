"""Plain reference of the generator's joint training: the train batches
drawn again from their seeds, the joint dice loss, its gradient and
Adam's update.

* Batches (the published loader's rules, PyMIC/pymic/net_run_dsbn/
  agent_abstract.py and the transforms of ``vs_t1s_g.cfg``): domain d's
  stream is seeded ``random_seed + d + 1``; epoch e visits the manifest in
  the order of ``RandomState(seed + e).shuffle``; item n of the stream is
  produced after ``random.seed(seed + n)``, through the z-score, a reflect
  pad up to the crop, a random crop (per axis ``randint(0, margin)``; with
  the foreground focus and ``random() < ratio``, ``randint(bb_min,
  bb_max) - size // 2`` clamped into the volume, ``bb`` the bounding box
  of the ``mask_label`` classes, max exclusive), a random flip (width if
  ``random() > 0.5``, then height) and the one-hot label.
* The joint step: each domain's batch through its own DSBN bank in train
  mode with its dropout generator (iteration ``it``, domain d seeded
  ``SeedSequence([random_seed, it, d]).generate_state(1)[0]``); the loss
  ``1 - mean_c dice_c`` of the softmax, dice ``(2 sum(p y) + 1e-5) /
  (sum(p) + sum(y) + 1e-5)`` per class over the batch's voxels; the joint
  loss the mean over domains; one backward.
* Adam (betas 0.9, 0.999, eps 1e-8, L2 weight decay added to the
  gradient), every parameter stepped on every update.
"""
from __future__ import annotations

import random
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference.unet2d5_dsbn import Net


def _bbox(mask: np.ndarray):
    nz = np.nonzero(mask)
    return ([int(ix.min()) for ix in nz],
            [int(ix.max()) + 1 for ix in nz])


def train_item(image: np.ndarray, label: np.ndarray, item_seed: int,
               crop: dict, flip: dict, class_num: int):
    """One item of a train stream: ``(image [1, *crop], one-hot label [K,
    *crop])`` from the decoded ``image`` and ``label`` ``[D, H, W]``."""
    rng = random.Random(int(item_seed))
    img = np.asarray(image, np.float32)[None]
    img[0] = (img[0] - img[0].mean()) / img[0].std()
    lab = np.asarray(label, np.int32)[None]
    size = list(crop['output_size'])
    margin = [max(0, o - s) for o, s in zip(size, img.shape[1:])]
    if any(margin):
        pad = [(0, 0)] + [(m // 2, m - m // 2) for m in margin]
        img, lab = np.pad(img, pad, 'reflect'), np.pad(lab, pad, 'reflect')
    shape = img.shape[1:]
    room = [s - o for s, o in zip(shape, size)]
    lo = [0 if m == 0 else rng.randint(0, m) for m in room]
    if crop.get('foreground_focus', False) and \
            rng.random() < crop.get('foreground_ratio', 0.5):
        mask = np.zeros_like(lab)
        for c in crop.get('mask_label', [1]):
            mask = np.maximum(mask, lab == c)
        if mask.sum() == 0:
            bb_min, bb_max = [0] * lab.ndim, list(mask.shape)
        else:
            bb_min, bb_max = _bbox(mask)
        lo = [rng.randint(bb_min[i + 1], bb_max[i + 1]) - size[i] // 2
              for i in range(3)]
        lo = [min(max(0, v), shape[i] - size[i]) for i, v in enumerate(lo)]
    box = (slice(None),) + tuple(slice(a, a + s) for a, s in zip(lo, size))
    img, lab = img[box], lab[box]
    axes = []
    if flip.get('flip_width', False) and rng.random() > 0.5:
        axes.append(-1)
    if flip.get('flip_height', False) and rng.random() > 0.5:
        axes.append(-2)
    if flip.get('flip_depth', False) and rng.random() > 0.5:
        axes.append(-3)
    if axes:
        img, lab = np.flip(img, axes), np.flip(lab, axes)
    onehot = (np.arange(class_num)[:, None, None, None] == lab[0][None])
    return np.ascontiguousarray(img), onehot.astype(np.float32)


def stream_items(n_rows: int, loader_seed: int, count: int):
    """``(row, item seed)`` of the first ``count`` items of a shuffled
    stream over ``n_rows`` manifest rows."""
    out, epoch, order = [], -1, None
    for n in range(count):
        if n // n_rows != epoch:
            epoch = n // n_rows
            order = np.arange(n_rows)
            np.random.RandomState(loader_seed + epoch).shuffle(order)
        out.append((int(order[n % n_rows]), loader_seed + n))
    return out


def dice_loss(logits: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    k = logits.shape[1]
    p = torch.softmax(logits, 1).movedim(1, -1).reshape(-1, k)
    y = onehot.movedim(1, -1).reshape(-1, k)
    dice = (2.0 * (p * y).sum(0) + 1e-5) / (p.sum(0) + y.sum(0) + 1e-5)
    return 1.0 - dice.mean()


def joint_steps(net_cfg: dict, weights: Dict[str, torch.Tensor],
                batches: List[List[tuple]], generator_seeds, lr: float,
                weight_decay: float, device) -> dict:
    """Run ``len(batches)`` joint steps from ``weights`` (left untouched).
    ``batches[it][d]``: ``(image [N, 1, *crop], onehot [N, K, *crop])``
    numpy arrays; ``generator_seeds[it][d]`` the dropout seed. Returns the
    losses, the first step's gradient per leaf (as Adam receives it,
    weight decay included) and the parameters after the last step."""
    params = {k: v.detach().clone().float().requires_grad_(True)
              for k, v in weights.items() if v.dtype == torch.float32
              and not k.endswith(('running_mean', 'running_var'))}
    state = {k: (torch.zeros_like(v), torch.zeros_like(v))
             for k, v in params.items()}
    buffers = {k: v for k, v in weights.items() if k not in params}
    beta1, beta2, eps = 0.9, 0.999, 1e-8
    losses, first_grad = [], None
    for it, per_domain in enumerate(batches):
        net = Net(net_cfg, dict(buffers, **params))
        total = 0.0
        for d, (image, onehot) in enumerate(per_domain):
            gen = torch.Generator(device=device)
            gen.manual_seed(int(generator_seeds[it][d]))
            x = torch.from_numpy(image).to(device)
            y = torch.from_numpy(onehot).to(device)
            total = total + dice_loss(net(x, d, True, [gen]), y)
        loss = total / len(per_domain)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        losses.append(float(loss.detach()))
        t = it + 1
        with torch.no_grad():
            step_grads = {}
            for (k, p), g in zip(params.items(), grads):
                g = torch.zeros_like(p) if g is None else g
                g = g + weight_decay * p
                step_grads[k] = g
                m, v = state[k]
                m.mul_(beta1).add_(g, alpha=1 - beta1)
                v.mul_(beta2).addcmul_(g, g, value=1 - beta2)
                denom = (v.sqrt() / (1 - beta2 ** t) ** 0.5).add_(eps)
                p.addcdiv_(m, denom, value=-lr / (1 - beta1 ** t))
            if first_grad is None:
                first_grad = {k: g.cpu() for k, g in step_grads.items()}
    return {'losses': losses, 'first_grad': first_grad,
            'params': {k: p.detach().cpu() for k, p in params.items()}}
