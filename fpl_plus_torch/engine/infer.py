"""Sliding-window inference with flip test-time augmentation.

Replaces the reference Inferer (PyMIC/pymic/net_run_dsbn/infer_func.py):
identical window-grid rule (clamped starts, :75-85), overlap averaging by an
exact coverage counter (:96-111) and flip-TTA over H/W (:195-222).

Design on the card: PyTorch runs eagerly, so the loop over window chunks is
plain Python around device work.

* The volume crosses to the device once; the four flip variants (identity,
  flip-H, flip-W, flip-HW) are stacked into a leading V axis, so every
  forward carries ``V x patch_chunk`` windows.
* Each chunk's windows are cut on the device, forwarded in one call and
  added into an f32 accumulator ``[V, K, *img]`` in grid order.
* The overlap counter is computed in closed form: the grid is the Cartesian
  product of per-dim start lists, so coverage is an outer product of per-dim
  1-D coverage vectors (duplicate clamped starts count, as in the
  reference).
* Division, un-flip averaging and the output head (logits, softmax or
  argmax) run on the device; only the result crosses back.

Single-head networks only. The JAX package's XLA compile devices (shape
bucketing, unrolled vs scanned accumulation, window placement, the device
mesh) change no value — bucketing is exact by construction, the rest are
schedules — so their ``[testing]`` keys are accepted and ignored; the last
chunk of the grid may simply be shorter than ``patch_chunk``.

Layout: volumes are ``[C, *img]`` channels-first, flip axes H = -2, W = -1.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from fpl_plus_torch.utils.precision import resolve_dtype


def window_grid(img_shape: Sequence[int], window: Sequence[int],
                stride: Sequence[int]) -> np.ndarray:
    """Clamped crop-start grid, identical ordering to the reference
    (infer_func.py:75-85: W outermost, then H, then D)."""
    dim = len(img_shape)
    starts = []
    if dim == 3:
        ds, hs, ws = img_shape
        for w in range(0, ws, stride[2]):
            w_min = min(w, ws - window[2])
            for h in range(0, hs, stride[1]):
                h_min = min(h, hs - window[1])
                for d in range(0, ds, stride[0]):
                    d_min = min(d, ds - window[0])
                    starts.append([d_min, h_min, w_min])
    elif dim == 2:
        hs, ws = img_shape
        for w in range(0, ws, stride[1]):
            w_min = min(w, ws - window[1])
            for h in range(0, hs, stride[0]):
                h_min = min(h, hs - window[0])
                starts.append([h_min, w_min])
    else:
        raise ValueError('sliding window supports 2D/3D only')
    return np.asarray(starts, np.int64)


def dim_start_lists(img_shape: Sequence[int], window: Sequence[int],
                    stride: Sequence[int]) -> Tuple[Tuple[int, ...], ...]:
    """Per-dim clamped start lists whose Cartesian product is
    ``window_grid`` (duplicates from aggressive clamping kept — the
    reference counts them)."""
    return tuple(
        tuple(min(p, img_shape[d] - window[d])
              for p in range(0, img_shape[d], stride[d]))
        for d in range(len(img_shape)))


_FLIPS = ((), (-2,), (-1,), (-2, -1))   # identity, flip-H, flip-W, flip-HW


def _make_variants(volume: torch.Tensor, tta: bool) -> torch.Tensor:
    """[C, *img] -> [V, C, *img] of flip variants (V=4 with TTA else 1)."""
    if not tta:
        return volume[None]
    return torch.stack([volume.flip(ax) if ax else volume for ax in _FLIPS])


def _unflip_mean(outputs: torch.Tensor, tta: bool) -> torch.Tensor:
    """[V, K, *img] -> TTA-averaged [K, *img] (un-flip each variant
    first)."""
    if not tta:
        return outputs[0]
    un = [outputs[i].flip(ax) if ax else outputs[i]
          for i, ax in enumerate(_FLIPS)]
    return sum(un) / len(un)


def _coverage(dim_starts, window, img_shape) -> torch.Tensor:
    """Closed-form overlap counter ``[*img]``: the outer product of per-dim
    coverage vectors, exactly the accumulated count of windows covering
    each voxel."""
    vecs = []
    for d, starts in enumerate(dim_starts):
        cov = np.zeros(img_shape[d], np.float32)
        for s in starts:
            cov[s:s + window[d]] += 1.0
        vecs.append(cov)
    c = vecs[0]
    for v in vecs[1:]:
        c = c[..., None] * v
    return torch.from_numpy(c)


def _finalize(out: torch.Tensor, output_mode: str) -> torch.Tensor:
    """Device-side head on ``[K, *img]``: 'logits', 'prob' (softmax) or
    'label' (argmax, uint8)."""
    if output_mode == 'prob':
        return torch.softmax(out, 0)
    if output_mode == 'label':
        return torch.argmax(out, 0).to(torch.uint8)
    return out


class Inferer:
    """``Inferer(testing_cfg, device).run(predictor, image)``.

    ``predictor(x)`` maps a patch batch ``[B, C, *win]`` (or the whole
    volume batch when sliding window is off) to logits ``[B, K, *win]``.
    ``image``: numpy ``[1, C, *img]``. ``run`` returns numpy
    ``[1, K, *img]`` f32 for 'logits'/'prob' and ``[1, *img]`` uint8 for
    'label'/'packed_label'.
    """

    def __init__(self, config: dict, device, patch_chunk: int = 2):
        self.config = config
        self.device = torch.device(device)
        # windows per forward ([testing] patch_chunk); the forward batch is
        # 4 x patch_chunk with TTA
        self.patch_chunk = int(config.get('patch_chunk', patch_chunk))
        mode = config.get('output_mode', 'logits')
        if mode not in ('logits', 'prob', 'label', 'packed_label'):
            raise ValueError('Undefined output_mode {0}'.format(mode))
        # 'packed_label' bit-packs labels for a slow device link in the JAX
        # package; its result after fetch is the label map, which is what
        # crosses back here
        self.output_mode = 'label' if mode == 'packed_label' else mode
        # 'bfloat16': the volume is cast on the host (round to nearest
        # even) and all patch activations follow; accumulators stay f32
        self.compute_dtype = resolve_dtype(config.get('precision', 'float32'))

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
        if self.compute_dtype is not None:
            t = t.to(self.compute_dtype)
        return t.to(self.device)

    def _resolve_sw(self, img_shape):
        """(use_sw, window, stride) with the reference clamps: window caps
        at the image, stride caps at the window."""
        dim = len(img_shape)
        use_sw = self.config.get('sliding_window_enable', False)
        window = list(self.config.get('sliding_window_size')
                      or [None] * dim)
        stride = list(self.config.get('sliding_window_stride')
                      or [None] * dim)
        for d in range(dim):
            if window[d] is None or window[d] > img_shape[d]:
                window[d] = img_shape[d]
            if stride[d] is None or stride[d] > window[d]:
                stride[d] = window[d]
        return use_sw, window, stride

    @staticmethod
    def _forward(predictor: Callable, x: torch.Tensor) -> torch.Tensor:
        out = predictor(x)
        if isinstance(out, (tuple, list)):
            raise NotImplementedError(
                'multi-head networks are not yet ported to the Inferer')
        return out.float()

    def _sliding_window(self, predictor, variants, window, stride):
        """Overlap-averaged ``[V, K, *img]`` f32 over the clamped grid."""
        img_shape = tuple(variants.shape[2:])
        starts = window_grid(img_shape, window, stride)
        chunk = min(self.patch_chunk, len(starts))
        v = variants.shape[0]
        lead = (slice(None), slice(None))
        out = None
        for i in range(0, len(starts), chunk):
            boxes = [lead + tuple(slice(s, s + w) for s, w in zip(st, window))
                     for st in starts[i:i + chunk].tolist()]
            patches = torch.stack([variants[b] for b in boxes], 1)
            pred = self._forward(predictor, patches.flatten(0, 1))
            if tuple(pred.shape[2:]) != tuple(window):
                raise NotImplementedError(
                    'heads at another scale than the window are not yet '
                    'ported')
            pred = pred.reshape((v, len(boxes)) + pred.shape[1:])
            if out is None:
                out = torch.zeros((v, pred.shape[2]) + img_shape,
                                  dtype=torch.float32, device=self.device)
            for j, b in enumerate(boxes):
                out[b] += pred[:, j]
        cnt = _coverage(dim_start_lists(img_shape, window, stride), window,
                        img_shape).to(self.device)
        return out / torch.clamp_min(cnt, 1e-6)

    @torch.inference_mode()
    def run(self, predictor: Callable, image) -> np.ndarray:
        tta_mode = self.config.get('tta_mode', 0)
        if tta_mode not in (0, 1):
            raise ValueError('Undefined tta_mode {0}'.format(tta_mode))
        tta = bool(tta_mode)

        image = np.asarray(image)
        if image.shape[0] != 1:
            raise ValueError('inference processes one volume at a time')
        vol = image[0]
        img_shape = vol.shape[1:]
        dim = len(img_shape)
        use_sw, window, stride = self._resolve_sw(img_shape)

        if not use_sw or all(window[d] >= img_shape[d] for d in range(dim)):
            # whole-volume path: reflect-pad spatial dims to a multiple of
            # the network's total downsampling factor so odd sizes survive
            # the encoder/decoder; padded before the flip variants so
            # un-flipping stays aligned, cropped after
            mult = self.config.get('infer_autopad_multiple', 16)
            pads = [(-s) % mult for s in img_shape]
            if any(pads):
                vol = np.pad(vol, [(0, 0)] + [(0, p) for p in pads],
                             mode='reflect')
            out = self._forward(predictor,
                                _make_variants(self._to_device(vol), tta))
            out = _unflip_mean(out, tta)[
                (slice(None),) + tuple(slice(0, s) for s in img_shape)]
        else:
            variants = _make_variants(self._to_device(vol), tta)
            out = _unflip_mean(
                self._sliding_window(predictor, variants, window, stride),
                tta)
        return _finalize(out, self.output_mode).cpu().numpy()[None]
