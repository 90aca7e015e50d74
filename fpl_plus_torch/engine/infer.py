"""Sliding-window inference with flip test-time augmentation, batched
volumes and folded MC-dropout passes.

Replaces the reference Inferer (PyMIC/pymic/net_run_dsbn/infer_func.py):
identical window-grid rule (clamped starts, :75-85), overlap averaging by an
exact coverage counter (:96-111) and flip-TTA over H/W (:195-222); and the
JAX package's batched serving (``run_batch``), pass folding
(``run_passes``) and on-device FPL uncertainty reduction
(``run_fpl_uncertainty``, ``engine/infer.py:515-544`` and ``:1114-1352``
there).

Design on the card: PyTorch runs eagerly, so the loop over window chunks is
plain Python around device work.

* N volumes (N same-shape volumes of a loader batch, or N copies of one
  volume for N folded passes) cross to the device once; their four flip
  variants (identity, flip-H, flip-W, flip-HW) stack into a leading N x V
  axis, volume-major, so every forward carries ``N x V x patch_chunk``
  windows and rows ``[i*V*chunk, (i+1)*V*chunk)`` belong to volume (pass)
  i. A group-folded predictor (the network called with one dropout
  generator per pass, ``models/common.py`` ``grouped_dropout``) relies on
  that order.
* Each chunk's windows are cut on the device, forwarded in one call and
  added into an f32 accumulator ``[N*V, K, *img]`` in grid order.
* The overlap counter is computed in closed form: the grid is the Cartesian
  product of per-dim start lists, so coverage is an outer product of per-dim
  1-D coverage vectors (duplicate clamped starts count, as in the
  reference).
* Division, un-flip averaging and the output head (logits, softmax or
  argmax) run on the device; only the result crosses back. The FPL pass
  crosses back two scalars.
* A predictor that returns a list (a multi-head network) gets every head
  accumulated on its own scaled grid (the JAX package's ``engine/infer.py``
  ``_sliding_window_jit``, reference infer_func.py:31-48,113-140): head i,
  whose window output is ``win_i``, has the full-volume shape
  ``floor(img * win_i / window)`` and window starts ``s * win_i // window``.
  Its overlap counter is its own exact coverage (``[testing]
  multiscale_counter = exact``, the default), or, with ``reference`` and
  more than one head, the reference's: the main head's full-resolution
  counter, nearest-resized to the head's shape and times the number of
  heads (``_overlap_divide`` there). The results are then lists, one entry
  per head; the FPL reduction reads the main head.

The JAX package's XLA compile devices (shape bucketing, unrolled vs scanned
accumulation, window placement) change no value --
bucketing is exact by construction, the rest are schedules -- so their
``[testing]`` keys are accepted and ignored; the last chunk of the grid may
simply be shorter than ``patch_chunk``.

Sharded over a mesh (``Inferer(..., mesh=)``, ``parallel/mesh.py``), as
the JAX package's mesh Inferer (``engine/infer.py:672-766`` and
``:1164-1300`` there); every rank gets the same result:

* ``run`` / ``run_logits``: the window grid splits into contiguous shares,
  one per rank (the first ``len % size`` ranks take one window more; the
  JAX package pads the grid with weight-0 windows instead); each rank
  accumulates its windows and one all-reduce per head sums the
  accumulators. The closed-form counter covers the whole grid and is not
  summed;
* ``run_batch``: the volume axis splits, padded to a multiple of the
  ranks by repeating the last volume; each rank runs its volumes through
  one batched sliding window and the per-volume logits are gathered, pads
  dropped;
* ``run_passes`` / ``run_fpl_uncertainty``: the pass axis splits the same
  way, padded by repeating the last pass's seed: the fold must be a
  ``PassFold``, which makes each rank's passes from their seeds. The
  per-pass logits are gathered before the reduction.

Asynchronous serving, as the JAX package's (``run_async``,
``run_batch_async``, ``run_passes_async``, a fetch-returning
``run_fpl_uncertainty`` and ``run_mc``; ``engine/infer.py:986-1369``
there): an entry dispatches everything and returns a ``fetch``; ``run``,
``run_batch`` and ``run_passes`` are ``*_async(...)()``. Between dispatch
and fetch nothing waits for the card: the volume crosses in from a pinned
buffer with ``non_blocking``, the counters are made on the device, the
FPL reduction stays there, and the result crosses out into pinned memory
behind a recorded event that only the fetch waits on. Under a mesh the
NCCL all-reduce and gathers are stream-ordered too, and every rank
dispatches in the same order; gloo's collectives block, so there the
dispatch waits (the result is the same).

Each dispatch (``run_async``, ``run_logits``, ``run_batch_async``,
``run_passes_async``, ``run_fpl_uncertainty``) runs inside the profiler
span ``infer_<entry>`` of its synchronous entry (``infer_run``,
``infer_run_logits``, ``infer_run_batch``, ``infer_run_passes``,
``infer_run_fpl_uncertainty``; ``utils/trace_metrics.py`` ``span``): one
span per dispatch, as JAX's trace has one program per call.

Layout: volumes are ``[N, C, *img]`` channels-first, flip axes H = -2,
W = -1.
"""
from __future__ import annotations

import functools
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from fpl_plus_torch.utils.precision import resolve_dtype
from fpl_plus_torch.utils.trace_metrics import traced


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


def _make_variants(vols: torch.Tensor, tta: bool) -> torch.Tensor:
    """[N, C, *img] -> [N*V, C, *img] of flip variants, volume-major (V=4
    with TTA else 1)."""
    if not tta:
        return vols
    return torch.stack([vols.flip(ax) if ax else vols for ax in _FLIPS],
                       1).flatten(0, 1)


def _unflip_mean(outputs: torch.Tensor, n: int, tta: bool) -> torch.Tensor:
    """[N*V, K, *img] -> TTA-averaged [N, K, *img] (un-flip each variant
    first)."""
    if not tta:
        return outputs
    g = outputs.reshape((n, len(_FLIPS)) + tuple(outputs.shape[1:]))
    un = [g[:, i].flip(ax) if ax else g[:, i] for i, ax in enumerate(_FLIPS)]
    return sum(un) / len(un)


def _coverage(dim_starts, window, head_window, out_shape,
              device) -> torch.Tensor:
    """Closed-form overlap counter ``[*out_shape]`` of a head whose window
    output is ``head_window`` (its starts scale by ``head_window /
    window``), made on ``device``: the outer product of per-dim coverage
    vectors, exactly the accumulated count of windows covering each
    voxel (small integers, exact in f32)."""
    c = None
    for d, starts in enumerate(dim_starts):
        cov = torch.zeros(out_shape[d], dtype=torch.float32, device=device)
        for s in starts:
            s0 = s * head_window[d] // window[d]
            cov[s0:s0 + head_window[d]] += 1.0
        c = cov if c is None else c[..., None] * cov
    return c


def _nearest_resize(c: torch.Tensor, out_shape) -> torch.Tensor:
    """Nearest-neighbour resize (source index ``floor(i * in / out)``, torch
    ``F.interpolate`` nearest) of a counter to ``out_shape``, on its
    device."""
    for d, (i, o) in enumerate(zip(c.shape, out_shape)):
        idx = torch.arange(o, device=c.device) * i // o
        c = c.index_select(d, idx)
    return c


def _box(start, size):
    """The ``[:, :, start:start+size]`` window index of ``[B, K, *img]``."""
    return (slice(None), slice(None)) + tuple(
        slice(s, s + w) for s, w in zip(start, size))


def _finalize(out: torch.Tensor, output_mode: str) -> torch.Tensor:
    """Device-side head on ``[N, K, *img]``: 'logits', 'prob' (softmax) or
    'label' (argmax, uint8 ``[N, *img]``)."""
    if output_mode == 'prob':
        return torch.softmax(out, 1)
    if output_mode == 'label':
        return torch.argmax(out, 1).to(torch.uint8)
    return out


def fpl_uncertainty_reduce(out: torch.Tensor, lo: Sequence[int],
                           up: Sequence[int]
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduce folded-pass logits ``[N, K, *img]`` to the FPL image-level
    uncertainty on their device, in f32 (reference agent_seg.py:921-929):

    - ``vars_sum``: the population variance over passes of the softmax
      probabilities, summed over classes and selected voxels;
    - ``boundary``: the count of selected voxels whose mean-probability
      entropy term exceeds 0.01 (K == 2: the class-1 term only; K > 2: the
      full entropy), both with ``log(mean + 1e-6)``.

    ``lo``/``up``: per-spatial-axis selection margins (the composed
    inverse-transform crop). Masking the per-voxel maps equals
    crop-then-reduce, since variance and entropy are per voxel. Returns
    two 0-d tensors on the logits' device (f32, int64); nothing waits for
    the device: a fetch reads them."""
    out = out.float()
    probs = torch.softmax(out, 1)                         # [N, K, *img]
    img = tuple(out.shape[2:])
    mask = torch.ones(img, dtype=torch.bool, device=out.device)
    for d, size in enumerate(img):
        idx = torch.arange(size, device=out.device)
        m = (idx >= int(lo[d])) & (idx < size - int(up[d]))
        mask &= m.reshape((-1,) + (1,) * (len(img) - 1 - d))
    vars_sum = torch.sum(probs.var(0, correction=0).sum(0) * mask.float())
    if out.shape[1] == 2:
        means = probs[:, 1].mean(0)                       # [*img]
        unc = -(means * torch.log(means + 1e-6))
    else:
        means = probs.mean(0)                             # [K, *img]
        unc = -torch.sum(means * torch.log(means + 1e-6), 0)
    boundary = torch.sum((unc > 0.01) & mask)
    return vars_sum, boundary


def _fetch_of(tensors: Sequence[torch.Tensor], form: Callable,
              staged: Sequence[torch.Tensor] = ()) -> Callable:
    """The zero-argument fetch of ``tensors`` (all on one device).

    On a card each tensor is copied into pinned host memory behind the
    work that makes it (``non_blocking``) and an event is recorded after
    the copies on the current stream; nothing waits here. The fetch waits
    on that event and returns ``form`` of the host arrays. ``staged``: the
    pinned buffers the dispatch's host-to-device copies read, held until
    the fetch has seen the event (which follows those copies in stream
    order). On the CPU the tensors are the result, so the fetch returns
    ``form`` of them at once."""
    if tensors[0].device.type == 'cpu':
        result = form([t.numpy() for t in tensors])
        return lambda: result
    stream = torch.cuda.current_stream(tensors[0].device)
    hosts = []
    for t in tensors:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        hosts.append(host)
    done = torch.cuda.Event()
    done.record(stream)

    def fetch():
        done.synchronize()
        return form([h.numpy() for h in hosts])
    fetch.staged = staged        # alive until the fetch is dropped
    return fetch


class PassFold:
    """``len(seeds)`` stochastic passes of ``predictor(x,
    dropout_generators=...)`` folded into one batch: pass i draws its masks
    from a ``torch.Generator`` on ``device`` seeded with ``seeds[i]``.
    ``take(passes)`` is the group predictor of those passes, with fresh
    generators, so a pass draws the same masks in any fold and on any
    rank."""

    def __init__(self, predictor: Callable, seeds: Sequence[int], device):
        self.predictor = predictor
        self.seeds = [int(s) for s in seeds]
        self.device = torch.device(device)

    def __len__(self):
        return len(self.seeds)

    def take(self, passes: Sequence[int]) -> Callable:
        gens = [torch.Generator(self.device).manual_seed(self.seeds[i])
                for i in passes]
        return functools.partial(self.predictor, dropout_generators=gens)


def _padded_share(n: int, mesh) -> List[int]:
    """This rank's items of ``n`` padded to a multiple of the ranks by
    repeating the last item: ``ceil(n / size)`` indices."""
    per = -(-n // mesh.size)
    return [min(i, n - 1) for i in range(mesh.rank * per,
                                         (mesh.rank + 1) * per)]


class Inferer:
    """``Inferer(testing_cfg, device).run(predictor, image)``.

    ``predictor(x)`` maps a patch batch ``[B, C, *win]`` (or the whole
    volume batch when sliding window is off) to logits ``[B, K, *win]``.
    ``image``: numpy ``[1, C, *img]``. ``run`` returns numpy
    ``[1, K, *img]`` f32 for 'logits'/'prob' and ``[1, *img]`` uint8 for
    'label'/'packed_label'; ``run_batch`` and ``run_passes`` return the
    same with a leading ``[N]``. A predictor that returns a list of heads
    gets a list of such results, one per head. ``mesh``: shard over its
    ranks (module docstring).

    Asynchronous serving, the JAX package's API (``engine/infer.py:986-
    1369`` there): ``run_async``, ``run_batch_async``, ``run_passes_async``
    and ``run_fpl_uncertainty`` dispatch all the device work, the copy of
    the volume in (staged in pinned memory, ``non_blocking``) and of the
    result out (into pinned memory, ``non_blocking``), and return a
    zero-argument ``fetch`` that waits for an event recorded after that
    copy and formats the result. Nothing on the way waits for the card, so
    a caller dispatches volume i+1 before it fetches volume i. ``run`` /
    ``run_batch`` / ``run_passes`` are ``*_async(...)()``. On the CPU the
    work is done when the call returns, and the fetch returns at once.
    """

    def __init__(self, config: dict, device, patch_chunk: int = 2,
                 mesh=None):
        self.config = config
        self.device = torch.device(device)
        self.mesh = mesh
        # windows per forward ([testing] patch_chunk); the forward batch is
        # N x 4 x patch_chunk with TTA over N volumes or passes
        self.patch_chunk = int(config.get('patch_chunk', patch_chunk))
        mode = config.get('output_mode', 'logits')
        if mode not in ('logits', 'prob', 'label', 'packed_label'):
            raise ValueError('Undefined output_mode {0}'.format(mode))
        # 'packed_label' bit-packs labels for a slow device link in the JAX
        # package; its result after fetch is the label map, which is what
        # crosses back here
        self.output_mode = 'label' if mode == 'packed_label' else mode
        # 'bfloat16' / 'float16': the volume is cast on the host (round to
        # nearest even; beyond f16's range, to +-inf, as numpy's astype in
        # the JAX package) and all patch activations follow; accumulators
        # stay f32
        self.compute_dtype = resolve_dtype(config.get('precision', 'float32'))
        self.counter_mode = config.get('multiscale_counter', 'exact')
        if self.counter_mode not in ('exact', 'reference'):
            raise ValueError('Undefined multiscale_counter {0}'.format(
                self.counter_mode))

    def _to_device(self, arr: np.ndarray, staged: list) -> torch.Tensor:
        """``arr`` on the device in the compute dtype. To a card: cast into
        a pinned buffer (appended to ``staged``, which the dispatch's fetch
        holds) and copied with ``non_blocking``, so the copy does not wait
        for the device."""
        t = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
        if self.device.type == 'cpu':
            return t if self.compute_dtype is None else t.to(
                self.compute_dtype)
        pinned = torch.empty(t.shape, dtype=self.compute_dtype or t.dtype,
                             pin_memory=True)
        pinned.copy_(t)
        staged.append(pinned)
        return pinned.to(self.device, non_blocking=True)

    def _tta(self) -> bool:
        tta_mode = self.config.get('tta_mode', 0)
        if tta_mode not in (0, 1):
            raise ValueError('Undefined tta_mode {0}'.format(tta_mode))
        return bool(tta_mode)

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

    def _windowed(self, img_shape) -> bool:
        """True when the sliding window runs: enabled, and the image is
        larger than one window in some axis."""
        use_sw, window, _ = self._resolve_sw(img_shape)
        return use_sw and not all(w >= s for w, s in zip(window, img_shape))

    @staticmethod
    def _forward(predictor: Callable, x: torch.Tensor) -> List[torch.Tensor]:
        """The predictor's heads as a list of f32 tensors."""
        out = predictor(x)
        heads = list(out) if isinstance(out, (tuple, list)) else [out]
        return [h.float() for h in heads]

    def _sliding_window(self, predictor, variants, window, stride,
                        shard: bool = True):
        """Overlap-averaged ``[N*V, K, *img_i]`` f32 per head over the
        clamped grid; with ``shard`` and a mesh, this rank's share of the
        windows, summed over the ranks."""
        img_shape = tuple(variants.shape[2:])
        starts = window_grid(img_shape, window, stride)
        shard = shard and self.mesh is not None
        mine, add = starts, True
        if shard:
            lo, hi = self.mesh.share(len(starts))
            # a rank without a window still forwards one (added nowhere)
            # to shape its accumulators for the all-reduce
            mine, add = (starts[lo:hi], True) if hi > lo else (starts[:1],
                                                               False)
        chunk = min(self.patch_chunk, len(mine))
        v = variants.shape[0]
        outs = wins = None
        for i in range(0, len(mine), chunk):
            sts = mine[i:i + chunk].tolist()
            patches = torch.stack([variants[_box(st, window)] for st in sts],
                                  1)
            preds = self._forward(predictor, patches.flatten(0, 1))
            if outs is None:
                wins = [tuple(p.shape[2:]) for p in preds]
                outs = [torch.zeros(
                    (v, p.shape[1]) + tuple(img_shape[d] * w[d] // window[d]
                                            for d in range(len(w))),
                    dtype=torch.float32, device=self.device)
                    for p, w in zip(preds, wins)]
            for out, pred, win in zip(outs, preds, wins):
                pred = pred.reshape((v, len(sts)) + pred.shape[1:])
                for j, st in enumerate(sts if add else ()):
                    s0 = [s * w // n for s, w, n in zip(st, win, window)]
                    out[_box(s0, win)] += pred[:, j]
        if shard:
            for out in outs:
                self.mesh.all_reduce(out)
        dim_starts = dim_start_lists(img_shape, window, stride)
        cnts = [_coverage(dim_starts, window, win, o.shape[2:], self.device)
                for win, o in zip(wins, outs)]
        if self.counter_mode == 'reference' and len(outs) > 1:
            cnts = [len(outs) * _nearest_resize(cnts[0], o.shape[2:])
                    for o in outs]
        return [o / torch.clamp_min(c, 1e-6) for o, c in zip(outs, cnts)]

    def _dev(self, predictor: Callable, images: np.ndarray, staged: list,
             copies: int = 1, shard_windows: bool = True
             ) -> List[torch.Tensor]:
        """Device logits ``[N, K, *img_i]`` f32 per head of ``images [N, C,
        *img]`` (``copies`` > 1: N = ``copies`` passes over one volume), TTA
        and overlap averaging done, before the output head; the windows
        sharded over the mesh unless ``shard_windows`` is False. The pinned
        buffer of the volume's copy goes into ``staged``."""
        tta = self._tta()
        img_shape = tuple(images.shape[2:])
        _, window, stride = self._resolve_sw(img_shape)
        windowed = self._windowed(img_shape)
        if not windowed:
            # whole-volume path: reflect-pad spatial dims to a multiple of
            # the network's total downsampling factor so odd sizes survive
            # the encoder/decoder; padded before the flip variants so
            # un-flipping stays aligned, cropped after (each head by its
            # own scale)
            mult = self.config.get('infer_autopad_multiple', 16)
            pads = [(-s) % mult for s in img_shape]
            if any(pads):
                images = np.pad(images, [(0, 0), (0, 0)]
                                + [(0, p) for p in pads], mode='reflect')
        vols = self._to_device(images, staged)
        if copies > 1:
            vols = vols.expand((copies,) + tuple(vols.shape[1:]))
        n = vols.shape[0]
        variants = _make_variants(vols, tta)
        if windowed:
            return [_unflip_mean(o, n, tta) for o in self._sliding_window(
                predictor, variants, window, stride, shard_windows)]
        padded = variants.shape[2:]
        return [_unflip_mean(o, n, tta)[(slice(None), slice(None)) + tuple(
            slice(0, int(s * (o.shape[2 + d] / padded[d])))
            for d, s in enumerate(img_shape))]
            for o in self._forward(predictor, variants)]

    @staticmethod
    def _one(heads: List):
        """A single head as itself, several as a list."""
        return heads[0] if len(heads) == 1 else heads

    def _fetch(self, heads: List[torch.Tensor], staged: list) -> Callable:
        """The output head on the device, then the fetch of the result."""
        return _fetch_of([_finalize(h, self.output_mode) for h in heads],
                         self._one, staged)

    def run(self, predictor: Callable, image):
        return self.run_async(predictor, image)()

    @traced('infer_run')
    @torch.inference_mode()
    def run_async(self, predictor: Callable, image) -> Callable:
        """Dispatch ``run`` and return its fetch (class docstring)."""
        staged = []
        return self._fetch(self._run_dev(predictor, image, staged), staged)

    @traced('infer_run_logits')
    @torch.inference_mode()
    def run_logits(self, predictor: Callable, image):
        """``run`` before the output head, kept on the device: the
        overlap- and TTA-averaged logits ``[1, K, *img]`` f32 (a list for a
        multi-head predictor; in-training validation computes its loss and
        dice there). The volume's pinned staging buffer is released at
        return: torch's caching host allocator keeps a block that a
        ``non_blocking`` copy read until that copy has run."""
        return self._one(self._run_dev(predictor, image, []))

    def _run_dev(self, predictor: Callable, image,
                 staged: list) -> List[torch.Tensor]:
        image = np.asarray(image)
        if image.shape[0] != 1:
            raise ValueError('inference processes one volume at a time')
        return self._dev(predictor, image, staged)

    def run_batch(self, predictor: Callable, images):
        return self.run_batch_async(predictor, images)()

    @traced('infer_run_batch')
    @torch.inference_mode()
    def run_batch_async(self, predictor: Callable, images) -> Callable:
        """Batched serving: N same-shape volumes ``[N, C, *img]`` through
        one sliding window whose forwards carry every volume's windows;
        returns the fetch of the ``[N, ...]`` result. Voxel-identical to N
        ``run`` calls up to the convolution library's choice of algorithm
        at the larger batch. Runs volume by volume (one fetch for all)
        when N is 1, the sliding window is off, or the volume fits in one
        window. On a mesh each rank runs its share of the volumes."""
        images = np.asarray(images)
        n = images.shape[0]
        if n == 0:
            raise ValueError('run_batch needs at least one volume')
        staged = []
        if n == 1 or not self._windowed(images.shape[2:]):
            per = [self._run_dev(predictor, images[i:i + 1], staged)
                   for i in range(n)]
            heads = [torch.cat(h, 0) for h in zip(*per)]
        elif self.mesh is None:
            heads = self._dev(predictor, images, staged)
        else:
            outs = self._dev(predictor, images[_padded_share(n, self.mesh)],
                             staged, shard_windows=False)
            heads = [self.mesh.gather_rows(o)[:n] for o in outs]
        return self._fetch(heads, staged)

    def _passes_dev(self, group_predictor, image, n_passes: int,
                    staged: list) -> List[torch.Tensor]:
        image = np.asarray(image)
        if image.shape[0] != 1:
            raise ValueError('run_passes folds passes over one volume')
        fold = isinstance(group_predictor, PassFold)
        if fold and len(group_predictor) != n_passes:
            raise ValueError('a PassFold of {0} passes run as {1}'.format(
                len(group_predictor), n_passes))
        if self.mesh is None:
            pred = (group_predictor.take(range(n_passes)) if fold
                    else group_predictor)
            return self._dev(pred, image, staged, copies=n_passes)
        if not fold:
            raise TypeError('passes sharded over a mesh need a PassFold: '
                            'each rank makes its passes from their seeds')
        mine = _padded_share(n_passes, self.mesh)
        outs = self._dev(group_predictor.take(mine), image, staged,
                         copies=len(mine), shard_windows=False)
        return [self.mesh.gather_rows(o)[:n_passes] for o in outs]

    def run_passes(self, group_predictor: Callable, image, n_passes: int):
        return self.run_passes_async(group_predictor, image, n_passes)()

    @traced('infer_run_passes')
    @torch.inference_mode()
    def run_passes_async(self, group_predictor: Callable, image,
                         n_passes: int) -> Callable:
        """Fold ``n_passes`` stochastic passes over one volume into one
        batched inference; returns the fetch of the ``[n_passes, ...]``
        result. ``group_predictor`` treats its patch batch as ``n_passes``
        contiguous groups, group i under pass i's randomness (the network
        given ``n_passes`` ``dropout_generators``), or is a ``PassFold`` of
        ``n_passes`` seeds (required on a mesh). Row i of the result is
        pass i's full inference (TTA, sliding window, overlap averaging):
        the same as ``run`` with pass i's predictor."""
        staged = []
        return self._fetch(self._passes_dev(group_predictor, image,
                                            n_passes, staged), staged)

    @traced('infer_run_fpl_uncertainty')
    @torch.inference_mode()
    def run_fpl_uncertainty(self, group_predictor: Callable, image,
                            n_passes: int, margins=None) -> Callable:
        """A zero-argument fetch of the FPL image-level uncertainty
        ``(vars_sum, boundary)`` of ``n_passes`` folded passes, reduced on
        the device (``fpl_uncertainty_reduce``), as the JAX package's
        ``run_fpl_uncertainty`` returns one (``engine/infer.py:1305-1352``
        there): only the two scalars cross back. ``margins``: optional
        ``(margin_lower, margin_upper)`` per spatial axis, the composed
        crop of the test chain's inverse transforms. The agent applies the
        ``1 if boundary < 50 else vars_sum / boundary`` rule."""
        staged = []
        out = self._passes_dev(group_predictor, image, n_passes, staged)[0]
        dim = out.dim() - 2
        lo, up = margins if margins is not None else ([0] * dim, [0] * dim)
        return _fetch_of(fpl_uncertainty_reduce(out, lo, up),
                         lambda pair: (float(pair[0]), int(pair[1])), staged)

    def run_mc(self, predictor_factory: Callable, image,
               seeds: Sequence[int]) -> List:
        """MC-dropout passes, unfused: one full inference (TTA, sliding
        window) per seed with ``predictor_factory(seed)``'s predictor, all
        dispatched before the first fetch, so the card runs them back to
        back (the JAX package's ``run_mc``, ``engine/infer.py:1354-1369``
        there). Returns one ``run`` result per seed. The folded pass
        (``run_passes`` of a ``PassFold``) is the production path; this is
        its oracle: with ``predictor_factory(s) = PassFold(net, [s],
        device).take([0])`` result i is row i of ``run_passes`` on
        ``PassFold(net, seeds, device)``."""
        fetches = [self.run_async(predictor_factory(s), image)
                   for s in seeds]
        return [fetch() for fetch in fetches]
