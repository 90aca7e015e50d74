"""The comparisons that decide ``correct``: the program's outputs from the
window against the plain reference, run after the window has closed and
the program's state is freed.

Each number is printed with its limit; ``correct`` holds when every
number is at or under its limit and no output is missing. The test
stage's comparisons build the network from the reference module of the
run's configuration (``run.reference``); the training comparison follows
``reference/train.py``, whose joint dual-domain DSBN step covers one
network alone (``check_trainable``).
"""
from __future__ import annotations

import contextlib
import inspect
import os
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import nifti
from benchmark.reference import serve, train


@contextlib.contextmanager
def strict_f32():
    """Float32 convolutions and matrix products without TF32."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


DTYPES = {'bfloat16': torch.bfloat16}


def sample_rows(rng: np.random.Generator, n: int, k: int) -> List[int]:
    """``k`` of the window's ``n`` rows: the last one finished and a seeded
    draw of the others."""
    k = min(k, n)
    rest = rng.choice(n - 1, size=k - 1, replace=False) if k > 1 else []
    return sorted(set(int(i) for i in rest) | {n - 1})


def label_gap(run, rows: List[int], captured) -> Dict[str, float]:
    """Pseudo-labels, for each sampled row: (1) the saved label file read
    back against its source's shape and placing header, and against the
    argmax of the logits the window computed for it (copied out behind
    the work, before the argmax on the card): ``saved_mismatch`` counts
    the rows where any of these differs; (2) at every voxel, the gap
    between the class-1 margin (logit 1 less logit 0) of those logits and
    of the reference's, the widest over the voxels over the root mean
    square of the reference's margin: ``margin_gap_rel``, the largest
    over the rows (the widest gap itself is noted as
    ``logit_margin_gap``). The margin and not the label is compared
    because a trained-like head (section 4 of PERF.md) labels most voxels
    far from a tie, so labels at a lower precision often come out equal
    to the reference's; it is taken relative to its own scale because
    the seeded weights set that scale, and with it every rounding error,
    some threefold from seed to seed."""
    t = run.sections['testing']
    net = run.reference.Net(run.net_cfg, run.weights)
    widest, widest_rel, mismatch = 0.0, 0.0, 0
    for i in rows:
        row = run.rows[i]
        source, geometry = nifti.read(run.ws.path(run.ws.sources[row]))
        image, margins = serve.preprocess(source, t['sliding_window_size'])
        x = torch.from_numpy(image[None]).to(run.device)
        with strict_f32(), torch.no_grad():
            want = serve.crop(serve.window_logits(
                net, x, t['domian_label'], t['sliding_window_size'],
                t['sliding_window_stride'], t.get('patch_chunk', 2)),
                margins)
        got = serve.crop(captured[i].to(run.device), margins)
        try:
            saved, saved_geometry = nifti.read(run.output_path(row))
        except (OSError, ValueError):
            saved = saved_geometry = None
        if saved is None or saved.shape != source.shape \
                or saved_geometry != geometry or not torch.equal(
                    torch.from_numpy(saved.astype(np.int64)).to(run.device),
                    got.argmax(0)):
            mismatch += 1
        margin = want[1] - want[0]
        gap = float(((got[1] - got[0]) - margin).abs().max())
        widest = max(widest, gap)
        widest_rel = max(widest_rel,
                         gap / float(margin.pow(2).mean().sqrt()))
    run.notes['logit_margin_gap'] = widest
    return {'margin_gap_rel': widest_rel, 'saved_mismatch': float(mismatch)}


def fpl_gap(run, rows: List[int], saved: Dict[str, float], captured,
            dtype=None) -> Dict[str, float]:
    """FPL pass: for each sampled row, (1) at every pass and voxel the gap
    by which the reference's logit of the class the program's pass put
    first lies below the reference's best (the program's per-pass logits
    as the window computed them, copied out for the sampled rows), the
    widest over passes, voxels and rows; (2) the relative gap between the
    saved uncertainty and the reference's reduction of those same logits,
    the widest over the rows. With ``dtype`` (the control), the reference
    computed in ``dtype`` throughout, forward and reduction, stands in the
    program's place."""
    t = run.sections['testing']
    Net = run.reference.Net
    net = Net(run.net_cfg, run.weights)
    low = None
    if dtype is not None:
        low = Net(run.net_cfg, {k: v.to(dtype) if v.is_floating_point()
                                else v for k, v in run.weights.items()})
    logit_gap = reduce_gap = 0.0
    args = (t['domian_label'], t['sliding_window_size'],
            t['sliding_window_stride'], t.get('patch_chunk', 2))
    for i in rows:
        row = run.rows[i]
        source, _ = nifti.read(run.ws.path(run.ws.sources[row]))
        image, margins = serve.preprocess(source, t['sliding_window_size'])
        x = torch.from_numpy(image[None]).to(run.device)
        seeds = serve.fpl_seeds(run.random_seed, i, run.fpl_passes)
        with strict_f32(), torch.no_grad():
            ref = serve.fpl_pass_logits(net, x, *args, seeds)
            if low is None:
                if row not in saved:
                    return {'fpl_logit_gap': float('inf'),
                            'fpl_reduce_gap': float('inf')}
                got = captured[i].to(run.device)
                got_u = saved[row]
            else:
                got = serve.fpl_pass_logits(low, x.to(dtype), *args, seeds)
                got_u = serve.fpl_reduce(got, margins, dtype)[2]
            label = got.argmax(1, keepdim=True)
            gap = ref.max(1).values - ref.gather(1, label)[:, 0]
            logit_gap = max(logit_gap, float(serve.crop(gap, margins).max()))
            want_u = serve.fpl_reduce(got.float(), margins)[2]
        reduce_gap = max(reduce_gap, abs(got_u - want_u) / abs(want_u))
    return {'fpl_logit_gap': logit_gap, 'fpl_reduce_gap': reduce_gap}


def _leaf_gaps(got: Dict[str, float], want: Dict[str, float],
               keep: List[str]):
    """``(worst gap, its leaf)``: each leaf's gap between the two norms
    over the larger of the reference's norm of that leaf and of the
    median leaf."""
    med = float(np.median([want[k] for k in keep]))
    gaps = {k: abs(got[k] - want[k]) / max(want[k], med) for k in keep}
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def check_trainable(reference) -> None:
    """Raise unless ``reference`` is the network module that
    ``reference/train.py`` steps: a training cell is judged against that
    step alone."""
    own = inspect.getfile(train.Net)
    if not os.path.samefile(reference.__file__, own):
        raise ValueError(
            'a train traffic needs the network that the training reference '
            'steps: benchmark/reference/train.py (the joint dual-domain DSBN '
            'step) steps {0} alone, and this configuration\'s reference is '
            '{1}'.format(os.path.basename(own), reference.__file__))


def train_gap(run) -> Dict[str, float]:
    """Generator training: the first steps' losses, the first gradient
    per leaf as Adam received it and each leaf's change over the steps,
    against the reference from the same weights and batches. Leaves whose
    reference gradient is under a thousandth of the median leaf's (the
    biases of the convolutions that batch norm follows, moved by round-off
    alone) are left out of the two norms."""
    cfg_d, cfg_t = run.sections['dataset'], run.sections['training']
    n = len(run.program['losses'])
    batches = []
    streams = [train.stream_items(len(run.train_rows[d]),
                                  run.random_seed + d + 1,
                                  n * cfg_d['train_batch_size'])
               for d in range(2)]
    crop = {k[len('RandomCrop_'):]: v for k, v in cfg_d.items()
            if k.startswith('RandomCrop_')}
    flip = {k[len('RandomFlip_'):]: v for k, v in cfg_d.items()
            if k.startswith('RandomFlip_')}
    decoded = {}
    for it in range(n):
        per_domain = []
        for d in range(2):
            items = streams[d][it * cfg_d['train_batch_size']:
                               (it + 1) * cfg_d['train_batch_size']]
            imgs, labs = [], []
            for row, item_seed in items:
                img_name, lab_name = run.train_rows[d][row]
                if img_name not in decoded:
                    decoded[img_name] = (nifti.read(run.ws.path(img_name))[0],
                                         nifti.read(run.ws.path(lab_name))[0])
                img, onehot = train.train_item(
                    *decoded[img_name], item_seed, crop, flip,
                    run.net_cfg['class_num'])
                imgs.append(img)
                labs.append(onehot)
            per_domain.append((np.stack(imgs), np.stack(labs)))
        batches.append(per_domain)
    gen_seeds = [[int(np.random.SeedSequence([run.random_seed, it, d])
                      .generate_state(1)[0]) for d in range(2)]
                 for it in range(n)]
    with strict_f32():
        ref = train.joint_steps(run.net_cfg, run.weights, batches, gen_seeds,
                                cfg_t['learning_rate'],
                                cfg_t.get('weight_decay', 0.0) or 0.0,
                                run.device)
    prog = run.program
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog['losses'], ref['losses']))
    theta0 = {k: v.detach().cpu() for k, v in run.weights.items()}
    g_ref = {k: float(v.norm()) for k, v in ref['first_grad'].items()}
    med = float(np.median(list(g_ref.values())))
    keep = sorted(k for k, v in g_ref.items() if v >= 1e-3 * med)
    g_prog = {k: float(prog['first_grad'][k].norm()) for k in keep}
    d_ref = {k: float((ref['params'][k] - theta0[k]).norm()) for k in keep}
    d_prog = {k: float((prog['params'][k] - theta0[k]).norm()) for k in keep}
    grad_gap, grad_leaf = _leaf_gaps(g_prog, g_ref, keep)
    update_gap, update_leaf = _leaf_gaps(d_prog, d_ref, keep)
    # the first gradient's gap is read and shown, not compared: neither
    # the control nor a fault reads it high enough above sound runs to
    # hold a limit (PERF.md, section 6)
    run.notes.update(grad_norm_gap=grad_gap, grad_worst_leaf=grad_leaf,
                     update_worst_leaf=update_leaf,
                     leaves_compared=len(keep))
    return {'loss_rel_gap': loss_gap, 'update_norm_gap': update_gap}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """``(correct, checks)``: each number beside its limit."""
    checks = {k: {'value': float(v), 'limit': float(limits[k])}
              for k, v in numbers.items()}
    ok = all(np.isfinite(c['value']) and c['value'] <= c['limit']
             for c in checks.values())
    return ok, checks
