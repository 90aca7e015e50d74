"""Ranks of the port's data-parallel CPU tests.

    python tests/torch_ranks.py WORKDIR RANKS

reads ``WORKDIR/cases.pt`` (a list of case dicts), starts RANKS gloo
ranks on the CPU through ``fpl_plus_torch.parallel.multihost``, runs every
case over the ranks' mesh and has rank 0 write ``WORKDIR/results.pt``
(one result per case). ``run_case(case, None)`` runs a case in one
process, the reference the tests hold the ranks to. It imports
``fpl_plus_torch`` and nothing else of the repo.

Case kinds:

* a train step (``'joint'``, ``'alternating'``, ``'dual_consistency'``,
  ``'dis'``): ``net`` (a ``[network]`` dict), ``state`` (its state dict),
  ``train`` (the ``[training]`` dict), ``batches`` (per step, a tuple of
  per-domain dicts of numpy arrays holding the global batch; with
  ``accum``, per-domain lists of microbatches), ``seeds`` (the dropout
  generators' seeds of each step's forwards, or None) and ``fpl_uda``.
  Result: each step's metrics, the first step's gradients (summed over the
  ranks: the global gradient) and the final state dict;
* ``'infer'``: ``net``, ``state``, ``testing`` (a ``[testing]`` dict),
  ``volume`` ``[1, C, *img]``, ``volumes`` ``[N, C, *img]``, ``passes``
  and ``pass_seeds``. Result: ``run`` logits and labels, ``run_batch``
  labels, ``run_passes`` logits, the ``run_fpl_uncertainty`` pair and,
  over a mesh, ``sharded_sliding_window``'s output and counter.
"""
import os
import sys

import numpy as np
import torch

from fpl_plus_torch.engine.infer import Inferer, PassFold, window_grid
from fpl_plus_torch.engine.optim import create_lr_schedule, create_optimizer
from fpl_plus_torch.engine.train import (AlternatingTrainStep,
                                         DiscriminatorStep,
                                         DualConsistencyStep, JointTrainStep)
from fpl_plus_torch.losses import create_loss_calculator
from fpl_plus_torch.models.registry import create_network
from fpl_plus_torch.models.unet2d5_dsbn import Dis
from fpl_plus_torch.parallel import (make_mesh, make_sharded_train_step,
                                     replicate, shard_batch,
                                     sharded_sliding_window)
from fpl_plus_torch.parallel import multihost

STEP_KINDS = ('joint', 'alternating', 'dual_consistency', 'dis')


def _tensors(tree):
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree))
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensors(v) for v in tree)
    return tree


def _generators(seeds):
    """One list of one CPU generator per forward (None: no dropout)."""
    if seeds is None:
        return None
    return [[torch.Generator().manual_seed(int(s))] for s in seeds]


def _network(case):
    net = create_network(case['net'])
    net.load_state_dict(case['state'], strict=True)
    return net


def run_step_case(case, mesh):
    kind = case['kind']
    net = _network(case).train()
    cfg_t = case['train']
    opt = create_optimizer(cfg_t, net.parameters())
    per_it = {'alternating': 2, 'dual_consistency': 2}.get(kind, 1)
    sched = create_lr_schedule(dict(cfg_t, last_iter=-1), per_it)
    loss = create_loss_calculator({'training': cfg_t})
    common = dict(fpl_uda=case.get('fpl_uda', False))
    if kind in ('joint', 'dis'):
        step = JointTrainStep(net, loss, opt, sched, 2,
                              accum_steps=case.get('accum', 1), **common)
    elif kind == 'alternating':
        step = AlternatingTrainStep(net, loss, opt, sched, 2,
                                    entropy_coeff=1.0, **common)
    else:
        step = DualConsistencyStep(net, loss, opt, sched,
                                   entropy_coeff=1.0, **common)
    dis_step = None
    if kind == 'dis':
        torch.manual_seed(case.get('dis_seed', 7))
        dis = Dis(case['net']['class_num'])
        dis_step = DiscriminatorStep(net, dis, torch.optim.Adam(
            dis.parameters(), lr=1e-4, betas=(0.5, 0.999)))
    if mesh is not None:
        replicate(net, mesh)
        step = make_sharded_train_step(step, mesh)
        if dis_step is not None:
            replicate(dis_step.dis, mesh)
            dis_step = make_sharded_train_step(dis_step, mesh)
    metrics, grads = [], None
    for i, step_batches in enumerate(case['batches']):
        batches = _tensors(step_batches)
        if mesh is not None:
            batches = shard_batch(batches, mesh)
        seeds = case['seeds'][i] if case.get('seeds') else None
        gens = _generators(seeds)
        if gens is None:
            gens = [None] * (3 if kind == 'dual_consistency' else 2)
        if case.get('accum', 1) > 1:
            gens = [[None] * case['accum']] * 2
        extra = {'consis_gate': 1.0} if kind == 'dual_consistency' else {}
        m = step(batches, gens, **extra)
        if dis_step is not None:
            m.update(dis_step(batches))
        metrics.append({k: v.detach().clone() for k, v in m.items()})
        if i == 0:
            grads = {k: p.grad.detach().clone()
                     for k, p in net.named_parameters()}
    state = {k: v.detach().clone() for k, v in net.state_dict().items()}
    if dis_step is not None:
        state.update({'dis.' + k: v.detach().clone() for k, v in
                      (dis_step.step if mesh is not None else dis_step)
                      .dis.state_dict().items()})
    return {'metrics': metrics, 'grads': grads, 'state': state}


def run_infer_case(case, mesh):
    net = _network(case).eval()
    domain = case.get('domain', 1)

    def predict(x, dropout_generators=None):
        out = net(x, domain, dropout_generators)
        return out[0] if isinstance(out, (list, tuple)) else out

    out = {}
    with torch.no_grad():
        logits = Inferer(dict(case['testing'], output_mode='logits'), 'cpu',
                         mesh=mesh)
        labels = Inferer(dict(case['testing'], output_mode='label'), 'cpu',
                         mesh=mesh)
        out['run'] = logits.run(predict, case['volume'])
        out['run_label'] = labels.run(predict, case['volume'])
        out['run_batch'] = labels.run_batch(predict, case['volumes'])
        fold = PassFold(predict, case['pass_seeds'], 'cpu')
        out['passes'] = logits.run_passes(fold, case['volume'],
                                          case['passes'])
        out['fpl'] = labels.run_fpl_uncertainty(
            fold, case['volume'], case['passes'], case.get('margins'))
        if mesh is not None:   # the helper needs a mesh
            window = case['testing']['sliding_window_size']
            starts = window_grid(case['volume'].shape[2:], window,
                                 case['testing']['sliding_window_stride'])
            out['sliding_window'] = [t.numpy() for t in sharded_sliding_window(
                predict, window, mesh, chunk=2)(
                torch.from_numpy(case['volume']), starts)]
    return out


def run_case(case, mesh=None):
    """One case over ``mesh`` (None: in this process alone)."""
    if case['kind'] in STEP_KINDS:
        return run_step_case(case, mesh)
    if case['kind'] == 'infer':
        return run_infer_case(case, mesh)
    raise ValueError('unknown case kind {0!r}'.format(case['kind']))


def _rank(local_rank, workdir, ranks, coordinator):
    torch.set_num_threads(1)
    multihost.maybe_initialize_distributed({}, 'cpu', local_rank, ranks,
                                           coordinator)
    mesh = make_mesh(ranks, 'cpu')
    cases = torch.load(os.path.join(workdir, 'cases.pt'), weights_only=False)
    results = [run_case(case, mesh) for case in cases]
    if mesh.rank == 0:
        torch.save(results, os.path.join(workdir, 'results.pt'))
    multihost.finalize_distributed()


def main(argv):
    workdir, ranks = argv[0], int(argv[1])
    coordinator = 'localhost:{0}'.format(multihost.free_local_port())
    multihost.launch_local_ranks(_rank, (workdir, ranks, coordinator), ranks)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
