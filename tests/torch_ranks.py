"""Ranks of the port's data-parallel CPU tests.

    python tests/torch_ranks.py WORKDIR RANKS

reads ``WORKDIR/cases.pt`` (a list of case dicts), starts RANKS gloo
ranks on the CPU through ``fpl_plus_torch.parallel.multihost``, runs every
case over the ranks' mesh and has rank 0 write ``WORKDIR/results.pt``
(one result per case), rank r > 0 ``WORKDIR/results.rank{r}.pt``. ``run_case(case, None)`` runs a case in one
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
  over a mesh, ``sharded_sliding_window``'s output and counter;
* ``'paradigm'``: an SSL, WSL or NLL method's step (``paradigm`` 'ssl',
  'wsl' or 'nll', ``method``, ``config`` its sections, ``state`` the
  state dict of its network, ``peers`` 1, 2 or 3 networks), ``batches``
  (per step, the method's batch structure of numpy arrays holding the
  global batch; USTM's rotation rides as the tuple's last entry), ``its``
  (each step's iteration: its ramp and draws), ``hyper`` (per step,
  values that replace the agent's, e.g. DMPLS's ``beta``) and
  ``no_noise`` (the teacher's input noise zeroed). Over a mesh a rank
  r > 0 first skews its host values (``k + r``, ``beta + r / 4``): the
  step must take rank 0's. Result: each step's metrics, the first step's
  gradients, the final state dict, the teacher's parameters, the
  small-loss masks with the values and counts they were built from, and
  DAST's gates after each step.
"""
import os
import sys

import numpy as np
import torch

from fpl_plus_torch.agents import nll as port_nll
from fpl_plus_torch.agents import ssl as port_ssl
from fpl_plus_torch.agents import wsl as port_wsl
from fpl_plus_torch.engine.infer import Inferer, PassFold, window_grid
from fpl_plus_torch.engine.optim import create_lr_schedule, create_optimizer
from fpl_plus_torch.engine.train import (AlternatingTrainStep,
                                         DiscriminatorStep,
                                         DualConsistencyStep, JointTrainStep)
from fpl_plus_torch.losses import create_loss_calculator
from fpl_plus_torch.models.multi_net import MultiNet
from fpl_plus_torch.models.registry import create_network
from fpl_plus_torch.models.unet2d5_dsbn import Dis
from fpl_plus_torch.parallel import (make_mesh, make_sharded_train_step,
                                     replicate, shard_batch,
                                     sharded_sliding_window)
from fpl_plus_torch.parallel import multihost

STEP_KINDS = ('joint', 'alternating', 'dual_consistency', 'dis')
METHODS = {'ssl': port_ssl.SSLMethodDict, 'wsl': port_wsl.WSLMethodDict,
           'nll': port_nll.NLLMethodDict}


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
            fold, case['volume'], case['passes'], case.get('margins'))()
        if mesh is not None:   # the helper needs a mesh
            window = case['testing']['sliding_window_size']
            starts = window_grid(case['volume'].shape[2:], window,
                                 case['testing']['sliding_window_stride'])
            out['sliding_window'] = [t.numpy() for t in sharded_sliding_window(
                predict, window, mesh, chunk=2)(
                torch.from_numpy(case['volume']), starts)]
    return out


def _skewed(batches, hyper, rank):
    """Rank ``rank``'s own host values: a rotation ``k`` riding last in a
    batch tuple turned by ``rank``, ``beta`` moved by ``rank / 4``."""
    if isinstance(batches, tuple) and isinstance(batches[-1], int):
        batches = batches[:-1] + ((batches[-1] + rank) % 4,)
    if 'beta' in hyper:
        hyper = dict(hyper, beta=hyper['beta'] + rank / 4)
    return batches, hyper


def run_paradigm_case(case, mesh):
    cfg = case['config']
    agent = METHODS[case['paradigm']][case['method']](cfg, 'train', 'cpu')
    peers = case.get('peers', 1)
    net = (create_network(cfg['network']) if peers == 1
           else MultiNet(cfg['network'], peers))
    net.load_state_dict(case['state'], strict=True)
    agent.module = net.train()
    if mesh is not None:
        replicate(net, mesh)
    step = agent._build_step(create_optimizer(cfg['training'],
                                              net.parameters()), None)
    if mesh is not None:
        step = make_sharded_train_step(step, mesh)
    masks, gates = [], []
    real_mask = port_nll.keep_smallest_mask
    real_noise = port_ssl.noise_like

    def recording(values, keep_n):
        mask = real_mask(values, keep_n)
        masks.append({'mask': mask.numpy(), 'values': values.numpy(),
                      'keep_n': keep_n})
        return mask

    port_nll.keep_smallest_mask = recording
    if case.get('no_noise'):
        port_ssl.noise_like = port_wsl.noise_like = \
            lambda gen, x: torch.zeros_like(x)
    metrics, grads = [], None
    extra = case.get('hyper') or [{}] * len(case['its'])
    try:
        for i, (it, step_batches) in enumerate(zip(case['its'],
                                                   case['batches'])):
            batches = _tensors(step_batches)
            hyper = dict(agent.training_hyper(it), **extra[i])
            if mesh is not None:
                batches = shard_batch(batches, mesh)
                batches, hyper = _skewed(batches, hyper, mesh.rank)
            m = step(batches, agent._step_generators(it), **hyper)
            metrics.append({k: v.detach().clone() for k, v in m.items()})
            gates.append(dict(agent.gates) if getattr(agent, 'gates', None)
                         else None)
            if i == 0:
                grads = {k: p.grad.detach().clone()
                         for k, p in net.named_parameters()}
    finally:
        port_nll.keep_smallest_mask = real_mask
        port_ssl.noise_like = port_wsl.noise_like = real_noise
    teacher = agent.teacher
    return {'metrics': metrics, 'grads': grads,
            'state': {k: v.detach().clone()
                      for k, v in net.state_dict().items()},
            'teacher': None if teacher is None else {
                k: v.clone() for k, v in teacher.params.items()},
            'masks': masks, 'gates': gates}


def run_case(case, mesh=None):
    """One case over ``mesh`` (None: in this process alone)."""
    if case['kind'] in STEP_KINDS:
        return run_step_case(case, mesh)
    if case['kind'] == 'infer':
        return run_infer_case(case, mesh)
    if case['kind'] == 'paradigm':
        return run_paradigm_case(case, mesh)
    raise ValueError('unknown case kind {0!r}'.format(case['kind']))


def _rank(local_rank, workdir, ranks, coordinator):
    torch.set_num_threads(1)
    multihost.maybe_initialize_distributed({}, 'cpu', local_rank, ranks,
                                           coordinator)
    mesh = make_mesh(ranks, 'cpu')
    cases = torch.load(os.path.join(workdir, 'cases.pt'), weights_only=False)
    results = [run_case(case, mesh) for case in cases]
    torch.save(results, os.path.join(workdir, 'results.pt' if mesh.rank == 0
                                     else 'results.rank{0}.pt'.format(
                                         mesh.rank)))
    multihost.finalize_distributed()


def main(argv):
    workdir, ranks = argv[0], int(argv[1])
    coordinator = 'localhost:{0}'.format(multihost.free_local_port())
    multihost.launch_local_ranks(_rank, (workdir, ranks, coordinator), ranks)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
