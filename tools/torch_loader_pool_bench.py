"""Time the port's train loop with its items made in the main process and
with the loader's worker pool, on the card:

    python tools/torch_loader_pool_bench.py [--iterations 12] \
        [--workers 0 8] [--out results.jsonl]

It builds ``chip_smoke.py``'s phase-13 workspace (3 target and 2 source
40x160x272 volumes, a full-width UNet2D5_dsbn with seeded random weights)
and runs ``fpl_plus_torch.cli train`` of phase 13's generator config
(batch 4 + 4 crops of [28,128,128], validation every 2 iterations, then
the auto test stage) once per ``num_workder`` of ``--workers``. Per run it
prints one JSON line: the step call's CUDA-event ms per iteration, the host
wait per iteration (``scalars.jsonl``, a mean per validation block),
validation ms per volume, the train stage's wall seconds, and the card's
name and power limit as nvidia-smi reports them. Needs one card.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def run(root, workers, iterations, fwd_per_volume):
    import chip_smoke as cs
    import numpy as np
    from fpl_plus_torch import cli
    from fpl_plus_torch.agents.agent_seg import SegmentationAgent
    from fpl_plus_torch.engine.train import JointTrainStep
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    tag = 'bench_w{0}'.format(workers)
    cfg = cs.train_cfg(root, tag, stop=iterations, ckpt=tag, workers=workers)
    step_ms, valid_ms = [], []
    with cs.timed_method(JointTrainStep, '__call__', step_ms), \
            cs.timed_method(SegmentationAgent, 'validation', valid_ms), \
            cs.counting_forwards() as forwards:
        dsbn_prelu.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(['train', cfg])
        wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError('train stage rc {0}'.format(rc))
    n_eval = (2 + cs.N_VOLUMES) * iterations // 2 + cs.N_VOLUMES
    if forwards[0] != n_eval * fwd_per_volume or \
            dsbn_prelu.launches != 18 * forwards[0]:
        raise RuntimeError('{0} forwards, {1} launches'.format(
            forwards[0], dsbn_prelu.launches))
    with open(os.path.join(root, 'model', tag, 'scalars.jsonl')) as f:
        recs = [json.loads(line) for line in f]
    return {'num_workder': workers, 'iterations': iterations,
            'step_ms': step_ms,
            'step_ms_median_after_first': float(np.median(step_ms[1:])),
            'host_wait_s': [r['value'] for r in recs
                            if r['tag'] == 'host_wait'],
            'valid_ms_per_volume': [t / (2 + cs.N_VOLUMES)
                                    for t in valid_ms],
            'wall_s': wall, 'launches': dsbn_prelu.launches}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--iterations', type=int, default=12)
    ap.add_argument('--workers', type=int, nargs='+', default=[0, 8])
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 1
    import chip_smoke as cs
    from fpl_plus_torch.engine.infer import window_grid
    from fpl_plus_torch.models.registry import create_network
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    net = create_network(cs.NET_CFG).eval()
    cs.init_random_(net, cs.SEED)
    fwd = -(-len(window_grid(cs.VOLUME, cs.WINDOW, cs.WINDOW))
            // cs.PATCH_CHUNK)
    os.makedirs(os.path.join(REPO, 'build'), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, 'build')) as ws:
        names = cs.write_workspace(ws, net)
        with open(os.path.join(ws, 'train_weighted.csv'), 'w') as f:
            f.write('image,label,pixel_weight,image_weight\n')
        cs.write_train_workspace(ws, names, 'train_weighted_rel.csv')
        for workers in args.workers:
            result = dict(run(ws, workers, args.iterations, fwd),
                          card=smi, tree=REPO)
            line = json.dumps(result)
            print(line, flush=True)
            if args.out:
                with open(args.out, 'a') as f:
                    f.write(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
