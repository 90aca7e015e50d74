"""Do ``torch.profiler`` traces lose kernel events, and how far off are their
device timestamps, against how ``start_trace`` starts them? One card.

    python tools/torch_trace_sessions.py [SECONDS [KIND]]   # from the
        # checkout's root; SECONDS default 300, KIND ``long`` or ``short``

After the batch-norm traces of ``chip_smoke.py`` phase 12, it runs rounds
until SECONDS have passed. Each round makes traces through
``fpl_plus_torch.utils.trace_metrics.start_trace`` / ``stop_trace``, for
each way with its ``PRIME_S`` (the priming kernels after the profiler's
start) set and a wait of the host after ``start_trace`` returns:

* ``long``: one trace per wait of 0.05, 0.5 and 2 s, no priming: a
  marker, then 8 blocks of 18 eval forwards of a flagship window batch
  (3672 launches each) with 50 ms of host time after each block and a
  marker after every second block. A marker is one ``addcmul_`` on a
  one-element tensor between two syncs, so its kernel starts a few
  microseconds after its launch call on a card that keeps time.
* ``short``: for each way (``none``: no wait, no priming; ``prime``: 50
  ms of priming, the default; ``wait+prime``: 2 s of wait as well), a trace of
  phase 12's f32 step (1464 launches) and one of 6 eval forwards (1224).

Each trace prints its kernel launch calls after the priming ones, those
without their kernel's event (index, us after the first launch call), the
priming calls with and without a kernel event, and, for ``long``, each marker's kernel start
less its launch call's start (``LOST`` without its kernel event). The
last lines sum each way's traces.
"""
import collections
import copy
import os
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402
from fpl_plus_torch.models.registry import create_network  # noqa: E402
from fpl_plus_torch.utils import trace_metrics as tm  # noqa: E402

# way: (the host's wait after start_trace in s, PRIME_S)
LONG = {'wait 0.05 s': (0.05, 0.0), 'wait 0.5 s': (0.5, 0.0),
        'wait 2 s': (2.0, 0.0)}
SHORT = {'none': (0.0, 0.0), 'prime': (0.0, 0.05), 'wait+prime': (2.0, 0.05)}
BLOCKS = 8
FORWARDS = 18                    # eval forwards per block
MARKER_OP = 'aten::addcmul_'


def audit(path):
    """(launch calls after the priming ones, [(index, us after the first
    launch call) of those without a kernel event], (priming calls with a
    kernel event, priming calls without one), [(us, kernel start less launch call in us, or 'LOST') per
    marker])."""
    events = [e for e in tm.trace_events(path) if e.get('ph') == 'X']
    kernels = {e['args'].get('correlation'): e for e in events
               if e.get('cat') == 'kernel'}
    ops = {e['args'].get('External id'): e['name'] for e in events
           if e.get('cat') == 'cpu_op'}
    calls = sorted((e for e in events
                    if e.get('cat') in ('cuda_runtime', 'cuda_driver')
                    and 'LaunchKernel' in e['name']),
                   key=lambda e: float(e['ts']))
    primed = [i for i, e in enumerate(calls) if tm.PRIME_KERNEL in kernels.get(
        e['args'].get('correlation'), {}).get('name', '')]
    cut = primed[-1] + 1 if primed else 0
    t0 = float(calls[cut]['ts'])

    def skew(e):
        k = kernels.get(e['args'].get('correlation'))
        return 'LOST' if k is None else float(k['ts']) - float(e['ts'])
    lost = [(i, float(e['ts']) - t0) for i, e in enumerate(calls[cut:])
            if e['args'].get('correlation') not in kernels]
    prime_lost = sum(1 for e in calls[:cut]
                     if e['args'].get('correlation') not in kernels)
    marks = [(float(e['ts']) - t0, skew(e)) for e in calls[cut:]
             if ops.get(e['args'].get('External id')) == MARKER_OP]
    return len(calls) - cut, lost, (len(primed), prime_lost), marks


def main():
    seconds = float(sys.argv[1]) if len(sys.argv) > 1 else 300.0
    dev = torch.device('cuda', 0)
    print(torch.cuda.get_device_name(0), torch.__version__,
          torch.version.cuda)
    os.makedirs(os.path.join(REPO, 'build'), exist_ok=True)
    net = create_network(cs.NET_CFG).eval()
    cs.init_random_(net, cs.SEED)
    eval_net = copy.deepcopy(net).to(dev).eval()
    x = torch.randn((cs.BATCH, 1) + tuple(cs.WINDOW), device=dev)
    m = torch.zeros(1, device=dev)

    def marker():
        torch.cuda.synchronize(dev)
        m.addcmul_(m, m)
        torch.cuda.synchronize(dev)

    def work():
        marker()
        with torch.inference_mode():
            for b in range(BLOCKS):
                for _ in range(FORWARDS):
                    eval_net(x, cs.DOMAIN)
                time.sleep(0.05)
                if b % 2:
                    marker()

    batches = cs.train_batches(dev)
    step, draws = cs.phase12_step(dev, net, 'float32')
    gens = draws()

    def train():
        step(batches, gens)

    def infer():
        with torch.inference_mode():
            for _ in range(6):
                eval_net(x, cs.DOMAIN)

    kind = sys.argv[2] if len(sys.argv) > 2 else 'long'
    ways = LONG if kind == 'long' else SHORT
    jobs = [('work', work)] if kind == 'long' else [('train', train),
                                                    ('infer', infer)]
    work()
    train()
    cs.norm_kernels(dev, net, batches)
    out = collections.defaultdict(list)
    end = time.perf_counter() + seconds
    r = 0
    while time.perf_counter() < end:
        for way, (wait, prime) in ways.items():
            tm.PRIME_S = prime
            for tag, fn in jobs:
                with tempfile.TemporaryDirectory(dir=os.path.join(
                        REPO, 'build')) as trace_dir:
                    tm.start_trace(trace_dir, dev)
                    time.sleep(wait)
                    try:
                        fn()
                    finally:
                        tm.stop_trace()
                    calls, lost, prime_lost, marks = audit(os.path.join(
                        trace_dir, os.listdir(trace_dir)[0]))
                out[way].append((len(lost), marks))
                print('{0}, round {1}, {2}: {3} launch calls, {4} without a '
                      'kernel event {5}; priming calls (kept, lost) {6}; '
                      'markers (us after the first call, kernel start less '
                      'launch call) {7}'.format(
                          way, r, tag, calls, len(lost),
                          [(i, round(t)) for i, t in lost[:3] + lost[-2:]],
                          prime_lost,
                          [(round(t), v if v == 'LOST' else round(v, 1))
                           for t, v in marks]))
        r += 1
    for way in ways:
        rows = out[way]
        skews = [abs(v) for _, marks in rows for _, v in marks
                 if v != 'LOST']
        print('SUMMARY {0}: {1} traces, {2} with lost kernel events, {3} '
              'lost; largest marker skew {4!r} us; traces with a marker '
              'skew over 1 ms or lost: {5}'.format(
                  way, len(rows), sum(1 for n, _ in rows if n),
                  sum(n for n, _ in rows), max(skews, default=None),
                  sum(1 for _, marks in rows if any(
                      v == 'LOST' or abs(v) > 1000 for _, v in marks))))
    return 0


if __name__ == '__main__':
    sys.exit(main())
