"""One run of one cell: set-up, the measured window, the traced slice,
the comparison with the reference, and the result.

A cell is a workload of ``BENCHMARK.json``: a configuration file
(``benchmark/configs/``), a traffic file (``benchmark/workloads/<traffic>
.json``) and a limits file (``benchmark/limits/<cell>.json``); its metrics
are the readers ``benchmark/metrics/<metric>.py``. Nothing here names a
cell or a network: a configuration's network is the plain reference file
its ``reference`` key names (its interface: ``benchmark/README.md``), and
a test stage's traced slice is guarded by the kernel names and program
counter of its ``trace_guard`` key (the eval DSBN+PReLU kernel's where it
has none).

The program is driven through its agent, as a user runs it:
``SegmentationAgent.infer()`` for a test stage (pseudo-labels, or the FPL
pass when the configuration sets ``fpl``) and ``train_valid()`` for
training. The harness observes it at four points without changing what
it computes: the agent's ``save_outputs`` (one call per pseudo-label),
the label Inferer its ``_inferers`` returns and the logits Inferer it is
given through ``set_inferer`` (one dispatch per volume; both copy a
sampled row's logits out, behind the work that makes them), and the
train step that ``_build_step`` returns (one call per iteration). There
it counts the units of work, starts and stops the traced slice, reads the
first steps' state for the comparison, and ends training at the close of
the window.

* Test stage: two warm-up calls of ``infer()`` (the first builds the
  kernels and the convolutions' plans, the second times a few volumes,
  one over the median time between them); then the window, one
  ``infer()`` over a manifest of as many rows as that rate fills
  ``--seconds`` with; the rate is the rows over the call's whole time.
* Training: one ``train_valid()``; its first iterations are compared
  with the reference, the following ones warm up, and the window runs
  from the first iteration after them until the first iteration that
  starts past ``--seconds``, where the harness ends the loop; the rate is
  the iterations completed over that time, the loader's waits included.
"""
from __future__ import annotations

import gc
import importlib.util
import math
import os
import re
import subprocess
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from benchmark.harness import judge, nifti, workspace
from benchmark.harness.trace import Profiler, TraceView, check_events
from benchmark.reference import serve

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, 'benchmark')
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'fpl_plus_tpu')
# the counter of a test stage's traced slice where a configuration names
# no ``trace_guard``: the eval DSBN+PReLU kernel's launches, whose events
# are ``kernels.json``'s ``dsbn_prelu`` names
DEFAULT_COUNTER = 'fpl_plus_torch.ops.dsbn_prelu:dsbn_prelu.launches'


class WindowClosed(Exception):
    """Raised from the train step's observer to end the loop."""


def load_cell(name: str) -> dict:
    manifest = workspace.load_json(os.path.join(ROOT, 'BENCHMARK.json'))
    cells = {w['name']: w for w in manifest['workloads']}
    if name not in cells:
        raise SystemExit('unknown workload {0!r}; known: {1}'.format(
            name, ', '.join(sorted(cells))))
    cell = cells[name]
    cfg_entry = {c['name']: c for c in manifest['configs']}[cell['config']]
    return {
        'name': name, 'cell': cell, 'manifest': manifest,
        'config': workspace.load_json(os.path.join(ROOT, cfg_entry['file'])),
        'traffic': workspace.load_json(os.path.join(
            BENCH, 'workloads', cell['traffic'] + '.json')),
        'limits': workspace.load_json(os.path.join(
            BENCH, 'limits', name + '.json')),
    }


def reader(metric: str):
    spec = importlib.util.spec_from_file_location(
        'bench_metric_' + metric.replace('.', '_'),
        os.path.join(BENCH, 'metrics', metric + '.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_reference(path: str):
    """The plain reference module at ``path`` (relative to the checkout),
    loaded once a process."""
    name = 'bench_reference_' + re.sub(r'\W', '_', path[:-len('.py')])
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, path))
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        try:
            spec.loader.exec_module(module)
        except BaseException:
            del sys.modules[name]
            raise
    return sys.modules[name]


def program_counter(path: str) -> int:
    """The program's counter at ``path``, ``module:attribute.attribute``."""
    module, attrs = path.split(':')
    value = importlib.import_module(module)
    for attr in attrs.split('.'):
        value = getattr(value, attr)
    return value


def metrics_of(manifest: dict, cell: str, per_layer: bool):
    entries = manifest['per_layer' if per_layer else 'end_to_end']
    return [m for m in entries if cell in m.get('workloads', [cell])]


def derived_seeds(seed: int) -> dict:
    state = np.random.SeedSequence(int(seed)).generate_state(2)
    return {'program': int(state[0] % 2 ** 31), 'weights': int(state[1])}


class Run:
    """The state of one run, handed to the judge and the readers."""

    def __init__(self, spec: dict, seed: int, seconds: float, trace: bool,
                 device, control: Optional[dict] = None,
                 fault: Optional[str] = None, shrink=None):
        self.spec = spec
        spec.setdefault('kernels', workspace.load_json(
            os.path.join(BENCH, 'kernels.json')))
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = trace
        self.device = torch.device(device)
        self.control = control or {}
        self.fault = fault
        config, traffic = spec['config'], dict(spec['traffic'])
        if shrink is not None:
            config, traffic = shrink(config, traffic)
        self.config, self.traffic = config, traffic
        self.net_cfg = dict(config['network'])
        self.reference = load_reference(config['reference'])
        self.fpl_passes = config.get('method', {}).get('fpl_passes', 6)
        seeds = derived_seeds(seed)
        self.random_seed = seeds['program']
        self.weight_seed = seeds['weights']
        self.items = 0
        self.window_s = None
        self.setup_s = None
        self.peak_bytes = None
        self.view = None
        self.failed = 0
        self.profiler = None
        self.slice_at = None
        self.captured = {}
        self.notes = {}
        self.stamps = []

    # -- set-up ------------------------------------------------------------
    def _sections(self, ws) -> Dict[str, dict]:
        paths = {
            'dataset': {'root_dir': ws.root,
                        'test_csv': ws.path('test.csv'),
                        '1_train_csv': ws.path('train_0.csv'),
                        '2_train_csv': ws.path('train_1.csv'),
                        '1_valid_csv': ws.path('valid_0.csv'),
                        '2_valid_csv': ws.path('valid_1.csv')},
            'training': {'ckpt_save_dir': ws.path('model', 'bench'),
                         'random_seed': self.random_seed},
            'testing': {'output_dir': ws.path('result'),
                        'fpl_uncertainty_sorted': ws.path('fpl.npy')}}
        return workspace.merged(self.config, self.traffic.get('overrides'),
                                self.control.get('program_overrides'), paths)

    def program_config(self, ws):
        from fpl_plus_torch.config.parser import (parse_config,
                                                  synchronize_config)
        self.sections = self._sections(ws)
        path = workspace.write_cfg(ws.path('bench.cfg'), self.sections)
        return synchronize_config(parse_config(path))

    def host_weights(self, calibration_volume=None):
        """The seeded weights, made on the device, as CPU tensors, kept
        for the judge. Where the traffic sets a ``foreground_share``, the
        head's bias is calibrated on the first window of
        ``calibration_volume`` (``calibrate_foreground``)."""
        ref = self.reference
        w = ref.make_weights(self.net_cfg, self.weight_seed, self.device)
        share = self.traffic.get('foreground_share')
        if share is not None:
            te = self.config['testing']
            image, _ = serve.preprocess(nifti.read(calibration_volume)[0],
                                        te['sliding_window_size'])
            starts, win = serve.grid(image.shape[1:],
                                     te['sliding_window_size'],
                                     te['sliding_window_stride'])
            x = torch.from_numpy(image[None]).to(self.device)[
                (slice(None), slice(None)) + tuple(
                    slice(a, a + b) for a, b in zip(starts[0], win))]
            with judge.strict_f32():
                ref.calibrate_foreground(self.net_cfg, w, x,
                                         te['domian_label'], share)
        self.host_w = {k: v.cpu() for k, v in w.items()}
        return self.host_w

    def device_weights(self):
        return {k: v.to(self.device) for k, v in self.host_w.items()}

    # -- the traced slice --------------------------------------------------
    def mark(self, k: int) -> None:
        """Called before unit of work ``k`` of a call (0-based)."""
        self.stamps.append(time.perf_counter())
        if self.slice_at is None:
            return
        a, b = self.slice_at
        if k == a:
            self.profiler = Profiler(self.device)
            self.profiler.start(self.launches())
        elif k == b and self.profiler is not None and self.profiler.running:
            self.profiler.stop(self.launches())

    def guard(self) -> Optional[dict]:
        """The kernel names and the program counter of their launches
        that guard a test stage's traced slice; None for a train stage,
        whose kernels the program does not count."""
        if self.stage == 'train':
            return None
        return self.config.get('trace_guard') or {
            'names': self.spec['kernels']['dsbn_prelu']['names'],
            'counter': DEFAULT_COUNTER}

    def launches(self) -> int:
        guard = self.guard()
        return 0 if guard is None else program_counter(guard['counter'])

    def plan_slice(self, expected: int) -> None:
        if not self.trace:
            return
        count = min(int(self.traffic['trace_items']), max(expected - 2, 3))
        a = max(1, (expected - count) // 2)
        self.slice_at = (a, a + count)

    def close_slice(self, ws, unit: str) -> None:
        """Stop the trace and read it; in a test stage, raise where the
        guard's kernel was not launched in the slice, or launched more often
        than the trace holds its events."""
        if self.profiler is None:
            raise RuntimeError('the window ended before the traced slice')
        if self.profiler.running:
            self.profiler.stop(self.launches())
        guard = self.guard()
        launched = self.profiler.launches[1] - self.profiler.launches[0]
        if guard is not None and launched <= 0:
            raise RuntimeError(
                'the trace guard counted no launches in the traced slice: '
                '{0} read {1[0]} at its start and {1[1]} at its end; the '
                'configuration\'s trace_guard has to name a kernel of the '
                'program that its test stage launches, and the counter of '
                'those launches'.format(guard['counter'],
                                        self.profiler.launches))
        self.view = TraceView(self.profiler.events(ws.path('trace.json')),
                              unit)
        os.remove(ws.path('trace.json'))
        if guard is not None:
            check_events(self.view, guard['names'], launched)
        if self.view.periods < 2:
            raise RuntimeError('the traced slice holds {0} periods of {1}'
                               .format(self.view.periods, unit))

    # -- the test stage ----------------------------------------------------
    def run_test(self, ws) -> dict:
        from fpl_plus_torch.agents.agent_seg import SegmentationAgent
        from fpl_plus_torch.engine.infer import Inferer
        t = self.traffic
        self.log('imports')
        sources = ws.write_volumes(0, t['distinct_volumes'], 0.0, False)
        self.log('volumes')
        weights = self.host_weights(ws.path(sources[0]))
        os.makedirs(ws.path('model', 'bench'), exist_ok=True)
        torch.save({'model_state_dict': weights, 'iteration': 0},
                   ws.path('model', 'bench', 'bench_0.pt'))
        with open(ws.path('model', 'bench', 'bench_best.txt'), 'w') as f:
            f.write('0')
        with open(ws.path('model', 'bench', 'bench_latest.txt'), 'w') as f:
            f.write('0')
        del weights
        self.log('weights')
        config = self.program_config(ws)
        fpl = bool(self.sections['testing'].get('fpl', False))
        agent = SegmentationAgent(config, 'test', self.device)
        agent.create_network()
        run = self
        counter = [0]

        if fpl:
            class ObservedInferer(Inferer):
                def run_fpl_uncertainty(self, group_predictor, image,
                                        n_passes, margins=None):
                    run.mark(counter[0])
                    counter[0] += 1
                    fetch = super().run_fpl_uncertainty(
                        group_predictor, image, n_passes, margins)
                    if run.fault == 'answer':
                        return lambda: (lambda v: (v[0] * 1.5, v[1]))(fetch())
                    return fetch

                def _passes_dev(self, group_predictor, image, n_passes,
                                staged):
                    # the per-pass logits of a sampled row, copied out
                    # behind the work that makes them
                    outs = super()._passes_dev(group_predictor, image,
                                               n_passes, staged)
                    buf = run.captured.get(counter[0] - 1)
                    if buf is not None:
                        buf.copy_(outs[0], non_blocking=True)
                    return outs

            agent.set_inferer(ObservedInferer(dict(
                config['testing'], output_mode='logits'), self.device))
        else:
            save = agent.save_outputs
            dispatched = [0]

            def observed_save(data):
                run.mark(counter[0])
                counter[0] += 1
                if run.fault == 'answer' and 'predict_label' in data:
                    data['predict_label'] ^= 1
                save(data)

            class ObservedLabelInferer(Inferer):
                def run_async(self, predictor, image):
                    dispatched[0] += 1
                    return super().run_async(predictor, image)

                def _fetch(self, heads, staged):
                    # a sampled row's logits, copied out behind the work
                    # that makes them, before the argmax
                    buf = run.captured.get(dispatched[0] - 1)
                    if buf is not None:
                        buf.copy_(heads[0][0], non_blocking=True)
                    return super()._fetch(heads, staged)

            def inferers():
                return (ObservedLabelInferer(dict(
                    config['testing'], output_mode='label'), self.device),
                    agent._logits_inferer())

            agent.save_outputs = observed_save
            agent._inferers = inferers

        rng = np.random.default_rng([self.seed, 5])

        def prepare(tag, count):
            rows = ws.rows(tag, sources, count, rng)
            ws.manifest('test.csv', rows)
            agent.test_set = None
            agent.create_dataset()
            return rows

        self.log('agent')
        warm_a, warm_b = t['warmup']
        prepare('warma', warm_a)
        agent.infer()
        self.log('first warm-up')
        prepare('warmb', warm_b)
        self.stamps = []
        agent.infer()
        # the steady rate: one unit over the median time between units,
        # without the call's own start, the pipeline's fill and its drain
        rate = 1.0 / float(np.median(np.diff(self.stamps)))
        n = max(int(t['min_items']), int(round(rate * self.seconds)))
        self.rows = prepare('row', n)
        self.plan_slice(n)
        sample = judge.sample_rows(np.random.default_rng([self.seed, 3]), n,
                                   int(t['sample']))
        shape = ((self.fpl_passes,) if fpl else ()) + (
            self.net_cfg['class_num'],) + tuple(max(s, w) for s, w in zip(
                t['volume_shape'],
                self.sections['testing']['sliding_window_size']))
        self.captured = {i: torch.empty(
            shape, pin_memory=self.device.type == 'cuda') for i in sample}
        counter[0] = 0
        if not fpl:
            dispatched[0] = 0
        self.stamps = []
        self.sync()
        start = time.perf_counter()
        self.setup_s = start - T0[0]
        agent.infer()
        self.sync()
        self.window_s = time.perf_counter() - start
        self.items = n
        self.log('window')
        self.notes['rate_by_thirds'] = [
            round(len(part) / (part[-1] - part[0]), 3)
            for part in np.array_split(np.asarray(self.stamps), 3)
            if len(part) > 1]
        if self.trace:
            self.close_slice(ws, 'infer_run_fpl_uncertainty' if fpl
                             else 'infer_run')
        self.peak_bytes = self.peak()
        out_dir = ws.path('result', 'bench_test')
        self.output_path = lambda row: os.path.join(out_dir,
                                                    os.path.basename(row))
        saved = {}
        if fpl:
            pairs = np.load(ws.path('fpl.npy'), allow_pickle=True)
            saved = {str(name): float(np.ravel(u)[0]) for u, name in pairs}
            self.failed = sum(1 for r in self.rows if r not in saved)
        else:
            self.failed = sum(1 for r in self.rows
                              if not os.path.isfile(self.output_path(r)))
        del agent
        self.free()
        self.weights = self.device_weights()
        if fpl:
            dtype = self.control.get('reference_dtype')
            numbers = judge.fpl_gap(self, sample, saved, self.captured,
                                    judge.DTYPES[dtype] if dtype else None)
        else:
            numbers = judge.label_gap(self, sample, self.captured)
        self.log('judge')
        return numbers

    # -- training ----------------------------------------------------------
    def run_train(self, ws) -> dict:
        judge.check_trainable(self.reference)
        from fpl_plus_torch.agents.agent_seg import SegmentationAgent
        t = self.traffic
        self.log('imports')
        self.train_rows = []
        for d in range(2):
            names = ws.write_volumes(d, t['distinct_volumes'],
                                     t['domain_shift'][d], True)
            labels = [n.replace('/img/', '/lab/') for n in names]
            ws.manifest('train_{0}.csv'.format(d), names, labels)
            ws.manifest('valid_{0}.csv'.format(d), names[:1], labels[:1])
            self.train_rows.append(list(zip(names, labels)))
        ws.manifest('test.csv', [])
        self.log('volumes')
        weights = self.host_weights()
        config = self.program_config(ws)
        agent = SegmentationAgent(config, 'train', self.device)
        agent.create_dataset()
        agent.create_network()
        agent.module.load_state_dict(weights, strict=True)
        del weights
        self.log('agent')
        checked = int(t['checked_steps'])
        warm = int(t['warmup_steps'])
        run = self
        program = {'losses': []}
        clock = {}
        build = agent._build_step

        def observed_build(optimizer, schedule):
            step = build(optimizer, schedule)
            params = dict(step.module.named_parameters())
            calls = [0]

            def observed(batches, generators, **hyper):
                k = calls[0]
                calls[0] += 1
                if k == 1:
                    program['first_grad'] = {
                        n: (optimizer.state[p]['exp_avg'] / 0.1).cpu()
                        for n, p in params.items()}
                if k == checked:
                    program['params'] = {n: p.detach().to('cpu', copy=True)
                                         for n, p in params.items()}
                if k == warm:
                    run.sync()
                    run.log('warm-up')
                    clock['start'] = time.perf_counter()
                    run.setup_s = clock['start'] - T0[0]
                    expected = run.seconds * (k - 1) / (clock['start']
                                                        - clock['first'])
                    run.plan_slice(int(expected))
                if k >= warm:
                    if time.perf_counter() - clock['start'] >= run.seconds:
                        run.sync()
                        run.window_s = time.perf_counter() - clock['start']
                        run.items = k - warm
                        raise WindowClosed()
                    run.mark(k - warm)
                if run.fault == 'half_batch':
                    batches = tuple({key: v[:v.shape[0] // 2]
                                     for key, v in b.items()}
                                    for b in batches)
                before = ({n: p.detach().clone() for n, p in params.items()}
                          if run.fault == 'unchanged' else None)
                metrics = step(batches, generators, **hyper)
                if before is not None:
                    with torch.no_grad():
                        for n, p in params.items():
                            p.copy_(before[n])
                if k < checked:
                    program['losses'].append(metrics['loss'].detach())
                if k == 0:
                    run.sync()
                    clock['first'] = time.perf_counter()
                return metrics

            return observed

        agent._build_step = observed_build
        try:
            agent.train_valid()
            raise RuntimeError('training ended before the window closed')
        except WindowClosed:
            pass
        finally:
            agent.shutdown()
        self.log('window')
        if self.trace:
            self.close_slice(ws, 'train_step')
        self.peak_bytes = self.peak()
        program['losses'] = [float(v) for v in program['losses']]
        self.program = program
        del agent, build, observed_build
        self.free()
        self.weights = self.device_weights()
        numbers = judge.train_gap(self)
        self.log('judge')
        return numbers

    # -- helpers -----------------------------------------------------------
    def log(self, phase: str) -> None:
        """A line on standard error: the seconds since the process
        started, at the end of ``phase``."""
        print('bench: {0} at {1:.3f} s'.format(
            phase, time.perf_counter() - T0[0]), file=sys.stderr, flush=True)

    def sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def peak(self) -> int:
        if self.device.type == 'cuda':
            return int(torch.cuda.max_memory_allocated(self.device))
        return 0

    def free(self):
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    # -- the work the readers divide by -------------------------------------
    def work(self) -> dict:
        """The work of one unit, from the reference's ``work_per_window``:
        ``flops_by_class`` (``conv``, ``matmul``, ...), their sum
        ``flops_per_item``, the ``precision``, and in a test stage for
        each kernel the reference counts ``<key>_bytes_per_item`` and
        ``<key>_launches_per_item`` under the reference's key."""
        d, te = self.sections['dataset'], self.sections['testing']
        tr = self.sections['training']
        count = self.reference.work_per_window
        if self.stage == 'train':
            crop = d['RandomCrop_output_size']
            macs = count(self.net_cfg, crop)['macs_by_class']
            by_class = {c: 6.0 * m * d['train_batch_size']
                        * self.net_cfg['num_domains']
                        for c, m in macs.items()}
            return {'flops_per_item': sum(by_class.values()),
                    'flops_by_class': by_class,
                    'precision': tr.get('precision', 'float32')}
        window = te['sliding_window_size']
        shape = [max(s, w) for s, w in zip(self.traffic['volume_shape'],
                                           window)]
        starts, win = serve.grid(shape, window, te['sliding_window_stride'])
        passes = self.fpl_passes if te.get('fpl', False) else 1
        variants = 4 if te.get('tta_mode', 0) else 1
        windows = len(starts) * variants * passes
        chunk = te.get('patch_chunk', 2)
        precision = te.get('precision', 'float32')
        itemsize = 4 if precision == 'float32' else 2
        per_window = count(self.net_cfg, win, itemsize)
        by_class = {c: 2.0 * m * windows
                    for c, m in per_window['macs_by_class'].items()}
        work = {'flops_per_item': sum(by_class.values()),
                'flops_by_class': by_class, 'precision': precision}
        # the passes and the flips fold into the batch of each forward
        forwards = math.ceil(len(starts) / chunk)
        for key, k in per_window.get('kernels', {}).items():
            work[key + '_bytes_per_item'] = float(k['bytes'] * windows)
            work[key + '_launches_per_item'] = k['launches'] * forwards
        return work

    def peaks(self) -> dict:
        table = self.spec['peaks']
        name = torch.cuda.get_device_name(self.device) \
            if self.device.type == 'cuda' else 'cpu'
        return table.get(name)


T0 = [time.perf_counter()]


def power_limit() -> Optional[float]:
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=power.limit',
             '--format=csv,noheader,nounits'], capture_output=True,
            text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def forbidden_modules():
    return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device='cuda', control=None, fault=None, shrink=None,
             spec=None) -> dict:
    """One run of cell ``name``; returns the result line's fields and the
    compared numbers (``checks``)."""
    spec = spec or load_cell(name)
    spec.setdefault('peaks', workspace.load_json(
        os.path.join(BENCH, 'peaks.json')))
    # the program's kernel cache at a fixed path inside the checkout, so
    # that only a checkout's first run compiles
    os.environ['TRITON_CACHE_DIR'] = os.path.join(ROOT, 'build', 'triton')
    run = Run(spec, seed, seconds, trace, device, control, fault, shrink)
    if run.device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(run.device)
    run.stage = run.traffic['stage']
    ws = run.ws = workspace.Workspace(seed, run.traffic)
    try:
        numbers = (run.run_train(ws) if run.stage == 'train'
                   else run.run_test(ws))
        found = forbidden_modules()
        if found:
            raise RuntimeError('modules of the JAX package loaded: {0}'
                               .format(', '.join(found)))
        correct, checks = judge.verdict(numbers, spec['limits']['limits'])
        correct = correct and run.failed == 0
        ctx = Context(run)
        per_layer = trace
        metrics = {}
        for m in metrics_of(spec['manifest'], name, per_layer):
            value = reader(m['name'])(ctx)
            if value is not None:
                metrics[m['name']] = {'value': float(value),
                                      'unit': m['unit']}
        dev = {'platform': 'gpu' if run.device.type == 'cuda' else 'cpu',
               'kind': (torch.cuda.get_device_name(run.device)
                        if run.device.type == 'cuda' else 'cpu'),
               'count': 1, 'memory_peak_bytes': run.peak_bytes}
        result = {'correct': bool(correct), 'attempted': run.items,
                  'failed': run.failed, 'metrics': metrics, 'device': dev}
        if trace:
            dev['busy_s'] = run.view.busy_us() / 1e6
            dev['window_s'] = run.view.length_us / 1e6
            result['breakdown'] = run.view.breakdown()
        if run.device.type == 'cuda':
            dev['power_limit_w'] = power_limit()
        result['checks'] = checks
        for k, v in run.notes.items():
            print('bench: {0} {1}'.format(k, v), file=sys.stderr)
        return result
    finally:
        ws.close()


class Context:
    """What a metric's reader sees of a run."""

    def __init__(self, run: Run):
        self.stage = run.stage
        self.items = run.items
        self.window_s = run.window_s
        self.setup_s = run.setup_s
        self.peak_bytes = run.peak_bytes
        self.trace = run.view
        self.kernels = run.spec['kernels']
        self._run = run
        self._work = None

    @property
    def work(self) -> dict:
        if self._work is None:
            self._work = self._run.work()
        return self._work

    @property
    def peaks(self) -> Optional[dict]:
        return self._run.peaks()

    def peak_flops(self, kind: str = 'conv') -> Optional[float]:
        """The published dense peak of the type work of class ``kind``
        runs in (``dense_peak``)."""
        peaks = self.peaks
        if peaks is None:
            return None
        return dense_peak(peaks, self.work['precision'], kind)


# whether float32 work of a class may run in TF32: convolutions through
# cuDNN, matrix products through cuBLAS
TF32_ALLOWED = {'conv': lambda: torch.backends.cudnn.allow_tf32,
                'matmul': lambda: torch.backends.cuda.matmul.allow_tf32}


def dense_peak(peaks: dict, precision: str, kind: str) -> float:
    """The published dense peak for work of class ``kind`` at
    ``precision``: at float32 the TF32 peak while that class's library may
    use TF32, else the float32 one."""
    if kind not in TF32_ALLOWED:
        raise ValueError('no peak for work of class {0!r}; the classes are '
                         '{1}'.format(kind, ', '.join(sorted(TF32_ALLOWED))))
    if precision == 'float32' and TF32_ALLOWED[kind]():
        precision = 'tf32'
    return peaks['dense_flops'][precision]
