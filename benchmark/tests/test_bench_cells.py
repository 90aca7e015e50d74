"""Each cell's whole run on the CPU at a tiny size, past the harness's look
for a card: sound runs come out correct, and a run with the timed path
broken underneath comes out not correct, once for each fault the cell can
have. On the card, the control at the cell's own size on three seeds
comes out not correct."""
import json
import os

import pytest

from benchmark.harness import cell

SEEDS = (12345, 2 ** 31 + 3777)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
    MANIFEST = json.load(f)
CELLS = [w['name'] for w in MANIFEST['workloads']]
# a cell whose files are kept for a later PR, not yet in BENCHMARK.json
# (PERF.md, section 7)
KEPT = {'vs_t1s_g.train_joint': {'name': 'vs_t1s_g.train_joint',
                                 'config': 'vs_t1s_g',
                                 'traffic': 'train_joint', 'chips': 1}}


def spec_of(name):
    if name in CELLS:
        return cell.load_cell(name)
    entry = KEPT[name]
    files = {c['name']: c['file'] for c in MANIFEST['configs']}

    def load(*parts):
        with open(os.path.join(ROOT, *parts)) as f:
            return json.load(f)
    return {'name': name, 'cell': entry, 'manifest': MANIFEST,
            'config': load(files[entry['config']]),
            'traffic': load('benchmark', 'workloads',
                            entry['traffic'] + '.json'),
            'limits': load('benchmark', 'limits', name + '.json')}


def run(name, seed, shrink, **kw):
    return cell.run_cell(name, seed, 0.05, False, device='cpu',
                         shrink=shrink, spec=spec_of(name), **kw)


@pytest.mark.parametrize('seed', SEEDS)
@pytest.mark.parametrize('name', CELLS + sorted(KEPT))
def test_a_sound_run_is_correct(name, seed, shrink):
    r = run(name, seed, shrink)
    assert r['correct'], r['checks']
    assert r['attempted'] > 0 and r['failed'] == 0
    assert list(r)[-1] == 'checks'
    e2e = {m['name'] for m in cell.metrics_of(MANIFEST, name, False)}
    assert set(r['metrics']) == e2e - {'peak_mem_gib'}


@pytest.mark.parametrize('seed', SEEDS)
@pytest.mark.parametrize('name, fault', [
    ('vs_t1s_g.pseudo_label', 'answer'),
    ('vs_t1s_weights.fpl_pass', 'answer'),
    ('vs_t1s_g.train_joint', 'unchanged'),
    ('vs_t1s_g.train_joint', 'half_batch'),
])
def test_a_broken_timed_path_is_not_correct(name, fault, seed, shrink):
    r = run(name, seed, shrink, fault=fault)
    assert not r['correct'], r['checks']


@pytest.mark.card
@pytest.mark.parametrize('name', CELLS)
def test_the_control_is_not_correct_on_the_card(name, card):
    control = spec_of(name)['limits']['control']
    for seed in (11, 2 ** 31 + 5, 977):
        r = cell.run_cell(name, seed, 3.0, False, device=card,
                          control=control)
        assert not r['correct'], (seed, r['checks'])
