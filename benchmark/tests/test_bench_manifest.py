"""BENCHMARK.json against the contract's form, and the files it names."""
import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
    B = json.load(f)
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
WIDTH = re.compile(r'(_dim|_rank|chns|hidden|intermediate|width|size)$')


def test_top_level_keys():
    assert set(B) == {'command', 'paths', 'run_seconds', 'configs',
                      'workloads', 'end_to_end', 'per_layer'}
    assert B['paths'] == ['benchmark']
    assert all(not w.startswith('/') and '..' not in w for w in B['command'])
    assert 1 <= B['run_seconds'] <= 51


@pytest.mark.parametrize('kind', ['configs', 'workloads', 'end_to_end',
                                  'per_layer'])
def test_names_and_units(kind):
    names = [e['name'] for e in B[kind]]
    assert len(names) == len(set(names))
    for e in B[kind]:
        assert NAME.match(e['name']), e['name']
        if 'unit' in e:
            assert UNIT.match(e['unit']), e['unit']
            assert e['better'] in ('lower', 'higher')
        for key in ('why', 'layer'):
            if key in e:
                assert 1 <= len(e[key]) <= 200
                assert '\n' not in e[key] and '\t' not in e[key]


def test_bounds():
    for m in B['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    assert any(m['name'] == 'setup_s' for m in B['end_to_end'])


def test_each_cell_reports_what_its_metrics_move():
    e2e = {m['name']: m for m in B['end_to_end']}
    cells = [w['name'] for w in B['workloads']]

    def reports(metric, cell):
        return cell in e2e[metric].get('workloads', cells)

    for m in B['per_layer']:
        assert m['moves'] in e2e
        for cell in m.get('workloads', cells):
            assert cell in cells
            assert reports(m['moves'], cell), (m['name'], cell)
    for cell in cells:
        assert reports('setup_s', cell)
        assert sum(reports(n, cell) for n in e2e) >= 2
        assert any(cell in m.get('workloads', cells)
                   for m in B['per_layer'])


def test_layers_are_named_alike():
    layers = {}
    for m in B['per_layer']:
        layers.setdefault(m['layer'].lower(), set()).add(m['layer'])
    assert all(len(v) == 1 for v in layers.values())


def test_files_the_harness_finds_by_name():
    for c in B['configs']:
        assert c['file'].startswith('benchmark/')
        assert os.path.isfile(os.path.join(ROOT, c['file']))
        assert len(c['reduced']) <= 16
        assert not any(WIDTH.search(k) for k in c['reduced'])
    for w in B['workloads']:
        assert w['chips'] == 1
        assert os.path.isfile(os.path.join(
            ROOT, 'benchmark', 'workloads', w['traffic'] + '.json'))
        assert os.path.isfile(os.path.join(
            ROOT, 'benchmark', 'limits', w['name'] + '.json'))
    for m in B['end_to_end'] + B['per_layer']:
        assert os.path.isfile(os.path.join(
            ROOT, 'benchmark', 'metrics', m['name'] + '.py'))


def test_the_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (B['run_seconds'] + 60) + 24 * 2 * 90 + 1200 <= 43200
