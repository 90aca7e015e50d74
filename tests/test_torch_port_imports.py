"""PyTorch port, package boundary: the port imports no JAX, no flax, no
pandas, no msgpack and nothing of the JAX package, and its device default is
the card with no silent CPU fallback.

The import check runs in a fresh interpreter so that this test process's own
JAX imports cannot hide one. The source scan reads every import statement
(and ``importlib.import_module`` / ``__import__`` call) of the package and
of chip_smoke.py; names in prose, such as the file of the TPU kernel a
kernel replaces, are not imports.
"""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from fpl_plus_torch.device import resolve_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'pandas', 'msgpack',
             'fpl_plus_tpu')


def _sources():
    return sorted((ROOT / 'fpl_plus_torch').rglob('*.py')) + [
        ROOT / 'chip_smoke.py']


def test_fresh_import_of_every_module_loads_no_forbidden_package():
    code = (
        'import importlib, pkgutil, sys\n'
        'import fpl_plus_torch\n'
        'names = [m.name for m in pkgutil.walk_packages('
        'fpl_plus_torch.__path__, "fpl_plus_torch.")]\n'
        'for n in names: importlib.import_module(n)\n'
        'print(len(names))\n'
        'bad = sorted(m for m in sys.modules if m.split(".")[0] in {0!r})\n'
        'print(bad)\n').format(FORBIDDEN)
    out = subprocess.run([sys.executable, '-c', code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.strip().splitlines()[-2:]
    assert int(n_modules) >= 64    # ... checkpoint tools, parallel/
    assert bad == '[]'


def _imported_roots(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split('.')[0]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, 'attr',
                          getattr(node.func, 'id', None))
              in ('import_module', '__import__')):
            yield node.args[0].value.split('.')[0]


def test_source_scan_finds_no_forbidden_import():
    sources = _sources()
    pkg = ROOT / 'fpl_plus_torch'
    for module in ('ops/dsbn_prelu.py', 'engine/train.py', 'engine/optim.py',
                   'losses/seg.py', 'transforms/crop.py',
                   'utils/scalar_writer.py', 'native/__init__.py',
                   'metrics/seg_metrics.py', 'metrics/evaluate.py',
                   'metrics/__main__.py', 'transforms/rescale.py',
                   'agents/nll.py', 'agents/nll_clslsr.py',
                   'agents/agent_cls.py', 'utils/make_noise.py',
                   'losses/cls.py', 'models/cls_nets.py',
                   'metrics/cls_metrics.py', 'io/loader.py', 'io/dataset.py',
                   'utils/flax_msgpack.py', 'utils/convert.py',
                   'utils/model_operate.py', 'utils/preprocess.py',
                   'utils/image_process.py', 'parallel/__init__.py',
                   'parallel/mesh.py', 'parallel/multihost.py',
                   'utils/trace_metrics.py'):
        assert pkg / module in sources
    for path in sources:
        bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
        assert not bad, '{0} imports {1}'.format(path, bad)


def test_trace_metrics_imports_no_jax_even_inside_a_function():
    """The JAX package's ``utils/trace_metrics.py`` imports jax inside
    ``traced_device_ms``, and the scan sees that import; the port's module
    imports torch and nothing forbidden, at module level or in a
    function."""
    jax_roots = set(_imported_roots(ROOT / 'fpl_plus_tpu' / 'utils' /
                                    'trace_metrics.py'))
    assert 'jax' in jax_roots and 'jax' not in _module_level_imports(
        ROOT / 'fpl_plus_tpu' / 'utils' / 'trace_metrics.py')
    roots = set(_imported_roots(ROOT / 'fpl_plus_torch' / 'utils' /
                                'trace_metrics.py'))
    assert 'torch' in roots
    assert not roots & set(FORBIDDEN), roots


def test_parallel_package_exports_the_jax_names_and_imports_no_jax():
    """``fpl_plus_torch.parallel`` exports the names of the JAX package's
    ``parallel/__init__.py`` (read from its source) and, imported alone in
    a fresh interpreter, loads no forbidden package."""
    jax_init = ast.parse((ROOT / 'fpl_plus_tpu' / 'parallel' /
                          '__init__.py').read_text())
    names = [ast.literal_eval(node.value) for node in jax_init.body
             if isinstance(node, ast.Assign)
             and node.targets[0].id == '__all__'][0]
    code = ('import sys\n'
            'import fpl_plus_torch.parallel as p\n'
            'import fpl_plus_torch.parallel.multihost\n'
            'print(sorted(p.__all__))\n'
            'print(sorted(m for m in sys.modules '
            'if m.split(".")[0] in {0!r}))\n').format(FORBIDDEN)
    out = subprocess.run([sys.executable, '-c', code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    exported, bad = out.stdout.strip().splitlines()[-2:]
    assert exported == str(sorted(names))
    assert bad == '[]'


def test_loader_worker_chain_imports_no_torch():
    """What a loader worker process imports (the forkserver's preload:
    the loader, the datasets and every transform) brings in no torch."""
    code = ('import sys\n'
            'import fpl_plus_torch.io.loader, fpl_plus_torch.io.dataset\n'
            'import fpl_plus_torch.transforms.trans_dict\n'
            'from fpl_plus_torch.io.loader import _PRELOAD\n'
            'for name in _PRELOAD: __import__(name)\n'
            'print(sorted(m for m in sys.modules if m.split(".")[0] in '
            '("torch", "jax", "triton")))\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'


def test_resolve_device_has_no_silent_cpu_fallback():
    assert resolve_device('cpu') == torch.device('cpu')
    if torch.cuda.is_available():
        assert resolve_device() == torch.device('cuda', 0)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device('cuda')
    with pytest.raises(ValueError, match='unsupported device'):
        resolve_device('meta')


# host packages the card's machine may lack: a module may use them only
# inside the function that needs them
LAZY = ('PIL', 'h5py', 'pandas')


def _module_level_imports(path):
    """Roots of the import statements that run when the module is
    imported: those outside every function body."""
    def walk(nodes):
        for node in nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            if isinstance(node, ast.Import):
                for alias in node.names:
                    yield alias.name.split('.')[0]
            elif isinstance(node, ast.ImportFrom) and node.module:
                yield node.module.split('.')[0]
            yield from walk(ast.iter_child_nodes(node))
    return set(walk(ast.parse(path.read_text(), str(path)).body))


def test_optional_host_packages_import_inside_functions():
    """PIL, h5py and pandas are imported inside functions only (the 2D
    image I/O of ``io/image_io.py`` imports PIL there)."""
    for path in _sources():
        bad = sorted(_module_level_imports(path) & set(LAZY))
        assert not bad, '{0} imports {1} at module level'.format(path, bad)
    image_io = (ROOT / 'fpl_plus_torch' / 'io' / 'image_io.py')
    assert 'PIL' in set(_imported_roots(image_io))
    assert 'PIL' not in _module_level_imports(image_io)
