"""PyTorch port, the public surface: every public name of the JAX package
is in the port, or listed here with a reason.

The JAX package (``fpl_plus_tpu/**/*.py`` and ``__graft_entry__.py``) is
read by AST, with no JAX import, and so is the port. Each JAX module's
public top-level names (functions, classes, assignments, the UPPERCASE
constants among them) and the public methods of its public classes must
meet one of these conditions:

* defined in the port's counterpart module, the same relative path under
  ``fpl_plus_torch/`` (``__graft_entry__.py`` maps to
  ``fpl_plus_torch/dryrun.py``); a name bound by an import there counts;
* a method: reached through the port class's bases within the port
  (the class may be imported into the counterpart module);
* listed in ``NOT_PORTED`` with the reason, or in ``MOVED`` with the
  port's module that defines it.

A table entry the port no longer needs, or one that names no JAX public
name, fails too, so the tables stay what ROADMAP.md section 1 lists.
"""
import ast
import glob
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRY = '__graft_entry__.py'

_JAX_STEP = ('a JAX program helper: the port\'s step classes '
             '(engine/train.py JointTrainStep, AlternatingTrainStep, '
             'DualConsistencyStep; the paradigm steps) replace it')
_AGENT_STEP = ('the agents\' JAX step builders and batch assembly: the port '
               'builds its step in _build_step and its batches in '
               '_train_batches')
_FLAX = ('a flax module of the JAX networks: the port\'s torch modules name '
         'their submodules after its scopes (utils/convert.py '
         'state_dict_from_flax)')
_CAST = 'a JAX pytree cast: the port casts modules and uses autocast'
_TORCH_CONVERT = ('utils/torch_convert.py turns reference .pt into JAX '
                  'variables: the port loads the reference layout directly, '
                  'and cli convert goes the other way')
_JAXCACHE = ('utils/jaxcache.py hardens the JAX compile cache: torch\'s '
             'eager kernels and the Triton cache (build/triton) need none')

NOT_PORTED = {
    'fpl_plus_tpu/agents/agent_cls.py:to_channels_last':
        'the port keeps channels-first tensors',
    'fpl_plus_tpu/agents/agent_seg.py:to_channels_last':
        'the port keeps channels-first tensors',
    'fpl_plus_tpu/agents/agent_seg.py:SegmentationAgent.build_train_step':
        _AGENT_STEP,
    'fpl_plus_tpu/agents/agent_seg.py:SegmentationAgent.init_extra_state':
        'a TrainState extra slot of JAX: the port keeps the paradigm state '
        '(teachers, queues) on the agent and its step',
    'fpl_plus_tpu/agents/agent_seg.py:SegmentationAgent.next_train_batches':
        _AGENT_STEP,
    'fpl_plus_tpu/agents/nll.py:NLLCoTeaching.build_train_step': _AGENT_STEP,
    'fpl_plus_tpu/agents/nll.py:NLLTriNet.build_train_step': _AGENT_STEP,
    'fpl_plus_tpu/agents/nll.py:NLLDAST.next_train_batches': _AGENT_STEP,
    'fpl_plus_tpu/agents/nll.py:NLLDAST.build_train_step': _AGENT_STEP,
    'fpl_plus_tpu/agents/ssl.py:SSLSegAgent.next_train_batches': _AGENT_STEP,
    'fpl_plus_tpu/agents/ssl.py:SSLEntropyMinimization.build_train_step':
        _AGENT_STEP,
    'fpl_plus_tpu/agents/ssl.py:SSLMeanTeacher.build_train_step':
        _AGENT_STEP,
    'fpl_plus_tpu/agents/ssl.py:SSLUAMT.build_train_step': _AGENT_STEP,
    'fpl_plus_tpu/agents/ssl.py:SSLCCT.build_train_step': _AGENT_STEP,
    'fpl_plus_tpu/agents/ssl.py:SSLCPS.build_train_step': _AGENT_STEP,
    'fpl_plus_tpu/agents/ssl.py:SSLURPC.build_train_step': _AGENT_STEP,
    'fpl_plus_tpu/agents/wsl.py:WSLEntropyMinimization.build_train_step':
        _AGENT_STEP,
    'fpl_plus_tpu/agents/wsl.py:WSLTotalVariation.build_train_step':
        _AGENT_STEP,
    'fpl_plus_tpu/agents/wsl.py:WSLMumfordShah.build_train_step':
        _AGENT_STEP,
    'fpl_plus_tpu/agents/wsl.py:WSLGatedCRF.build_train_step': _AGENT_STEP,
    'fpl_plus_tpu/agents/wsl.py:WSLUSTM.next_train_batches': _AGENT_STEP,
    'fpl_plus_tpu/agents/wsl.py:WSLUSTM.build_train_step': _AGENT_STEP,
    'fpl_plus_tpu/agents/wsl.py:WSLDMPLS.build_train_step': _AGENT_STEP,
    'fpl_plus_tpu/engine/infer.py:GroupedMCPredictor':
        'engine/infer.py PassFold replaces it (a group predictor of '
        'dropout generators)',
    'fpl_plus_tpu/engine/optim.py:RpropState':
        'the optax rprop\'s state: the port uses torch.optim.Rprop',
    'fpl_plus_tpu/engine/optim.py:rprop':
        'an optax rprop: the port uses torch.optim.Rprop',
    'fpl_plus_tpu/engine/train.py:donation_safe': _JAX_STEP,
    'fpl_plus_tpu/engine/train.py:jit_train_step': _JAX_STEP,
    'fpl_plus_tpu/engine/train.py:TrainState': _JAX_STEP,
    'fpl_plus_tpu/engine/train.py:create_train_state': _JAX_STEP,
    'fpl_plus_tpu/engine/train.py:make_train_step': _JAX_STEP,
    'fpl_plus_tpu/engine/train.py:make_dual_consistency_step': _JAX_STEP,
    'fpl_plus_tpu/engine/train.py:make_eval_step': _JAX_STEP,
    'fpl_plus_tpu/losses/util.py:dice_weight_loss':
        'unused in the JAX package',
    'fpl_plus_tpu/models/common.py:DepthSliceConv':
        'a JAX program helper (a depth-sliced conv for XLA): torch\'s '
        'Conv3d serves',
    'fpl_plus_tpu/models/common.py:DepthSliceConvTranspose':
        'a JAX program helper (a depth-sliced transposed conv for XLA): '
        'torch\'s ConvTranspose3d serves',
    'fpl_plus_tpu/models/common.py:kaiming_normal_conv':
        'a flax initializer: the port initialises with torch.nn.init',
    'fpl_plus_tpu/models/common.py:normal_init':
        'a flax initializer: the port initialises with torch.nn.init',
    'fpl_plus_tpu/models/registry.py:init_network':
        'a JAX program helper: a torch module holds its weights when built',
    'fpl_plus_tpu/models/unet2d.py:ConvBlock2D': _FLAX,
    'fpl_plus_tpu/models/unet2d.py:UpBlock2D': _FLAX,
    'fpl_plus_tpu/models/unet3d.py:ConvBlock3D': _FLAX,
    'fpl_plus_tpu/models/unet3d.py:UpBlock3D': _FLAX,
    'fpl_plus_tpu/native/__init__.py:connected_components':
        'scipy.ndimage.label serves (the same sizes and raster-order ties)',
    'fpl_plus_tpu/utils/precision.py:cast_float_tree': _CAST,
    'fpl_plus_tpu/utils/precision.py:cast_apply_fn': _CAST,
    'fpl_plus_tpu/utils/precision.py:cast_infer_variables': _CAST,
    'fpl_plus_tpu/utils/jaxcache.py:cpu_microarch_tag': _JAXCACHE,
    'fpl_plus_tpu/utils/jaxcache.py:harden_compilation_cache': _JAXCACHE,
    'fpl_plus_tpu/utils/torch_convert.py:convert_unet2d5_dsbn':
        _TORCH_CONVERT,
    'fpl_plus_tpu/utils/torch_convert.py:convert_torchvision_resnet18':
        _TORCH_CONVERT,
    'fpl_plus_tpu/utils/torch_convert.py:convert_torchvision_vgg16':
        _TORCH_CONVERT,
    'fpl_plus_tpu/utils/torch_convert.py:convert_torchvision_mobilenetv2':
        _TORCH_CONVERT,
    'fpl_plus_tpu/utils/torch_convert.py:CLS_CONVERTERS': _TORCH_CONVERT,
    'fpl_plus_tpu/utils/torch_convert.py:load_torchvision_pretrained':
        _TORCH_CONVERT + ' (models/cls_nets.py load_pretrained loads a '
        'torchvision .pth)',
    'fpl_plus_tpu/utils/torch_convert.py:transplant_params': _TORCH_CONVERT,
    'fpl_plus_tpu/utils/torch_convert.py:convert_to_reference_state_dict':
        _TORCH_CONVERT + ' (utils/convert.py state_dict_from_jax is the '
        'port\'s direction)',
    'fpl_plus_tpu/utils/torch_convert.py:convert_reference_checkpoint':
        _TORCH_CONVERT,
}

MOVED = {
    'fpl_plus_tpu/agents/agent_abstract.py:Compose':
        'fpl_plus_torch/transforms/trans_dict.py',
    'fpl_plus_tpu/agents/agent_seg.py:SegmentationAgent.grad_accum_steps':
        'fpl_plus_torch/agents/agent_seg.py',
    'fpl_plus_tpu/ops/pallas_fused.py:dsbn_prelu':
        'fpl_plus_torch/ops/dsbn_prelu.py',
    'fpl_plus_tpu/ops/pallas_fused.py:dsbn_prelu_reference':
        'fpl_plus_torch/ops/dsbn_prelu.py',
}

_TREES = {}


def _index(rel):
    """``(names bound at top level, {imported name: (module, name)},
    {class: (base names, names in the body)})`` of a file of the repo."""
    if rel not in _TREES:
        with open(os.path.join(ROOT, rel)) as f:
            tree = ast.parse(f.read())
        bound, imports, classes = set(), {}, {}
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                bound.add(node.name)
            if isinstance(node, ast.ClassDef):
                body = {n.name for n in node.body if isinstance(
                    n, (ast.FunctionDef, ast.AsyncFunctionDef))}
                body |= {t.id for n in node.body if isinstance(n, ast.Assign)
                         for t in n.targets if isinstance(t, ast.Name)}
                classes[node.name] = ([b.id for b in node.bases
                                       if isinstance(b, ast.Name)], body)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                bound |= {n.id for t in targets for n in ast.walk(t)
                          if isinstance(n, ast.Name)}
            elif isinstance(node, ast.ImportFrom):
                for a in node.names:
                    bound.add(a.asname or a.name)
                    imports[a.asname or a.name] = (node.module, a.name)
            elif isinstance(node, ast.Import):
                bound |= {(a.asname or a.name).split('.')[0]
                          for a in node.names}
        _TREES[rel] = bound, imports, classes
    return _TREES[rel]


def _file_of(module):
    rel = module.replace('.', '/')
    if os.path.isdir(os.path.join(ROOT, rel)):
        return rel + '/__init__.py'
    return rel + '.py'


def _has_method(rel, cls, method):
    """``cls`` of the port file ``rel`` (defined there or imported from the
    port) has ``method`` in its body or its bases' within the port."""
    _, imports, classes = _index(rel)
    if cls not in classes:
        module, name = imports.get(cls, ('', ''))
        return (module.startswith('fpl_plus_torch')
                and _has_method(_file_of(module), name, method))
    bases, body = classes[cls]
    return method in body or any(_has_method(rel, b, method) for b in bases)


def _public(rel):
    """The public names of a JAX file: top-level names and
    ``Class.method`` of its public classes."""
    with open(os.path.join(ROOT, rel)) as f:
        tree = ast.parse(f.read())
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if node.name.startswith('_'):
                continue
            names.append(node.name)
            if isinstance(node, ast.ClassDef):
                names += ['{0}.{1}'.format(node.name, n.name)
                          for n in node.body
                          if isinstance(n, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))
                          and not n.name.startswith('_')]
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names += [n.id for t in targets for n in ast.walk(t)
                      if isinstance(n, ast.Name) and not n.id.startswith('_')]
    return names


def _counterpart(rel):
    if rel == ENTRY:
        return 'fpl_plus_torch/dryrun.py'
    return 'fpl_plus_torch' + rel[len('fpl_plus_tpu'):]


def _in_port(port_rel, name):
    if not os.path.isfile(os.path.join(ROOT, port_rel)):
        return False
    if '.' in name:
        return _has_method(port_rel, *name.split('.'))
    return name in _index(port_rel)[0]


JAX_FILES = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, 'fpl_plus_tpu', '**', '*.py'), recursive=True)) + [
        ENTRY]


@pytest.mark.parametrize('rel', JAX_FILES)
def test_every_public_jax_name_is_ported_or_listed(rel):
    missing = []
    for name in _public(rel):
        key = '{0}:{1}'.format(rel, name)
        if key in NOT_PORTED:
            continue
        if key in MOVED:
            assert _in_port(MOVED[key], name.split('.')[-1]), key
            continue
        if not _in_port(_counterpart(rel), name):
            missing.append(name)
    assert not missing, ('{0}: not in {1}, nor in NOT_PORTED or MOVED: {2}'
                         .format(rel, _counterpart(rel), missing))


def test_tables_name_jax_names_the_port_still_lacks():
    """Each entry names a public name of the JAX package that the port's
    counterpart does not define (else the entry has gone stale), and each
    reason or location is given."""
    for key, value in list(NOT_PORTED.items()) + list(MOVED.items()):
        rel, name = key.split(':')
        assert name in _public(rel), key
        assert not _in_port(_counterpart(rel), name), key
        assert value, key
    assert not set(NOT_PORTED) & set(MOVED)
