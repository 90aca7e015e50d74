"""Command-line entry points.

``python -m fpl_plus_torch.cli {train,test,inference} cfg [--device cpu]``
mirrors the FPL+ runner (PyMIC/pymic/net_run_dsbn/net_run.py:11-43): parse
and synchronize the config, set up file+stdout logging in
``ckpt_save_dir`` and run the stage agent. After ``train`` the test stage
runs, reading the checkpoint the training wrote through its pointer file;
after ``train`` and ``inference`` (which is the test stage) ``eva_main``
writes the reports (on the host) when the config has an ``[evaluation]``
section, as the JAX package's CLI does (``cli.py:139-147`` there). It runs
on the card (``cuda:0``) unless ``--device`` (or ``main(..., device=...)``)
names another device; without a card and without ``--device cpu`` it
raises.

``[dataset] task_type`` picks the agent: ``seg`` the segmentation agent,
``cls`` / ``cls_nexcl`` the classification agent, which runs the named
stage alone (no auto test stage and no ``eva_main``, as in the JAX
package's CLI).

``main_ssl`` / ``main_wsl`` / ``main_nll`` (``python -m fpl_plus_torch.cli
ssl ...`` / ``wsl ...`` / ``nll ...``, the reference's ``pymic_ssl`` /
``pymic_wsl`` / ``pymic_nll``) take the same arguments and run the agent of
``[semi_supervised_learning] ssl_method`` / ``[weakly_supervised_learning]
wsl_method`` / ``[noisy_label_learning] nll_method`` (an unknown method
raises ``ValueError``) through the same stages; the JAX package's paradigm
CLI runs the named stage alone. ``main_nll_clslsr`` (``... nll_clslsr
[stage] cfg``) runs the CLSLSR confidence-map stage: ``slsr_conf/`` maps
and the ``<train_csv>_clslsr.csv`` manifest.

``main_convert`` (``python -m fpl_plus_torch.cli convert
in/prefix_IT.ckpt cfg out/prefix_IT.pt``) turns a checkpoint the JAX
package wrote into a port checkpoint with its latest pointer
(``utils/convert.py``; no optimizer state, so a resume from it starts a
fresh optimizer); the JAX package's ``fpl_convert`` goes the other way.

``main_eval_seg`` (``python -m fpl_plus_torch.metrics cfg``) runs the
evaluation reports alone (the reference's ``pymic_eval_seg``) and
``main_eval_cls`` (``python -m fpl_plus_torch.metrics.cls_metrics cfg``)
the classification metrics (``pymic_eval_cls``); they need no device.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys

from fpl_plus_torch.agents.agent_cls import ClassificationAgent
from fpl_plus_torch.agents.agent_seg import SegmentationAgent
from fpl_plus_torch.agents.nll import NLLMethodDict
from fpl_plus_torch.agents.nll_clslsr import run_get_confidence_map
from fpl_plus_torch.agents.ssl import SSLMethodDict
from fpl_plus_torch.agents.wsl import WSLMethodDict
from fpl_plus_torch.config.parser import (logging_config, parse_config,
                                          synchronize_config)
from fpl_plus_torch.device import resolve_device
from fpl_plus_torch.metrics.cls_metrics import main_eval_cls  # noqa: F401
from fpl_plus_torch.metrics.evaluate import eva_main
from fpl_plus_torch.utils.convert import convert_jax_checkpoint
from fpl_plus_torch.utils.precision import apply_matmul_precision


def _setup_logging(log_path: str) -> None:
    os.makedirs(os.path.dirname(log_path) or '.', exist_ok=True)
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    for h in list(root.handlers):
        root.removeHandler(h)
        h.close()
    root.addHandler(logging.FileHandler(log_path, mode='a'))
    root.addHandler(logging.StreamHandler(sys.stdout))


def _run(argv, prog: str, agent_of, device=None) -> int:
    """Parse ``stage cfg [--device]``, run the stage with the agent class
    ``agent_of(config)`` gives, then the auto test stage and the reports."""
    argv = argv if argv is not None else sys.argv[1:]
    parser = argparse.ArgumentParser(prog=prog)
    parser.add_argument('stage', choices=('train', 'test', 'inference'))
    parser.add_argument('cfg')
    parser.add_argument('--device', default=None,
                        help='cuda[:i] (default cuda:0) or cpu')
    args = parser.parse_args(argv)
    if not os.path.isfile(args.cfg):
        raise ValueError('The config file does not exist: {0}'.format(
            args.cfg))
    dev = resolve_device(device if device is not None else args.device)
    config = synchronize_config(parse_config(args.cfg))
    agent_class = agent_of(config)
    apply_matmul_precision(config, args.stage)
    log_dir = config['training']['ckpt_save_dir']
    os.makedirs(log_dir, exist_ok=True)
    _setup_logging('{0}/log_{1}.txt'.format(log_dir, args.stage))
    logging_config(config)

    agent_class(config, args.stage, dev).run()
    if config['dataset'].get('task_type', 'seg') != 'seg':
        return 0
    if args.stage == 'train':
        # the auto test stage (reference net_run_dsbn/net_run.py:37-40)
        agent_class(config, 'test', dev).run()
    if args.stage != 'test' and 'evaluation' in config:
        eva_main(config)
    return 0


def _task_agent(config):
    task = config['dataset'].get('task_type', 'seg')
    if task == 'seg':
        return SegmentationAgent
    if task in ('cls', 'cls_nexcl'):
        return ClassificationAgent
    raise ValueError('Undefined task type {0}'.format(task))


def main(argv=None, device=None):
    return _run(argv, 'python -m fpl_plus_torch.cli', _task_agent, device)


def _method_agent(section: str, key: str, registry: dict):
    def agent_of(config):
        method = config[section][key]
        if method not in registry:
            raise ValueError('Undefined {0} method {1}'.format(section,
                                                               method))
        return registry[method]
    return agent_of


def main_ssl(argv=None, device=None):
    """pymic_ssl (reference net_run_ssl/ssl_main.py:23-48)."""
    return _run(argv, 'python -m fpl_plus_torch.cli ssl', _method_agent(
        'semi_supervised_learning', 'ssl_method', SSLMethodDict), device)


def main_wsl(argv=None, device=None):
    """pymic_wsl (reference net_run_wsl/wsl_main.py)."""
    return _run(argv, 'python -m fpl_plus_torch.cli wsl', _method_agent(
        'weakly_supervised_learning', 'wsl_method', WSLMethodDict), device)


def main_nll(argv=None, device=None):
    """pymic_nll (reference net_run_nll/nll_main.py)."""
    return _run(argv, 'python -m fpl_plus_torch.cli nll', _method_agent(
        'noisy_label_learning', 'nll_method', NLLMethodDict), device)


def main_nll_clslsr(argv=None, device=None):
    """The CLSLSR stage (reference net_run_nll/nll_clslsr.py:149-205):
    ``[stage] cfg [--device]``; a leading stage token is accepted and
    ignored, as the JAX package's CLI does."""
    argv = argv if argv is not None else sys.argv[1:]
    parser = argparse.ArgumentParser(
        prog='python -m fpl_plus_torch.cli nll_clslsr')
    parser.add_argument('args', nargs='+', metavar='[stage] cfg')
    parser.add_argument('--device', default=None,
                        help='cuda[:i] (default cuda:0) or cpu')
    args = parser.parse_args(argv)
    if len(args.args) > 2:
        parser.error('expected [stage] cfg, got {0}'.format(args.args))
    cfg = args.args[-1]
    if not os.path.isfile(cfg):
        raise ValueError('The config file does not exist: {0}'.format(cfg))
    dev = resolve_device(device if device is not None else args.device)
    config = synchronize_config(parse_config(cfg))
    apply_matmul_precision(config, 'test')
    log_dir = config['training']['ckpt_save_dir']
    os.makedirs(log_dir, exist_ok=True)
    _setup_logging('{0}/log_clslsr.txt'.format(log_dir))
    logging_config(config)
    run_get_confidence_map(config, dev)
    return 0


PARADIGM_MAINS = {'ssl': main_ssl, 'wsl': main_wsl, 'nll': main_nll,
                  'nll_clslsr': main_nll_clslsr}


def main_eval_seg(argv=None):
    """The evaluation reports of ``cfg`` (``eva_main``), host only."""
    argv = argv if argv is not None else sys.argv[1:]
    parser = argparse.ArgumentParser(prog='python -m fpl_plus_torch.metrics')
    parser.add_argument('cfg')
    args = parser.parse_args(argv)
    if not os.path.isfile(args.cfg):
        raise ValueError('The config file does not exist: {0}'.format(
            args.cfg))
    logging.basicConfig(level=logging.INFO)
    eva_main(parse_config(args.cfg))
    return 0


def main_convert(argv=None):
    """``in/prefix_IT.ckpt cfg out/prefix_IT.pt``: a JAX checkpoint of the
    cfg's ``[network]`` as a port checkpoint (host only)."""
    argv = argv if argv is not None else sys.argv[1:]
    parser = argparse.ArgumentParser(
        prog='python -m fpl_plus_torch.cli convert')
    parser.add_argument('jax_ckpt')
    parser.add_argument('cfg')
    parser.add_argument('out', help='{ckpt_dir}/{prefix}_{iteration}.pt')
    args = parser.parse_args(argv)
    for path in (args.jax_ckpt, args.cfg):
        if not os.path.isfile(path):
            raise ValueError('The file does not exist: {0}'.format(path))
    logging.basicConfig(level=logging.INFO)
    written = convert_jax_checkpoint(args.jax_ckpt, parse_config(args.cfg),
                                     args.out)
    logging.info('converted %s -> %s', args.jax_ckpt, written)
    return 0


def shell(argv) -> int:
    """``[ssl | wsl | nll | nll_clslsr] stage cfg [--device]`` or
    ``convert ckpt cfg out`` from the shell."""
    if argv and argv[0] in PARADIGM_MAINS:
        return PARADIGM_MAINS[argv[0]](argv[1:])
    if argv and argv[0] == 'convert':
        return main_convert(argv[1:])
    return main(argv)


if __name__ == '__main__':
    sys.exit(shell(sys.argv[1:]))
