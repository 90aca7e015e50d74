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

``main_ssl`` / ``main_wsl`` (``python -m fpl_plus_torch.cli ssl ...`` /
``wsl ...``, the reference's ``pymic_ssl`` / ``pymic_wsl``) take the same
arguments and run the agent of ``[semi_supervised_learning] ssl_method`` /
``[weakly_supervised_learning] wsl_method`` (an unknown method raises
``ValueError``) through the same stages; the JAX package's paradigm CLI
runs the named stage alone.

``main_eval_seg`` (``python -m fpl_plus_torch.metrics cfg``) runs the
evaluation reports alone (the reference's ``pymic_eval_seg``); it needs no
device.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys

from fpl_plus_torch.agents.agent_seg import SegmentationAgent
from fpl_plus_torch.agents.ssl import SSLMethodDict
from fpl_plus_torch.agents.wsl import WSLMethodDict
from fpl_plus_torch.config.parser import (logging_config, parse_config,
                                          synchronize_config)
from fpl_plus_torch.device import resolve_device
from fpl_plus_torch.metrics.evaluate import eva_main
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
    task = config['dataset'].get('task_type', 'seg')
    if task != 'seg':
        raise NotImplementedError('task_type {0} is not yet ported'.format(
            task))
    agent_class = agent_of(config)
    apply_matmul_precision(config, args.stage)
    log_dir = config['training']['ckpt_save_dir']
    os.makedirs(log_dir, exist_ok=True)
    _setup_logging('{0}/log_{1}.txt'.format(log_dir, args.stage))
    logging_config(config)

    agent_class(config, args.stage, dev).run()
    if args.stage == 'train':
        # the auto test stage (reference net_run_dsbn/net_run.py:37-40)
        agent_class(config, 'test', dev).run()
    if args.stage != 'test' and 'evaluation' in config:
        eva_main(config)
    return 0


def main(argv=None, device=None):
    return _run(argv, 'python -m fpl_plus_torch.cli',
                lambda config: SegmentationAgent, device)


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


PARADIGM_MAINS = {'ssl': main_ssl, 'wsl': main_wsl}


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


def shell(argv) -> int:
    """``[ssl | wsl] stage cfg [--device]`` from the shell."""
    if argv and argv[0] in PARADIGM_MAINS:
        return PARADIGM_MAINS[argv[0]](argv[1:])
    return main(argv)


if __name__ == '__main__':
    sys.exit(shell(sys.argv[1:]))
