"""Checkpoint surgery on the port's ``.pt`` checkpoints (reference
PyMIC/pymic/util/model_operate.py:4-30, the JAX package's
``utils/model_operate.py``): renaming entries and N-way weight averaging.

Entries are addressed by their state-dict names, ``'.'``-joined (e.g.
``block0.conv.conv2d_1.weight``), where the JAX package joins flax paths
with ``'/'``. Both tools rewrite ``model_state_dict`` and keep the rest of
the first checkpoint (iteration, optimizer state) as it is.

``get_average_model``, as the JAX package's, averages the parameters and
keeps the first checkpoint's statistics (``running_mean``,
``running_var``, ``num_batches_tracked``): the JAX tool averages
``params`` and leaves ``batch_stats`` alone, so an average made there and
converted equals the average of the converted checkpoints made here.

    python -m fpl_plus_torch.utils.model_operate rename in.pt out.pt \\
        --from a.weight --to b.weight
    python -m fpl_plus_torch.utils.model_operate average a.pt b.pt \\
        --output mean.pt
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from fpl_plus_torch.engine import ckpt as ckpt_lib


def rename_model_variable(input_file: str, output_file: str,
                          input_var_list: Sequence[str],
                          output_var_list: Sequence[str]) -> None:
    """Rename the ``model_state_dict`` entries ``input_var_list`` to
    ``output_var_list`` (the order of the entries is kept)."""
    if len(input_var_list) != len(output_var_list):
        raise ValueError('{0} names to rename, {1} new names'.format(
            len(input_var_list), len(output_var_list)))
    payload = ckpt_lib.load_checkpoint(input_file)
    renames = dict(zip(input_var_list, output_var_list))
    sd = payload['model_state_dict']
    missing = sorted(set(renames) - set(sd))
    if missing:
        raise KeyError('{0} has no entries {1}'.format(input_file, missing))
    payload['model_state_dict'] = type(sd)(
        (renames.get(k, k), v) for k, v in sd.items())
    torch.save(payload, output_file)


def get_average_model(checkpoint_names: List[str], save_name: str) -> None:
    """Uniform weight averaging of checkpoints (the reference hardcodes
    3): the parameters averaged (``engine/ckpt.average_checkpoints``), the
    statistics and the rest from the first checkpoint."""
    payload = ckpt_lib.load_checkpoint(checkpoint_names[0])
    mean = ckpt_lib.average_checkpoints(checkpoint_names)
    sd = payload['model_state_dict']
    for key in sd:
        if not key.endswith(ckpt_lib.STATISTICS):
            sd[key] = mean[key]
    torch.save(payload, save_name)


def main(argv=None):
    """CLI for the reference's hardcoded-path ``__main__`` block
    (util/model_operate.py:35-47): ``rename`` and ``average``."""
    import argparse
    import sys
    ap = argparse.ArgumentParser(
        prog='python -m fpl_plus_torch.utils.model_operate')
    sub = ap.add_subparsers(dest='cmd', required=True)
    r = sub.add_parser('rename', help="rename state-dict entries ('.'-"
                                      'joined names)')
    r.add_argument('input_ckpt')
    r.add_argument('output_ckpt')
    r.add_argument('--from', dest='src', nargs='+', required=True)
    r.add_argument('--to', dest='dst', nargs='+', required=True)
    a = sub.add_parser('average', help='uniform N-way weight averaging')
    a.add_argument('checkpoints', nargs='+')
    a.add_argument('--output', required=True)
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
    if args.cmd == 'rename':
        if len(args.src) != len(args.dst):
            ap.error('--from and --to need the same length')
        rename_model_variable(args.input_ckpt, args.output_ckpt,
                              args.src, args.dst)
    else:
        get_average_model(args.checkpoints, args.output)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
