"""``python -m fpl_plus_torch.metrics cfg``: the evaluation reports of a
config (``fpl_plus_torch.cli.main_eval_seg``)."""
import sys

from fpl_plus_torch.cli import main_eval_seg

if __name__ == '__main__':
    sys.exit(main_eval_seg())
