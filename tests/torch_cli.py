"""The port's CLI for the data-parallel CPU tests.

    python tests/torch_cli.py STAGE CFG
    python tests/torch_cli.py {ssl,wsl,nll,nll_clslsr} STAGE CFG
    python tests/torch_cli.py dryrun ROOT N

runs ``fpl_plus_torch.cli.main([STAGE, CFG], device='cpu')`` (or the
paradigm's main, ``main_ssl`` ...; or the dry run's four stages over N
ranks on a workspace under ROOT, ``fpl_plus_torch.dryrun._pipeline``,
printing its stage walls as the last line of JSON) with one torch thread
per process and ``torch.utils.tensorboard`` blocked (it pulls
TensorFlow, seconds per process). The CLI starts the ranks the config's
mesh asks for; they re-import this file, so the same holds in each of
them. It imports ``fpl_plus_torch`` and nothing else of the repo.
"""
import sys

sys.modules['torch.utils.tensorboard'] = None   # noqa: E402

import torch  # noqa: E402

from fpl_plus_torch.cli import PARADIGM_MAINS, main  # noqa: E402

torch.set_num_threads(1)

if __name__ == '__main__':
    if sys.argv[1] == 'dryrun':
        import json
        from fpl_plus_torch.dryrun import _pipeline
        out = _pipeline(sys.argv[2], int(sys.argv[3]), 'cpu')
        print(json.dumps(out['walls']))
        sys.exit(0)
    if sys.argv[1] in PARADIGM_MAINS:
        sys.exit(PARADIGM_MAINS[sys.argv[1]](sys.argv[2:4], device='cpu'))
    sys.exit(main(sys.argv[1:3], device='cpu'))
