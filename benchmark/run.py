"""One run of one benchmark cell on the card this process is started on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

prints the numbers compared with the reference as the last lines of
standard error and one JSON result line as the last line of standard
output. It exits with another code than 0, and prints no result, when
there is no CUDA device or fewer than the cell asks for, or when the run
fails (the program missing, a trace that lost events, a module of the JAX
package loaded).
"""
import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def stop_helpers():
    """Stop the helper processes that multiprocessing starts for the
    program's loader pools (the forkserver and the resource tracker) and
    wait for them."""
    from multiprocessing import forkserver, resource_tracker
    for helper in (forkserver._forkserver, resource_tracker._resource_tracker):
        stop = getattr(helper, '_stop', None)
        if stop is not None:
            stop()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog='benchmark/run.py')
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    import torch
    from benchmark.harness import cell
    spec = cell.load_cell(args.workload)
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 2
    if torch.cuda.device_count() < spec['cell']['chips']:
        print('the cell needs {0} cards, {1} present'.format(
            spec['cell']['chips'], torch.cuda.device_count()),
            file=sys.stderr)
        return 2
    cell.T0[0] = START
    try:
        result = cell.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), spec=spec)
    finally:
        stop_helpers()
    for name, c in result['checks'].items():
        print('{0} {1!r} limit {2!r}'.format(name, c['value'], c['limit']),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
