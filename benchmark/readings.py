"""The readings a cell's limits are set from, on the card, in one process:

    python3 benchmark/readings.py --workload <cell> --seeds 1 2 3 ... \
        [--control] [--seconds 3]

runs the cell once per seed with a short window (the cell's own load and
sizes) and prints one JSON line per seed with the compared numbers. With
``--control`` the cell's control (its limits file's ``control``: the
program's own path one precision lower, or the reference at the next
lower precision in the program's place) runs instead, and has to come out
not correct; ``--fault`` breaks the timed path underneath (a training
cell's faults set upper readings too). The benchmark's own runs never run
the control or a fault.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog='benchmark/readings.py')
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', type=int, nargs='+', required=True)
    parser.add_argument('--seconds', type=float, default=3.0)
    parser.add_argument('--control', action='store_true')
    parser.add_argument('--fault', choices=('answer', 'unchanged',
                                            'half_batch'),
                        help='break the timed path underneath (a fault\'s '
                             'reading for a training cell\'s limits)')
    args = parser.parse_args(argv)
    import torch
    from benchmark.harness import cell
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 2
    spec = cell.load_cell(args.workload)
    control = spec['limits']['control'] if args.control else None
    try:
        for seed in args.seeds:
            result = cell.run_cell(args.workload, seed, args.seconds, False,
                                   control=control, fault=args.fault,
                                   spec=dict(spec))
            print(json.dumps({'seed': seed, 'control': args.control,
                              'fault': args.fault,
                              'correct': result['correct'],
                              'attempted': result['attempted'],
                              'checks': result['checks']}), flush=True)
    finally:
        from benchmark.run import stop_helpers
        stop_helpers()
    return 0


if __name__ == '__main__':
    sys.exit(main())
