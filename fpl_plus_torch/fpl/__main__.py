"""FPL+ pipeline tool CLI (host numpy and scipy; no device).

Replaces the reference's standalone scripts (data/get_pixel_weight.py,
"data/get image_weight.py", data/write_csv.py, data/preprocess_*.py) with
subcommands:

  python -m fpl_plus_torch.fpl pixel-weight  --pseudo-target DIR --pseudo-fake-source DIR --output DIR
  python -m fpl_plus_torch.fpl image-weight  --uncertainty NPY --output-csv CSV \
         --image-dir DIR --pseudo-label-dir DIR --pixel-weight-dir DIR
  python -m fpl_plus_torch.fpl write-csv     --image-dir DIR --output CSV [--label-dir DIR]
  python -m fpl_plus_torch.fpl split-csv     --input CSV --output CSV:COUNT [...] [--seed N]
  python -m fpl_plus_torch.fpl preprocess-vs-source IMG LAB OUT_IMG OUT_LAB
  python -m fpl_plus_torch.fpl preprocess-vs-target IMG OUT_IMG
  python -m fpl_plus_torch.fpl preprocess-bst       IMG LAB OUT_IMG OUT_LAB
"""
from __future__ import annotations

import argparse
import logging
import sys

from fpl_plus_torch.fpl.manifests import (create_image_label_csv,
                                          random_split_csv)
from fpl_plus_torch.fpl.weights import (compute_pixel_weights,
                                      write_image_weight_csv)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(prog='python -m fpl_plus_torch.fpl')
    sub = parser.add_subparsers(dest='cmd', required=True)

    p = sub.add_parser('pixel-weight')
    p.add_argument('--pseudo-target', required=True)
    p.add_argument('--pseudo-fake-source', required=True)
    p.add_argument('--output', required=True)

    p = sub.add_parser('image-weight')
    p.add_argument('--uncertainty', required=True)
    p.add_argument('--output-csv', required=True)
    p.add_argument('--image-dir', default='')
    p.add_argument('--pseudo-label-dir', required=True)
    p.add_argument('--pixel-weight-dir', required=True)

    p = sub.add_parser('write-csv')
    p.add_argument('--image-dir', required=True)
    p.add_argument('--output', required=True)
    p.add_argument('--label-dir', default=None)
    p.add_argument('--filter', default='')

    p = sub.add_parser('split-csv')
    p.add_argument('--input', required=True)
    p.add_argument('--output', action='append', required=True,
                   help='PATH:COUNT (COUNT=-1 for remainder), repeatable')
    p.add_argument('--seed', type=int, default=2022)

    p = sub.add_parser('preprocess-vs-source',
                       help='VS ceT1 fixed-physical-bbox crop '
                            '(reference data/preprocess_vs.py:63-98)')
    p.add_argument('image'), p.add_argument('label')
    p.add_argument('out_image'), p.add_argument('out_label')

    p = sub.add_parser('preprocess-vs-target',
                       help='VS hrT2 crop + 256x256 zoom '
                            '(preprocess_vs.py:100-135)')
    p.add_argument('image'), p.add_argument('out_image')

    p = sub.add_parser('preprocess-bst',
                       help='BraTS binarize+window+depth-crop '
                            '(data/preprocess_bst.py:35-49)')
    p.add_argument('image'), p.add_argument('label')
    p.add_argument('out_image'), p.add_argument('out_label')

    args = parser.parse_args(argv)
    if args.cmd == 'pixel-weight':
        compute_pixel_weights(args.pseudo_target, args.pseudo_fake_source,
                              args.output)
    elif args.cmd == 'image-weight':
        write_image_weight_csv(args.uncertainty, args.output_csv,
                               args.image_dir, args.pseudo_label_dir,
                               args.pixel_weight_dir)
    elif args.cmd == 'write-csv':
        n = create_image_label_csv(args.image_dir, args.output,
                                   label_dir=args.label_dir,
                                   name_filter=args.filter)
        logging.info('wrote %d rows', n)
    elif args.cmd == 'split-csv':
        outputs = []
        for spec in args.output:
            path, count = spec.rsplit(':', 1)
            outputs.append((path, int(count)))
        random_split_csv(args.input, outputs, args.seed)
    elif args.cmd == 'preprocess-vs-source':
        from fpl_plus_torch.fpl.preprocess import vs_source_crop
        vs_source_crop(args.image, args.label, args.out_image,
                       args.out_label)
    elif args.cmd == 'preprocess-vs-target':
        from fpl_plus_torch.fpl.preprocess import vs_target_crop
        vs_target_crop(args.image, args.out_image)
    elif args.cmd == 'preprocess-bst':
        from fpl_plus_torch.fpl.preprocess import preprocess_bst_case
        preprocess_bst_case(args.image, args.label, args.out_image,
                            args.out_label)
    return 0


if __name__ == '__main__':
    sys.exit(main())
