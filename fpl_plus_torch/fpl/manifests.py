"""CSV-manifest writers (reference data/write_csv.py:10-148).

Parameterized versions of the reference's hardcoded helpers: image/label
pair manifests from a directory layout and seeded random train/valid
splits.
"""
from __future__ import annotations

import csv
import os
import random
from typing import List, Optional, Sequence, Tuple


def _write_rows(output_file: str, fields: Sequence[str],
                rows: List[Sequence]) -> None:
    os.makedirs(os.path.dirname(output_file) or '.', exist_ok=True)
    with open(output_file, 'w') as f:
        writer = csv.writer(f, delimiter=',', quotechar='"',
                            quoting=csv.QUOTE_MINIMAL)
        writer.writerow(fields)
        writer.writerows(rows)


def create_image_label_csv(image_dir: str, output_file: str,
                           label_dir: Optional[str] = None,
                           name_filter: str = '') -> int:
    """Pair every image in ``image_dir`` with the file of the same name
    in ``label_dir`` (default: ``image_dir``)."""
    names = sorted(n for n in os.listdir(image_dir) if name_filter in n)
    rows = [[os.path.join(image_dir, name),
             os.path.join(label_dir or image_dir, name)] for name in names]
    _write_rows(output_file, ['image', 'label'], rows)
    return len(rows)


def random_split_csv(input_file: str, outputs: Sequence[Tuple[str, int]],
                     seed: int = 2022) -> None:
    """Seeded random split of a manifest into parts
    (reference random_split_dataset, write_csv.py:60-100). ``outputs`` is a
    list of (path, count); the last count may be -1 = remainder."""
    with open(input_file) as f:
        lines = f.readlines()
    head, data = lines[0], lines[1:]
    random.Random(seed).shuffle(data)
    pos = 0
    for path, count in outputs:
        chunk = data[pos:] if count < 0 else data[pos:pos + count]
        pos += len(chunk)
        os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
        with open(path, 'w') as f:
            f.write(head)
            f.writelines(chunk)


def create_pair_csv(gt_names: Sequence[str], seg_names: Sequence[str],
                    output_file: str) -> None:
    """Ground-truth / segmentation pair CSV (columns ``gt``, ``seg``) for
    ``eva_main``."""
    if len(gt_names) != len(seg_names):
        raise ValueError('{0} ground truths, {1} segmentations'.format(
            len(gt_names), len(seg_names)))
    _write_rows(output_file, ['gt', 'seg'], list(zip(gt_names, seg_names)))
