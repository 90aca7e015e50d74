"""CSV-manifest dataset of the test stage.

Behavioural parity with the reference ``NiftyDataset``
(PyMIC/pymic/io/nifty_dataset.py:106-218) for image-only manifests: the
first ``modal_num`` columns name the image files (relative to ``root_dir``),
concatenated along the channel axis; ``names`` is the first of them. The
manifest is read with the ``csv`` module. Labels, pixel/image weights and
the other dataset variants belong to the training slice (ROADMAP.md).
"""
from __future__ import annotations

import csv

import numpy as np

from fpl_plus_torch.io.image_io import load_image_as_nd_array


class NiftyDataset:
    def __init__(self, root_dir: str, csv_file: str, modal_num: int = 1,
                 transform=None):
        self.root_dir = root_dir
        with open(csv_file, newline='') as f:
            rows = list(csv.reader(f))
        if not rows:
            raise ValueError('empty manifest {0}'.format(csv_file))
        self.columns = rows[0]
        self.rows = [r for r in rows[1:] if r]
        if modal_num > len(self.columns):
            raise ValueError('manifest {0} has {1} columns, modal_num is {2}'
                             .format(csv_file, len(self.columns), modal_num))
        self.modal_num = modal_num
        self.transform = transform

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx):
        names_list, image_list = [], []
        image_dict = None
        for i in range(self.modal_num):
            image_name = self.rows[idx][i]
            image_dict = load_image_as_nd_array(
                '{0}/{1}'.format(self.root_dir, image_name))
            names_list.append(image_name)
            image_list.append(image_dict['data_array'])
        image = np.asarray(np.concatenate(image_list, axis=0), np.float32)
        sample = {'image': image, 'names': names_list[0],
                  'origin': image_dict['origin'],
                  'spacing': image_dict['spacing'],
                  'direction': image_dict['direction']}
        if self.transform:
            sample = self.transform(sample)
        return sample
