"""CSV-manifest dataset on the sample-dict contract.

Behavioural parity with the reference ``NiftyDataset``
(PyMIC/pymic/io/nifty_dataset.py:106-218) and the JAX package's
``io/dataset.py``: the first ``modal_num`` columns name the image files
(relative to ``root_dir``), concatenated along the channel axis; ``names``
is the first of them. ``with_label`` adds the ``label`` column (int32).
The FPL+ weight columns: ``image_weight`` (a float per row) and
``pixel_weight`` (a map), composed by ``compose_weight``
(``pixel_weight[pixel_weight < 1] = 0`` then ``*= image_weight``, reference
``set_weight_`` :165-168); an ``image_weight`` without ``pixel_weight``
gives an all-ones map; an unreadable pixel-weight file falls back to a
constant 0.5 map (:197-203), logged. An ``image1`` column (the fake-source
translation that the dual-consistency training feeds through bank 0) loads
as ``image1``; when its file cannot be read, ``image1`` is the image
itself, as in the JAX package. The manifest is read with the ``csv``
module.

Two byte-bounded LRU caches serve the training stages, which revisit the
same rows every epoch (``cache_bytes`` > 0):

* decoded volumes by path (a NIfTI is decoded once; items get copies, so
  in-place transforms cannot corrupt the cache);
* the sample after the chain's longest deterministic prefix
  (``cache_safe()`` transforms, e.g. Normalize and Pad over the whole
  volume), by item index, with the first random transform's ``precompute``
  stash (RandomCrop's foreground box). Cache-safe transforms draw no random
  numbers, so the random tail sees the same inputs and the same random
  stream as without the cache: the samples are identical.
"""
from __future__ import annotations

import csv
import logging
from collections import OrderedDict

import numpy as np

from fpl_plus_torch.io.image_io import load_image_as_nd_array


def _nbytes(sample: dict) -> int:
    return sum(int(v.nbytes) for v in sample.values()
               if isinstance(v, np.ndarray))


def _copy_sample(sample: dict) -> dict:
    """Shallow dict copy with ndarray values copied: transforms mutate
    arrays in place, so cached samples are exchanged by copy only."""
    return {k: (v.copy() if isinstance(v, np.ndarray) else v)
            for k, v in sample.items()}


class _LRU:
    """Byte-bounded LRU of sample-like dicts (ndarray values count)."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self.used = 0
        self.store = OrderedDict()

    def get(self, key):
        entry = self.store.get(key)
        if entry is None:
            return None
        self.store.move_to_end(key)
        return _copy_sample(entry)

    def put(self, key, entry: dict) -> None:
        nbytes = _nbytes(entry)
        if key in self.store or nbytes > self.max_bytes:
            return
        while self.used + nbytes > self.max_bytes and self.store:
            _, old = self.store.popitem(last=False)
            self.used -= _nbytes(old)
        self.store[key] = _copy_sample(entry)
        self.used += nbytes


class NiftyDataset:
    def __init__(self, root_dir: str, csv_file: str, modal_num: int = 1,
                 with_label: bool = False, transform=None,
                 cache_bytes: int = 0, transform_cache: bool = True):
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
        self.with_label = with_label
        self.transform = transform
        keys = self.columns
        self.label_idx = keys.index('label') if 'label' in keys else None
        if with_label and self.label_idx is None:
            raise ValueError('manifest {0} has no label column'.format(
                csv_file))
        self.image_weight_idx = (keys.index('image_weight')
                                 if 'image_weight' in keys else None)
        self.pixel_weight_idx = (keys.index('pixel_weight')
                                 if 'pixel_weight' in keys else None)
        self.image1_idx = keys.index('image1') if 'image1' in keys else None
        self._volumes = _LRU(cache_bytes) if cache_bytes else None
        # the deterministic prefix of the chain, cached per item
        self._prefix = self._suffix = self._samples = None
        tlist = getattr(transform, 'transforms', None) or []
        n_det = 0
        while n_det < len(tlist) and tlist[n_det].cache_safe():
            n_det += 1
        if cache_bytes and transform_cache and n_det:
            self._prefix, self._suffix = tlist[:n_det], tlist[n_det:]
            self._samples = _LRU(cache_bytes)

    def __len__(self):
        return len(self.rows)

    def _load_image(self, name: str) -> dict:
        path = '{0}/{1}'.format(self.root_dir, name)
        if self._volumes is None:
            return load_image_as_nd_array(path)
        entry = self._volumes.get(path)
        if entry is None:
            entry = load_image_as_nd_array(path)
            self._volumes.put(path, entry)
        return entry

    def _load_array(self, idx: int, col: int, dtype) -> np.ndarray:
        return np.asarray(self._load_image(self.rows[idx][col])['data_array'],
                          dtype)

    @staticmethod
    def compose_weight(image_weight, pixel_weight):
        """FPL+ weight composition (reference set_weight_,
        nifty_dataset.py:165-168)."""
        pixel_weight = np.where(pixel_weight < 1, 0.0, pixel_weight)
        return (pixel_weight * image_weight).astype(np.float32)

    def _raw_sample(self, idx) -> dict:
        """The untransformed sample dict (decode and weight composition)."""
        names_list, image_list = [], []
        image_dict = None
        for i in range(self.modal_num):
            image_name = self.rows[idx][i]
            image_dict = self._load_image(image_name)
            names_list.append(image_name)
            image_list.append(image_dict['data_array'])
        image = np.asarray(np.concatenate(image_list, axis=0), np.float32)
        sample = {'image': image, 'names': names_list[0],
                  'origin': image_dict['origin'],
                  'spacing': image_dict['spacing'],
                  'direction': image_dict['direction']}
        if self.with_label:
            sample['label'] = self._load_array(idx, self.label_idx, np.int32)
            if image.shape[1:] != sample['label'].shape[1:]:
                raise ValueError('label shape {0} != image shape {1}'.format(
                    sample['label'].shape[1:], image.shape[1:]))
        if self.image_weight_idx is not None:
            sample['image_weight'] = np.float32(
                self.rows[idx][self.image_weight_idx])
            if self.pixel_weight_idx is None:
                sample['pixel_weight'] = self.compose_weight(
                    sample['image_weight'], np.ones_like(image))
        if self.pixel_weight_idx is not None:
            try:
                pw = self._load_array(idx, self.pixel_weight_idx, np.float32)
                sample['pixel_weight'] = self.compose_weight(
                    sample.get('image_weight', np.float32(1.0)), pw)
            except (OSError, ValueError, KeyError):
                logging.warning(
                    'pixel weight unreadable for item %d (%s); falling back '
                    'to a constant 0.5 map (reference nifty_dataset.py:'
                    '197-203)', idx, self.rows[idx][self.pixel_weight_idx])
                sample['pixel_weight'] = np.ones_like(image) * 0.5
            if image.shape[1:] != sample['pixel_weight'].shape[1:]:
                raise ValueError('pixel weight shape {0} != image shape {1}'
                                 .format(sample['pixel_weight'].shape[1:],
                                         image.shape[1:]))
        if self.image1_idx is not None:
            try:
                sample['image1'] = self._load_array(idx, self.image1_idx,
                                                    np.float32)
            except (OSError, ValueError, KeyError):
                logging.warning('image1 unreadable for item %d (%s); using '
                                'the image', idx,
                                self.rows[idx][self.image1_idx])
                sample['image1'] = image
        return sample

    def __getitem__(self, idx):
        if self._samples is None:
            sample = self._raw_sample(idx)
            return self.transform(sample) if self.transform else sample
        sample = self._samples.get(idx)
        if sample is None:
            sample = self._raw_sample(idx)
            for t in self._prefix:
                sample = t(sample)
            if self._suffix:
                # only the first random transform sees the post-prefix
                # sample at call time, so only its stash stays valid
                sample = self._suffix[0].precompute(sample)
            self._samples.put(idx, sample)
        for t in self._suffix:
            sample = t(sample)
        return sample
