"""The traffic generator: seeded volumes, labels, manifests and the run's
config file, in a workspace directory under the temporary directory.

Everything a cell sends is drawn from the seed and the parameters of its
traffic file, so the same seed gives the same files. Volumes are
MR-like: a smooth field (a coarse normal grid, trilinearly upsampled),
a bright ellipsoid (the tumour, the label's foreground) and voxel noise,
scaled to a scanner's integer range and stored as gzip-compressed int16
NIfTI, as MR volumes are commonly stored.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.harness import nifti

SPACING = (0.41015625, 0.41015625, 1.5)      # x, y, z in mm, exact in f32
ORIGIN = (52.5, 32.8125, -30.0)


def make_volume(rng: np.random.Generator, shape, gen: dict):
    """``(image int16, label uint8)`` of ``shape`` [D, H, W]."""
    coarse = [max(2, s // gen['coarse_every']) for s in shape]
    field = torch.from_numpy(rng.standard_normal(coarse).astype(np.float32))
    field = F.interpolate(field[None, None], size=tuple(shape),
                          mode='trilinear', align_corners=False)[0, 0]
    image = gen['base'] + gen['field_scale'] * field.numpy()
    grids = np.ogrid[tuple(slice(0, s) for s in shape)]
    centre = [rng.uniform(0.3 * s, 0.7 * s) for s in shape]
    radii = [rng.uniform(lo * s, hi * s) for s, (lo, hi)
             in zip(shape, gen['tumour_radius'])]
    r2 = sum(((g - c) / r) ** 2 for g, c, r in zip(grids, centre, radii))
    label = (r2 <= 1.0).astype(np.uint8)
    image = image + gen['tumour_gain'] * label
    image = image + gen['noise'] * rng.standard_normal(shape,
                                                       dtype=np.float32)
    image = np.clip(np.rint(image * gen['scale']), 0, 32767)
    return image.astype(np.int16), label


class Workspace:
    """A directory of one run's files; ``close()`` removes it."""

    def __init__(self, seed: int, traffic: dict):
        self.root = tempfile.mkdtemp(prefix='fplx_bench_')
        self.seed = int(seed)
        self.traffic = traffic
        self.sources: Dict[str, str] = {}     # row name -> its volume

    def close(self):
        shutil.rmtree(self.root, ignore_errors=True)

    def path(self, *parts) -> str:
        return os.path.join(self.root, *parts)

    def write_volumes(self, domain: int, count: int, gain_shift: float,
                      with_labels: bool) -> List[str]:
        """``count`` volumes of domain ``domain`` (its own seeded stream);
        returns their names relative to the root
        (``d<domain>/img/vol_XX.nii.gz``)."""
        t = self.traffic
        gen = dict(t['generator'])
        gen['base'] = gen['base'] + gain_shift
        rng = np.random.default_rng([self.seed, 11, domain])
        domain = 'd{0}'.format(domain)
        os.makedirs(self.path(domain, 'img'), exist_ok=True)
        if with_labels:
            os.makedirs(self.path(domain, 'lab'), exist_ok=True)
        names = []
        for k in range(count):
            image, label = make_volume(rng, t['volume_shape'], gen)
            name = '{0}/img/vol_{1:02d}.nii.gz'.format(domain, k)
            nifti.write(self.path(name), image, SPACING, ORIGIN)
            if with_labels:
                nifti.write(self.path(domain, 'lab',
                                      'vol_{0:02d}.nii.gz'.format(k)),
                            label, SPACING, ORIGIN)
            names.append(name)
        return names

    def rows(self, tag: str, sources: List[str], count: int,
             rng: np.random.Generator) -> List[str]:
        """``count`` manifest rows named ``rows/<tag>_XXXXX.nii.gz``,
        symbolic links to ``sources`` in cycles, each cycle in a seeded
        order: every row is its own output file."""
        os.makedirs(self.path('rows'), exist_ok=True)
        order = []
        while len(order) < count:
            order.extend(rng.permutation(len(sources)).tolist())
        names = []
        for i in range(count):
            name = 'rows/{0}_{1:05d}.nii.gz'.format(tag, i)
            os.symlink(os.path.relpath(self.path(sources[order[i]]),
                                       self.path('rows')), self.path(name))
            names.append(name)
        self.sources.update(zip(names, (sources[o] for o in order[:count])))
        return names

    def manifest(self, name: str, rows: List[str], labels=None) -> str:
        path = self.path(name)
        with open(path, 'w') as f:
            f.write('image,label\n' if labels else 'image\n')
            for i, r in enumerate(rows):
                f.write(r + (',' + labels[i] if labels else '') + '\n')
        return path


def _ini_value(v) -> str:
    if isinstance(v, bool):
        return 'True' if v else 'False'
    if isinstance(v, (list, tuple)):
        return '[' + ', '.join(_ini_value(x) for x in v) + ']'
    if v is None:
        return 'None'
    return str(v)


def write_cfg(path: str, sections: Dict[str, dict]) -> str:
    """The program's INI config file from ``{section: {key: value}}``."""
    with open(path, 'w') as f:
        for section, entries in sections.items():
            f.write('[{0}]\n'.format(section))
            for k, v in entries.items():
                f.write('{0} = {1}\n'.format(k, _ini_value(v)))
            f.write('\n')
    return path


def merged(config: dict, *overrides: dict) -> Dict[str, dict]:
    """The config file's sections with ``overrides`` applied in order."""
    out = {s: dict(config[s]) for s in ('dataset', 'network', 'training',
                                         'testing')}
    for o in overrides:
        for section, entries in (o or {}).items():
            out.setdefault(section, {}).update(entries)
    return out


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
