"""The raster-scan distance transform of the evaluation metrics, in C++
(``raster_scan.cpp``) bound with ctypes, and its plain numpy version.

``raster_scan_distance`` builds the library with ``g++ -O3 -shared -fPIC``
at first use, into ``build/native/`` of the checkout (named by a hash of the
source and the flags, so an edit rebuilds), and raises when the build or the
load fails: the plain version is a Python loop over every voxel, hours at a
40x160x272 volume, so nothing falls back to it. ``raster_scan_reference``
is that loop, for tests at small sizes.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_SOURCE = Path(__file__).resolve().with_name('raster_scan.cpp')
_BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'native'
_CXX_FLAGS = ('-O3', '-std=c++17', '-shared', '-fPIC')


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build (once per source and flags) and load the library."""
    src = _SOURCE.read_bytes()
    tag = hashlib.sha1(src + ' '.join(_CXX_FLAGS).encode()).hexdigest()[:12]
    lib_path = _BUILD_DIR / 'libraster_scan-{0}.so'.format(tag)
    if not lib_path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # concurrent builds (test workers) each write their own file and
        # rename it into place
        tmp = lib_path.with_suffix('.{0}.tmp'.format(os.getpid()))
        cmd = ['g++', *_CXX_FLAGS, str(_SOURCE), '-o', str(tmp)]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=300)
        except OSError as exc:
            raise RuntimeError('cannot run g++ to build {0}: {1}'.format(
                _SOURCE.name, exc)) from exc
        if res.returncode != 0:
            raise RuntimeError('building {0} failed ({1}):\n{2}'.format(
                _SOURCE.name, ' '.join(cmd), res.stderr))
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    f32p = np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS')
    u8p = np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS')
    lib.raster_scan_distance_3d.argtypes = [
        f32p, u8p, f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        f32p, ctypes.c_float, ctypes.c_int]
    lib.raster_scan_distance_3d.restype = None
    lib.raster_scan_distance_2d.argtypes = [
        f32p, u8p, f32p, ctypes.c_int64, ctypes.c_int64,
        f32p, ctypes.c_float, ctypes.c_int]
    lib.raster_scan_distance_2d.restype = None
    return lib


def _prepare(seeds, spacing, image):
    seeds = np.ascontiguousarray(seeds, np.uint8)
    if seeds.ndim not in (2, 3):
        raise ValueError('seeds must be 2D or 3D, got shape {0}'.format(
            seeds.shape))
    if spacing is None:
        spacing = [1.0] * seeds.ndim
    spacing = np.ascontiguousarray(spacing, np.float32)
    if spacing.shape != (seeds.ndim,):
        raise ValueError('spacing {0} for a {1}D map'.format(
            spacing.tolist(), seeds.ndim))
    if image is None:
        image = np.zeros(seeds.shape, np.float32)
    image = np.ascontiguousarray(image, np.float32)
    if image.shape != seeds.shape:
        raise ValueError('image shape {0} != seeds shape {1}'.format(
            image.shape, seeds.shape))
    return seeds, spacing, image


def raster_scan_distance(seeds: np.ndarray, spacing=None,
                         image: Optional[np.ndarray] = None,
                         lamb: float = 0.0, iterations: int = 2) -> np.ndarray:
    """Spacing-weighted raster-scan distance from ``seeds`` (nonzero voxels),
    2D ``[H, W]`` or 3D ``[D, H, W]``, as the reference evaluation calls
    GeodisTK (lamb 0, zero image, 2 iterations). Returns f32."""
    seeds, spacing, image = _prepare(seeds, spacing, image)
    dist = np.empty(seeds.shape, np.float32)
    lib = _library()
    if seeds.ndim == 3:
        lib.raster_scan_distance_3d(image.reshape(-1), seeds.reshape(-1),
                                    dist.reshape(-1), *seeds.shape, spacing,
                                    lamb, iterations)
    else:
        lib.raster_scan_distance_2d(image.reshape(-1), seeds.reshape(-1),
                                    dist.reshape(-1), *seeds.shape, spacing,
                                    lamb, iterations)
    return dist


def raster_scan_reference(seeds: np.ndarray, spacing=None,
                          image: Optional[np.ndarray] = None,
                          lamb: float = 0.0,
                          iterations: int = 2) -> np.ndarray:
    """Plain version: the same relaxation as a Python loop in float64,
    rounded to f32 at the end."""
    seeds, spacing, image = _prepare(seeds, spacing, image)
    arr3 = seeds if seeds.ndim == 3 else seeds[None]
    img3 = image if image.ndim == 3 else image[None]
    sp3 = (np.concatenate([[1.0], spacing]) if seeds.ndim == 2
           else np.asarray(spacing, np.float64))
    d_, h_, w_ = arr3.shape
    dist = np.where(arr3 > 0, 0.0, 1e10).astype(np.float64)
    offsets = []
    for dz in (-1, 0):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dz == 0 and (dy > 0 or (dy == 0 and dx >= 0)):
                    continue
                sp2 = ((dz * sp3[0]) ** 2 + (dy * sp3[1]) ** 2
                       + (dx * sp3[2]) ** 2)
                offsets.append((dz, dy, dx, sp2))

    def relax(order):
        for z in (range(d_) if order > 0 else range(d_ - 1, -1, -1)):
            for y in (range(h_) if order > 0 else range(h_ - 1, -1, -1)):
                for x in (range(w_) if order > 0 else range(w_ - 1, -1, -1)):
                    best = dist[z, y, x]
                    for dz, dy, dx, sp2 in offsets:
                        zz, yy, xx = z + order * dz, y + order * dy, \
                            x + order * dx
                        if 0 <= zz < d_ and 0 <= yy < h_ and 0 <= xx < w_:
                            g = lamb * (img3[z, y, x] - img3[zz, yy, xx])
                            cand = dist[zz, yy, xx] + np.sqrt(sp2 + g * g)
                            best = min(best, cand)
                    dist[z, y, x] = best

    for _ in range(iterations):
        relax(+1)
        relax(-1)
    out = dist.astype(np.float32)
    return out if seeds.ndim == 3 else out[0]
