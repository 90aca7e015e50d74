"""A minimal NIfTI-1 codec for the benchmark's own files.

The benchmark writes its input volumes and reads the program's saved
labels with this codec, never with the program's: the traffic and the
judge of the outputs stay independent of the code under test. It handles
what the benchmark needs: 3D volumes of uint8, int16, float32 with an
sform affine, gzip-compressed.

Array layout: ``[D, H, W]`` in C order, which is x fastest on disk, as
NIfTI stores it.
"""
from __future__ import annotations

import gzip
import struct

import numpy as np

_HDR = 348
_CODES = {np.dtype(np.uint8): (2, 8), np.dtype(np.int16): (4, 16),
          np.dtype(np.int32): (8, 32), np.dtype(np.float32): (16, 32)}
_DTYPES = {code: dt for dt, (code, _) in _CODES.items()}


def write(path: str, data: np.ndarray, spacing, origin,
          level: int = 1) -> None:
    """``data [D, H, W]`` with voxel size ``spacing`` (x, y, z) and
    ``origin`` (x, y, z, RAS), an axis-aligned sform, gzip at ``level``."""
    data = np.ascontiguousarray(data)
    code, bitpix = _CODES[data.dtype]
    nz, ny, nx = data.shape
    hdr = bytearray(_HDR + 4)
    struct.pack_into('<i', hdr, 0, _HDR)
    struct.pack_into('<8h', hdr, 40, 3, nx, ny, nz, 1, 1, 1, 1)
    struct.pack_into('<hh', hdr, 70, code, bitpix)
    sx, sy, sz = (float(s) for s in spacing)
    struct.pack_into('<8f', hdr, 76, 1.0, sx, sy, sz, 0, 0, 0, 0)
    struct.pack_into('<f', hdr, 108, float(_HDR + 4))
    struct.pack_into('<ff', hdr, 112, 1.0, 0.0)
    hdr[123] = 2 | 8
    struct.pack_into('<hh', hdr, 252, 1, 1)
    ox, oy, oz = (float(o) for o in origin)
    struct.pack_into('<3f', hdr, 268, ox, oy, oz)
    struct.pack_into('<4f', hdr, 280, -sx, 0.0, 0.0, ox)
    struct.pack_into('<4f', hdr, 296, 0.0, -sy, 0.0, oy)
    struct.pack_into('<4f', hdr, 312, 0.0, 0.0, sz, oz)
    hdr[344:348] = b'n+1\x00'
    with gzip.open(path, 'wb', compresslevel=level) as f:
        f.write(bytes(hdr))
        f.write(data.tobytes())


def read(path: str):
    """``(data [D, H, W], geometry)``; ``geometry`` is the tuple of the
    header fields that place the volume: pixdim[1:4], the three sform
    rows, the qform and sform codes."""
    opener = gzip.open if path.endswith('.gz') else open
    with opener(path, 'rb') as f:
        raw = f.read()
    if struct.unpack('<i', raw[:4])[0] != _HDR:
        raise ValueError('{0}: not a little-endian NIfTI-1 file'.format(path))
    dim = struct.unpack_from('<8h', raw, 40)
    if dim[0] not in (3, 4) or (dim[0] == 4 and dim[4] != 1):
        raise ValueError('{0}: dim {1} is not a 3D volume'.format(path, dim))
    code = struct.unpack_from('<h', raw, 70)[0]
    if code not in _DTYPES:
        raise ValueError('{0}: datatype {1} unsupported'.format(path, code))
    slope, inter = struct.unpack_from('<ff', raw, 112)
    if slope not in (0.0, 1.0) or inter != 0.0:
        raise ValueError('{0}: scaled data unsupported'.format(path))
    nx, ny, nz = dim[1:4]
    offset = int(struct.unpack_from('<f', raw, 108)[0])
    data = np.frombuffer(raw, _DTYPES[code], nx * ny * nz, offset)
    geometry = (struct.unpack_from('<3f', raw, 80)
                + struct.unpack_from('<12f', raw, 280)
                + struct.unpack_from('<hh', raw, 252))
    return data.reshape(nz, ny, nx).copy(), geometry
