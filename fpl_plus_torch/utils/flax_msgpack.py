"""A reader for the msgpack that flax writes (``flax.serialization.to_bytes``
/ ``msgpack_serialize``), so that JAX checkpoints load without the
``msgpack`` package.

The subset read is what a flax state dict of numpy leaves packs to:

* maps (fixmap, map16, map32) and arrays (fixarray, array16, array32);
  flax writes tuples and lists as maps with keys ``'0'``, ``'1'``, ...;
* strings (fixstr, str8-32) and binary (bin8-32);
* the positive and negative fixints, uint8-64, int8-64, float32, float64,
  nil and bool;
* extensions (fixext, ext8-32) of code 1, a numpy array: a msgpack of
  ``(shape, dtype name, C-order bytes)`` (flax ``_ndarray_to_bytes``), and
  code 3, a numpy scalar: the same triple of shape ``()`` (flax 0.12), or
  ``(dtype name, bytes)`` (older flax).

``bfloat16``, which numpy lacks, arrives as a ``torch.bfloat16`` tensor (its
uint16 bits viewed); every other array as a numpy array. Anything else
raises ``ValueError``: complex numbers (code 2), other extension codes,
other type bytes, and flax's chunked arrays (a map with the key
``'__msgpack_chunked_array__'``, which flax writes for arrays over 2**30
bytes).
"""
from __future__ import annotations

import struct

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = '__msgpack_chunked_array__'

# fixed-width scalars: type byte -> struct format (big-endian)
_SCALARS = {0xca: '>f', 0xcb: '>d', 0xcc: '>B', 0xcd: '>H', 0xce: '>I',
            0xcf: '>Q', 0xd0: '>b', 0xd1: '>h', 0xd2: '>i', 0xd3: '>q'}
# type byte -> width of the length field (strings, binary, containers)
_STR = {0xd9: 1, 0xda: 2, 0xdb: 4}
_BIN = {0xc4: 1, 0xc5: 2, 0xc6: 4}
_ARRAY = {0xdc: 2, 0xdd: 4}
_MAP = {0xde: 2, 0xdf: 4}
_EXT = {0xc7: 1, 0xc8: 2, 0xc9: 4}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_WIDTH = {1: '>B', 2: '>H', 4: '>I'}


def unpackb(data: bytes):
    """The object that ``data`` (one msgpack value) encodes."""
    reader = _Reader(memoryview(data))
    value = reader.value()
    if reader.pos != len(data):
        raise ValueError('{0} trailing bytes after the msgpack value'.format(
            len(data) - reader.pos))
    return value


def _array_from(shape, dtype_name: str, raw: bytes):
    if dtype_name == 'bfloat16':
        bits = np.frombuffer(raw, np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(raw, np.dtype(dtype_name)).reshape(shape).copy()


class _Reader:
    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError('truncated msgpack at byte {0}'.format(self.pos))
        out = bytes(self.buf[self.pos:self.pos + n])
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def length(self, width: int) -> int:
        return self.unpack(_WIDTH[width])

    def value(self):
        at = self.pos
        b = self.unpack('>B')
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self.take(b & 0x1f).decode('utf-8')
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _SCALARS:
            return self.unpack(_SCALARS[b])
        if b in _STR:
            return self.take(self.length(_STR[b])).decode('utf-8')
        if b in _BIN:
            return self.take(self.length(_BIN[b]))
        if b in _ARRAY:
            return [self.value() for _ in range(self.length(_ARRAY[b]))]
        if b in _MAP:
            return self.map(self.length(_MAP[b]))
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b], at)
        if b in _EXT:
            return self.ext(self.length(_EXT[b]), at)
        raise ValueError('unsupported msgpack type byte 0x{0:02x} at byte '
                         '{1}'.format(b, at))

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if _CHUNKED in out:
            raise ValueError('flax chunked arrays (over 2**30 bytes) are not '
                             'read')
        return out

    def ext(self, n: int, at: int):
        code = self.unpack('>b')
        payload = self.take(n)
        if code == _EXT_NDARRAY:
            shape, dtype_name, raw = unpackb(payload)
            return _array_from(tuple(shape), dtype_name, raw)
        if code == _EXT_NPSCALAR:
            fields = unpackb(payload)
            dtype_name, raw = fields[-2:]
            scalar = _array_from((), dtype_name, raw)
            return scalar if isinstance(scalar, torch.Tensor) else scalar[()]
        raise ValueError('unsupported msgpack extension code {0} at byte {1} '
                         '(1: ndarray and 3: numpy scalar are read)'.format(
                             code, at))
