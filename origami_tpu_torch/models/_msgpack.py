"""A small msgpack reader for flax.serialization checkpoints.

Reads the subset `flax.serialization.to_bytes` writes for a parameter
tree: maps, str, bin, ints, floats, arrays, and ext type 1 (an ndarray,
itself a msgpack array of (shape, dtype name, C-order bytes)). Anything
else raises ValueError. Keeps the port free of the msgpack package.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1


class _Reader:
    def __init__(self, data):
        self._d = memoryview(data)
        self._i = 0

    def _take(self, n):
        i = self._i
        if i + n > len(self._d):
            raise ValueError("truncated msgpack data")
        self._i = i + n
        return self._d[i: i + n]

    def _u(self, fmt):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(size))[0]

    def value(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        if b == 0xC4:
            return bytes(self._take(self._u(">B")))
        if b == 0xC5:
            return bytes(self._take(self._u(">H")))
        if b == 0xC6:
            return bytes(self._take(self._u(">I")))
        if b in (0xC7, 0xC8, 0xC9):
            n = self._u({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self._ext(self._u(">b"), n)
        if b == 0xCA:
            return self._u(">f")
        if b == 0xCB:
            return self._u(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self._u(ints[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(self._u(">b"), fixext[b])
        if b == 0xD9:
            return self._str(self._u(">B"))
        if b == 0xDA:
            return self._str(self._u(">H"))
        if b == 0xDB:
            return self._str(self._u(">I"))
        if b == 0xDC:
            return self._array(self._u(">H"))
        if b == 0xDD:
            return self._array(self._u(">I"))
        if b == 0xDE:
            return self._map(self._u(">H"))
        if b == 0xDF:
            return self._map(self._u(">I"))
        raise ValueError("unsupported msgpack type byte 0x%02x" % b)

    def _str(self, n):
        return bytes(self._take(n)).decode("utf-8")

    def _array(self, n):
        return [self.value() for _ in range(n)]

    def _map(self, n):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def _ext(self, code, n):
        payload = bytes(self._take(n))
        if code != _EXT_NDARRAY:
            raise ValueError("unsupported msgpack ext type %d" % code)
        return _ndarray(payload)


def _ndarray(payload):
    r = _Reader(payload)
    tpl = r.value()
    if not (isinstance(tpl, list) and len(tpl) == 3):
        raise ValueError("malformed ndarray ext payload")
    shape, dtype, buf = tpl
    if isinstance(dtype, bytes):
        dtype = dtype.decode("ascii")
    if dtype == "bfloat16":
        raise ValueError("bfloat16 leaves are not supported")
    dt = np.dtype(dtype)
    if dt.hasobject:
        raise ValueError("object arrays are not supported")
    return np.frombuffer(buf, dtype=dt).reshape(tuple(shape)).copy()


def unpackb(data):
    """Decode one msgpack object from `data` (bytes)."""
    r = _Reader(data)
    out = r.value()
    if r._i != len(r._d):
        raise ValueError("trailing bytes after msgpack object")
    return out
