"""A small msgpack reader and writer for flax.serialization checkpoints.

Reads the subset `flax.serialization.to_bytes` writes for a parameter
tree: maps, str, bin, ints, floats, arrays, ext type 1 (an ndarray,
itself a msgpack array of (shape, dtype name, C-order bytes)) and ext
type 3 (a numpy scalar, packed as a 0-d ndarray). Anything else raises
ValueError. `packb` writes a tree of dicts and numpy arrays
as those bytes exactly: maps in their keys' order, each number in its
shortest msgpack form, each ndarray as ext type 1 and each numpy scalar
as ext type 3. Keeps the port free of the msgpack package.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


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
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload)[()]
        raise ValueError("unsupported msgpack ext type %d" % code)


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


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def _pack_uint(n, out):
    if n < 0x80:
        out.append(struct.pack(">B", n))
    elif n < 0x100:
        out.append(struct.pack(">BB", 0xCC, n))
    elif n < 0x10000:
        out.append(struct.pack(">BH", 0xCD, n))
    elif n < 0x100000000:
        out.append(struct.pack(">BI", 0xCE, n))
    else:
        out.append(struct.pack(">BQ", 0xCF, n))


def _pack_int(n, out):
    if n >= 0:
        _pack_uint(n, out)
    elif n >= -32:
        out.append(struct.pack(">b", n))
    elif n >= -0x80:
        out.append(struct.pack(">Bb", 0xD0, n))
    elif n >= -0x8000:
        out.append(struct.pack(">Bh", 0xD1, n))
    elif n >= -0x80000000:
        out.append(struct.pack(">Bi", 0xD2, n))
    else:
        out.append(struct.pack(">Bq", 0xD3, n))


def _pack_len(n, small, fix_limit, codes, out):
    """A length header: fixed form below `fix_limit` (small | n), else
    the 8/16/32-bit code of `codes` (None where the format has none)."""
    if n < fix_limit:
        out.append(struct.pack(">B", small | n))
    elif codes[0] is not None and n < 0x100:
        out.append(struct.pack(">BB", codes[0], n))
    elif n < 0x10000:
        out.append(struct.pack(">BH", codes[1], n))
    else:
        out.append(struct.pack(">BI", codes[2], n))


def _pack_ext(code, payload, out):
    n = len(payload)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(struct.pack(">Bb", fixext[n], code))
    elif n < 0x100:
        out.append(struct.pack(">BBb", 0xC7, n, code))
    elif n < 0x10000:
        out.append(struct.pack(">BHb", 0xC8, n, code))
    else:
        out.append(struct.pack(">BIb", 0xC9, n, code))
    out.append(payload)


def _ndarray_bytes(arr):
    """msgpack of (shape, dtype name, C-order bytes), as flax's
    _ndarray_to_bytes packs it."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not supported")
    return packb((tuple(int(d) for d in arr.shape), arr.dtype.name,
                  arr.tobytes("C")))


def _pack(x, out):
    if isinstance(x, dict):
        _pack_len(len(x), 0x80, 16, (None, 0xDE, 0xDF), out)
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(x, (list, tuple)):
        _pack_len(len(x), 0x90, 16, (None, 0xDC, 0xDD), out)
        for v in x:
            _pack(v, out)
    elif isinstance(x, np.ndarray):
        _pack_ext(_EXT_NDARRAY, _ndarray_bytes(x), out)
    elif isinstance(x, np.generic):
        _pack_ext(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)), out)
    elif x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, int):
        _pack_int(x, out)
    elif isinstance(x, float):
        out.append(struct.pack(">Bd", 0xCB, x))
    elif isinstance(x, str):
        b = x.encode("utf-8")
        _pack_len(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out.append(b)
    elif isinstance(x, (bytes, bytearray, memoryview)):
        b = bytes(x)
        _pack_len(len(b), 0, 0, (0xC4, 0xC5, 0xC6), out)
        out.append(b)
    else:
        raise ValueError("cannot pack %s" % type(x).__name__)


def packb(tree):
    """msgpack bytes of a tree of dicts, lists, numpy arrays and python
    scalars: `flax.serialization.to_bytes(tree)` for a parameter tree."""
    out = []
    _pack(tree, out)
    return b"".join(out)
