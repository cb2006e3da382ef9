"""JPEG without PIL: the host library's decoder (core/jpeg.cpp) and
encoder (core/jpeg_enc.cpp).

Baseline, extended sequential and progressive files, Huffman- or
arithmetic-coded, and lossless (SOF3) files, 8-bit, gray, three
components (YCbCr; RGB where an Adobe marker or the component ids say
so, and in a lossless file without JFIF or Adobe marker) or four (CMYK,
or YCCK by the Adobe marker: PIL's "CMYK;I" through Pillow's
cmyk2rgb), decoded to the pixels libjpeg-turbo gives PIL (ISLOW inverse
DCT, fancy upsampling, progressive block smoothing; lossless planes
replicated). What PIL cannot read raises ValueError naming the kind:
12-bit files, lossless files of another precision or whose colour
needs converting, lossless arithmetic coding (SOF11), hierarchical
frames, and arithmetic-coded scans that run past PIL's 65536-byte read
block (core/jpeg.cpp states the rule).

`encode(array, quality)` gives the bytes of PIL's `Image.fromarray(
array).save(f, "JPEG", quality=quality)`: baseline, gray ("L") or RGB
as YCbCr 4:2:0, libjpeg-turbo's tables and arithmetic; `write(path,
array, quality)` writes them.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

_ERR = 256


def _lib():
    from origami_tpu_torch.geometry.native_bindings import library
    return library()


def info(data):
    """(width, height, components) from the frame header."""
    from origami_tpu_torch.geometry.native_bindings import _IP, _U8P
    buf = np.frombuffer(data, np.uint8)
    out = np.zeros(3, np.int32)
    err = ctypes.create_string_buffer(_ERR)
    if _lib().jpeg_info(buf.ctypes.data_as(_U8P), buf.size,
                        out.ctypes.data_as(_IP), err, _ERR) < 0:
        raise ValueError(err.value.decode())
    return tuple(int(v) for v in out)


def comment(data):
    """PIL's info["comment"] of a JPEG: the last COM segment before the
    first scan, or None."""
    pos, n, found = 2, len(data), None
    while pos < n:
        while pos < n and data[pos] != 0xFF:
            pos += 1
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos + 2 >= n:
            break
        m = data[pos]
        pos += 1
        if m in (0x01, 0xD8) or 0xD0 <= m <= 0xD7:
            continue
        if m in (0xD9, 0xDA):
            break
        (length,) = struct.unpack(">H", data[pos: pos + 2])
        if m == 0xFE:
            found = bytes(data[pos + 2: pos + length])
        pos += length
    return found


def decode(data, gray=False):
    """JPEG bytes -> uint8 (H, W) gray (one component, or `gray`: PIL's
    convert("L")) or (H, W, 3) RGB."""
    from origami_tpu_torch.geometry.native_bindings import _U8P
    w, h, ncomp = info(data)
    buf = np.frombuffer(data, np.uint8)
    ch = 1 if gray or ncomp == 1 else 3
    out = np.empty((h, w, ch), np.uint8)
    err = ctypes.create_string_buffer(_ERR)
    got = _lib().jpeg_decode(buf.ctypes.data_as(_U8P), buf.size,
                             out.ctypes.data_as(_U8P), int(gray), err, _ERR)
    if got < 0:
        raise ValueError(err.value.decode())
    return out[..., 0] if ch == 1 else out


def planes(data):
    """JPEG bytes -> [(h, v, uint8 plane)], each component's samples at its
    own sampling as libjpeg's raw data output gives them (no upsampling,
    no colour conversion): ceil(H * v / vmax) rows of ceil(W * h / hmax).
    DCT files only."""
    from origami_tpu_torch.geometry.native_bindings import _IP, _U8P
    w, h, ncomp = info(data)
    buf = np.frombuffer(data, np.uint8)
    out = np.empty(max(w * h * ncomp, 1), np.uint8)
    samp = np.zeros(8, np.int32)
    err = ctypes.create_string_buffer(_ERR)
    got = _lib().jpeg_planes(buf.ctypes.data_as(_U8P), buf.size,
                             out.ctypes.data_as(_U8P),
                             samp.ctypes.data_as(_IP), err, _ERR)
    if got < 0:
        raise ValueError(err.value.decode())
    hmax, vmax = samp[0:2 * got:2].max(), samp[1:2 * got:2].max()
    result, pos = [], 0
    for i in range(got):
        ch, cv = int(samp[2 * i]), int(samp[2 * i + 1])
        dh, dw = -(-h * cv // vmax), -(-w * ch // hmax)
        result.append((ch, cv, out[pos: pos + dh * dw].reshape(dh, dw)))
        pos += dh * dw
    return result


def encode(array, quality=75, comment=None):
    """uint8 (H, W) gray or (H, W, 3) RGB -> PIL's JPEG bytes at
    `quality`; `comment` (bytes): the COM segment PIL writes from an
    image's info["comment"]."""
    from origami_tpu_torch.geometry.native_bindings import _U8P
    px = np.asarray(array)
    if px.dtype != np.uint8 or not (px.ndim == 2 or (
            px.ndim == 3 and px.shape[2] == 3)):
        raise ValueError("JPEG encodes uint8 (H, W) or (H, W, 3), not %s %s"
                         % (px.dtype, px.shape))
    if not isinstance(quality, (int, np.integer)) or \
            isinstance(quality, bool):
        raise ValueError("JPEG quality %r is not an integer" % (quality,))
    if px.size == 0:
        raise ValueError("cannot write an empty image as JPEG")
    px = np.ascontiguousarray(px)
    ch = 1 if px.ndim == 2 else 3
    err = ctypes.create_string_buffer(_ERR)
    cap = px.size + 4096
    while True:
        out = np.empty(cap, np.uint8)
        n = _lib().jpeg_encode(px.ctypes.data_as(_U8P), px.shape[0],
                               px.shape[1], ch, int(quality),
                               out.ctypes.data_as(_U8P), cap, err, _ERR)
        if n < 0:
            raise ValueError(err.value.decode())
        if n <= cap:
            break
        cap = n
    data = out[:n].tobytes()
    if comment:
        # PIL writes the comment right after the JFIF APP0 segment
        data = data[:20] + b"\xff\xfe" + struct.pack(
            ">H", len(comment) + 2) + bytes(comment) + data[20:]
    return data


def write(path, array, quality=75, comment=None):
    """`encode(array, quality, comment)` into the file `path`."""
    data = encode(array, quality, comment)
    with open(path, "wb") as f:
        f.write(data)
