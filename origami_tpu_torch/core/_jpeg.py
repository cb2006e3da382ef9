"""JPEG pages without PIL: the host library's decoder (core/jpeg.cpp).

Huffman-coded baseline, extended sequential and progressive files, 8-bit,
gray or three components (YCbCr; RGB where an Adobe marker or the
component ids say so), decoded to the pixels libjpeg-turbo gives PIL
(ISLOW inverse DCT, fancy upsampling, progressive block smoothing).
Arithmetic-coded, lossless, hierarchical, 12-bit and CMYK/YCCK files
raise ValueError naming the kind.
"""

from __future__ import annotations

import ctypes

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
