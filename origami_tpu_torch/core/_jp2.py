"""JPEG 2000 pages without PIL: the host library's decoder (core/jp2.cpp).

JP2 files and raw codestreams (J2K), read as PIL reads them for the JAX
package (Pillow's mode from the JP2 header or the SIZ segment, OpenJPEG
2.5's pixels, Pillow's unpackers): both wavelets (the 9/7 in OpenJPEG's
float32 operation order), every progression order and progression order
changes, precincts, layers, tiles and tile-parts, image and tile offsets,
the RCT and ICT, signed and 1-16-bit samples, the code-block styles,
SOP/EPH markers, packed packet headers (PPM/PPT), ROI shifts, sub-sampled
colour components, sYCC (PIL's YCbCr tables), CMYK (PIL's cmyk2rgb),
`pclr` palettes as PIL's palette takes them, and ICC profiles unapplied
as PIL leaves them. HTJ2K code-blocks, Part 2 transforms, e-sYCC colour,
sub-sampled gray, more than four components, more than 16 bits and the
colour spaces PIL has no unpacker for raise ValueError naming the kind.
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
    """(width, height, channels) from the header: PIL's size; channels 1
    for the gray modes (L, I;16, LA), 3 for the others."""
    from origami_tpu_torch.geometry.native_bindings import _IP, _U8P
    buf = np.frombuffer(data, np.uint8)
    out = np.zeros(3, np.int32)
    err = ctypes.create_string_buffer(_ERR)
    if _lib().jp2_info(buf.ctypes.data_as(_U8P), buf.size,
                       out.ctypes.data_as(_IP), err, _ERR) < 0:
        raise ValueError(err.value.decode())
    return tuple(int(v) for v in out)


def comment(data):
    """PIL's info["comment"] of a JPEG 2000 file: the first COM segment
    of the main header before the first tile, without its registration
    field; in a JP2 file only where the codestream box follows the
    header box at once, as Pillow looks for it. None where there is
    none."""
    if data[:4] == b"\xff\x4f\xff\x51":
        pos = 2
    else:
        pos = 0
        while True:
            if pos + 8 > len(data):
                return None
            lbox, tbox = struct.unpack(">I4s", data[pos: pos + 8])
            if lbox == 1:
                (lbox,) = struct.unpack(">Q", data[pos + 8: pos + 16])
            elif lbox == 0:
                lbox = len(data) - pos
            if lbox < 8:
                return None
            pos += lbox
            if tbox == b"jp2h":
                break
        if data[pos + 4: pos + 12] != b"jp2c\xff\x4f\xff\x51":
            return None
        pos += 10
    while pos + 4 <= len(data):
        if data[pos] != 0xFF or data[pos + 1] in (0x90, 0xD9):
            break
        (length,) = struct.unpack(">H", data[pos + 2: pos + 4])
        if data[pos + 1] == 0x64:
            return bytes(data[pos + 4: pos + 2 + length][2:])
        pos += 2 + length
    return None


def decode(data, gray=False):
    """JPEG 2000 bytes -> uint8 (H, W) gray (a gray mode, or `gray`: PIL's
    convert("L")) or (H, W, 3): PIL's convert("RGB")."""
    from origami_tpu_torch.geometry.native_bindings import _U8P
    w, h, channels = info(data)
    buf = np.frombuffer(data, np.uint8)
    ch = 1 if gray else channels
    out = np.empty((h, w, ch), np.uint8)
    err = ctypes.create_string_buffer(_ERR)
    got = _lib().jp2_decode(buf.ctypes.data_as(_U8P), buf.size,
                            out.ctypes.data_as(_U8P), int(gray), err, _ERR)
    if got < 0:
        raise ValueError(err.value.decode())
    return out[..., 0] if ch == 1 else out
