"""Page images in the formats that PIL opens for the JAX package.

`read(path)` -> uint8 (H, W) gray or (H, W, 3) RGB, `read_gray(path)`
-> PIL's `np.asarray(Image.open(path).convert("L"))`, `read_size(path)`
-> PIL's `Image.open(path).size` from the header alone, `comment(path)`
-> the info["comment"] that PIL keeps from a JPEG, JPEG 2000 or PNG page
and writes into a JPEG saved from it. The reader is chosen by the
file's magic bytes, not its suffix, as PIL chooses it: PNG
(core/_png.py), JPEG (core/_jpeg.py: lossless and arithmetic-coded
too), TIFF (core/_tiff.py: classic and BigTIFF, planar, CMYK, signed and
float samples, YCbCr, old-style JPEG and old-style LZW too), BMP (core/_bmp.py) and JPEG 2000, JP2 or a raw
codestream (core/_jp2.py). Anything else, and every kind PIL refuses,
raises ValueError; nothing falls back to another reader.
"""

from __future__ import annotations

from origami_tpu_torch.core import _bmp, _jp2, _jpeg, _png, _tiff

_JP2 = (b"\x00\x00\x00\x0cjP  \r\n\x87\n", b"\xff\x4f\xff\x51")


def kind(head):
    """The format of a file from its first bytes: "png", "jpeg", "tiff",
    "bmp", "jpeg2000" or None."""
    if head.startswith(_png._SIG):
        return "png"
    if head[:3] == b"\xff\xd8\xff":
        return "jpeg"
    if _tiff.is_tiff(head) or head[:4] in (b"II+\x00", b"MM\x00+"):
        return "tiff"
    if _bmp.is_bmp(head):
        return "bmp"
    if any(head.startswith(m) for m in _JP2):
        return "jpeg2000"
    return None


def _unsupported(path):
    return ValueError("%s: not a PNG, JPEG, TIFF, BMP or JPEG 2000 file"
                      % path)


def decode(data, what="data", gray=False):
    """Image bytes -> uint8 (H, W) or (H, W, 3); `gray`: PIL's
    convert("L")."""
    k = kind(data[:16])
    if k == "jpeg":
        return _jpeg.decode(data, gray=gray)
    if k == "jpeg2000":
        return _jp2.decode(data, gray=gray)
    if k == "png":
        px = _png.decode(data, what)
    elif k == "tiff":
        px = _tiff.decode(data)
    elif k == "bmp":
        px = _bmp.decode(data)
    else:
        raise _unsupported(what)
    return _png.to_gray(px) if gray else px


def read(path):
    with open(path, "rb") as f:
        return decode(f.read(), path)


def read_gray(path):
    with open(path, "rb") as f:
        return decode(f.read(), path, gray=True)


def comment(path):
    """PIL's `Image.open(path).info.get("comment")` of a JPEG, JPEG 2000
    (their COM segments) or PNG page (its text chunk "comment", UTF-8
    encoded as PIL writes it); None for the other formats."""
    with open(path, "rb") as f:
        data = f.read()
    k = kind(data[:16])
    if k == "jpeg":
        return _jpeg.comment(data)
    if k == "jpeg2000":
        return _jp2.comment(data)
    if k == "png":
        return _png.comment(data)
    return None


def read_size(path):
    """(width, height) from the file's header, without decoding."""
    with open(path, "rb") as f:
        head = f.read(256)
        k = kind(head)
        if k == "png":
            return _png.read_size(path)
        if k == "bmp":
            return _bmp.read_size(head)
        if k in ("jpeg", "tiff", "jpeg2000"):
            data = head + f.read()
            if k == "tiff":
                return _tiff.read_size(data)
            w, h, _ = (_jpeg if k == "jpeg" else _jp2).info(data)
            return w, h
    raise _unsupported(path)
