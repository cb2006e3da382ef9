#!/usr/bin/env python3
"""Build tests/data/torch_jpeg/: PIL's JPEG bytes for the port's encoder
and two four-component JPEG pages, which chip_smoke.py phase 23 and
tests/test_torch_jpeg_encode.py hold the port to (the card's machine has
no PIL).

    python scripts/make_torch_jpeg_fixture.py

Writes encode.json:

    cases            for each of chip_smoke.jpeg_cases() (mode, size,
                     content, seed, quality): PIL's
                     `Image.fromarray(chip_smoke.jpeg_case_pixels(...))
                     .save(f, "JPEG", quality=q)`, its sha256 and length
    pages            the same for chip_smoke.jpeg_page_cases(): the
                     fixture page synth0000 gray and cut to RGB
    four_components  for cmyk.jpg (PIL's CMYK save: an Adobe marker,
                     transform 0) and ycck.jpg (that file with the
                     transform set to 2), made here from synth0000: the
                     sha256 of PIL's convert("L") pixels and the size

and cmyk.jpg, ycck.jpg. Seconds on a CPU, with Pillow 12.1 over
libjpeg-turbo 3.1.
"""

from __future__ import annotations

import hashlib
import io
import json
import sys
from pathlib import Path

import numpy as np
import PIL
import PIL.Image

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

OUT = ROOT / "tests" / "data" / "torch_jpeg"
# the four-component pages: a crop of synth0000 as C, M, Y, K planes
CMYK_CROP = (960, 656)
CMYK_QUALITY = 75


def pil_jpeg(px, quality, mode=None):
    buf = io.BytesIO()
    PIL.Image.fromarray(px, mode).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def entry(data):
    return dict(sha256=hashlib.sha256(data).hexdigest(), length=len(data))


def cmyk_page():
    """uint8 (H, W, 4) from the fixture page: its negative, the page
    shifted, a gradient and the page's dark strokes."""
    page = cs.jpeg_page_pixels("L")[: CMYK_CROP[0], : CMYK_CROP[1]]
    h, w = page.shape
    ramp = np.linspace(0, 180, w, dtype=np.float64)[None, :].repeat(h, 0)
    return np.stack([255 - page, np.roll(page, 9, axis=0) // 2,
                     ramp.astype(np.uint8),
                     np.where(page < 100, 255 - page, 0).astype(np.uint8)],
                    axis=-1)


def ycck(data):
    """`data` with its Adobe marker's transform byte set to 2."""
    i = data.index(b"\xff\xee") + 4
    assert data[i: i + 5] == b"Adobe" and data[i + 11] == 0
    return data[: i + 11] + b"\x02" + data[i + 12:]


def main():
    OUT.mkdir(parents=True, exist_ok=True)
    cases = {name: dict(mode=mode, shape=list(shape), content=content,
                        seed=seed, quality=q,
                        **entry(pil_jpeg(cs.jpeg_case_pixels(
                            mode, shape, content, seed), q)))
             for name, (mode, shape, content, seed, q)
             in cs.jpeg_cases().items()}
    pages = {name: dict(mode=mode, quality=q,
                        shape=list(cs.jpeg_page_pixels(mode).shape),
                        **entry(pil_jpeg(cs.jpeg_page_pixels(mode), q)))
             for name, (mode, q) in cs.jpeg_page_cases().items()}
    cmyk = pil_jpeg(cmyk_page(), CMYK_QUALITY, "CMYK")
    four = {}
    for name, data in (("cmyk.jpg", cmyk), ("ycck.jpg", ycck(cmyk))):
        (OUT / name).write_bytes(data)
        with PIL.Image.open(OUT / name) as im:
            px = np.asarray(im.convert("L"))
            four[name] = dict(size=list(im.size), sha256=hashlib.sha256(
                px.tobytes()).hexdigest())
    (OUT / "encode.json").write_text(json.dumps(dict(
        pillow=PIL.__version__, cases=cases, pages=pages,
        four_components=four), indent=1, sort_keys=True) + "\n")
    print("wrote %s: %d cases, %d page cases, %s" % (
        OUT, len(cases), len(pages), ", ".join(four)))


if __name__ == "__main__":
    main()
