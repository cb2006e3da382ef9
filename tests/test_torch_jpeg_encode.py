"""The port's JPEG encoder (core/_jpeg.encode over core/jpeg_enc.cpp)
against PIL's `Image.save(f, "JPEG", quality=q)` (Pillow 12.1 over
libjpeg-turbo 3.1), on the CPU.

Bars (tolerance: none):
  * the bytes equal PIL's on every seeded case of chip_smoke.jpeg_cases()
    (gray and RGB 4:2:0; 1x1, 7x9, 8x8, 15x17, 16x16 and 33x65; flat,
    noise and text-like content; qualities 1, 10, 24, 25, 50, 75, 80,
    85, 90, 95 and 100) and on the fixture page, gray and cut to RGB of
    partial MCUs, and equal tests/data/torch_jpeg/encode.json's digests,
    which chip_smoke phase 23 holds the card's machine to;
  * the port's decoder reads the port's bytes as PIL reads them;
  * jcdctmgr.c's reciprocal quantization equals division rounded half
    away from zero over every coefficient and divisor the encoder meets;
  * a JPEG comment lands where PIL writes it; shapes, dtypes and
    qualities the encoder does not take raise.
"""

import hashlib
import io
import json

import numpy as np
import PIL.Image
import pytest

import chip_smoke
from origami_tpu_torch.core import _image, _jpeg

REF = json.loads((chip_smoke.JPEG_REF / "encode.json").read_text())
CASES = chip_smoke.jpeg_cases()
PAGE_CASES = chip_smoke.jpeg_page_cases()


def pil_jpeg(px, quality=None, **kw):
    buf = io.BytesIO()
    if quality is not None:
        kw["quality"] = quality
    PIL.Image.fromarray(px).save(buf, "JPEG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("name", sorted(CASES))
def test_encode_equals_pil(name):
    mode, shape, content, seed, q = CASES[name]
    px = chip_smoke.jpeg_case_pixels(mode, shape, content, seed)
    data = _jpeg.encode(px, q)
    assert data == pil_jpeg(px, q)
    assert hashlib.sha256(data).hexdigest() == REF["cases"][name]["sha256"]


@pytest.fixture(scope="module")
def pages():
    return {m: chip_smoke.jpeg_page_pixels(m) for m in chip_smoke.JPEG_MODES}


@pytest.mark.parametrize("name", sorted(PAGE_CASES))
def test_fixture_page_encodes_as_pil(pages, name):
    mode, q = PAGE_CASES[name]
    data = _jpeg.encode(pages[mode], q)
    assert data == pil_jpeg(pages[mode], q)
    assert hashlib.sha256(data).hexdigest() == REF["pages"][name]["sha256"]


def test_fixture_covers_every_case():
    assert set(REF["cases"]) == set(CASES)
    assert set(REF["pages"]) == set(PAGE_CASES)
    assert REF["pages"]["page-RGB-q85"]["shape"] == \
        list(chip_smoke.JPEG_PAGE_RGB) + [3]
    assert all(s % 16 for s in chip_smoke.JPEG_PAGE_RGB)


@pytest.mark.parametrize("mode,shape,q", [
    ("L", (61, 47), 90), ("L", (700, 1024)[::-1], 85), ("RGB", (37, 45), 85),
    ("RGB", (24, 40), 24), ("RGB", (1, 17), 100), ("RGB", (130, 3), 5)])
def test_round_trip_reads_as_pil(mode, shape, q):
    """The port's bytes through the port's decoder and PIL's decoder."""
    px = chip_smoke.jpeg_case_pixels(mode, shape, "text", sum(shape))
    data = _jpeg.encode(px, q)
    want = np.asarray(PIL.Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(_jpeg.decode(data), want)
    np.testing.assert_array_equal(
        _image.decode(data, gray=True),
        np.asarray(PIL.Image.open(io.BytesIO(data)).convert("L")))


def test_default_quality_is_pils():
    px = chip_smoke.jpeg_case_pixels("RGB", (33, 65), "text", 7)
    assert _jpeg.encode(px) == pil_jpeg(px) == pil_jpeg(px, 75)


def test_reciprocal_quantization_is_rounded_division():
    """compute_reciprocal for 16-bit DCT elements, as the encoder
    quantizes: (|x| + corr) * recip >> shift against |x| / d rounded half
    up, for every divisor 8 q (q = 1..255) and |x| up to 2^14 (the ISLOW
    DCT of 8-bit samples stays under 8192)."""
    x = np.arange(1 << 14, dtype=np.int64)
    for d in range(8, 8 * 256, 8):
        b = d.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        got = ((x + c) * fq) >> r
        np.testing.assert_array_equal(got, (x + d // 2) // d, err_msg=str(d))


def test_comment_goes_where_pil_writes_it():
    px = chip_smoke.jpeg_case_pixels("L", (15, 17), "noise", 3)
    assert _jpeg.encode(px, 85, comment=b"a page of 1872") == \
        pil_jpeg(px, 85, comment=b"a page of 1872")
    data = _jpeg.encode(px, 85, comment=b"x")
    assert _jpeg.comment(data) == b"x"
    assert _jpeg.comment(_jpeg.encode(px, 85)) is None


@pytest.mark.parametrize("bad", [
    np.zeros((4, 4), np.float32), np.zeros((4, 4, 4), np.uint8),
    np.zeros((4, 4, 1), np.uint8), np.zeros((4,), np.uint8),
    np.zeros((0, 5), np.uint8)])
def test_other_arrays_raise(bad):
    with pytest.raises(ValueError):
        _jpeg.encode(bad, 75)


def test_non_integer_quality_raises():
    with pytest.raises(ValueError, match="quality"):
        _jpeg.encode(np.zeros((8, 8), np.uint8), 75.5)


def test_write_writes_the_bytes(tmp_path):
    px = chip_smoke.jpeg_case_pixels("RGB", (16, 16), "text", 1)
    _jpeg.write(tmp_path / "a.jpg", px, 90)
    assert (tmp_path / "a.jpg").read_bytes() == pil_jpeg(px, 90)
