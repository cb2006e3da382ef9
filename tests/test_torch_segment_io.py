"""core/segment.py and the paletted PNG codec of core/_png.py against
the JAX package's segment.zip reader and writer (PIL): a zip written by
either package must read back equal in the other: labels, class dicts
and palette. No tolerance: these are bytes.
"""

import io
import json
import zipfile
from pathlib import Path

import numpy as np
import PIL.Image
import pytest

from origami_tpu.core import segment as jax_segment
from origami_tpu_torch.core import _png, segment
from origami_tpu_torch.batch.core.io import (Artifact, AtomicFileWriter,
                                             Input, Output)

ROOT = Path(__file__).resolve().parent.parent
FIXTURE_ZIP = ROOT / "tests/data/torch_ocr/full/synth0000.out/segment.zip"
REGION = {"TEXT": 0, "TABULAR": 1, "ILLUSTRATION": 2, "BACKGROUND": 3}
SEP = {"H": 0, "V": 1, "T": 2, "BACKGROUND": 3}


def label_maps(seed, hw=(97, 61)):
    rng = np.random.default_rng(seed)
    reg = np.full(hw, 3, np.uint8)
    reg[10:60, 5:40] = 0
    reg[70:90, 20:55] = rng.integers(0, 3, (20, 35))
    sep = np.full(hw, 3, np.uint8)
    sep[30:32, :] = 0
    sep[:, 44:46] = 1
    return reg, sep


def make(mod, seed=0):
    reg, sep = label_maps(seed)
    return mod.Segmentation([
        mod.Prediction("REGION", "regions", reg, REGION),
        mod.Prediction("SEPARATOR", "separators", sep, SEP)])


def assert_same(a, b):
    assert [p.name for p in a.predictions] == [p.name for p in b.predictions]
    for pa, pb in zip(a.predictions, b.predictions):
        assert pa.type.name == pb.type.name
        assert pa.classes.as_dict() == pb.classes.as_dict()
        assert pa.labels.dtype == pb.labels.dtype == np.uint8
        np.testing.assert_array_equal(pa.labels, pb.labels)


def test_port_written_zip_reads_in_jax(tmp_path):
    seg = make(segment)
    seg.save(tmp_path / "segment.zip")
    assert_same(jax_segment.Segmentation.open(tmp_path / "segment.zip"), seg)
    assert jax_segment.Segmentation.read_predictors(
        tmp_path / "segment.zip") == \
        segment.Segmentation.read_predictors(tmp_path / "segment.zip")


def test_jax_written_zip_reads_in_port(tmp_path):
    seg = make(jax_segment, seed=1)
    seg.save(tmp_path / "segment.zip")
    assert_same(segment.Segmentation.open(tmp_path / "segment.zip"), seg)


def test_fixture_zip_reads_equal_in_both():
    got = segment.Segmentation.open(FIXTURE_ZIP)
    assert_same(got, jax_segment.Segmentation.open(FIXTURE_ZIP))
    assert got.size == got.by_name("regions").size
    assert got.by_type(segment.PredictorType.SEPARATOR)[0].name == \
        "separators"
    assert segment.Segmentation.open(FIXTURE_ZIP) is got      # memoized


def test_zip_layout_and_palette_equal_pil(tmp_path):
    make(segment).save(tmp_path / "port.zip")
    make(jax_segment).save(tmp_path / "jax.zip")
    with zipfile.ZipFile(tmp_path / "port.zip") as a, \
            zipfile.ZipFile(tmp_path / "jax.zip") as b:
        assert a.namelist() == b.namelist()
        for name in a.namelist():
            ia, ib = a.getinfo(name), b.getinfo(name)
            assert ia.compress_type == ib.compress_type, name
            if name.endswith(".json"):
                assert json.loads(a.read(name)) == json.loads(b.read(name))
                continue
            assert ia.compress_type == zipfile.ZIP_STORED
            pa = PIL.Image.open(io.BytesIO(a.read(name)))
            pb = PIL.Image.open(io.BytesIO(b.read(name)))
            assert pa.mode == pb.mode == "P"
            np.testing.assert_array_equal(np.array(pa), np.array(pb))
            n = 3 * 256
            assert (pa.getpalette() + [0] * n)[:n] == \
                (pb.getpalette() + [0] * n)[:n]
            assert pa.getpalette()[3 * 3: 3 * 4] == [255, 255, 255]


@pytest.mark.parametrize("colors,hw", [(2, (9, 13)), (4, (7, 5)),
                                       (16, (11, 3)), (200, (6, 17))])
def test_decode_paletted_reads_pil_bit_depths(colors, hw):
    """PIL packs a paletted PNG into 1, 2 or 4 bits when the palette is
    short enough."""
    rng = np.random.default_rng(colors)
    idx = rng.integers(0, colors, hw).astype(np.uint8)
    im = PIL.Image.fromarray(idx, "P")
    pal = rng.integers(0, 256, (colors, 3)).astype(np.uint8)
    im.putpalette(pal.flatten().tolist())
    buf = io.BytesIO()
    im.save(buf, "png")
    got, got_pal = _png.decode_paletted(buf.getvalue())
    np.testing.assert_array_equal(got, idx)
    np.testing.assert_array_equal(got_pal[:colors], pal)


def test_encode_paletted_round_trip_and_errors():
    idx = np.arange(35, dtype=np.uint8).reshape(5, 7)
    pal = np.arange(256 * 3, dtype=np.uint32).reshape(256, 3) % 251
    data = _png.encode_paletted(idx, pal)
    got, got_pal = _png.decode_paletted(data)
    np.testing.assert_array_equal(got, idx)
    np.testing.assert_array_equal(got_pal, pal.astype(np.uint8))
    with pytest.raises(ValueError):
        _png.encode_paletted(idx[0], pal)
    with pytest.raises(ValueError):
        _png.encode_paletted(idx, np.zeros((0, 3)))
    gray = io.BytesIO()
    PIL.Image.fromarray(idx, "L").save(gray, "png")
    with pytest.raises(ValueError):
        _png.decode_paletted(gray.getvalue())


def test_writer_and_reader_artifacts(tmp_path):
    page = tmp_path / "p.png"
    PIL.Image.fromarray(np.zeros((8, 8), np.uint8)).save(page)
    (tmp_path / "p.out").mkdir()
    writer = Output(Artifact.SEGMENTATION).instantiate(
        page, file_writer=AtomicFileWriter(overwrite=False))
    assert writer.is_ready()
    seg = make(segment)
    writer.segmentation(seg)
    assert not writer.is_ready()
    reader = Input(Artifact.SEGMENTATION).instantiate(page, device="cpu")
    assert reader.is_ready()
    assert_same(reader.segmentation, seg)
    jax_seg = jax_segment.Segmentation.open(tmp_path / "p.out/segment.zip")
    assert_same(jax_seg, seg)


def test_classes_and_labels_api():
    seg = make(segment)
    sep = seg.by_name("separators")
    assert sep.classes["V"].orientation.name == "V"
    assert sep.classes["T"].orientation.name == "H"
    assert sep.background_label == segment.ClassLabel("BACKGROUND", 3)
    assert sep.classes.name_of(1) == "V" and len(sep.classes) == 4
    assert [c.name for c in sep.classes] == list(SEP)
    assert sep.class_mask("V").sum() == 2 * 97
    assert sep.size == (61, 97)
    with pytest.raises(KeyError):
        seg.by_name("nope")
