"""The port's annotate renders (origami_tpu_torch/batch/annotate) against
the JAX package's (origami_tpu/batch/annotate), on the CPU.

The JAX renders draw with cv2 and save a JPEG through PIL; their
canvases and files are captured (the make_torch_inspect_fixture helpers
wrap annotate.utils.save_jpeg), the port's canvases before its JPEG is
written.

Bars:
  * every drawing primitive (fills and their blend, outlines at
    thickness 1-3 open and closed, arrows, points), on seeded shapes
    partly off a small canvas: equal to the JAX module's on every pixel;
  * to_canvas and the addWeighted blend: equal on every value;
  * the renders of synth0000 (grid, flow, contours warped and reliable,
    lines, layout): equal to the JAX canvases on every pixel outside the
    label boxes, the boxes equal to label_box at the JAX labels' origins,
    cv2's label ink inside them, and the JAX canvases' digests equal to
    tests/data/torch_inspect (ROADMAP C8: the labels are drawn with the
    glyph atlas, not cv2's Hershey strokes);
  * the written renders: PIL's JPEG bytes of the port's canvas, and
    decoded equal to PIL's decode of the JAX file on every pixel outside
    the label boxes grown to the 16-px MCU lattice and one MCU more
    (chip_smoke.mcu_box: 4:2:0 fancy upsampling reads the next MCU's
    chroma), with the JAX files' sha256 those of the fixture.
"""

import hashlib
import importlib.util
import io
import json

import cv2
import numpy as np
import PIL.Image
import pytest

import chip_smoke
from origami_tpu import geometry as JG
from origami_tpu.batch.annotate import utils as ju
from origami_tpu_torch import geometry as G
from origami_tpu_torch.batch.annotate import utils as pu
from origami_tpu_torch.core import _image

ROOT = chip_smoke.ROOT
REF = json.loads((chip_smoke.INSPECT_REF / "inspect.json").read_text())
PAGE = "synth0000"
RENDER_NAMES = ["annotation.dewarp.jpg", "annotation.flow.jpg",
                "annotation.contours.0.jpg", "annotation.contours.3.jpg",
                "annotation.lines.jpg", "annotation.layout.jpg"]


def _fixture_script():
    spec = importlib.util.spec_from_file_location(
        "make_torch_inspect_fixture",
        ROOT / "scripts" / "make_torch_inspect_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_to_canvas_equals_jax():
    px = np.arange(256, dtype=np.uint8).repeat(3).reshape(16, 48)
    np.testing.assert_array_equal(pu.to_canvas(px), ju.to_canvas(px))


@pytest.mark.parametrize("alpha", [0.15, 0.25, 0.5])
def test_add_weighted_equals_cv2(alpha):
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, (500, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (500, 3), dtype=np.uint8)
    ref = b.copy()
    cv2.addWeighted(a, alpha, b, 1 - alpha, 0, ref)
    np.testing.assert_array_equal(pu._add_weighted(a, alpha, b), ref)


def _shapes(seed):
    """Seeded shapes partly off a 160 x 200 canvas: a polygon (labelless),
    a line string, a point."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-20, 220, 2)
    ang = np.sort(rng.uniform(0, 2 * np.pi, int(rng.integers(3, 9))))
    r = rng.uniform(10, 70, len(ang))
    poly = np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1)
    line = rng.uniform(-30, 230, (int(rng.integers(2, 6)), 2))
    point = rng.uniform(-2, 200, 2)
    return poly, line, point


@pytest.mark.parametrize("thickness", [1, 2, 3])
@pytest.mark.parametrize("seed", range(6))
def test_primitives_equal_jax(seed, thickness):
    poly, line, point = _shapes(seed)
    rng = np.random.default_rng(100 + seed)
    bg = rng.integers(0, 256, (200, 160), dtype=np.uint8)
    want, got = ju.to_canvas(bg), pu.to_canvas(bg)
    color = tuple(int(v) for v in rng.integers(0, 256, 3))
    alpha = (0.15, 0.25, 0.0)[seed % 3]
    for mod, geo, canvas in ((ju, JG, want), (pu, G, got)):
        mod.draw_geometry(canvas, geo.Polygon(poly), color, thickness,
                          alpha)
        mod.draw_geometry(canvas, geo.LineString(line), color[::-1],
                          thickness)
        mod.draw_geometry(canvas, geo.Point(*point), (9, 200, 90))
        mod.draw_arrow(canvas, tuple(line[0]), tuple(line[-1]), color,
                       thickness)
        mod.draw_arrow(canvas, point, point, color, thickness)
    assert int((want != got).any(axis=2).sum()) == 0


def test_hershey_advances_are_cv2s():
    for c, adv in pu._HERSHEY_ADVANCE.items():
        assert cv2.getTextSize(c, cv2.FONT_HERSHEY_SIMPLEX, 1.0, 0)[0][0] \
            == adv, c


@pytest.mark.parametrize("label", [
    "TEXT/12", "TABULAR/5.1.5.3", "ILLUSTRATION/3", "H/0", "V/17",
    "".join(map(chr, range(33, 80))), "".join(map(chr, range(80, 127))),
    "gjpqy()[]{}|", "WWWMMM@@@", "x"])
def test_label_boxes_hold_cv2_and_port_ink(label):
    """cv2.putText's ink and the port's label lie inside label_box, also
    where the box is cut by the canvas."""
    for org in ((30, 60), (2, 12), (150, 95)):
        m = np.zeros((100, 400), np.uint8)
        cv2.putText(m, label, org, cv2.FONT_HERSHEY_SIMPLEX, 0.6, 255, 2)
        canvas = np.zeros((100, 400, 3), np.uint8)
        box = pu.put_label(canvas, label, org, (255, 255, 255))
        assert box == pu.label_box(label, org)
        x0, y0, x1, y1 = box
        for ink in (m, canvas.any(axis=2)):
            ink = ink.copy()
            ink[max(y0, 0):max(y1, 0), max(x0, 0):max(x1, 0)] = 0
            assert not ink.any(), (label, org)


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    """{file name: (JAX canvas, JAX labels, JAX file bytes, port canvas,
    port boxes, port file bytes)} of the renders of PAGE, each package
    on its own copy of the corpus."""
    script = _fixture_script()
    work = tmp_path_factory.mktemp("annotate")
    jax_corpus = chip_smoke.inspect_corpus(work / "jax")
    (jax_corpus / "synth0001.png").unlink()
    jax = script.jax_renders(jax_corpus)
    port_corpus = chip_smoke.inspect_corpus(work / "port")
    got = {}

    def save(self, path):
        real(self, path)
        with open(path, "rb") as f:
            got[path.rsplit("/", 1)[-1]] = (
                self.canvas.copy(), self.label_boxes, f.read())

    real = pu.AnnotateWriter.save
    pu.AnnotateWriter.save = save
    try:
        from origami_tpu_torch.batch.annotate import (
            contours, flow, grid, layout, lines)
        common = ["--device", "cpu", "--lock-strategy", "NONE", "--plain",
                  "--name", PAGE]
        grid.main(common + [str(port_corpus)])
        flow.main(common + [str(port_corpus)])
        contours.main(common + ["--stage", "warped", str(port_corpus)])
        contours.main(common + [str(port_corpus)])
        lines.main(common + [str(port_corpus)])
        layout.main(common + [str(port_corpus)])
    finally:
        pu.AnnotateWriter.save = real
    out = {name: jax[name][PAGE] + got[name] for name in RENDER_NAMES}
    out["_file"] = (port_corpus / (PAGE + ".out")
                    / "annotation.layout.jpg").read_bytes()
    return out


@pytest.mark.parametrize("name", RENDER_NAMES)
def test_render_equals_jax_outside_label_boxes(renders, name):
    jax_canvas, labels, _, canvas, boxes, _ = renders[name]
    assert canvas.shape == jax_canvas.shape
    script = _fixture_script()
    assert boxes == [tuple(b) for b in script.label_boxes(labels)]
    assert script.ink_outside_boxes(canvas.shape, labels) == 0
    differ = (canvas != jax_canvas).any(axis=2)
    for x0, y0, x1, y1 in boxes:
        differ[max(y0, 0):max(y1, 0), max(x0, 0):max(x1, 0)] = False
    assert int(differ.sum()) == 0
    # the fixture holds this JAX canvas
    ref = REF["renders"][PAGE][name]
    assert chip_smoke.masked_digest(jax_canvas, boxes) == ref["digest"]
    assert [list(b) for b in boxes] == ref["boxes"]


def test_render_png_holds_the_canvas(renders):
    """The written render is PIL's JPEG of the canvas (RGB, quality 85),
    as the JAX module's save_jpeg writes it."""
    canvas = renders["annotation.layout.jpg"][3]
    buf = io.BytesIO()
    PIL.Image.fromarray(cv2.cvtColor(canvas, cv2.COLOR_BGR2RGB)).save(
        buf, "JPEG", quality=85)
    assert renders["_file"] == buf.getvalue()
    assert renders["annotation.layout.jpg"][5] == renders["_file"]


@pytest.mark.parametrize("name", RENDER_NAMES)
def test_render_jpeg_decodes_as_jax_outside_grown_boxes(renders, name):
    _, _, jax_file, _, boxes, data = renders[name]
    ref = REF["renders"][PAGE][name]
    assert hashlib.sha256(jax_file).hexdigest() == ref["sha256"]
    grown = [list(chip_smoke.mcu_box(b)) for b in boxes]
    assert grown == ref["grown"]
    want = np.asarray(PIL.Image.open(io.BytesIO(jax_file)))
    got = _image.decode(data)
    assert got.shape == want.shape
    differ = (got != want).any(axis=2)
    for x0, y0, x1, y1 in grown:
        differ[max(y0, 0):max(y1, 0), max(x0, 0):max(x1, 0)] = False
    assert int(differ.sum()) == 0
    assert chip_smoke.masked_digest(got, grown) == ref["decoded"]


def _polygons(seed, n_polys):
    """Seeded rings (star-shaped and self-crossing) over and around a
    160 x 200 canvas."""
    rng = np.random.default_rng(seed)
    for k in range(n_polys):
        n = int(rng.integers(3, 9))
        c = rng.uniform(-40, 240, 2)
        ang = rng.uniform(0, 2 * np.pi, n)
        if k % 2:
            ang = np.sort(ang)
        r = rng.uniform(5, 120, n)
        yield np.round(np.stack([c[0] + r * np.cos(ang),
                                 c[1] + r * np.sin(ang)], 1)).astype(np.int32)


def test_fill_equals_cv2_on_the_canvas_and_counts_the_rest():
    """cv2.fillPoly against the native fill: every ring inside the canvas
    and every ring partly off it is filled equally (ROADMAP C14: an edge
    whose clipped part is one point on the border runs along the border,
    as in OpenCV 5's CollectPolyEdges; 16 of these 935 rings differed on
    612 pixels before that)."""
    from origami_tpu_torch.geometry.raster import _fill_polygon
    on = on_differ = off = off_differ = pixels = 0
    for pts in _polygons(7, 1000):
        want = np.zeros((200, 160), np.uint8)
        cv2.fillPoly(want, [pts], 1)
        got = np.zeros((200, 160), np.uint8)
        _fill_polygon(got, pts, 1)
        d = int((want != got).sum())
        if pts.min() >= 0 and pts[:, 0].max() < 160 and pts[:, 1].max() < 200:
            on, on_differ = on + 1, on_differ + (d > 0)
        else:
            off, off_differ, pixels = off + 1, off_differ + (d > 0), pixels + d
    assert (on, on_differ) == (65, 0)
    assert (off, off_differ, pixels) == (935, 0, 0)
