"""The port's GT region generation (origami_tpu_torch/train/segment/
regions.py) and its cv2 pieces against the JAX module and cv2.

Tolerance: every pixel equal. `warp_affine_u8` must give cv2 5's
warpAffine bytes (float32 source coordinates with fused multiply-adds,
rounded half to even for INTER_NEAREST; float32 lerps for INTER_AREA,
which warpAffine runs as INTER_LINEAR; BORDER_REPLICATE), including the
half-pixel ties of a rotation by 0 or +-90 degrees about the centre of an
odd- or even-sized raster; the master, stops and region rasters must equal
the JAX module's, whose painting is cv2.polylines (ROADMAP C6: an
extended separator leaving the raster).
"""

import math

import cv2
import numpy as np
import pytest

from origami_tpu_torch.core.polyline import Polyline
from origami_tpu_torch.geometry import contour_trace, raster
from origami_tpu_torch.train.segment import regions as R
from origami_tpu_torch.train.segment.labels import (LabelSet,
                                                    DEFAULT_BBZ_SPEC)

LABEL_SET = LabelSet(DEFAULT_BBZ_SPEC)


def test_region_stoppers():
    h, w = 200, 300
    labels = np.full((h, w), 3, np.uint8)
    # text ink: two columns separated by a whitespace gutter at x=150,
    # with a SHORT vertical separator that only spans the middle
    text = np.zeros((h, w), np.uint8)
    text[20:180, 20:140] = 1
    text[20:180, 160:280] = 1
    sep = Polyline([(150, 60), (150, 140)], width=3)
    gen = R.AnnotationsGenerator(
        LABEL_SET, labels, {"V": [sep]},
        segment_thickness=1.0, segment_extend={"V": 80})
    master = gen.master
    stops = gen.stops
    vidx = LABEL_SET.label("separator", "V").index
    # stops extends the stroke well beyond its master extent
    assert (stops == vidx).sum() > (master == vidx).sum() * 1.5
    # region growth: with a wide close kernel the two columns would
    # merge; the extended stopper keeps them apart
    merged = R.generate_regions(text, np.zeros_like(master), close=(41, 11))
    assert merged.max() == 1
    split = R.generate_regions(text, stops == vidx, close=(41, 11))
    assert split.max() == 2


def test_deskewing_regions():
    angle = 0.03
    segs = {"H": [Polyline([(10, 50 + i * 30),
                            (290, 50 + i * 30 + 280 * math.tan(angle))],
                           width=2) for i in range(4)]}
    est = R.estimate_skew(segs)
    assert abs(est - angle) < 0.01
    labels = np.full((200, 300), 3, np.uint8)
    gen = R.AnnotationsGenerator(LABEL_SET, labels, segs)
    hidx = LABEL_SET.label("separator", "H").index
    master = gen.master
    # painted separators are level after deskewing: each stroke's
    # bounding-box height collapses to ~thickness
    n, _, stats = contour_trace.connected_components_with_stats(
        (master == hidx).astype(np.uint8))
    heights = [stats[i, 3] for i in range(1, n) if stats[i, 4] > 50]
    assert heights and max(heights) <= 6


WARP_TIES = [(h, w, deg) for h, w in ((41, 60), (40, 61), (60, 60), (61, 61))
             for deg in (0.0, 90.0, -90.0)]


@pytest.mark.parametrize("h, w, deg", WARP_TIES)
def test_warp_affine_u8_ties_are_cv2s(h, w, deg):
    src = np.random.default_rng(h * w).integers(0, 256, (h, w)) \
        .astype(np.uint8)
    m = cv2.getRotationMatrix2D((w / 2.0, h / 2.0), deg, 1.0)
    np.testing.assert_array_equal(
        raster.rotation_matrix_2d((w / 2.0, h / 2.0), deg, 1.0), m)
    for flags, nearest in ((cv2.INTER_NEAREST, True),
                           (cv2.INTER_AREA, False)):
        want = cv2.warpAffine(src, m, (w, h), flags=flags,
                              borderMode=cv2.BORDER_REPLICATE)
        np.testing.assert_array_equal(
            raster.warp_affine_u8(src, m, (w, h), nearest), want)


@pytest.mark.parametrize("chunk", range(4))
def test_warp_affine_u8_is_cv2s(chunk):
    """50 seeded rasters a chunk, up to 400x600, small and arbitrary
    angles, labels and gray levels."""
    rng = np.random.default_rng(chunk)
    for _ in range(50):
        h, w = int(rng.integers(5, 400)), int(rng.integers(5, 600))
        deg = float(rng.normal(0, 3) if rng.random() < 0.5
                    else rng.uniform(-180, 180))
        src = rng.integers(0, 256, (h, w)).astype(np.uint8)
        if rng.random() < 0.3:
            src //= 64
        m = cv2.getRotationMatrix2D((w / 2.0, h / 2.0), deg, 1.0)
        for flags, nearest in ((cv2.INTER_NEAREST, True),
                               (cv2.INTER_AREA, False)):
            want = cv2.warpAffine(src, m, (w, h), flags=flags,
                                  borderMode=cv2.BORDER_REPLICATE)
            got = raster.warp_affine_u8(src, m, (w, h), nearest)
            np.testing.assert_array_equal(got, want,
                                          err_msg="%dx%d %g" % (h, w, deg))


def _labels(seed, h, w):
    """Seeded region labels: blocks of TEXT (0), TABULAR (1) and
    ILLUSTRATION (2) on BACKGROUND (3)."""
    rng = np.random.default_rng(seed)
    lab = np.full((h, w), 3, np.uint8)
    for _ in range(8):
        y, x = int(rng.integers(0, h - 20)), int(rng.integers(0, w - 20))
        lab[y:y + int(rng.integers(10, 120)),
            x:x + int(rng.integers(10, 160))] = int(rng.integers(0, 3))
    return lab


GEN_CASES = {
    # an extended slanted separator leaving the raster (ROADMAP C6): the
    # two level ones hold the skew at 0, so it stays slanted
    "slanted_off_raster": dict(
        segs={"H": [((10, 30), (290, 30)), ((10, 170), (290, 170)),
                    ((-10, 50), (310, 57))],
              "V": [((150, 60), (150, 140))]},
        extend={"H": 40, "V": 80}, width=3.0),
    "skewed_page": dict(
        segs={"H": [((10, 50 + i * 40), (290, 50 + i * 40 + 9))
                    for i in range(4)],
              "T": [((20, 30), (280, 38))],
              "V": [((100, 20), (104, 180)), ((200, 20), (203, 180))]},
        extend={"H": 30, "V": 60, "T": 30}, width=4.0),
}


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_annotations_generator_equal_jax(case):
    from origami_tpu.core.polyline import Polyline as JPolyline
    from origami_tpu.train.segment import labels as JL
    from origami_tpu.train.segment import regions as JR
    spec = GEN_CASES[case]
    labels = _labels(len(case), 200, 300)
    text = labels == 0
    outs = []
    for mod, pl, ls in ((JR, JPolyline, JL.LabelSet(JL.DEFAULT_BBZ_SPEC)),
                        (R, Polyline, LABEL_SET)):
        segs = {c: [pl(p, width=spec["width"]) for p in v]
                for c, v in spec["segs"].items()}
        gen = mod.AnnotationsGenerator(ls, labels, segs,
                                       segment_extend=spec["extend"])
        stops = gen.stops
        regions = mod.generate_regions(
            gen.deskewing.pixels(text.astype(np.uint8)),
            stops != gen.deskewing.pixels(labels), close=(24, 12),
            min_area=100)
        outs.append((gen.skew, gen.master, stops, regions,
                     gen.deskewing.pixels(labels, nearest=False)))
    (js, jm, jst, jr, ja), (ps, pm, pst, pr, pa) = outs
    assert js == ps
    np.testing.assert_array_equal(pm, jm)
    np.testing.assert_array_equal(pst, jst)
    np.testing.assert_array_equal(pa, ja)
    np.testing.assert_array_equal(pr, jr)
    assert jr.max() >= 1


def test_clip_extension_geometry_equal_jax():
    """_clip_extension's geometry (LineString.intersection as Point or
    MultiPoint, project, substring) and its result against the JAX
    package's, on an extension crossing one and two other separators."""
    from origami_tpu import geometry as JG
    from origami_tpu.core.polyline import Polyline as JPolyline
    from origami_tpu.train.segment import regions as JR
    from origami_tpu_torch import geometry as G
    ext = [(-30.0, 50.0), (0.0, 50.0), (200.0, 54.0), (260.0, 55.0)]
    orig = ext[1:3]
    for others, kind in (([[(230, 0), (232, 120)]], "Point"),
                         ([[(20, 0), (30, 120), (120, 0), (130, 120)]],
                          "MultiPoint")):
        got = G.LineString(ext).intersection(G.LineString(others[0]))
        want = JG.LineString(ext).intersection(JG.LineString(others[0]))
        assert got.geom_type == want.geom_type == kind
        line, jline = G.LineString(ext), JG.LineString(ext)
        pts = [got] if kind == "Point" else list(got.geoms)
        jpts = [want] if kind == "Point" else list(want.geoms)
        for p, jp in zip(pts, jpts):
            t, jt = line.project(p), jline.project(jp)
            assert abs(t - jt) <= 1e-12
            np.testing.assert_allclose(
                line.substring(0.0, t).np_coords,
                jline.substring(0.0, jt).np_coords, atol=1e-12)
        res = R._clip_extension(Polyline(ext, 3.0), Polyline(orig, 3.0),
                                [Polyline(o, 2.0) for o in others])
        jres = JR._clip_extension(JPolyline(ext, 3.0), JPolyline(orig, 3.0),
                                  [JPolyline(o, 2.0) for o in others])
        np.testing.assert_allclose(res.np_coords, jres.np_coords,
                                   atol=1e-12)
        if kind == "Point":      # the crossing cuts the extension
            assert res.line_string.length < G.LineString(ext).length
