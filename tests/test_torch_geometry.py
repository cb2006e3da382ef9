"""The port's host geometry (origami_tpu_torch/geometry, a copy of
origami_tpu/geometry without cv2) against the JAX package's, on seeded
polygons and on the fixture pages' text areas.

Tolerances, each with its reason:
  * WKT, transform, exact overlays (difference through native.cpp, built
    from the same source with the same flags), separator buffers (the
    exact miter offset) and make_valid of a valid polygon: exact
    coordinates — the same arithmetic in the same order;
  * the convex hull: the same points in cv2's order, exactly, for points
    in general position, on integer lattices, clustered, collinear to
    within float32 rounding, and on the corners of a text block's tilted
    line rectangles (the port repeats cv2.convexHull's Sklansky scan,
    with cv2 5's unit-length difference vectors for float32 points);
  * polygon buffers and make_valid of an invalid polygon go through the
    raster bridge, whose fill and contour tracer are the port's own
    (cv2's in the JAX copy): the symmetric difference of the two results
    stays below one raster pixel times the perimeter.
"""

import fcntl
import shutil
import subprocess
import time
from pathlib import Path

import cv2
import numpy as np
import pytest

from origami_tpu import geometry as J
from origami_tpu.geometry import native_bindings as jax_native_bindings
from origami_tpu_torch import geometry as G
from origami_tpu_torch.geometry import booleans, poly, raster

ROOT = Path(__file__).resolve().parent.parent
FULL = ROOT / "tests/data/torch_ocr/full"
FLOW = ROOT / "tests/data/torch_flow"


def load_jax_native():
    """Build and load the JAX package's native geometry library, or fail.

    Its loader runs `make` on every first load, and the Makefile writes
    the library in place, so test workers that start together on a tree
    without the library build it at the same moment; a worker whose load
    fails caches the failure and then runs the Python overlay, whose
    polygons differ from native.cpp's. Here the build runs under a file
    lock, the load is retried while another build finishes, and a cached
    failure is cleared."""
    lock = ROOT / "build" / "jax_native.lock"
    lock.parent.mkdir(exist_ok=True)
    with open(lock, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        subprocess.run(["make", "-C", str(jax_native_bindings._DIR)],
                       check=True, capture_output=True)
        for _ in range(100):
            if jax_native_bindings._LIB is not None:
                break
            jax_native_bindings._TRIED = False
            if jax_native_bindings.available():
                break
            time.sleep(0.1)
    assert jax_native_bindings.available(), \
        "the JAX package's native geometry library did not load"


@pytest.fixture(scope="module")
def jax_native():
    """For tests that compare live against the JAX package's native
    geometry (see load_jax_native)."""
    load_jax_native()


def star(rng, cx, cy, r0, r1, n):
    """A seeded simple star-shaped polygon ring."""
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    rad = rng.uniform(r0, r1, n)
    return np.c_[cx + rad * np.cos(ang), cy + rad * np.sin(ang)]


def pair(seed):
    rng = np.random.default_rng(seed)
    a = star(rng, 100, 100, 40, 90, 12)
    b = star(rng, 150, 120, 30, 80, 9)
    hole = star(rng, 100, 100, 5, 15, 6)
    return (G.Polygon(a, [hole]), G.Polygon(b),
            J.Polygon(a, [hole]), J.Polygon(b))


def all_coords(g):
    return np.asarray(g._all_coords())


@pytest.mark.parametrize("seed", range(4))
def test_wkt_round_trip_and_dumps_match(seed):
    pa, pb, ja, jb = pair(seed)
    for p, j in ((pa, ja), (pb, jb),
                 (G.MultiPolygon([pa, pb]), J.MultiPolygon([ja, jb]))):
        assert p.wkt == j.wkt
        back = G.wkt.loads(j.wkt)
        assert back.wkt == j.wkt
        np.testing.assert_array_equal(all_coords(back), all_coords(p))
    line = G.LineString(pa.np_shell[:5])
    assert G.wkt.loads(line.wkt).wkt == J.wkt.loads(line.wkt).wkt


@pytest.mark.parametrize("seed", range(4))
def test_difference_and_intersection_equal_jax(seed, jax_native):
    pa, pb, ja, jb = pair(seed)
    for op in ("difference", "intersection", "union"):
        got, want = getattr(pa, op)(pb), getattr(ja, op)(jb)
        assert got.geom_type == want.geom_type
        assert got.wkt == want.wkt


@pytest.mark.parametrize("seed", range(3))
def test_native_and_python_overlay_agree(seed):
    pa, pb, _, _ = pair(seed)
    try:
        booleans.USE_NATIVE = True
        native = pa.difference(pb)
        booleans.USE_NATIVE = False
        python = pa.difference(pb)
    finally:
        booleans.USE_NATIVE = True
    assert native.symmetric_difference(python).area < 1e-6


@pytest.mark.parametrize("seed", range(3))
def test_separator_buffer_and_transform_equal_jax(seed):
    rng = np.random.default_rng(seed)
    xs = np.linspace(0, 400, 7)
    c = np.c_[xs, 50 + rng.normal(0, 2, 7)]
    got = G.ops.buffer(G.LineString(c), 3.0)
    want = J.ops.buffer(J.LineString(c), 3.0)
    assert got.wkt == want.wkt

    def f(x, y):
        return x * 1.01 + 0.3 * y, y - 0.002 * x * x

    pa, _, ja, _ = pair(seed)
    assert G.transform(f, pa).wkt == J.transform(f, ja).wkt
    assert G.make_valid(pa) is pa


@pytest.mark.parametrize("dist", [10.0, -4.0])
def test_polygon_buffer_close_to_jax_raster(dist):
    pa, _, ja, _ = pair(11)
    got = G.ops.buffer(pa, dist)
    want = J.ops.buffer(ja, dist)
    sym = J.wkt.loads(got.wkt).symmetric_difference(want).area
    assert sym < want.length * 1.0
    assert abs(got.area - want.area) < 0.02 * want.area


def test_make_valid_of_a_bowtie_close_to_jax():
    c = [(0, 0), (40, 40), (40, 0), (0, 40)]
    got = G.make_valid(G.Polygon(c))
    want = J.make_valid(J.Polygon(c))
    assert got.is_valid and not got.is_empty
    assert abs(got.area - want.area) < 0.02 * want.area


def test_crack_tracer_keeps_holes_and_diagonal_pixels():
    # the raster tracer is cv2's border following since the contours
    # stage needed cv2's vertices: the polygon equals the JAX copy's
    m = np.zeros((12, 12), np.uint8)
    m[2:10, 2:10] = 1
    m[4:7, 4:7] = 0                  # a hole
    m[10, 10] = 1                    # joined diagonally to the square
    frame = raster.RasterFrame((0, 0, 7, 7), scale=1.0, margin=2)
    g = raster.vectorize(m, frame, min_area_px=0.5)
    assert g.geom_type == "Polygon"
    assert len(g.np_holes) == 1
    jframe = J.raster.RasterFrame((0, 0, 7, 7), scale=1.0, margin=2)
    assert g.wkt == J.raster.vectorize(m, jframe, min_area_px=0.5).wkt
    assert g.contains(G.Point(8.0, 8.0))      # the diagonal pixel


def test_ellipse_kernel_is_cv2s():
    for r in range(1, 16):
        np.testing.assert_array_equal(
            raster.ellipse_kernel(r).astype(np.uint8),
            cv2.getStructuringElement(cv2.MORPH_ELLIPSE,
                                      (2 * r + 1, 2 * r + 1)))


def _text_block(rng):
    """Corners of 3-40 line rectangles of a text block, tilted by up to
    3e-3 rad: their left and right edges are near-collinear sets."""
    n = int(rng.integers(3, 41))
    th = rng.uniform(-3e-3, 3e-3)
    x0, y0 = rng.uniform(50, 1200, 2)
    w, h = rng.uniform(200, 600), rng.uniform(10, 16)
    c, s = np.cos(th), np.sin(th)
    pts = []
    for i in range(n):
        wl = w * rng.uniform(0.85, 1.0) if i == n - 1 or rng.random() < 0.3 \
            else w
        xs, ys = x0 + rng.uniform(-0.5, 0.5), y0 + i * h * 1.5
        for dx, dy in ((0, 0), (wl, 0), (wl, h), (0, h)):
            x, y = xs + dx - x0, ys + dy - y0
            pts.append((x0 + x * c - y * s, y0 + x * s + y * c))
    return np.array(pts)


@pytest.mark.parametrize("kind", ["uniform", "lattice", "clustered",
                                  "collinear", "text_block"])
def test_convex_hull_is_cv2s(kind):
    rng = np.random.default_rng({"uniform": 0, "lattice": 1, "clustered": 2,
                                 "collinear": 1, "text_block": 3}[kind])
    # collinear: the 2,000 sets of scripts/torch_parity_gaps.py::hull_collinear
    n_sets = {"collinear": 2000, "text_block": 1000}.get(kind, 300)
    for _ in range(n_sets):
        if kind == "collinear":
            u = rng.uniform(0, 1, int(rng.integers(3, 15)))
            p = np.c_[3 + 7 * u, 2 + 5 * u]
        elif kind == "text_block":
            p = _text_block(rng)
        else:
            k = int(rng.integers(1, 30))
        if kind == "uniform":
            p = rng.uniform(0, 1000, (k, 2))
        elif kind == "lattice":
            p = rng.integers(0, 6, (k, 2)).astype(float)
        elif kind == "clustered":
            base = rng.uniform(0, 1000, (4, 2))
            p = base[rng.integers(0, 4, k)] \
                + rng.integers(0, 2, (k, 2)) * 0.25
        p = p.astype(np.float32)
        np.testing.assert_array_equal(
            poly.convex_hull_f32(p),
            cv2.convexHull(p).reshape(-1, 2).astype(np.float64))
        if kind in ("lattice", "clustered"):
            # integer points take cv2's exact integer scan
            q = np.round(p).astype(np.int32)
            np.testing.assert_array_equal(
                q[poly.convex_hull_indices(q)].reshape(-1, 2),
                cv2.convexHull(q).reshape(-1, 2))


@pytest.fixture(scope="module")
def fixture_regions(tmp_path_factory):
    from origami_tpu_torch.batch.core.io import Artifact, Input, Stage
    tmp = tmp_path_factory.mktemp("regions")
    readers = []
    for png in sorted(FULL.glob("*.png")):
        shutil.copy(png, tmp)
        out = tmp / (png.stem + ".out")
        out.mkdir()
        shutil.copy(FULL / (png.stem + ".out") / "segment.zip", out)
        shutil.copy(FLOW / (png.stem + ".out") / "contours.0.zip", out)
        readers.append(Input(Artifact.CONTOURS, stage=Stage.WARPED)
                       .instantiate(tmp / png.name, device="cpu"))
    return readers


def test_native_and_python_text_areas_agree_on_fixture(fixture_regions):
    """The flow stage's text areas (blocks minus buffered neighbours and
    separators) through native.cpp and through the Python overlay."""
    from origami_tpu_torch.core.block import TextAreaFactory
    n = 0
    for r in fixture_regions:
        obstacles = [G.ops.buffer(g, 3.0) for g in r.separators.geoms]
        blocks = r.regions.by_path
        areas = {}
        try:
            for native in (True, False):
                booleans.USE_NATIVE = native
                f = TextAreaFactory(list(blocks.values()),
                                    obstacles=obstacles)
                areas[native] = {p: f(b, "TABULAR" not in p).wkt
                                 for p, b in blocks.items()}
        finally:
            booleans.USE_NATIVE = True
        assert areas[True] == areas[False]
        n += len(blocks)
    assert n > 50
