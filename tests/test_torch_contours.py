"""The port's contours stage and its cv2-free raster code against cv2, the
JAX package's native bindings and the JAX stage's artifacts.

Tolerances, each with its reason:
  * border following, contour areas, connected components, both chamfer
    distance transforms and the polygon fill: exactly cv2's (the same
    vertices in the same order, the same hierarchy, labels, stats and
    float32 distances, the same pixels): contour_trace.cpp repeats
    OpenCV's algorithms step for step;
  * the raster bridge (make_valid, unions, polygon buffers) and the
    skeleton polylines: the JAX package's WKT exactly, since every raster
    step now gives cv2's pixels and vertices;
  * the native bindings (thinning, city-block EDT, skeleton tracer,
    concave hull): equal to the JAX bindings' output, the same C++;
  * the graph module: networkx's node, edge and path orders exactly;
  * the stage: contours.0.zip's WKT entries and meta.json byte for byte
    equal to tests/data/torch_flow (the JAX stage on the same inputs).
"""

import json
import shutil
import zipfile
from pathlib import Path

import cv2
import networkx as nx
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from origami_tpu import geometry as J
from origami_tpu.core import contours as jax_contours
from origami_tpu.core import skeleton as jax_skeleton
from origami_tpu.core.math import Orientation as JaxOrientation
from origami_tpu.geometry import native_bindings as jax_nb
from origami_tpu_torch import geometry as G
from origami_tpu_torch.batch.detect import contours as stage
from origami_tpu_torch.core import contours as port_contours
from origami_tpu_torch.core import graph
from origami_tpu_torch.core import skeleton as port_skeleton
from origami_tpu_torch.core.math import Orientation
from origami_tpu_torch.geometry import contour_trace as T
from origami_tpu_torch.geometry import native_bindings as nb
from origami_tpu_torch.geometry import raster
from test_torch_geometry import jax_native, pair  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
FULL = ROOT / "tests/data/torch_ocr/full"
FLOW = ROOT / "tests/data/torch_flow"
COMMON = ["--device", "cpu", "--lock-strategy", "NONE", "--plain"]


def crafted(kind):
    """Masks for the cases border following gets wrong first."""
    m = np.zeros((40, 48), np.uint8)
    if kind == "holes_in_holes":
        m[2:38, 2:46] = 1
        m[6:34, 6:42] = 0            # a hole
        m[10:30, 10:38] = 1          # an island in it
        m[14:26, 14:34] = 0          # a hole in the island
        m[18:22, 20:24] = 1          # and an island in that
    elif kind == "lines":
        m[5, 3:40] = 1               # 1-px horizontal line
        m[8:35, 20] = 1              # 1-px vertical line
        m[np.arange(10, 30), np.arange(10, 30)] = 1     # diagonal
        m[30, 40] = 1                # a single pixel
    elif kind == "border":
        m[0:10, 0:12] = 1            # touches two borders
        m[30:, 40:] = 1
        m[0, 20:30] = 1
        m[15:25, 47] = 1
    elif kind == "diagonal":
        for k in range(0, 30, 2):
            m[5 + k // 2, 5 + k] = 1     # 8-connected only
        m[20:30, 20:30] = 1
        m[30, 30] = 1                # joined diagonally to the square
        m[24:26, 24:26] = 0          # a hole
        m[31, 31] = 1
    elif kind == "touching_holes":
        m[4:36, 4:44] = 1
        m[8:16, 8:16] = 0
        m[16:24, 16:24] = 0          # meets the first hole at a corner
        m[10:20, 30:40] = 0
    return m


def seeded(seed):
    rng = np.random.default_rng(seed)
    h, w = (int(v) for v in rng.integers(8, 90, 2))
    kind = seed % 4
    if kind == 0:
        m = rng.random((h, w)) < 0.5
    elif kind == 1:
        m = ndi.binary_dilation(rng.random((h, w)) < 0.03,
                                iterations=int(rng.integers(1, 4)))
    elif kind == 2:
        m = rng.random((h, w)) < 0.15
    else:
        m = ndi.gaussian_filter(rng.random((h, w)), 2) > 0.5
    return m.astype(np.uint8)


MASKS = [(k, crafted(k)) for k in ("holes_in_holes", "lines", "border",
                                   "diagonal", "touching_holes")] \
    + [("seed%d" % s, seeded(s)) for s in range(8)]


@pytest.mark.parametrize("name,mask", MASKS, ids=[n for n, _ in MASKS])
def test_border_following_area_and_components_are_cv2s(name, mask):
    want, want_h = cv2.findContours(mask.copy(), cv2.RETR_CCOMP,
                                    cv2.CHAIN_APPROX_SIMPLE)
    got, got_h = T.find_contours(mask)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert T.contour_area(g) == cv2.contourArea(w)
    np.testing.assert_array_equal(got_h, want_h)
    n, labels, stats, _ = cv2.connectedComponentsWithStats(
        mask, connectivity=8)
    got_n, got_labels, got_stats = T.connected_components_with_stats(mask)
    assert got_n == n
    np.testing.assert_array_equal(got_labels, labels)
    np.testing.assert_array_equal(got_stats, stats)


@pytest.mark.parametrize("name,mask", MASKS[:5] + MASKS[-2:],
                         ids=[n for n, _ in MASKS[:5] + MASKS[-2:]])
def test_chamfer_distance_transforms_are_cv2s(name, mask):
    np.testing.assert_array_equal(T.distance_transform(mask),
                                  cv2.distanceTransform(mask, cv2.DIST_L2, 5))
    dist, labels = cv2.distanceTransformWithLabels(
        mask, cv2.DIST_L2, 5, labelType=cv2.DIST_LABEL_PIXEL)
    got_dist, got_labels = T.distance_transform_with_labels(mask)
    np.testing.assert_array_equal(got_dist, dist)
    np.testing.assert_array_equal(got_labels, labels)


def test_empty_mask_has_no_contours():
    contours, hierarchy = T.find_contours(np.zeros((5, 7), bool))
    assert contours == () and hierarchy is None
    assert T.connected_components_with_stats(np.zeros((5, 7)))[0] == 1


@pytest.mark.parametrize("seed", range(6))
def test_polygon_fill_and_lines_are_cv2s(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        n = int(rng.integers(3, 12))
        if rng.random() < 0.5:           # simple, star-shaped
            ang = np.sort(rng.uniform(0, 2 * np.pi, n))
            rad = rng.uniform(3, 28, n)
            pts = np.round(np.c_[30 + rad * np.cos(ang),
                                 30 + rad * np.sin(ang)]).astype(np.int32)
        else:                            # self-intersecting
            pts = rng.integers(0, 60, (n, 2)).astype(np.int32)
        want = np.zeros((64, 64), np.uint8)
        got = want.copy()
        cv2.fillPoly(want, [pts], 1)
        raster._fill_polygon(got, pts, 1)
        np.testing.assert_array_equal(got, want)
        want = np.zeros((64, 64), np.uint8)
        got = want.copy()
        cv2.polylines(want, [pts], False, 1)
        raster._draw_segments(got, pts, False, 1)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_raster_bridge_equals_jax(seed):
    pa, pb, ja, jb = pair(seed)
    for dist in (-3.0, 4.0):
        assert G.ops.buffer(pa, dist).wkt == J.ops.buffer(ja, dist).wkt
    assert G.raster.raster_union_all([pa, pb]).wkt == \
        J.raster.raster_union_all([ja, jb]).wkt
    bowtie = [(0, 0), (40, 40 + seed), (40, 0), (0, 40)]
    assert G.make_valid(G.Polygon(bowtie)).wkt == \
        J.make_valid(J.Polygon(bowtie)).wkt


@pytest.mark.parametrize("name,mask", MASKS[:4] + MASKS[5:8],
                         ids=[n for n, _ in MASKS[:4] + MASKS[5:8]])
def test_new_bindings_equal_jax_bindings(name, mask, jax_native):
    ink = mask > 0
    np.testing.assert_array_equal(nb.thin_mask_native(ink),
                                  jax_nb.thin_mask_native(ink))
    np.testing.assert_array_equal(nb.chamfer_edt_native(ink),
                                  jax_nb.chamfer_edt_native(ink))
    sk = nb.thin_mask_native(ink)
    got = nb.trace_skeleton_native(sk)
    want = jax_nb.trace_skeleton_native(sk)
    assert (got is None) == (want is None)      # None: buffers outgrown
    for g, w in zip(got or (), want or ()):
        np.testing.assert_array_equal(g, w)
    pts = np.unique(np.argwhere(ink)[:, ::-1].astype(np.float64), axis=0)
    if len(pts) >= 4:
        for concavity in (1.5, 3.0):
            g = nb.concave_hull_native(pts, concavity, 0.0)
            w = jax_nb.concave_hull_native(pts, concavity, 0.0)
            assert (g is None) == (w is None)
            if g is not None:
                np.testing.assert_array_equal(g, w)


def random_graph(seed):
    rng = np.random.default_rng(seed)
    edges = []
    for _ in range(40):
        u, v = (int(x) for x in rng.integers(0, 25, 2))
        edges.append((u, v, float(rng.integers(1, 5))))
    return edges


@pytest.mark.parametrize("seed", range(4))
def test_graph_keeps_networkx_orders(seed):
    edges = random_graph(seed)
    g, h = graph.Graph(), nx.Graph()
    for gr in (g, h):
        gr.add_nodes_from([3, 1, 30, 2])
        for u, v, w in edges:
            gr.add_edge(u, v, weight=w, index=u * 100 + v)
    assert list(g.edges()) == list(h.edges())
    assert g.number_of_edges() == h.number_of_edges()
    assert list(graph.connected_components(g)) == \
        list(nx.connected_components(h))
    weight = lambda u, v, d: d["weight"]   # noqa: E731
    got = graph.single_source_dijkstra_path_length(g, edges[0][0], weight)
    want = nx.single_source_dijkstra_path_length(h, edges[0][0],
                                                 weight=weight)
    assert list(got.items()) == list(want.items())
    inv = lambda u, v, d: 1.0 / (1e-9 + d["weight"])    # noqa: E731
    for target in want:
        assert graph.dijkstra_path(g, edges[0][0], target, inv) == \
            nx.shortest_path(h, edges[0][0], target, weight=inv)
    with pytest.raises(graph.NoPath):
        graph.dijkstra_path(g, 30, edges[0][0], inv)


def bar_with_block():
    """A 2-px rule with a block on it: the skeleton's junction cluster
    holds paths of equal length, which networkx's two-ended Dijkstra
    search and a search from one end break differently."""
    m = np.zeros((20, 170), np.uint8)
    m[5:13, 73:94] = 1
    m[13:15, 10:160] = 1
    return m


SEPARATOR_MASKS = MASKS[:5] + [("bar_with_block", bar_with_block())]


@pytest.mark.parametrize("name,mask", SEPARATOR_MASKS,
                         ids=[n for n, _ in SEPARATOR_MASKS])
def test_separator_polylines_equal_jax(name, mask, jax_native):
    for o, jo in ((Orientation.H, JaxOrientation.H),
                  (Orientation.V, JaxOrientation.V)):
        got = port_contours.EstimatePolyline(o, 3.0)(mask)
        want = jax_contours.EstimatePolyline(jo, 3.0)(mask)
        assert [p.line_string.wkt for p in got] == \
            [p.line_string.wkt for p in want]
        assert [p.width for p in got] == [p.width for p in want]
    sk = port_skeleton.FastSkeleton()(mask)
    jsk = jax_skeleton.FastSkeleton()(mask)
    for d in (None, np.array([1.0, 0.0])):
        a, b = sk.longest_path(d), jsk.longest_path(d)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_region_polygons_equal_jax(jax_native):
    """Contours + Decompose on masks whose borders touch themselves, so
    that make_valid's raster round trip runs."""
    for _, mask in MASKS:
        got = port_contours.Decompose()(port_contours.Contours()(mask))
        want = jax_contours.Decompose()(jax_contours.Contours()(mask))
        assert [p.wkt for p in got] == [p.wkt for p in want]
        for convex in (False, True):
            assert [p.wkt for p in port_contours.find_contour_polygons(
                        mask, convex=convex)] == \
                [p.wkt for p in jax_contours.find_contour_polygons(
                    mask, convex=convex)]


def corpus(tmp_path):
    c = tmp_path / "c"
    c.mkdir()
    for png in sorted(FULL.glob("*.png")):
        shutil.copy(png, c / png.name)
        (c / (png.stem + ".out")).mkdir()
        shutil.copy(FULL / (png.stem + ".out") / "segment.zip",
                    c / (png.stem + ".out") / "segment.zip")
    return c


def entries(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def test_stage_matches_jax_contours_zip(tmp_path, capsys):
    c = corpus(tmp_path)
    stage.main(COMMON + [str(c)])
    launches = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(launches["kernel_launches"].values()) == {0}
    for png in sorted(FULL.glob("*.png")):
        out = c / (png.stem + ".out")
        rt = json.loads((out / "runtime.json").read_text())
        assert rt[stage.STAGE_NAME]["status"] == "COMPLETED", rt
        got = entries(out / "contours.0.zip")
        want = entries(FLOW / (png.stem + ".out") / "contours.0.zip")
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name] == want[name], name


def test_export_images_match_jax_crops(tmp_path):
    """--export-images: the same entry names as the JAX stage's zip, and
    every region crop (the port's gray PNG encoder; PIL's in the JAX
    stage) the same pixels under PIL."""
    import io

    import PIL.Image
    from origami_tpu.batch.detect.contours import \
        ContoursProcessor as JaxContours
    got_dir, want_dir = tmp_path / "port", tmp_path / "jax"
    for d in (got_dir, want_dir):
        d.mkdir()
        c = corpus(d)
        for png in c.glob("synth0000*"):
            shutil.rmtree(png) if png.is_dir() else png.unlink()
    opts = dict(lock_strategy="NONE", plain=True, export_images=True)
    stage.ContoursProcessor(dict(opts, device="cpu")).traverse(
        str(got_dir / "c"))
    JaxContours(opts).traverse(str(want_dir / "c"))
    name = "synth0001.out/contours.0.zip"
    got, want = entries(got_dir / "c" / name), entries(want_dir / "c" / name)
    assert sorted(got) == sorted(want)
    pngs = [n for n in want if n.endswith(".png")]
    assert len(pngs) >= 10
    for n in want:
        if not n.endswith(".png"):
            assert got[n] == want[n], n
            continue
        a = np.asarray(PIL.Image.open(io.BytesIO(got[n])))
        b = np.asarray(PIL.Image.open(io.BytesIO(want[n])))
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b, err_msg=n)


def test_contours_entry_points_need_cuda_unless_told_cpu():
    assert stage.parser().parse_args(["x"]).device == "cuda"
    assert stage.parser().parse_args(["--export-images", "x"]).export_images
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    for make in (lambda: stage.ContoursProcessor({}),
                 lambda: stage.main(["--lock-strategy", "NONE", "."])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert stage.ContoursProcessor({"device": "cpu"}).device.type == "cpu"
