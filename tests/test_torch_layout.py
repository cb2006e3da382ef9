"""The port's layout stage and its host modules against the JAX package.

Tolerances, each with its reason:
  * neighbors (edges in networkx's order), the XY-cut order, concave
    hulls and geometry_ops' squeeze splits and inscribed rectangles:
    exactly the JAX results (the same host code; the raster steps give
    cv2's pixels and vertices, tests/test_torch_contours.py);
  * the binarization site on a whole fixture page: >= 99.9 % of the
    pixels equal to the JAX stage's (ROADMAP's bar for binary masks),
    and no more than the 194 pixels that differ on synth0001 (ROADMAP
    C3): the port's Sauvola sums are exact integers where JAX
    differences float32 integral images (a few pixels in ten thousand);
    the separator mask itself, resized, dewarped by the site's
    dewarp_f32 and thresholded, equals the JAX banded route's on every
    pixel of both fixture pages;
  * each separator-whitening route on a small crafted page (a smooth
    grid, a sheared grid that has no banded plan, no grid, no mask):
    every pixel equal;
  * the stage: contours.2.zip's entries and tables.json equal to
    tests/data/torch_layout (the JAX stage on the same inputs).
"""

import json
import shutil
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from origami_tpu import geometry as J
from origami_tpu.batch.core.io import Artifact as JArtifact
from origami_tpu.batch.core.io import Input as JInput
from origami_tpu.batch.core.io import Stage as JStage
from origami_tpu.batch.detect.layout import RegionState as JaxRegionState
from origami_tpu.core import geometry_ops as jax_geometry_ops
from origami_tpu.core import hull as jax_hull
from origami_tpu.core import neighbors as jax_neighbors
from origami_tpu.core import xycut as jax_xycut
from origami_tpu.core.dewarp import Grid as JaxGrid
from origami_tpu.ops import binarize as jax_binarize
from origami_tpu.ops.remap import dewarp_banded
from origami_tpu_torch import geometry as G
from origami_tpu_torch.batch.core.io import Artifact, Input, Stage, \
    read_contours_zip
from origami_tpu_torch.batch.detect import layout as stage
from origami_tpu_torch.core import geometry_ops, hull, neighbors, xycut
from origami_tpu_torch.core.dewarp import Grid
from origami_tpu_torch.core.segment import PredictorType
from origami_tpu_torch.ops import binarize
from origami_tpu_torch.ops.remap import dewarp_f32
from origami_tpu_torch.ops.resize import resize
from test_torch_geometry import jax_native  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
FULL = ROOT / "tests/data/torch_ocr/full"
FLOW = ROOT / "tests/data/torch_flow"
LAYOUT = ROOT / "tests/data/torch_layout"
COMMON = ["--device", "cpu", "--lock-strategy", "NONE", "--plain"]
INPUTS = ("contours.0.zip", "lines.0.zip", "contours.1.zip", "dewarp.zip",
          "runtime.json")


def corpus(dst, stems=("synth0000", "synth0001")):
    """The layout stage's inputs: torch_ocr/full's PNG and segment.zip,
    torch_flow's contours, lines and grid (the JAX stages' artifacts)."""
    dst.mkdir()
    for stem in stems:
        out = dst / (stem + ".out")
        out.mkdir()
        shutil.copy(FULL / (stem + ".png"), dst / (stem + ".png"))
        shutil.copy(FULL / (stem + ".out") / "segment.zip", out)
        for name in INPUTS:
            shutil.copy(FLOW / (stem + ".out") / name, out)
    return dst


def dewarped_regions(stem):
    path = FLOW / (stem + ".out") / "contours.1.zip"
    items, _ = read_contours_zip(path, PredictorType.REGION)
    port = {k: g for k, g in items}
    jax_items = {k: J.wkt.loads(g.wkt) for k, g in items}
    return port, jax_items


@pytest.mark.parametrize("stem", ["synth0000", "synth0001"])
def test_neighbors_and_xycut_equal_jax(stem):
    port, jx = dewarped_regions(stem)
    got = neighbors.neighbors(port)
    want = jax_neighbors.neighbors(jx)
    assert list(got.edges()) == list(want.edges())
    assert got.nodes == list(want.nodes)
    for fringe in (0.0, 5.0):
        assert xycut.polygon_order(list(port.items()), fringe=fringe) == \
            jax_xycut.polygon_order(list(jx.items()), fringe=fringe)
    bounds = [(k, g.bounds) for k, g in port.items()]
    for mode in ("flat", "grouped"):
        assert xycut.reading_order(bounds, mode=mode) == \
            jax_xycut.reading_order(bounds, mode=mode)


def test_concave_hull_equals_jax(jax_native):
    port, jx = dewarped_regions("synth0001")
    for k in list(port)[:12]:
        for concavity, detail in ((2.0, 0.0), (1.5, 20.0)):
            assert hull.concave_hull_polygon(
                port[k], concavity, detail).wkt == \
                jax_hull.concave_hull_polygon(jx[k], concavity, detail).wkt


def dumbbell(neck):
    a = [(0, 0), (60, 0), (60, 25 - neck), (100, 25 - neck), (100, 0),
         (160, 0), (160, 50), (100, 50), (100, 25 + neck), (60, 25 + neck),
         (60, 50), (0, 50)]
    return a


@pytest.mark.parametrize("neck", [3, 6, 12])
def test_geometry_ops_equal_jax(neck):
    c = dumbbell(neck)
    got = geometry_ops.squeeze_split(G.Polygon(c), 0.5, 0.2)
    want = jax_geometry_ops.squeeze_split(J.Polygon(c), 0.5, 0.2)
    assert [p.wkt for p in got] == [p.wkt for p in want]
    assert geometry_ops.largest_inscribed_rect(G.Polygon(c)).wkt == \
        jax_geometry_ops.largest_inscribed_rect(J.Polygon(c)).wkt


def crafted_page():
    rng = np.random.default_rng(0)
    h, w, res = 96, 128, 8
    img = np.full((h, w), 230, np.uint8)
    for y in range(8, h - 8, 12):
        img[y:y + 6, 10:w - 10][rng.random((6, w - 20)) < 0.6] = 30
    yy, xx = np.mgrid[0:h // res, 0:w // res].astype(np.float64) * res
    smooth = np.stack([xx + 1.5 * np.sin(yy / 40),
                       yy + 2.0 * np.sin(xx / 50) + 0.7], -1)
    sheared = np.stack([xx + 0.4 * yy + 3 * np.sin(yy / 9),
                        yy + 0.35 * xx], -1)
    sep = np.zeros((60, 70), bool)
    sep[10:50, 33:35] = True
    sep[30, 5:65] = True
    sep[:, 0] = True                     # on the page's edge
    return img, res, smooth.astype(np.float32), sheared.astype(np.float32), \
        sep


def test_each_whitening_route_equals_jax():
    img, res, smooth, sheared, sep = crafted_page()
    h, w = img.shape
    t_img, t_sep = torch.from_numpy(img), torch.from_numpy(sep)
    sep_packed = jnp.asarray(np.packbits(sep, axis=1))
    plan = JaxGrid(smooth, res).banded_plan((h, w))
    assert plan is not None and Grid(smooth, res).has_banded_plan((h, w))
    assert JaxGrid(sheared, res).banded_plan((h, w)) is None
    assert not Grid(sheared, res).has_banded_plan((h, w))
    cases = [
        (binarize.binarize_sep_dewarped_packed(
            t_img, 15, t_sep, torch.from_numpy(smooth), res, h, w),
         jax_binarize.binarize_sep_banded_packed(
             jnp.asarray(img), 15, sep_packed, jnp.asarray(plan["lat_my"]),
             jnp.asarray(plan["lat_mx"]), sep.shape[1], h, w, plan["step"],
             plan["d1"], plan["n1"], plan["d2"], plan["n2"])),
        (binarize.binarize_with_separators_packed(
            t_img, 15, t_sep, torch.from_numpy(sheared), res, h, w),
         jax_binarize.binarize_with_separators_packed(
             jnp.asarray(img), 15, jnp.asarray(sep),
             jnp.asarray(sheared), float(res), h, w)),
        (binarize.binarize_sep_resized_packed(t_img, 15, t_sep),
         jax_binarize.binarize_sep_resized_packed(
             jnp.asarray(img), 15, sep_packed, sep.shape[1])),
        (binarize.sauvola_packed(t_img, 15),
         jax_binarize.sauvola_packed(jnp.asarray(img), 15)),
    ]
    for got, want in cases:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def region_state(mod, page, rs, **kw):
    inp, art, stg = mod
    warped = inp(art.CONTOURS, art.LINES, art.SEGMENTATION,
                 stage=stg.WARPED).instantiate(page, **kw)
    dew = inp(art.CONTOURS, stage=stg.DEWARPED).instantiate(page, **kw)
    return rs(dew.page, warped.lines.by_path,
              [(k, b.image_space_polygon)
               for k, b in dew.regions.by_path.items()],
              dew.separators, warped.segmentation, grid=dew.grid)


# the binarized layout page's pixels that differ from the JAX stage's on
# synth0001 (ROADMAP C3; 475 on synth0000), measured with dewarp_f32 at
# the site
SITE_DIFFERING = 194


def test_binarization_site_matches_jax_on_a_page(tmp_path):
    c = corpus(tmp_path / "c", stems=("synth0001",))
    page = c / "synth0001.png"
    port = region_state((Input, Artifact, Stage), page, stage.RegionState,
                        device="cpu")
    jx = region_state((JInput, JArtifact, JStage), page, JaxRegionState)
    assert port.median_line_height == jx.median_line_height
    got, want = port.binarized, jx.binarized
    assert got.shape == want.shape == (2200, 1600)
    assert (got == want).mean() >= 0.999
    assert (got != want).sum() <= SITE_DIFFERING
    # the separator mask alone: resized onto the warped page, dewarped
    # through the grid (the site's dewarp_f32 against the banded route),
    # thresholded
    sep = [p.labels != p.classes["BACKGROUND"].value
           for p in port._segmentation.predictions
           if p.type == PredictorType.SEPARATOR][0]
    ww, wh = port.page.size(False)
    h, w = got.shape
    plan = jx.grid.banded_plan((wh, ww))
    js = jax.image.resize(jnp.asarray(sep, jnp.float32), (wh, ww),
                          method="linear")
    jd = np.asarray(dewarp_banded(
        js, jnp.asarray(plan["lat_my"]), jnp.asarray(plan["lat_mx"]),
        plan["step"], plan["d1"], plan["n1"], plan["d2"], plan["n2"],
        h, w, 0.0))
    ps = resize(torch.from_numpy(sep).float(), (wh, ww), "area")
    pd = dewarp_f32(ps.contiguous(),
                    torch.from_numpy(port.grid.points("sample")),
                    port.grid.resolution, 0.0).numpy()
    np.testing.assert_array_equal(pd > 0.2, jd > 0.2)


def entries(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def test_stage_matches_jax_layout_artifacts(tmp_path, capsys):
    c = corpus(tmp_path / "c")
    stage.main(COMMON + [str(c)])
    launches = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # the CPU runs the kernels' plain versions: nothing launches
    assert set(launches["kernel_launches"].values()) == {0}
    for stem in ("synth0000", "synth0001"):
        out = c / (stem + ".out")
        rt = json.loads((out / "runtime.json").read_text())
        assert rt[stage.STAGE_NAME]["status"] == "COMPLETED", rt
        assert rt[stage.STAGE_NAME]["sauvola_window"] == 5
        want_dir = LAYOUT / (stem + ".out")
        got, want = entries(out / "contours.2.zip"), \
            entries(want_dir / "contours.2.zip")
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name] == want[name], name
        assert json.loads((out / "tables.json").read_text()) == \
            json.loads((want_dir / "tables.json").read_text())
        assert json.loads((want_dir / "tables.json").read_text()) == \
            json.loads((FULL / (stem + ".out") / "tables.json").read_text())


def test_layout_entry_points_need_cuda_unless_told_cpu():
    assert stage.parser().parse_args(["x"]).device == "cuda"
    assert stage.parser().parse_args(["x"]).layout == "bbz"
    for name in ("bbz", "default"):
        assert stage.load_layout(name).make_transformer() is not None
    with pytest.raises(ValueError, match="not found"):
        stage.load_layout("nosuchlayout")
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    for make in (lambda: stage.LayoutDetectionProcessor({}),
                 lambda: stage.main(["--lock-strategy", "NONE", "."])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert stage.LayoutDetectionProcessor(
        {"device": "cpu"}).device.type == "cpu"
