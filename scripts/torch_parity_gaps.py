"""Measure, on the CPU, the parity gaps between the PyTorch port's plain
kernels and the JAX functions they are held against (ROADMAP.md, queue
C): numbers the parity tests only bound.

    JAX_PLATFORMS=cpu python scripts/torch_parity_gaps.py

  1. strip mode (a) vs the JAX banded route (extract_strips_banded) and
     vs the direct affine sample (extract_line_strips) as lines tilt;
  2. the port's dewarp vs the JAX dense route on the fixture pages'
     own grids (page-boundary pixels of the hard edge);
  3. remap vs remap_pallas(interpret=True) on a map off the 1/64-px
     lattice;
  4. the dewarp grid build (ops/grid.build_grid_plain) vs build_grid_device
     on seeded sample sets, at 400x300 and at the fixture's 1312x1920;
  5. the port's convex hull vs cv2.convexHull on point sets collinear to
     within float32 rounding, and on the corners of a text block's tilted
     line rectangles;
  6. what the dewarp's hard page edge (ROADMAP C3) costs the composed
     text: the port's OCR stage (single model) and compose stage on the
     JAX inputs of the fixture, once as they run and once with the
     dewarped page replaced by the JAX banded route's; page.txt lines
     that differ from the JAX chain's in the first run only come from
     the edge, the rest from bf16 convolution rounding (ROADMAP C2).
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from origami_tpu.core.dewarp import Grid as JaxGrid  # noqa: E402
from origami_tpu.core.dewarp import _jitted_dewarp_fns  # noqa: E402
from origami_tpu.ops import remap as jax_remap  # noqa: E402
from origami_tpu.ops.pallas.remap import remap_pallas  # noqa: E402
from origami_tpu_torch.core import _png  # noqa: E402
from origami_tpu_torch.core.block import BAND_PAD, Line  # noqa: E402
from origami_tpu_torch.ops import remap as ops  # noqa: E402

FIXTURE = ROOT / "tests/data/torch_ocr/full"


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def frames(specs, th=48):
    fr, wd = [], []
    for x, y, length, height, slope in specs:
        line = Line(None, p=[x, y], right=[length, length * slope],
                    up=[height * slope, -height])
        band_h = height * np.hypot(1, slope) * (1 + sum(BAND_PAD))
        f, w = line.dewarped_frame(th, xres=th / band_h, pad=BAND_PAD)
        fr.append(f)
        wd.append(w)
    return np.stack(fr).astype(np.float32), np.asarray(wd, np.int32)


def strip_drift(crop):
    print("1. strip mode (a): share of pixels within 1 gray level")
    print("   slope   vs extract_strips_banded   vs extract_line_strips "
          "(max |diff|, inside the page)")
    for slope in (0.0, 5e-4, 1e-3, 2e-3, 3e-3, 5e-3, 1e-2, 2e-2):
        fr, wd = frames([(20, 60, 100, 14, slope), (40, 120, 90, 18, -slope),
                         (5, 190, 100, 16, slope), (150, 40, 60, 20, slope)])
        banded = np.asarray(jax_remap.extract_strips_banded(
            jnp.asarray(crop), jnp.asarray(fr), jnp.asarray(wd), 48, 256,
            64, 264, 6, 255.0))
        direct = np.asarray(jax_remap.extract_line_strips(
            jnp.asarray(crop.astype(np.float32)), jnp.asarray(fr),
            jnp.asarray(wd), 48, 256, 255.0))
        got = ops.strips_dewarped(t(crop), t(fr), t(wd), 48, 256).numpy()
        d = np.abs(got.astype(int) - banded.astype(int))
        xs = np.arange(256, dtype=np.float32)[None, None, :]
        ys = np.arange(48, dtype=np.float32)[None, :, None]
        px = fr[:, 0, 0, None, None] * xs + fr[:, 0, 1, None, None] * ys \
            + fr[:, 0, 2, None, None]
        py = fr[:, 1, 0, None, None] * xs + fr[:, 1, 1, None, None] * ys \
            + fr[:, 1, 2, None, None]
        h, w = crop.shape
        inside = ((px >= 1) & (px <= w - 2) & (py >= 1) & (py <= h - 2)
                  & (xs < wd[:, None, None]))
        dd = np.abs(got.astype(np.float32) - direct)[inside]
        print("   %-7g %.5f (max %3d)               %.3f"
              % (slope, (d <= 1).mean(), d.max(), dd.max()))


def dewarp_edges():
    print("2. dewarp vs the JAX dense route on the fixture grids")
    for png in sorted(FIXTURE.glob("*.png")):
        grid = JaxGrid.open(png.with_suffix(".out") / "dewarp.zip")
        page = _png.read_gray(png)
        ref = np.asarray(_jitted_dewarp_fns()[1](
            jnp.asarray(page), jnp.asarray(grid._hv),
            jnp.ones(2, jnp.float32), grid.resolution))
        got = ops.dewarp_u8(t(page), t(grid._hv), grid.resolution).numpy()
        d = np.abs(got.astype(int) - ref.astype(int))
        mx, my = (p.numpy() for p in ops._upsample_grid(t(grid._hv),
                                                         grid.resolution))
        h, w = page.shape
        edge = ((np.abs(mx) < 1e-3) | (np.abs(mx - (w - 1)) < 1e-3)
                | (np.abs(my) < 1e-3) | (np.abs(my - (h - 1)) < 1e-3))
        big = d > 1
        print("   %s: %d of %d pixels > 1 off (max %d), %d of them on a "
              "page-boundary coordinate" % (png.name, big.sum(), d.size,
                                            d.max(), (big & edge).sum()))


def remap_offlattice(crop):
    print("3. remap vs remap_pallas(interpret=True), map off the lattice")
    img = crop.astype(np.float32)
    yy, xx = np.meshgrid(np.arange(64, dtype=np.float32),
                         np.arange(256, dtype=np.float32), indexing="ij")
    mx = 20.0 + 0.98 * xx + 0.05 * yy + 1.5 * np.sin(yy / 9.0 + 0.3)
    my = 60.0 + 1.02 * yy - 0.03 * xx + 1.2 * np.sin(xx / 17.0 + 1.1)
    m = np.stack([mx, my], -1).astype(np.float32)
    ref = np.asarray(remap_pallas(jnp.asarray(img), jnp.asarray(m),
                                  fill=0.0, interpret=True))
    got = ops.remap(t(img), t(m), 0.0).numpy()
    q = np.round(m * 64) / 64
    refq = np.asarray(remap_pallas(jnp.asarray(img), jnp.asarray(q),
                                   fill=0.0, interpret=True))
    gotq = ops.remap(t(img), t(q.astype(np.float32)), 0.0).numpy()
    print("   max |diff| %.2e off the lattice, %.2e on the 1/64 lattice"
          % (np.abs(got - ref).max(), np.abs(gotq - refq).max()))


def grid_drift():
    import math
    from origami_tpu.core import dewarp as jax_dewarp
    from origami_tpu_torch.ops import grid as port_grid
    print("4. build_grid_plain vs build_grid_device (60 seeded samples a field)")
    for seed, (w, h) in ((0, (400, 300)), (1, (400, 300)),
                         (2, (1312, 1920))):
        rng = np.random.default_rng(seed)
        padded = []
        for base in (0.0, math.pi / 2):
            pts = np.c_[rng.uniform(0, w, 60), rng.uniform(0, h, 60)]
            phi = base + 0.03 * np.sin(pts[:, 0] / 70.0) \
                + rng.normal(0, 0.01, 60)
            padded += list(jax_dewarp._pad_samples(pts, phi, 1024))
        n_gx = jax_dewarp._round_up(math.ceil(w / 25) + 6, 8)
        n_gy = jax_dewarp._round_up(math.ceil(h / 25) + 6, 8)
        ref = np.asarray(jax_dewarp.build_grid_device(
            *map(jnp.asarray, padded), n_gy=n_gy, n_gx=n_gx, res=25))
        got = port_grid.build_grid_plain(*map(t, padded), n_gy, n_gx,
                                         25).numpy()
        print("   seed %d, %dx%d page, grid %s: max |diff| %.2e px"
              % (seed, w, h, ref.shape[:2], np.abs(got - ref).max()))
    # chip_smoke.grid_case "miss": the V samples of the left 30 % point
    # up; between the halves the rays turn through the horizontal, where
    # the choice among the far-extended border segments follows float32
    # rounding, so the grid is ill-conditioned beyond small pages
    from chip_smoke import grid_case
    for w, h in ((400, 300), (800, 600), (1312, 1920)):
        padded, (n_gy, n_gx) = grid_case("miss", w, h)
        ref = np.asarray(jax_dewarp.build_grid_device(
            *map(jnp.asarray, padded), n_gy=n_gy, n_gx=n_gx, res=25))
        got = port_grid.build_grid_plain(*map(t, padded), n_gy, n_gx,
                                         25).numpy()
        print("   rays that miss (left 30 %% of the V field up), %dx%d: "
              "max |diff| %.2e px" % (w, h, np.abs(got - ref).max()))


def hull_collinear(n_sets=2000, n_blocks=1000):
    import cv2
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_geometry import _text_block
    from origami_tpu_torch.geometry.poly import convex_hull_f32
    print("5. convex hull vs cv2.convexHull, near-collinear point sets")
    rng = np.random.default_rng(1)
    sets = []
    for _ in range(n_sets):
        u = rng.uniform(0, 1, int(rng.integers(3, 15)))
        sets.append(np.c_[3 + 7 * u, 2 + 5 * u].astype(np.float32))
    rng = np.random.default_rng(3)
    blocks = [_text_block(rng).astype(np.float32) for _ in range(n_blocks)]
    for name, group in (("collinear", sets), ("text-block", blocks)):
        differ = 0
        for p in group:
            want = cv2.convexHull(p).reshape(-1, 2).astype(np.float64)
            got = convex_hull_f32(p)
            differ += got.shape != want.shape or not np.array_equal(got,
                                                                    want)
        print("   %s: %d of %d sets differ" % (name, differ, len(group)))


def composed_edge_cost(tmp):
    """Item 6: page.txt lines that differ from the JAX chain's, with the
    port's dewarped page and with the JAX banded route's."""
    import chip_smoke
    from origami_tpu.core.page import Page as JaxPage
    from origami_tpu_torch.batch.detect.compose import ComposeProcessor
    from origami_tpu_torch.batch.detect.ocr import OCRProcessor
    from origami_tpu_torch.core import page as port_page
    print("6. composed text vs the JAX chain's: the dewarp's page edge "
          "(C3) against bf16 rounding (C2)")
    opts = dict(device="cpu", lock_strategy="NONE", plain=True)
    model = str(ROOT / "models_pretrained" / "recognizer")
    own = port_page.Page.dewarped_dev
    banded = {}

    def jax_dewarped(self):
        key = self.path.name
        if key not in banded:
            banded[key] = torch.from_numpy(np.array(JaxPage(
                self.path, JaxGrid.open(self.path.with_suffix(".out")
                                        / "dewarp.zip")).dewarped))
        return banded[key]

    differing = {}
    for route in ("port", "jax_banded"):
        corpus = chip_smoke.order_corpus(Path(tmp) / route)
        for png in corpus.glob("*.png"):
            shutil.copy(chip_smoke.COMPOSE_REF / (png.stem + ".out")
                        / "order.json", corpus / (png.stem + ".out"))
        port_page.Page.dewarped_dev = own if route == "port" \
            else property(jax_dewarped)
        try:
            OCRProcessor(dict(opts, model=model)).traverse(str(corpus))
        finally:
            port_page.Page.dewarped_dev = own
        ComposeProcessor(dict(opts)).traverse(str(corpus))
        lines = set()
        for png in sorted(corpus.glob("*.png")):
            got = chip_smoke.page_text(corpus / (png.stem + ".out")
                                       / "compose.zip").split("\n")
            ref = chip_smoke.page_text(chip_smoke.COMPOSE_REF / (
                png.stem + ".out") / "compose.zip").split("\n")
            same, n, errs, chars = chip_smoke.text_diff("\n".join(got),
                                                        "\n".join(ref))
            lines |= {(png.stem, t) for t in ref if t not in got}
            print("   %-10s %s: %d of %d page.txt lines identical, CER "
                  "%.5f" % (route, png.stem, same, n, errs / chars))
        differing[route] = lines
    edge = differing["port"] - differing["jax_banded"]
    print("   differing lines from the page edge (C3): %d %s" % (
        len(edge), sorted(edge)))
    print("   differing lines either way (bf16 rounding, C2): %d %s" % (
        len(differing["port"] & differing["jax_banded"]),
        sorted(differing["port"] & differing["jax_banded"])))


def main():
    page = _png.read_gray(FIXTURE / "synth0001.png")
    crop = np.ascontiguousarray(page[700:900, 250:550])
    strip_drift(crop)
    dewarp_edges()
    remap_offlattice(crop)
    grid_drift()
    hull_collinear()
    with tempfile.TemporaryDirectory() as tmp:
        composed_edge_cost(tmp)


if __name__ == "__main__":
    main()
