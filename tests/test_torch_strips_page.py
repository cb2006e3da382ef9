"""The page-level strip entries (`strips_dewarped_page`,
`strips_through_grid_page`: all groups of a page in one launch, into one
u8 buffer laid out by `strip_layout`) and `LineExtractor.device_groups`,
which cuts a page's strips through them.

Tolerances, each with its reason:
  * a page-level plain version against its group-level plain calls, and
    device_groups against the group-level calls it replaced: 0 — the
    same function of the same inputs;
  * either mode vs extract_line_strips_pallas(interpret=True) where
    strips_frames_ok holds: <= 2.55, the 1e-2-of-range bound that
    module states for its two-shear decomposition (remap.py:19-23), as
    in tests/test_torch_remap.py.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from origami_tpu.ops.pallas.remap import (extract_line_strips_pallas,
                                          strips_frames_ok)
from origami_tpu_torch.batch.core.io import Artifact, Input, Stage
from origami_tpu_torch.batch.core.lines import LineExtractor, identity_grid
from origami_tpu_torch.core import _png
from origami_tpu_torch.ops import remap as ops
from test_torch_remap import _frames, _t  # line specs -> strip frames

ROOT = Path(__file__).resolve().parent.parent
RES = 25


@pytest.fixture(scope="module")
def crop():
    page = _png.read_gray(ROOT / "tests/data/torch_ocr/full/synth0001.png")
    return np.ascontiguousarray(page[700:900, 250:550])       # (200, 300)


@pytest.fixture(scope="module")
def grid():
    """A seeded smooth warp grid over the crop (2-cell pad)."""
    rng = np.random.default_rng(5)
    gh, gw = 14, 18
    ii, jj = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    x = -50.0 + RES * jj + 2.1 * np.sin(jj / 4.1 + rng.uniform(0, 6))
    y = -50.0 + RES * ii + 1.7 * np.sin(ii / 2.7 + rng.uniform(0, 6))
    return np.stack([x, y], -1).astype(np.float32)


# three groups of one page: (line specs, rows nb, wmax); the rows past
# the specs are zero padding, as LineExtractor.groups pads; one strip
# runs off the crop, one is tilted to slope 2e-2, one group is ragged
GROUPS = [
    ([(20, 60, 100, 14, 0.0), (-10, 120, 90, 18, 2e-2),
      (240, 160, 120, 20, 5e-4)], 5, 256),
    ([(30, 110, 150, 40, 2e-3)], 2, 197),
    ([(5, 190, 300, 16, -1e-2), (150, 40, 60, 20, 0.0)], 4, 512),
]


def _page_groups(specs_groups, shift=0.0):
    """[(frames (nb, 2, 3), widths (nb,), n_real, wmax)] padded with zero
    rows; `shift` moves the frames' translation (dewarped coords)."""
    out = []
    for specs, nb, wmax in specs_groups:
        f, w = _frames(specs)
        f[:, :, 2] += shift
        fr = np.zeros((nb, 2, 3), np.float32)
        wd = np.zeros(nb, np.int32)
        fr[: len(f)], wd[: len(w)] = f, w
        out.append((fr, wd, len(specs), wmax))
    return out


def _page_args(groups, start=0):
    desc, offsets, end = ops.strip_layout(
        [(len(fr), n, wmax) for fr, _, n, wmax in groups], 48, start=start)
    fr = np.concatenate([g[0] for g in groups])
    wd = np.concatenate([g[1] for g in groups])
    return _t(fr), _t(wd), _t(desc), offsets, end


def test_strip_layout_aligns_each_group():
    groups = [(5, 3, 256), (2, 1, 197), (4, 2, 512), (1, 1, 197)]
    desc, offsets, end = ops.strip_layout(groups, 48, start=7)
    assert desc.dtype == np.int32 and desc.shape == (12, 4)
    prev_end = 7
    row = 0
    for g, ((nb, n_real, wmax), off) in enumerate(zip(groups, offsets)):
        assert off % 16 == 0 and prev_end <= off < prev_end + 16
        for r in range(nb):
            assert tuple(desc[row]) == (g, off + r * 48 * wmax, wmax,
                                        int(r < n_real))
            row += 1
        prev_end = off + nb * 48 * wmax
    assert end == prev_end


@pytest.mark.parametrize("mode", ["dewarped", "through_grid"])
def test_page_plain_is_its_group_plain_calls(crop, grid, mode):
    groups = _page_groups(GROUPS, shift=50.0 if mode == "through_grid"
                          else 0.0)
    fr, wd, desc, offsets, end = _page_args(groups, start=3)
    out = torch.full((end,), 7, dtype=torch.uint8)
    page = _t(crop)
    if mode == "dewarped":
        got = ops.strips_dewarped_page_plain(page, fr, wd, desc, out, 48)
    else:
        got = ops.strips_through_grid_page_plain(page, _t(grid), float(RES),
                                                 fr, wd, desc, out, 48)
    assert got is out
    assert (out[:offsets[0]] == 7).all()         # nothing before the layout
    ink = 0
    for (gfr, gwd, n, wmax), off in zip(groups, offsets):
        if mode == "dewarped":
            want = ops.strips_dewarped_plain(page, _t(gfr), _t(gwd), 48, wmax)
        else:
            want = ops.strips_through_grid_plain(page, _t(grid), float(RES),
                                                 _t(gfr), _t(gwd), 48, wmax)
        view = out[off: off + want.numel()].view(want.shape)
        assert torch.equal(view, want)
        ink += int((want[:n] < 128).sum())
    assert ink > 100                              # ink was sampled


@pytest.mark.parametrize("mode", ["dewarped", "through_grid"])
def test_page_entries_match_pallas_strips_kernel(crop, mode):
    # strips well inside the crop, so mode (a)'s hard page edge and fill
    # columns play no part; mode (b) through the identity grid
    specs = [([(20, 70, 150, 14, 0.01), (60, 130, 170, 18, -0.008)], 3, 256),
             ([(40, 180, 140, 16, 0.0)], 2, 384)]
    groups = _page_groups(specs)
    fr, wd, desc, offsets, end = _page_args(groups)
    out = torch.empty(end, dtype=torch.uint8)
    if mode == "dewarped":
        ops.strips_dewarped_page(_t(crop), fr, wd, desc, out, 48, 384)
    else:
        hv, res = identity_grid(crop.shape[1], crop.shape[0])
        ops.strips_through_grid_page(_t(crop), _t(hv), res, fr, wd, desc,
                                     out, 48, 384)
    for (gfr, gwd, n, wmax), off in zip(groups, offsets):
        assert strips_frames_ok(gfr[:n], 48, wmax)
        ref = np.asarray(extract_line_strips_pallas(
            jnp.asarray(crop.astype(np.float32)), jnp.asarray(gfr[:n]),
            jnp.asarray(np.full(n, 48, np.int32)), 48, wmax, 255.0,
            interpret=True))
        got = out[off: off + len(gfr) * 48 * wmax].view(len(gfr), 48, wmax)
        cols = np.arange(wmax)[None, None, :] < gwd[:n, None, None]
        cols = np.broadcast_to(cols, ref.shape)
        d = np.abs(got[:n].numpy().astype(np.float32) - ref)[cols]
        assert d.max() <= 2.55


class _Proc:
    device = torch.device("cpu")

    @staticmethod
    def lock_or_open(path, mode):
        return open(path, mode)


@pytest.mark.parametrize("mode", ["banded", "gather"])
def test_device_groups_cut_the_same_strips_into_one_buffer(mode):
    """device_groups on the small fixture page gives, bit for bit, what
    one group-level call per group gave before the page-level launch,
    as views of one buffer at 16-byte aligned offsets."""
    png = next((ROOT / "tests/data/torch_ocr/small").glob("*.png"))
    reader = Input(Artifact.LINES, Artifact.TABLES,
                   stage=Stage.RELIABLE).instantiate(png, _Proc())
    ext = LineExtractor(reader.tables, 48, {"extract_mode": mode},
                        min_confidence=reader.lines.min_confidence,
                        max_width=2048)
    parts = ext.parts(reader.lines.by_path)
    page = reader.page
    before = dict(ops.launches)
    got = list(ext.device_groups(parts))
    assert ops.launches == before                 # the CPU runs no kernel
    planned = list(ext.groups(parts))
    assert len(got) == len(planned) >= 2
    base = got[0][1].untyped_storage().data_ptr()
    for (paths, strips, widths, wmax), (_, ppaths, fr, wd, pwmax, prof) in \
            zip(got, planned):
        assert paths == ppaths and wmax == pwmax
        assert strips.shape == (len(fr), 48, wmax) and strips.is_contiguous()
        assert strips.untyped_storage().data_ptr() == base
        assert strips.storage_offset() % 16 == 0
        np.testing.assert_array_equal(widths, wd[: len(paths)])
        if prof == "gather":
            hv = torch.from_numpy(page.grid.points("sample"))
            want = ops.strips_through_grid(
                page.device_pixels, hv, float(page.grid.resolution),
                _t(fr), _t(wd), 48, wmax, 255.0)
        else:
            want = ops.strips_dewarped(page.dewarped_dev, _t(fr), _t(wd), 48,
                                       wmax, 255.0)
        assert torch.equal(strips, want)


def test_page_wrappers_check_their_inputs(crop):
    fr, wd, desc, _, end = _page_args(_page_groups(GROUPS[:1]))
    out = torch.empty(end, dtype=torch.uint8)
    page = _t(crop)
    with pytest.raises(ValueError):
        ops.strips_dewarped_page(page, fr, wd, desc[:-1], out, 48, 256)
    with pytest.raises(TypeError):
        ops.strips_dewarped_page(page, fr, wd, desc.long(), out, 48, 256)
    with pytest.raises(ValueError):
        ops.strips_dewarped_page(page, fr, wd, desc, out.view(-1, 16), 48,
                                 256)
    with pytest.raises(TypeError):
        hv, res = identity_grid(300, 200)
        ops.strips_through_grid_page(page, _t(hv).double(), res, fr, wd,
                                     desc, out, 48, 256)
    apart = desc.clone()
    apart[1, 1] += 16                 # a group's rows no longer contiguous
    with pytest.raises(ValueError):
        ops.strips_dewarped_page(page, fr, wd, apart, out, 48, 256)
