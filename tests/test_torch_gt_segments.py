"""The port's GT separator segments (origami_tpu_torch/train/segment/
segments.py) against the JAX module: its tests, ported, and the cleaned
polylines of seeded separator masks.

Tolerance: the same number of segments per class, their coordinates,
widths and fit errors within 1e-9 (both packages run the same float64
host code; the components come from the port's cv2-free labelling).
The JAX side traces the skeletons through its native geometry library
when that loads and in Python when not, and the two give stroke widths
up to 7e-4 apart; the live comparisons take the `jax_native` fixture,
which loads that library or fails.
"""

import numpy as np
import pytest

from origami_tpu_torch.core.math import Orientation
from origami_tpu_torch.core.polyline import Polyline
from origami_tpu_torch.train.segment import segments as S
from test_torch_geometry import jax_native  # noqa: F401


def test_gt_segments_cleanup():
    mask = np.zeros((60, 300), np.uint8)
    # one separator drawn as two fragments with a 10px gap
    mask[30:33, 10:140] = 1
    mask[30:33, 150:290] = 1
    # a speck
    mask[10:12, 50:60] = 1
    segs = S.clean_separators(mask, Orientation.H, max_gap=20,
                              min_length=25)
    assert len(segs) == 1
    c = segs[0].np_coords
    assert c[:, 0].min() < 20 and c[:, 0].max() > 280


def test_merge_obstacle_veto():
    # two collinear separator fragments; an obstacle between them must
    # veto the join
    a = Polyline([(0, 50), (40, 50)], width=2)
    b = Polyline([(55, 50), (95, 50)], width=2)
    free = S.merge_by_distance([a, b], max_gap=20)
    assert len(free) == 1
    obstacles = np.zeros((100, 100), bool)
    obstacles[45:55, 46:50] = True   # ink in the gap
    blocked = S.merge_by_distance([a, b], max_gap=20, obstacles=obstacles)
    assert len(blocked) == 2


def test_filter_by_quality():
    good = Polyline([(0, 0), (200, 0)], width=2, error=0.1)
    bad = Polyline([(0, 10), (200, 14)], width=2, error=1.4)
    short = Polyline([(0, 20), (4, 20)], width=2, error=0.0)
    kept = S.filter_by_quality([good, bad, short], max_error=0.5,
                               min_length=0.02, shape=(500, 400))
    assert kept == [good]
    # config-driven pipeline applies the same strategy
    kept2 = S.run_merge_pipeline(
        [good, bad, short],
        [dict(strategy="by_quality",
              args=dict(max_error=0.5, min_length=0.02))],
        shape=(500, 400))
    assert kept2 == [good]


def test_extract_segments_fit_error():
    mask = np.zeros((60, 200), np.uint8)
    mask[30:32, 10:190] = 1            # clean straight separator
    segs = S.extract_segments(mask, Orientation.H)
    assert len(segs) == 1
    assert segs[0].error < 0.6
    blob = np.zeros((60, 200), np.uint8)  # fat blob: bad line fit
    blob[10:50, 40:160] = 1
    segs2 = S.extract_segments(blob, Orientation.H)
    assert len(segs2) == 1
    assert segs2[0].error > segs[0].error


def separator_mask(seed, h=240, w=360):
    """Seeded strokes: slanted and broken horizontal rules, vertical
    rules, short specks and a thick smudge; and a block of 'text' ink
    between some fragments."""
    rng = np.random.default_rng(seed)
    m = np.zeros((h, w), np.uint8)
    for _ in range(5):
        y = int(rng.integers(10, h - 10))
        x0 = int(rng.integers(0, w // 3))
        x1 = int(rng.integers(2 * w // 3, w))
        slope = rng.normal(0, 0.02)
        th = int(rng.integers(1, 4))
        gap = int(rng.integers(x0 + 20, x1 - 20))
        for x in range(x0, x1):
            if gap <= x < gap + int(rng.integers(4, 18)):
                continue
            yy = int(round(y + slope * (x - x0)))
            m[max(yy, 0):yy + th, x] = 1
    for _ in range(3):
        x = int(rng.integers(10, w - 10))
        y0, y1 = sorted(int(v) for v in rng.integers(0, h, 2))
        m[y0:y1 + 12, x:x + int(rng.integers(1, 4))] = 1
    for _ in range(4):
        y, x = int(rng.integers(0, h - 3)), int(rng.integers(0, w - 8))
        m[y:y + 2, x:x + int(rng.integers(2, 8))] = 1
    m[40:70, 100:150] = 1
    text = np.zeros((h, w), bool)
    text[int(h * 0.4):int(h * 0.6), w // 3:w // 2] = True
    return m, text


def _rows(polylines):
    return [(p.np_coords, p.width, p.error) for p in polylines]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("orientation", ["H", "V"])
def test_clean_separators_equal_jax(seed, orientation, jax_native):
    from origami_tpu.core.math import Orientation as JOrientation
    from origami_tpu.train.segment import segments as JS
    mask, text = separator_mask(seed)
    if orientation == "V":
        mask, text = mask.T.copy(), text.T.copy()
    want = _rows(JS.clean_separators(mask, JOrientation[orientation],
                                     obstacles=text))
    got = _rows(S.clean_separators(mask, Orientation[orientation],
                                   obstacles=text))
    assert len(got) == len(want) and len(want) >= 1
    for (gc, gw, ge), (wc, ww, we) in zip(got, want):
        np.testing.assert_allclose(gc, wc, rtol=0, atol=1e-9)
        assert abs(gw - ww) <= 1e-9 and abs(ge - we) <= 1e-9


def test_default_pipeline_equal_jax(jax_native):
    """run_merge_pipeline with DEFAULT_PIPELINE (page-relative quality
    filter) on the extracted segments of a seeded mask."""
    from origami_tpu.core.math import Orientation as JOrientation
    from origami_tpu.train.segment import segments as JS
    mask, text = separator_mask(7)
    want = _rows(JS.run_merge_pipeline(
        JS.extract_segments(mask, JOrientation.H), JS.DEFAULT_PIPELINE,
        obstacles=text, shape=mask.shape))
    got = _rows(S.run_merge_pipeline(
        S.extract_segments(mask, Orientation.H), S.DEFAULT_PIPELINE,
        obstacles=text, shape=mask.shape))
    assert len(got) == len(want) and len(want) >= 1
    for (gc, gw, ge), (wc, ww, we) in zip(got, want):
        np.testing.assert_allclose(gc, wc, rtol=0, atol=1e-9)
        assert abs(gw - ww) <= 1e-9 and abs(ge - we) <= 1e-9
