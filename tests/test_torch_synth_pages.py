"""The port's synthetic corpus (origami_tpu_torch/train/synth.py) against
origami_tpu/train/synth.py on the same seeds: render_page on every pixel
of the image and both label maps, and in every LineGT and region (two
seeds, test_quality's n_columns=2 page and an undegraded one);
render_line over 200 seeds (strip and text); page_line_pool(n_pages=1);
write_corpus's files read back equal to JAX's (the PNG bytes may
differ, the arrays and gt.json may not).
"""

import dataclasses
import json

import numpy as np
import PIL.Image
import pytest

from origami_tpu.train import synth as jax_synth
from origami_tpu_torch.core import _png
from origami_tpu_torch.train import synth

PAGES = [(70000, {}), (70001, {}), (55_000_000, {"n_columns": 2}),
         (123, {"degrade": False})]


def _gt_rows(page):
    return ([dataclasses.astuple(l) for l in page.lines],
            [tuple(r) for r in page.regions])


@pytest.mark.parametrize("seed,kw", PAGES)
def test_render_page_equals_jax(seed, kw):
    want = jax_synth.render_page(seed, **kw)
    got = synth.render_page(seed, **kw)
    for name in ("image", "region_labels", "separator_labels"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert int((a != b).sum()) == 0, name
    assert _gt_rows(got) == _gt_rows(want)
    # the same Python types, so the gt.json documents are the same text
    assert json.dumps(synth.page_gt_json(got)) == \
        json.dumps(synth.page_gt_json(want))


@pytest.mark.parametrize("start", range(0, 200, 50))
def test_render_line_equals_jax(start):
    for seed in range(start, start + 50):
        a, ta = synth.render_line(seed)
        b, tb = jax_synth.render_line(seed)
        assert ta == tb, seed
        assert a.shape == b.shape and a.dtype == b.dtype, seed
        assert int((a != b).sum()) == 0, seed


def test_line_batch_and_given_text_equal_jax():
    for (a, ta), (b, tb) in zip(synth.line_batch(3, 5),
                                jax_synth.line_batch(3, 5)):
        assert ta == tb
        np.testing.assert_array_equal(a, b)
    a, _ = synth.render_line(9, text="Kauffrau flieht: 1872 (fünf)")
    b, _ = jax_synth.render_line(9, text="Kauffrau flieht: 1872 (fünf)")
    np.testing.assert_array_equal(a, b)


def test_page_line_pool_equals_jax():
    got = synth.page_line_pool(n_pages=1, seed=7_000_011)
    want = jax_synth.page_line_pool(n_pages=1, seed=7_000_011)
    assert len(got) == len(want) > 50
    for (a, ta), (b, tb) in zip(got, want):
        assert ta == tb
        np.testing.assert_array_equal(a, b)


def test_write_corpus_equals_jax(tmp_path):
    names = synth.write_corpus(tmp_path / "port", 1, seed=3)
    assert jax_synth.write_corpus(tmp_path / "jax", 1, seed=3) == names
    for name in names:
        for suffix in (".png", ".labels.region.png",
                       ".labels.separator.png"):
            got = _png.read_gray(tmp_path / "port" / (name + suffix))
            want = np.asarray(PIL.Image.open(tmp_path / "jax"
                                             / (name + suffix)))
            np.testing.assert_array_equal(got, want, err_msg=suffix)
        assert (tmp_path / "port" / (name + ".gt.json")).read_text() == \
            (tmp_path / "jax" / (name + ".gt.json")).read_text()
