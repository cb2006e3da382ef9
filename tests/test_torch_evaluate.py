"""The port's batch/utils/evaluate.py against origami_tpu's: the edit
distances on seeded strings and token lists, the baseline matchers and
zones on detections made from a synthetic page's ground truth (jittered,
split, dropped and spurious), the Page-XML text (ElementTree against
lxml) and the CLI's per-page CER/WER and report over a corpus of the
compose fixture's pages (`--device cpu`).
"""

import contextlib
import io
import json
import shutil
import zipfile

import numpy as np
import pytest

import chip_smoke
from origami_tpu.batch.utils import evaluate as jax_ev
from origami_tpu_torch.batch.utils import evaluate as ev
from origami_tpu_torch.train import synth

COMPOSE = chip_smoke.ROOT / "tests" / "data" / "torch_compose"
ALPHABET = list("abcdeäß 1.")
_GT = {}


def _page_gt(seed):
    """The gt.json document of render_page(seed), rendered once."""
    if seed not in _GT:
        _GT[seed] = synth.page_gt_json(synth.render_page(seed))
    return _GT[seed]


def test_edit_distances_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(300):
        a = "".join(rng.choice(ALPHABET, int(rng.integers(0, 25))))
        b = "".join(rng.choice(ALPHABET, int(rng.integers(0, 25))))
        assert ev.levenshtein(a, b) == jax_ev.levenshtein(a, b)
        assert ev.cer(a, b) == jax_ev.cer(a, b)
        assert ev.wer(a, b) == jax_ev.wer(a, b)
        ta, tb = a.split(), b.split()
        assert ev.levenshtein(ta, tb) == jax_ev.levenshtein(ta, tb)
    with pytest.raises(TypeError):
        ev.levenshtein("ab", ["a", "b"])


def _detections(lines, rng):
    """Polylines from GT baselines: jittered, some split in two, some
    dropped, a few spurious; (N, 2) arrays in random point order."""
    dets = []
    for g in lines:
        r = rng.random()
        if r < 0.1:
            continue
        y = g["y"] + rng.normal(0, 3)
        xs = np.sort(rng.uniform(g["x0"], g["x1"], int(rng.integers(2, 6))))
        pts = np.stack([xs, y + rng.normal(0, 1, len(xs))], 1)
        if r < 0.2 and len(pts) >= 4:
            dets.extend([pts[:2], pts[2:]])
        else:
            dets.append(pts[rng.permutation(len(pts))])
    for _ in range(8):
        x0 = rng.uniform(0, 1200)
        dets.append(np.array([[x0, rng.uniform(0, 1900)],
                              [x0 + rng.uniform(5, 300),
                               rng.uniform(0, 1900)]]))
    dets.append(np.zeros((1, 2)))
    return dets


@pytest.mark.parametrize("seed", [70000, 70001])
def test_matchers_equal_jax(seed):
    rng = np.random.default_rng(seed)
    lines = chip_smoke.synth_gt_lines(_page_gt(seed))
    dets = _detections(lines, rng)
    got = ev.match_baselines(lines, dets)
    want = jax_ev.match_baselines(lines, dets)
    assert [d for _, d in got] == [d for _, d in want]
    assert sum(d is not None for _, d in got) > len(lines) // 2
    for min_overlap in (0.4, 0.8):
        assert ev.match_detections(lines, dets, min_overlap=min_overlap) \
            == jax_ev.match_detections(lines, dets,
                                       min_overlap=min_overlap)
    # band-annotated GT: four bands of ten lines, detections outside
    # them left out
    banded = [dict(g, band=i // 10) for i, g in enumerate(lines[1:41])]
    zones = ev.gt_zones(banded)
    assert zones == jax_ev.gt_zones(banded) and len(zones) == 4
    assert ev.gt_zones(lines) is None
    got = ev.match_detections(banded, dets, zones=zones)
    assert got == jax_ev.match_detections(banded, dets, zones=zones)
    assert got["n_out_of_zone"] > 0


def test_page_xml_text_equals_lxml():
    for stem in ("synth0000", "synth0001"):
        with zipfile.ZipFile(COMPOSE / (stem + ".out")
                             / "compose_xml.zip") as zf:
            data = zf.read("page.xml")
        text = ev._page_xml_text(data)
        assert text and text == jax_ev._page_xml_text(data)


def _corpus(root):
    """The compose fixture's pages with their page.txt; ground truth as
    .gt.txt (synth0000, its gt.json lines) and .gt.page.xml
    (synth0001, the fixture's page.xml); a third page without any."""
    root.mkdir()
    for i, stem in enumerate(("synth0000", "synth0001", "synth0002")):
        src = chip_smoke.FIXTURE / ("synth%04d.png" % min(i, 1))
        shutil.copy(src, root / (stem + ".png"))
        out = root / (stem + ".out")
        out.mkdir()
        shutil.copy(COMPOSE / ("synth%04d.out" % min(i, 1)) / "compose.zip",
                    out)
    (root / "synth0000.gt.txt").write_text(
        "\n".join(l["text"] for l in _page_gt(70000)["lines"]))
    with zipfile.ZipFile(COMPOSE / "synth0001.out" / "compose_xml.zip") as zf:
        (root / "synth0001.gt.page.xml").write_bytes(zf.read("page.xml"))
    return root


def test_cli_equals_jax(tmp_path):
    port = _corpus(tmp_path / "port")
    shutil.copytree(port, tmp_path / "jax")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ev.main([str(port), "--device", "cpu", "--lock-strategy", "NONE"])
    p = jax_ev.EvaluationProcessor(dict(lock_strategy="NONE"))
    want = io.StringIO()
    with contextlib.redirect_stdout(want):
        p.traverse(tmp_path / "jax")
        p.print()

    def report(text):
        return [l for l in text.splitlines() if "CER=" in l]

    assert report(out.getvalue()) == report(want.getvalue())
    assert len(report(out.getvalue())) == 3       # two pages and the mean
    for stem in ("synth0000", "synth0001"):
        rt = [json.loads((root / (stem + ".out") / "runtime.json")
                         .read_text())[ev.STAGE_NAME]
              for root in (port, tmp_path / "jax")]
        assert {k: rt[0][k] for k in ("cer", "wer", "status")} == \
            {k: rt[1][k] for k in ("cer", "wer", "status")}
    assert not (port / "synth0002.out" / "runtime.json").exists()
