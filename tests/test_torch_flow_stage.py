"""The port's flow and dewarp CLIs (`python -m
origami_tpu_torch.batch.detect.{flow,dewarp} --device cpu`) against the
JAX stages' artifacts in tests/data/torch_flow, on the fixture's two
1312x1920 pages (chip_smoke.py's phase 7, run here on the CPU).

Bars (chip_smoke.FLOW_BARS), each with its reason:
  * flow.zip: the same sample counts, each sample within 0.5 px and
    1e-3 rad; lines.0.zip: the same keys, p and right within 0.5 px —
    the port's Sauvola sums exactly in integers where JAX uses float32
    integral images, so a page's mask may differ on a few pixels, and a
    line's extent with it (on these pages they agree: both are exact);
  * dewarp.zip, built from the JAX flow.zip: nodes within 1e-3 px (both
    float32, the IDW sums reduce in another order);
  * contours.1.zip: the same keys, vertices within 0.01 px (the contours
    move through the grid's Newton inverse).
"""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

PAGES = ["synth0000", "synth0001"]


@pytest.fixture(scope="module")
def flow_run(tmp_path_factory):
    corpus = chip_smoke.flow_corpus(tmp_path_factory.mktemp("flow") / "c")
    launches, _, _ = chip_smoke.run_stage_cli("flow", corpus, "cpu")
    return corpus, launches


@pytest.fixture(scope="module")
def dewarp_run(tmp_path_factory):
    corpus = chip_smoke.flow_corpus(tmp_path_factory.mktemp("dewarp") / "c",
                                    with_flow=True)
    launches, _, _ = chip_smoke.run_stage_cli("dewarp", corpus, "cpu")
    return corpus, launches


def compare(corpus, page, arts):
    return chip_smoke.compare_flow_outputs(
        corpus / (page + ".out"), chip_smoke.FLOW_REF / (page + ".out"), arts)


@pytest.mark.parametrize("page", PAGES)
def test_flow_zip_within_bars(flow_run, page):
    r = compare(flow_run[0], page, ("flow.zip",))
    assert r["flow_px"] <= chip_smoke.FLOW_PX
    assert r["flow_rad"] <= chip_smoke.FLOW_RAD


@pytest.mark.parametrize("page", PAGES)
def test_lines_zip_within_bars(flow_run, page):
    r = compare(flow_run[0], page, ("lines.0.zip",))
    assert r["lines_px"] <= chip_smoke.LINES_PX


@pytest.mark.parametrize("page", PAGES)
def test_flow_runtime_entry_like_jax(flow_run, page):
    got = json.loads((flow_run[0] / (page + ".out") / "runtime.json")
                     .read_text())[chip_smoke.FLOW_STAGE]
    want = json.loads((chip_smoke.FLOW_REF / (page + ".out") /
                       "runtime.json").read_text())[chip_smoke.FLOW_STAGE]
    for k in ("n_lines", "n_samples_h", "n_samples_v", "status"):
        assert got[k] == want[k], k


@pytest.mark.parametrize("page", PAGES)
def test_dewarp_grid_within_bar(dewarp_run, page):
    r = compare(dewarp_run[0], page, ("dewarp.zip",))
    assert r["grid_px"] <= chip_smoke.GRID_PX


@pytest.mark.parametrize("page", PAGES)
def test_dewarped_contours_within_bar(dewarp_run, page):
    r = compare(dewarp_run[0], page, ("contours.1.zip",))
    assert r["contours_px"] <= chip_smoke.CONTOUR_PX


@pytest.mark.parametrize("page", PAGES)
def test_dewarp_runtime_entry_like_jax(dewarp_run, page):
    got = json.loads((dewarp_run[0] / (page + ".out") / "runtime.json")
                     .read_text())[chip_smoke.DEWARP_STAGE]
    want = json.loads((chip_smoke.FLOW_REF / (page + ".out") /
                       "runtime.json").read_text())[chip_smoke.DEWARP_STAGE]
    assert got["grid_shape"] == want["grid_shape"] == [88, 64]
    assert abs(got["warping"] - want["warping"]) < 1e-6


def test_cpu_runs_launch_no_kernel(flow_run, dewarp_run):
    for _, launches in (flow_run, dewarp_run):
        assert set(launches) >= {"sauvola_packed", "dewarp_u8",
                                 "take_along_axis_lane"}
        assert not any(launches.values())


def test_dewarp_prefetch_failure_fails_the_page(tmp_path, monkeypatch):
    """The JAX stage swallows a failure of its dewarp + binarize
    prefetch; the port's records the page FAILED."""
    from origami_tpu_torch.batch.detect.dewarp import DewarpProcessor
    from origami_tpu_torch.core import page as page_mod

    def broken(self):
        raise RuntimeError("prefetch failed")

    monkeypatch.setattr(page_mod.Page, "dewarped_binarized",
                        property(broken))
    png = sorted(chip_smoke.FIXTURE.glob("*.png"))[:1]
    corpus = chip_smoke.flow_corpus(tmp_path / "c", png, with_flow=True)
    DewarpProcessor(dict(lock_strategy="NONE", plain=True,
                         device="cpu")).traverse(str(corpus))
    entry = json.loads((corpus / (png[0].stem + ".out") / "runtime.json")
                       .read_text())[chip_smoke.DEWARP_STAGE]
    assert entry["status"] == "FAILED"
    assert "prefetch failed" in entry["traceback"]
