"""The port's four web tools (origami_tpu_torch/tool: annotate_web,
pick_web, cluster_web, xycut_web) against the JAX package's, on the CPU
(`device="cpu"`).

Each tool's handler is served with HTTPServer on 127.0.0.1, port 0, and
driven through every route (chip_smoke.web_routes) after the sample ->
harmonize -> export chain (chip_smoke phase 20a/20b on the CPU). Bars:
  * the JSON and text bodies equal the JAX tools' (the corpus path
    written as {corpus}; tests/data/torch_tools), their HTML too;
  * the JPEG image routes (pick_web's and xycut_web's /image, the dewarped
    page; cluster_web's /thumb and /image, the gray page narrowed as PIL's
    resize narrows it) send image/jpeg bodies byte-equal to the JAX
    tools'; annotate_web's PNG line strip decodes within 1 gray level of
    the array the JAX tool encodes;
  * cut_tree, the line polygons of pick_web and compute_clusters equal
    the JAX functions' on the same inputs, live.
"""

import json

import numpy as np
import PIL.Image
import pytest

import chip_smoke
from origami_tpu_torch.tool import cluster_web, pick_web, xycut_web

REF = json.loads((chip_smoke.TOOLS_REF / "tools.json").read_text())


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The port's phase 20a chain on the CPU, and the signatures."""
    work = tmp_path_factory.mktemp("web")
    corpus = chip_smoke.tools_corpus(work / "corpus")
    out = chip_smoke.tools_chain(corpus, work, REF, "cpu")
    chip_smoke.write_signatures(corpus, "cpu")
    return corpus, work, out


@pytest.mark.parametrize("tool", chip_smoke.WEB_TOOLS)
def test_web_tool_routes_equal_jax(chain, tool):
    corpus, work, out = chain
    assert out["rows"] == REF["rows"]
    bad, note, _ = chip_smoke.web_tool_errors(tool, corpus, work, REF,
                                              out["rows"], "cpu")
    assert bad == [], note
    assert len(REF["web"][tool]["records"]) >= 5


@pytest.mark.parametrize("stage", ["reliable", "dewarped"])
def test_cut_tree_and_page_lines_equal_jax(chain, stage):
    from origami_tpu.tool import pick_web as jax_pick
    from origami_tpu.tool import xycut_web as jax_xycut
    corpus, _, _ = chain
    for png in chip_smoke.tools_pages(corpus):
        if stage == "dewarped":
            # contours.1.zip: the JAX dewarp stage's (tests/data/torch_flow)
            import shutil
            shutil.copy(chip_smoke.FLOW_REF / (png.stem + ".out")
                        / "contours.1.zip", corpus / (png.stem + ".out"))
        got = xycut_web.cut_tree(png, stage, device="cpu")
        want = jax_xycut.cut_tree(png, stage)
        assert json.dumps(got) == json.dumps(want)
        assert got["tree"]["cut"]
    png = chip_smoke.tools_pages(corpus)[0]
    lines, size, _ = pick_web._page_lines(png, "reliable", "cpu")
    jlines, jsize, _ = jax_pick._page_lines(png, "reliable")
    assert [p for p, _ in lines] == [p for p, _ in jlines]
    for (_, a), (_, b) in zip(lines, jlines):
        np.testing.assert_array_equal(a, b)
    assert tuple(size) == tuple(jsize)


def test_compute_clusters_equals_jax(chain):
    from origami_tpu.tool import cluster_web as jax_cluster_web
    corpus, _, _ = chain
    for k in (1, 2, 8):
        assert cluster_web.compute_clusters(corpus, k) \
            == jax_cluster_web.compute_clusters(corpus, k)
    assert cluster_web.compute_clusters(corpus / "nothing", 2) == {}


@pytest.mark.parametrize("w,h", [(2999, 1001), (500, 90), (361, 40)])
def test_page_view_equals_pil_resize(tmp_path, w, h):
    """cluster_web's /thumb and /image pixels: PIL's convert("L") and
    default resize of a seeded RGB page."""
    rng = np.random.default_rng(w)
    px = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    px[:, : w // 3] //= 3
    path = tmp_path / "p.png"
    PIL.Image.fromarray(px, "RGB").save(path)
    for max_w in (360, 2400):
        im = PIL.Image.open(path).convert("L")
        if im.width > max_w:
            im = im.resize((max_w, int(im.height * max_w / im.width)))
        np.testing.assert_array_equal(cluster_web.page_view(path, max_w),
                                      np.asarray(im))
