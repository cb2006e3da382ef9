"""chip_smoke.py's phase 9 on the CPU: the port's contours, flow, dewarp
and layout CLIs in turn from the JAX segment.zip of the fixture pages, and
the layout CLI on the JAX stages' artifacts, each held by chip_smoke's own
comparisons.

Tolerances, each with its reason (chip_smoke.py holds the same on the
card):
  * contours.0.zip: every entry byte-equal to tests/data/torch_flow's;
  * flow.zip, lines.0.zip, dewarp.zip, contours.1.zip: phase 7's bars
    (FLOW_BARS: the grid is float32 built in another summation order);
  * contours.2.zip from the chain: the JAX keys and vertex counts within
    0.01 px (it is built from contours.1.zip, within 4e-6 px of JAX's),
    tables.json equal;
  * the layout stage on the JAX inputs: contours.2.zip and tables.json
    equal to tests/data/torch_layout.
On the CPU the kernels' plain versions run, so nothing launches.
"""

import chip_smoke


def test_chain_from_jax_segmentation_on_cpu(tmp_path):
    runs = chip_smoke.check_chain_from_jax_segmentation(tmp_path, "cpu")
    assert sorted(runs) == sorted(
        "%s (from the JAX segment.zip)" % s
        for s in ("contours", "flow", "dewarp", "layout"))
    assert all(set(v.values()) == {0} for v in runs.values())


def test_layout_on_jax_inputs_on_cpu(tmp_path):
    runs = chip_smoke.check_layout_on_jax_inputs(tmp_path, "cpu")
    assert list(runs) == ["layout (on the JAX inputs)"]
    assert chip_smoke.windows(tmp_path / "layout_on_jax_inputs") == [5, 5]
