"""Operator tools (port of origami_tpu/tool/): the annotation DB and
line loading (lineload), sampling, picking, annotating and merging GT
lines (sample, pick, annotate, merge), harmonization (harmonize), the
training export (export), train/valid splits (split), layout clusters
(cluster), the XY-cut debugger (xycut), the four browser tools
(annotate_web, pick_web, cluster_web, xycut_web) and migration
(migrate).

Every CLI takes --device (cuda by default, raising without a card; cpu
for a run on the CPU), as the stages do.
"""

from __future__ import annotations

DEVICE_HELP = "torch device: cuda (default) or cpu"


def add_device_argument(parser):
    parser.add_argument("--device", type=str, default="cuda",
                        help=DEVICE_HELP)
