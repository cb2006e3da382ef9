"""XY-cut debugger: prints the recursive cut tree for a page's regions.

Port of origami_tpu/tool/xycut.py through the port's core/xycut
(`_axis_candidates`, `_split`, `reading_order`): the region polygons of
the stage's contours, their bounds inset by `fringe` of the page's
diameter, cut as the order stage cuts them. Host work only: `--device`
is taken as every port CLI takes it (the page is not decoded).

    python -m origami_tpu_torch.tool.xycut PAGE [--stage reliable] \\
        [--fringe 0.005] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from origami_tpu_torch.tool import add_device_argument


def xycut_debug(page_path, stage="reliable", fringe=0.005, device=None):
    """Print the XY-cut decision tree for PAGE_PATH and the reading
    order. `device` None means the card, raising without one."""
    from origami_tpu_torch.batch.core.io import Artifact, Input, Stage
    from origami_tpu_torch.core import xycut
    from origami_tpu_torch.core.xycut import _axis_candidates, _split

    reader = Input(Artifact.CONTOURS,
                   stage=Stage[stage.upper()]).instantiate(
        page_path=Path(page_path), device=device)
    items = [(parts, geom) for parts, geom in reader.contours
             if geom.geom_type == "Polygon"]
    page_geom = reader.page.geometry(Stage[stage.upper()].is_dewarped)
    f = page_geom.rel_length(fringe)

    named = []
    for parts, geom in items:
        minx, miny, maxx, maxy = geom.bounds
        named.append(("/".join(parts), (minx + f, miny + f,
                                        maxx - f, maxy - f)))

    names = [n for n, _ in named]
    bounds = np.array([b for _, b in named], np.float64).reshape(-1, 4)

    def show(idx, depth):
        indent = "  " * depth
        if len(idx) <= 1:
            for i in idx:
                print("%s- %s" % (indent, names[i]))
            return
        cands = (_axis_candidates(bounds, idx, 0,
                                  xycut.SCORES["widest_gap"], 0, 0.1)
                 + _axis_candidates(bounds, idx, 1,
                                    xycut.SCORES["widest_gap"], 0, 0.1))
        if not cands:
            print("%s* unsplittable group: %s"
                  % (indent, [names[i] for i in idx]))
            return
        s, x, axis, overlap = max(cands, key=lambda c: c[0])
        a, b = _split(bounds, idx, axis, x, 0.1)
        print("%scut %s at %.1f (score %.1f%s)"
              % (indent, "x" if axis == 0 else "y", x, s,
                 ", overlap" if overlap else ""))
        show(a, depth + 1)
        show(b, depth + 1)

    show(np.arange(len(named)), 0)
    print("\nfinal order:")
    for name in xycut.reading_order(named):
        print("  %s" % name)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m origami_tpu_torch.tool.xycut",
        description="Show the XY-cut decision tree for PAGE_PATH.")
    p.add_argument("page_path", type=str)
    p.add_argument("--stage", type=str, default="reliable")
    p.add_argument("--fringe", type=float, default=0.005)
    add_device_argument(p)
    args = p.parse_args(argv)
    if not Path(args.page_path).exists():
        raise SystemExit("no such path: %s" % args.page_path)
    xycut_debug(args.page_path, args.stage, args.fringe, args.device)


if __name__ == "__main__":
    main()
