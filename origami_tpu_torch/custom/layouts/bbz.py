"""BBZ layout rule set (Berliner Börsen-Zeitung newspapers).

Port of origami_tpu/custom/layouts/bbz.py: the operator pipeline that
fixes over/under-segmentation for this corpus and the text-vs-table
dominance strategy, with the port's layout operators.
"""

from origami_tpu_torch import geometry as G
from origami_tpu_torch.batch.detect.layout import (
    Transformer, SetUnionOperator, Dilation, AdjacencyMerger, IsOnSameLine,
    IsBelow, OverlapMerger, Shrinker, SequentialMerger, DominanceOperator,
    FixSpillOverH, FixSpillOverHOnSeparator, FixSpillOverV, AreaFilter,
    RegionSeparatorDetector, interval_overlap,
)

FRINGE = 0.001

_CODES = {("regions", "TEXT"): "txt", ("regions", "TABULAR"): "tab"}


def _y_aligned(contours, text_path, table_path):
    _, y0a, _, y1a = contours[text_path].bounds
    _, y0b, _, y1b = contours[table_path].bounds
    return interval_overlap(y0a, y1a, y0b, y1b, mode="a") > 0.9


def _split_text_table(text, table):
    """Give the table its full y-band of the union; text keeps the rest."""
    _, tab_y0, _, tab_y1 = table.bounds
    union = text.union(table)
    minx, _, maxx, _ = union.bounds
    band = G.box(minx - 1, tab_y0, maxx + 1, tab_y1)
    return union.difference(band), union.intersection(band)


def dominance_strategy(contours, a, b):
    code = tuple(_CODES.get(x[:2], "other") for x in (a, b))
    if code == ("txt", "tab"):
        if _y_aligned(contours, a, b):
            return "merge", b
        return "custom", _split_text_table(contours[a], contours[b])
    if code == ("tab", "txt"):
        if _y_aligned(contours, b, a):
            return "merge", a
        text_shape, table_shape = _split_text_table(
            contours[b], contours[a])
        return "custom", (table_shape, text_shape)
    if contours[a].area < contours[b].area:
        return "split", b, a
    return "split", a, b


def make_transformer():
    seq_merger = SequentialMerger(
        filters="regions/TABULAR",
        cohesion=(0.5, 0.8),
        max_distance=0.01,
        max_error=0.05,
        fringe=FRINGE,
        obstacles=["separators/V"])

    return Transformer([
        SetUnionOperator("convex"),
        Dilation("none"),
        AdjacencyMerger(
            "regions/TEXT",
            IsOnSameLine(max_line_count=3, fringe=FRINGE)),
        OverlapMerger(0.1),
        Shrinker(),
        seq_merger,
        AdjacencyMerger("regions/TABULAR", IsBelow()),
        seq_merger,
        OverlapMerger(0),
        Dilation("rect"),
        SetUnionOperator("none"),
        DominanceOperator(
            filters="regions/TEXT, regions/TABULAR",
            fringe=0,
            strategy=dominance_strategy),
        FixSpillOverH("regions/TEXT"),
        FixSpillOverHOnSeparator(
            RegionSeparatorDetector(
                "regions/TEXT", "separators/V", axis=0)),
        FixSpillOverV("regions/TEXT"),
        AreaFilter(0.0025),
    ])
