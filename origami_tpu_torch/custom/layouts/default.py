"""Conservative default layout rule set: merge obvious fragments, resolve
overlaps, filter specks — no corpus-specific table heuristics (port of
origami_tpu/custom/layouts/default.py)."""

from origami_tpu_torch.batch.detect.layout import (
    Transformer, SetUnionOperator, Dilation, AdjacencyMerger, IsOnSameLine,
    OverlapMerger, Shrinker, AreaFilter,
)


def make_transformer():
    return Transformer([
        SetUnionOperator("convex"),
        Dilation("none"),
        AdjacencyMerger("regions/TEXT", IsOnSameLine(max_line_count=3)),
        OverlapMerger(0.1),
        Shrinker(),
        OverlapMerger(0),
        AreaFilter(0.0025),
    ])
