"""Region path filters and table path combination.

Port of origami_tpu/batch/core/utils.py: `RegionsFilter` parses
"regions/TEXT, regions/TABULAR" specs; `TableRegionCombinator` maps the
layout stage's split table paths ("X.1.1.1") back to their base region
"X" (:34-91).
"""

from __future__ import annotations

import collections


class RegionsFilter:
    def __init__(self, spec):
        self._paths = set()
        if isinstance(spec, str):
            parts = [s.strip() for s in spec.split(",") if s.strip()]
        else:
            parts = list(spec)
        for p in parts:
            if isinstance(p, str):
                self._paths.add(tuple(p.split("/")))
            else:
                self._paths.add(tuple(p))

    def __call__(self, path):
        return tuple(path[:2]) in self._paths

    @property
    def paths(self):
        return self._paths


def base_block_id(block_id):
    """'5.1.1.1' -> '5'; plain ids pass through."""
    return str(block_id).split(".")[0]


class TableRegionCombinator:
    """Groups split table paths by their base region path and provides
    the mapping used when re-assembling tables at compose time."""

    def __init__(self, paths):
        mapping = collections.defaultdict(list)
        for p in paths:
            p = tuple(p)
            base = p[:2] + (base_block_id(p[2]),)
            mapping[base].append(p)
        self._mapping = dict(mapping)

    @property
    def mapping(self):
        return self._mapping

    def combined_path(self, path):
        path = tuple(path)
        return path[:2] + (base_block_id(path[2]),)

    def contours(self, contours):
        """Union split-table contours back into base-region shapes."""
        from origami_tpu_torch import geometry as G
        combined = {}
        for base, members in self._mapping.items():
            if len(members) == 1:
                combined[base] = contours[members[0]]
            else:
                geom = G.unary_union([contours[m] for m in members])
                if geom.geom_type != "Polygon":
                    geom = geom.convex_hull
                combined[base] = geom
        return combined

    def contours_from_blocks(self, blocks):
        return self.contours({k: b.image_space_polygon
                              for k, b in blocks.items()})

    def lines(self, lines):
        """Re-key line paths so split-table lines group under their base
        block; line ids are renumbered from 1 per base block."""
        by_block = collections.defaultdict(list)
        for k, line in lines.items():
            by_block[tuple(k[:3])].append((k, line))
        out = {}
        for base, members in self._mapping.items():
            merged = []
            for m in members:
                merged.extend(sorted(by_block.get(tuple(m), []),
                                     key=lambda kv: kv[0]))
            for i, (_, line) in enumerate(merged):
                out[base + (1 + i,)] = line
        return out
