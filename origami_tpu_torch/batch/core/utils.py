"""Region path filters (port of origami_tpu/batch/core/utils.py
`RegionsFilter`: "regions/TEXT, regions/TABULAR" specs)."""

from __future__ import annotations


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
