"""Label model for segmentation training data.

Port of origami_tpu/train/segment/labels.py, whole (it is host code).
Counterpart of the reference's LabelSet/Label JSON spec
(origami/train/segment/gen/labels.py + custom/bbz.json): a JSON document
declaring the label classes per network kind with colors, loss weights,
separator orientation and code mappings. GT label images are paletted
PNGs whose indices map through this spec (the PSD-layer pipeline of the
reference is replaced by plain label-mask images — an open format any
annotation tool can emit).
"""

from __future__ import annotations

import json
from pathlib import Path


class Label:
    def __init__(self, name, index, color=None, weight=1.0,
                 orientation=None, codes=()):
        self.name = name
        self.index = int(index)
        self.color = color
        self.weight = float(weight)
        self.orientation = orientation
        self.codes = list(codes)

    def __repr__(self):
        return "<Label %s=%d>" % (self.name, self.index)


class LabelSet:
    """{"kinds": {"region": {"classes": [{"name": "TEXT", ...}, ...]},
                  "separator": {...}}}"""

    def __init__(self, spec):
        if isinstance(spec, (str, Path)):
            spec = json.loads(Path(spec).read_text())
        self._kinds = {}
        for kind, kspec in spec["kinds"].items():
            labels = []
            for i, c in enumerate(kspec["classes"]):
                labels.append(Label(
                    c["name"], c.get("index", i), c.get("color"),
                    c.get("weight", 1.0), c.get("orientation"),
                    c.get("codes", ())))
            self._kinds[kind] = labels

    @property
    def kinds(self):
        return list(self._kinds.keys())

    def labels(self, kind):
        return list(self._kinds[kind])

    def label(self, kind, name):
        for l in self._kinds[kind]:
            if l.name == name:
                return l
        raise KeyError((kind, name))

    def classes_dict(self, kind):
        return {l.name: l.index for l in self._kinds[kind]}

    def background(self, kind):
        return self.label(kind, "BACKGROUND")

    def num_classes(self, kind):
        return len(self._kinds[kind])


DEFAULT_BBZ_SPEC = {
    "kinds": {
        "region": {
            "classes": [
                {"name": "TEXT", "index": 0, "weight": 1.0},
                {"name": "TABULAR", "index": 1, "weight": 2.0},
                {"name": "ILLUSTRATION", "index": 2, "weight": 2.0},
                {"name": "BACKGROUND", "index": 3, "weight": 0.5},
            ],
        },
        "separator": {
            "classes": [
                {"name": "H", "index": 0, "orientation": "H",
                 "weight": 4.0},
                {"name": "V", "index": 1, "orientation": "V",
                 "weight": 4.0},
                {"name": "T", "index": 2, "orientation": "H",
                 "weight": 4.0},
                {"name": "BACKGROUND", "index": 3, "weight": 0.25},
            ],
        },
    },
}
