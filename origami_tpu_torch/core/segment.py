"""Segmentation containers and the segment.zip artifact format.

Port of origami_tpu/core/segment.py. The on-disk contract is the JAX
package's (docs/formats.md#segmentzip): per predictor a paletted label
PNG plus a JSON {"type", "name", "classes"} file inside segment.zip, so
corpora segmented by either package interoperate. The PNGs go through
the port's own codec (core/_png.py) instead of PIL.
"""

from __future__ import annotations

import builtins
import enum
import json
import os
import zipfile

import numpy as np

from origami_tpu_torch.core import _png
from origami_tpu_torch.core.math import Orientation


class PredictorType(enum.Enum):
    REGION = 1
    SEPARATOR = 2


class Classes:
    """Ordered label name -> index mapping (name lookup, .value,
    background)."""

    def __init__(self, mapping):
        self._by_name = dict(mapping)
        self._by_value = {v: k for k, v in self._by_name.items()}

    def __getitem__(self, name):
        return ClassLabel(name, self._by_name[name])

    def __contains__(self, name):
        return name in self._by_name

    def __iter__(self):
        for name, value in self._by_name.items():
            yield ClassLabel(name, value)

    def name_of(self, value):
        return self._by_value.get(int(value))

    def as_dict(self):
        return dict(self._by_name)

    def __len__(self):
        return len(self._by_name)


class ClassLabel:
    __slots__ = ("name", "value")

    def __init__(self, name, value):
        self.name = name
        self.value = int(value)

    @property
    def orientation(self):
        # separator class names start with H or V (T counts as a
        # horizontal table separator)
        return Orientation.V if self.name.startswith("V") else Orientation.H

    def __eq__(self, other):
        return isinstance(other, ClassLabel) and \
            (self.name, self.value) == (other.name, other.value)

    def __hash__(self):
        return hash((self.name, self.value))

    def __repr__(self):
        return "<ClassLabel %s=%d>" % (self.name, self.value)


_BASE_COLORS = np.array([
    [31, 119, 180], [255, 127, 14], [44, 160, 44], [214, 39, 40],
    [148, 103, 189], [140, 86, 75], [227, 119, 194], [127, 127, 127],
    [188, 189, 34], [23, 190, 207]], dtype=np.uint8)


def label_palette(labels, background=None):
    """The (256, 3) palette of a label map's PNG: tab10-ish colours for
    the labels in use, white for the background (segment.py:80-95)."""
    pal = np.zeros((256, 3), dtype=np.uint8)
    n = int(np.asarray(labels).max()) + 1 if np.asarray(labels).size else 1
    for i in range(max(n, 1)):
        pal[i] = _BASE_COLORS[i % len(_BASE_COLORS)]
    if background is not None:
        pal[int(background)] = (255, 255, 255)
    return pal


class Prediction:
    """One predictor's label map + class metadata."""

    def __init__(self, type_, name, labels, classes):
        self.type = type_ if isinstance(type_, PredictorType) \
            else PredictorType[str(type_).upper()]
        self.name = name
        self.labels = np.asarray(labels)
        self.classes = classes if isinstance(classes, Classes) \
            else Classes(classes)

    @property
    def background_label(self):
        if "BACKGROUND" in self.classes:
            return self.classes["BACKGROUND"]
        return None

    @property
    def size(self):
        h, w = self.labels.shape[:2]
        return (w, h)

    def class_mask(self, name):
        return self.labels == self.classes[name].value

    @property
    def palette(self):
        bg = self.background_label
        return label_palette(self.labels,
                             bg.value if bg is not None else None)

    def png_bytes(self):
        """The label map as a paletted PNG. zlib level 1: the best level
        costs many times the encode time of a full-page raster to save a
        few KB."""
        return _png.encode_paletted(self.labels.astype(np.uint8),
                                    self.palette, level=1)


_SEGMENTATION_OPEN_CACHE = {}


class Segmentation:
    """A set of per-predictor Predictions with zip save/load."""

    def __init__(self, predictions):
        self.predictions = tuple(predictions)

    @property
    def size(self):
        return self.predictions[0].size

    def by_name(self, name):
        for p in self.predictions:
            if p.name == name:
                return p
        raise KeyError(name)

    def by_type(self, type_):
        return [p for p in self.predictions if p.type == type_]

    def save(self, file_or_path):
        if hasattr(file_or_path, "write"):
            self._save_to(file_or_path)
        else:
            with open(file_or_path, "wb") as f:
                self._save_to(f)

    def _save_to(self, f):
        with zipfile.ZipFile(f, "w", zipfile.ZIP_DEFLATED) as zf:
            for p in self.predictions:
                # PNGs are compressed already: stored as they are
                zf.writestr("%s.png" % p.name, p.png_bytes(),
                            zipfile.ZIP_STORED)
                zf.writestr("%s.json" % p.name, json.dumps(dict(
                    type=p.type.name, name=p.name,
                    classes=p.classes.as_dict())))

    @staticmethod
    def open(path, open=None):
        """Read segment.zip. Memoized per file identity when read with
        the builtin open: every later stage opens it again, and label
        arrays are treated as immutable (mutators copy first)."""
        cache_key = None
        if open is None or open is builtins.open:
            try:
                st = os.stat(path)
                cache_key = (str(path), st.st_mtime_ns, st.st_size)
            except OSError:
                cache_key = None
            hit = _SEGMENTATION_OPEN_CACHE.get(cache_key)
            if hit is not None:
                return hit
        open = open or builtins.open
        predictions = []
        with open(path, "rb") as f:
            with zipfile.ZipFile(f, "r") as zf:
                stems = [n[:-4] for n in zf.namelist() if n.endswith(".png")]
                for stem in stems:
                    labels, _ = _png.decode_paletted(zf.read(stem + ".png"))
                    meta = json.loads(zf.read(stem + ".json"))
                    predictions.append(Prediction(
                        meta["type"], meta["name"], labels,
                        meta["classes"]))
        seg = Segmentation(predictions)
        if cache_key is not None:
            if len(_SEGMENTATION_OPEN_CACHE) > 16:
                _SEGMENTATION_OPEN_CACHE.clear()
            _SEGMENTATION_OPEN_CACHE[cache_key] = seg
        return seg

    @staticmethod
    def open_meta(path, open=None):
        """segment.zip's predictors without their label maps: type, name
        and classes from the JSON entries, labels empty. What the
        separator store needs (core/separate.Separators), without
        decoding the label PNGs."""
        return Segmentation([
            Prediction(m["type"], m["name"], np.zeros((0, 0), np.uint8),
                       m["classes"])
            for m in Segmentation.read_predictors(path, open=open)])

    @staticmethod
    def read_predictors(path, open=None):
        """Metadata-only read of segment.zip."""
        open = open or builtins.open
        out = []
        with open(path, "rb") as f:
            with zipfile.ZipFile(f, "r") as zf:
                for name in zf.namelist():
                    if name.endswith(".json"):
                        out.append(json.loads(zf.read(name)))
        return out
