"""Ground-truth annotation sources.

Port of origami_tpu/train/segment/annotations.py. A page's GT is its
image plus one paletted label PNG per network kind
(<stem>.labels.<kind>.png) or, failing that, a layered PSD (<stem>.psd,
read only when psd-tools is installed). The image goes through the port's
image readers (core/_image.py; PIL's convert("L")), the label PNGs through
`data.read_labels` (a paletted PNG's indices, as PIL gives them).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from origami_tpu_torch.core import _image
from origami_tpu_torch.train.segment.data import read_labels


class PageAnnotations:
    """GT for one page: image + per-kind label maps."""

    def __init__(self, image, label_maps):
        self.image = np.asarray(image)
        self.label_maps = dict(label_maps)   # kind -> (H, W) uint8

    def labels(self, kind):
        return self.label_maps[kind]

    @property
    def kinds(self):
        return list(self.label_maps.keys())


def load_page_annotations(image_path, kinds=("region", "separator")):
    """Load GT for a page from label PNGs (<stem>.labels.<kind>.png) or,
    failing that, a PSD layer stack (<stem>.psd, requires psd-tools)."""
    image_path = Path(image_path)
    image = _image.read_gray(image_path)
    label_maps = {}
    for kind in kinds:
        p = image_path.with_name(
            image_path.stem + ".labels.%s.png" % kind)
        if p.exists():
            label_maps[kind] = read_labels(p)
    if not label_maps:
        psd = image_path.with_suffix(".psd")
        if psd.exists():
            label_maps = _load_psd_layers(psd, image.shape, kinds)
    if not label_maps:
        raise FileNotFoundError(
            "no GT label maps for %s (expected %s.labels.<kind>.png)"
            % (image_path, image_path.stem))
    return PageAnnotations(image, label_maps)


def _load_psd_layers(psd_path, shape, kinds):
    """Optional PSD layer import: layer names map to class labels via
    '<kind>/<LABEL>' naming. Needs psd-tools (without it: no layers)."""
    try:
        from psd_tools import PSDImage
    except ImportError:
        return {}
    from origami_tpu_torch.train.segment.labels import (
        LabelSet, DEFAULT_BBZ_SPEC)
    label_set = LabelSet(DEFAULT_BBZ_SPEC)
    psd = PSDImage.open(str(psd_path))
    out = {}
    for kind in kinds:
        bg = label_set.background(kind).index
        lab = np.full(shape, bg, np.uint8)
        for layer in psd.descendants():
            name = (layer.name or "").strip()
            if not name.startswith(kind + "/"):
                continue
            cls = name.split("/", 1)[1].upper()
            try:
                idx = label_set.label(kind, cls).index
            except KeyError:
                continue
            mask = np.array(layer.composite().convert("L"))
            x0, y0 = layer.left, layer.top
            h, w = mask.shape
            lab[y0:y0 + h, x0:x0 + w][mask > 127] = idx
        out[kind] = lab
    return out
