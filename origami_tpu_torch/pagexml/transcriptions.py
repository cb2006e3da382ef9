"""Reading transcriptions out of existing Page-XML ground truth.

Port of origami_tpu/pagexml/transcriptions.py: the ground truth's
TextLines (Coords polygon, last TextEquiv/Unicode) are matched to the
detected lines by polygon overlap, each detected line taking the text of
the line it overlaps best, where that IoU exceeds 0.3. The XML is read
with ElementTree (the JAX module uses lxml), the polygons with the
port's geometry.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

from origami_tpu_torch import geometry as G


def _parse_points(s):
    pts = []
    for tok in s.split():
        x, y = tok.split(",")
        pts.append((float(x), float(y)))
    return np.array(pts)


class TranscriptionReader:
    """Matches GT text lines (by polygon overlap) to detected lines."""

    def __init__(self, page_xml_path, detected_lines):
        root = ET.fromstring(Path(page_xml_path).read_bytes())
        self._gt = []
        for tl in root.iterfind(".//{*}TextLine"):
            coords = tl.find("./{*}Coords")
            uni = tl.findall("./{*}TextEquiv/{*}Unicode")
            if coords is None or not uni or not uni[-1].text:
                continue
            poly = G.Polygon(_parse_points(coords.get("points", "")))
            if not poly.is_empty:
                self._gt.append((poly, uni[-1].text))
        self._tree = G.STRtree([p for p, _ in self._gt])
        self._texts = {}
        for path, line in detected_lines.items():
            poly = line.image_space_polygon
            best, score = None, 0.0
            for i in self._tree.query_indices(poly):
                gt_poly, text = self._gt[int(i)]
                inter = gt_poly.intersection(poly)
                if inter.is_empty:
                    continue
                iou = inter.area / max(
                    gt_poly.union(poly).area, 1e-9)
                if iou > score:
                    best, score = text, iou
            if best is not None and score > 0.3:
                self._texts["/".join(map(str, path))] = best

    def text_for(self, line_path):
        return self._texts.get(str(line_path))

    @property
    def matched(self):
        return dict(self._texts)
