"""utils.evaluate — CER/WER evaluation against ground truth.

Port of origami_tpu/batch/utils/evaluate.py: Levenshtein distance over
characters (CER) and tokens (WER) between the composed text and
`<page>.gt.txt` / `<page>.gt.page.xml` ground truth, and the baseline
matchers that score detected lines against the synthetic corpus's
`gt.json`. The Page-XML text is read with ElementTree (the JAX module
uses lxml). Host work only: `--device` is taken as every stage takes it,
and nothing runs on it.

    python -m origami_tpu_torch.batch.utils.evaluate CORPUS [--device cpu]
"""

from __future__ import annotations

import argparse
import zipfile
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

from origami_tpu_torch.batch.core.io import Artifact, Input
from origami_tpu_torch.batch.core.processor import (BatchedProcessor,
                                                    Processor)

STAGE_NAME = "origami_tpu.batch.utils.evaluate"


def _as_codes(a, b):
    """Map two strings (chars) or token lists to int numpy arrays
    under ONE shared code mapping."""
    if isinstance(a, str):
        return (np.frombuffer(a.encode("utf-32-le"), dtype=np.uint32),
                np.frombuffer(b.encode("utf-32-le"), dtype=np.uint32))
    codes = {}
    return tuple(
        np.array([codes.setdefault(t, len(codes)) for t in seq],
                 dtype=np.int64)
        for seq in (a, b))


def levenshtein(a, b):
    """Edit distance, one vectorized row at a time.

    The left-to-right dependency cur[j+1] = min(..., cur[j] + 1) is an
    exact prefix-min: cur[j] = j + cummin(u)[j] with u_0 = cur[0] and
    u_k = min(prev[k] + 1, prev[k-1] + cost_k) - k."""
    if not len(a):
        return len(b)
    if not len(b):
        return len(a)
    if isinstance(a, str) != isinstance(b, str):
        raise TypeError("mixed str/list operands")
    ca, cb = _as_codes(a, b)
    n = len(cb)
    steps = np.arange(1, n + 1, dtype=np.int64)
    prev = np.arange(n + 1, dtype=np.int64)
    u = np.empty(n + 1, dtype=np.int64)
    for i in range(len(ca)):
        base = np.minimum(prev[1:] + 1, prev[:-1] + (ca[i] != cb))
        u[0] = i + 1
        np.subtract(base, steps, out=u[1:])
        np.minimum.accumulate(u, out=u)
        prev[0] = i + 1
        np.add(u[1:], steps, out=prev[1:])
    return int(prev[-1])


def cer(gt, pred):
    gt = gt.strip()
    if not gt:
        return 0.0 if not pred.strip() else 1.0
    return levenshtein(gt, pred.strip()) / len(gt)


def wer(gt, pred):
    gw = gt.split()
    pw = pred.split()
    if not gw:
        return 0.0 if not pw else 1.0
    return levenshtein(gw, pw) / len(gw)


def _sorted_polylines(detected):
    """Each detected polyline with >= 2 points as an (N, 2) float array
    sorted by x."""
    out = []
    for pts in detected:
        pts = np.asarray(pts, float)
        if len(pts) < 2:
            continue
        out.append(pts[np.argsort(pts[:, 0])])
    return out


def _gap(gt, pts, min_overlap):
    """The vertical gap between GT line `gt` and polyline `pts` at their
    x-overlap's midpoint, or None when the overlap is too short (under
    25 px or `min_overlap` of the shorter span)."""
    span = max(1.0, gt["x1"] - gt["x0"])
    lo = max(gt["x0"], pts[0, 0])
    hi = min(gt["x1"], pts[-1, 0])
    need = max(25.0, min_overlap * min(span, pts[-1, 0] - pts[0, 0]))
    if hi - lo < need:
        return None
    xm = 0.5 * (lo + hi)
    return abs(float(np.interp(xm, pts[:, 0], pts[:, 1])) - gt["y"])


def match_baselines(gt_lines, detected, min_overlap=0.4):
    """Match GT baselines to detected baseline polylines.

    ``gt_lines``: dicts with ``y`` (baseline row), ``x0``/``x1`` (ink
    extent) and ``h`` (x-height band). ``detected``: polylines as
    (N, 2) x/y point arrays in the same (warped-page) pixel space.
    Returns ``[(gt, dist-or-None), ...]`` with the best (smallest-gap)
    candidate per GT line."""
    dets = _sorted_polylines(detected)
    out = []
    for gt in gt_lines:
        best = None
        for pts in dets:
            d = _gap(gt, pts, min_overlap)
            if d is not None and (best is None or d < best):
                best = d
        out.append((gt, best))
    return out


def gt_zones(gt_lines, pad_x=12.0, pad_y_factor=2.0):
    """Evaluation zones for partially-annotated GT: one padded bbox per
    ``band`` of the GT lines, or ``None`` when the GT is full-page (a
    line without a band)."""
    bands = {}
    for g in gt_lines:
        b = g.get("band")
        if b is None:
            return None
        bands.setdefault(b, []).append(g)
    zones = []
    for ls in bands.values():
        pad_y = pad_y_factor * float(np.median([g["h"] for g in ls]))
        zones.append((min(g["x0"] for g in ls) - pad_x,
                      min(g["y"] for g in ls) - pad_y,
                      max(g["x1"] for g in ls) + pad_x,
                      max(g["y"] for g in ls) + pad_y))
    return zones


def match_detections(gt_lines, detected, zones=None, min_overlap=0.4):
    """Per-detection matching (precision side): a detection is a true
    positive when some GT line x-overlaps it (as in match_baselines)
    within that line's tolerance max(0.5 h, 4) px. With ``zones``,
    detections whose midpoint falls outside every zone are left out of
    the denominator.

    Returns ``dict(n_considered, n_true, n_out_of_zone, precision)``."""
    n_true = 0
    n_considered = 0
    n_out = 0
    for pts in _sorted_polylines(detected):
        xm_det = 0.5 * (pts[0, 0] + pts[-1, 0])
        ym_det = float(np.interp(xm_det, pts[:, 0], pts[:, 1]))
        if zones is not None and not any(
                x0 <= xm_det <= x1 and y0 <= ym_det <= y1
                for x0, y0, x1, y1 in zones):
            n_out += 1
            continue
        n_considered += 1
        for gt in gt_lines:
            d = _gap(gt, pts, min_overlap)
            if d is not None and d <= max(0.5 * gt["h"], 4.0):
                n_true += 1
                break
    return dict(
        n_considered=n_considered, n_true=n_true, n_out_of_zone=n_out,
        precision=(n_true / n_considered) if n_considered else 0.0)


def _local(tag):
    return tag.rsplit("}", 1)[-1]


def _page_xml_text(data):
    """The last TextEquiv/Unicode text of every TextRegion, in document
    order, one a line."""
    root = ET.fromstring(data)
    lines = []
    for te in root.iter():
        if _local(te.tag) != "TextRegion":
            continue
        uni = [u for eq in te if _local(eq.tag) == "TextEquiv"
               for u in eq if _local(u.tag) == "Unicode"]
        if uni and uni[-1].text:
            lines.append(uni[-1].text)
    return "\n".join(lines)


def find_ground_truth(page_path):
    page_path = Path(page_path)
    for suffix, parse in ((".gt.txt", lambda b: b.decode("utf8")),
                          (".gt.page.xml", _page_xml_text)):
        p = page_path.with_suffix(suffix)
        if p.exists():
            return parse(p.read_bytes())
    return None


class EvaluationProcessor(BatchedProcessor):
    """One page a batch; the scores of every page are kept for
    `print`, so the evaluation runs in one process."""

    def __init__(self, options):
        options = dict(options)
        options.setdefault("lock_strategy", "NONE")
        super().__init__(options, batch_size=1)
        self._results = []

    @property
    def processor_name(self):
        return STAGE_NAME

    def artifacts(self):
        return [("input", Input(Artifact.COMPOSE))]

    def should_process(self, page_path):
        return find_ground_truth(page_path) is not None

    def process(self, page_path, input):
        gt = find_ground_truth(page_path)
        with zipfile.ZipFile(input.path(Artifact.COMPOSE)) as zf:
            pred = zf.read("page.txt").decode("utf8")
        c = cer(gt, pred)
        w = wer(gt, pred)
        self._results.append((str(page_path), c, w))
        return dict(cer=round(c, 4), wer=round(w, 4))

    def process_batch(self, pages):
        return {p: self.process(p, kw["input"]) for p, kw in pages}

    def print(self):
        if not self._results:
            print("no pages with ground truth found.")
            return
        cs = [r[1] for r in self._results]
        ws = [r[2] for r in self._results]
        for path, c, w in self._results:
            print("%s  CER=%.4f  WER=%.4f" % (Path(path).name, c, w))
        print("mean over %d pages: CER=%.4f WER=%.4f"
              % (len(cs), np.mean(cs), np.mean(ws)))


def parser():
    p = argparse.ArgumentParser(
        prog="python -m origami_tpu_torch.batch.utils.evaluate",
        description="Evaluate CER/WER against ground truth in DATA_PATH.")
    p.add_argument("data_path", type=str)
    Processor.add_arguments(p, pooled=False)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    if not Path(args.data_path).exists():
        raise SystemExit("no such path: %s" % args.data_path)
    p = EvaluationProcessor(vars(args))
    p.traverse(args.data_path)
    p.print()


if __name__ == "__main__":
    main()
