"""utils.compare — artifact parity between two corpora.

Port of origami_tpu/batch/utils/compare.py: for every `.out` folder of
CORPUS_A that CORPUS_B has too, the per-class IoU of each segment.zip
predictor's label maps (B's resized to A's with cv2's INTER_NEAREST,
train/segment/data.resize_nearest_u8), the mean CER of the ocr.zip
lines both hold (batch/utils/evaluate.cer) and the CER of compose.zip's
page.txt; one line a page and the means, as the JAX command prints them.
Host work only.

    python -m origami_tpu_torch.batch.utils.compare CORPUS_A CORPUS_B
"""

from __future__ import annotations

import argparse
import zipfile
from pathlib import Path

import numpy as np

from origami_tpu_torch.batch.utils.evaluate import cer


def mask_iou(a_labels, b_labels, n_classes):
    """{class: IoU} between two label maps (B's resized to A's), for the
    classes either map holds."""
    from origami_tpu_torch.train.segment.data import resize_nearest_u8
    if a_labels.shape != b_labels.shape:
        b_labels = resize_nearest_u8(
            b_labels, (a_labels.shape[1], a_labels.shape[0]))
    ious = {}
    for c in range(n_classes):
        am = a_labels == c
        bm = b_labels == c
        union = np.logical_or(am, bm).sum()
        if union == 0:
            continue
        ious[c] = float(np.logical_and(am, bm).sum() / union)
    return ious


def compare_segmentation(path_a, path_b):
    """{predictor name: {class name: IoU}} of two segment.zip files."""
    from origami_tpu_torch.core.segment import Segmentation
    seg_a = Segmentation.open(path_a)
    seg_b = Segmentation.open(path_b)
    out = {}
    for pa in seg_a.predictions:
        try:
            pb = seg_b.by_name(pa.name)
        except KeyError:
            continue
        ious = mask_iou(pa.labels, pb.labels, len(pa.classes))
        out[pa.name] = {pa.classes.name_of(c) or str(c): v
                        for c, v in ious.items()}
    return out


def compare_ocr(path_a, path_b):
    """The mean CER of the lines both ocr.zip files hold, the count of
    all lines and of those only one holds."""
    def read(path):
        with zipfile.ZipFile(path) as zf:
            return {n: zf.read(n).decode("utf8")
                    for n in zf.namelist() if n.endswith(".txt")}
    ta = read(path_a)
    tb = read(path_b)
    joint = sorted(set(ta) | set(tb))
    if not joint:
        return dict(cer=0.0, n_lines=0, only_a=0, only_b=0)
    cers = [cer(ta[n], tb[n]) for n in sorted(set(ta) & set(tb))]
    return dict(
        cer=float(np.mean(cers)) if cers else 1.0,
        n_lines=len(joint),
        only_a=len(set(ta) - set(tb)),
        only_b=len(set(tb) - set(ta)))


def compare_compose(path_a, path_b):
    def read(path):
        with zipfile.ZipFile(path) as zf:
            return zf.read("page.txt").decode("utf8") \
                if "page.txt" in zf.namelist() else ""
    return dict(cer=cer(read(path_a), read(path_b)))


def compare(corpus_a, corpus_b):
    """Print one line a page of CORPUS_A and the means."""
    corpus_a = Path(corpus_a)
    corpus_b = Path(corpus_b)
    all_iou = []
    all_cer = []
    for name in sorted(p.name for p in corpus_a.glob("*.out")):
        out_a = corpus_a / name
        out_b = corpus_b / name
        if not out_b.exists():
            print("%s: missing in B" % name)
            continue
        row = [name]
        sa, sb = out_a / "segment.zip", out_b / "segment.zip"
        if sa.exists() and sb.exists():
            flat = [v for d in compare_segmentation(sa, sb).values()
                    for v in d.values()]
            if flat:
                all_iou.extend(flat)
                row.append("seg IoU %.4f" % np.mean(flat))
        oa, ob = out_a / "ocr.zip", out_b / "ocr.zip"
        if oa.exists() and ob.exists():
            oc = compare_ocr(oa, ob)
            all_cer.append(oc["cer"])
            row.append("ocr CER %.4f (%d lines, +%d/-%d)"
                       % (oc["cer"], oc["n_lines"], oc["only_a"],
                          oc["only_b"]))
        ca, cb = out_a / "compose.zip", out_b / "compose.zip"
        if ca.exists() and cb.exists():
            row.append("compose CER %.4f"
                       % compare_compose(ca, cb)["cer"])
        print("  ".join(row))
    if all_iou:
        print("mean segment IoU: %.4f" % np.mean(all_iou))
    if all_cer:
        print("mean OCR CER:     %.4f" % np.mean(all_cer))


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m origami_tpu_torch.batch.utils.compare",
        description="Diff artifacts of the same pages processed by two "
                    "systems.")
    p.add_argument("corpus_a", type=str)
    p.add_argument("corpus_b", type=str)
    args = p.parse_args(argv)
    for path in (args.corpus_a, args.corpus_b):
        if not Path(path).exists():
            raise SystemExit("no such path: %s" % path)
    compare(args.corpus_a, args.corpus_b)


if __name__ == "__main__":
    main()
