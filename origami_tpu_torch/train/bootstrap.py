"""Corpus -> trained models, on the card.

Port of origami_tpu/train/bootstrap.py:

  * `train_segmentation` trains a k-member U-Net ensemble for one kind
    (median-frequency class weights, k-fold exclusion, a device-resident
    corpus warped on the card each step through the remap kernel);
  * `distill_students` folds each kind's ensemble into one student;
  * `train_recognizer_synth` (:280-362) renders the strip pool with the
    port's train/synth.py (half cut from degraded pages, half
    render_line strips, the JAX function's seeds and subsample) and
    trains on it through `train_recognizer_pool`, which buckets a list
    of (strip u8 (H, W), text) pairs by width, moves the pool to the
    card and trains the CTC recognizer;
  * `eval_segmentation` and `eval_separator_tolerant` (:124-227) score
    the serving predictor (core/predict.SegmentationPredictor) against
    a validation corpus: per-class IoU, and separator recall/precision
    within a pixel tolerance. cv2's INTER_NEAREST resize is
    data.resize_nearest_u8, its square dilation ops/morphology.dilate;
  * `eval_recognizer` (:365-388) scores the serving RecognizerPredictor
    on held-out render_line strips (CER).

`main` is scripts/bootstrap_synth.py on the port:

    python -m origami_tpu_torch.train.bootstrap --work DIR \
        [--phases gen,seg,distill,ocr,eval] [--device cuda]

Each trainer and evaluator takes `device` (cuda unless "cpu") or a
`mesh` (parallel.mesh.make_mesh: the trainers run on it as train/mesh.py
says, the evaluators' predictor shards its pages over it), and the
convolutions' `dtype` (bf16, the JAX trainers' and the stage's numeric
mode; float32 for parity runs). `on_step(kind, member,
step, loss)` is called after every step with the loss as a device tensor
(the JAX functions log every `log_every` steps; so do these).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from pathlib import Path

import numpy as np
import torch

REGION_CLASSES = ["TEXT", "TABULAR", "ILLUSTRATION", "BACKGROUND"]
SEP_CLASSES = ["H", "V", "T", "BACKGROUND"]
KIND_CLASSES = dict(region=REGION_CLASSES, separator=SEP_CLASSES)

log = logging.getLogger(__name__)


def load_corpus_arrays(corpus_dir, kind, full_size):
    """All (image, label) pages of one kind, resized to the net canvas
    (cv2's INTER_AREA and INTER_NEAREST, train/segment/data.py).

    Returns (images (N, H, W) uint8, labels (N, H, W) uint8, names)."""
    from origami_tpu_torch.train.segment.data import load_pair, page_pairs
    imgs, labs, names = [], [], []
    for img_path, lab_path in page_pairs(corpus_dir, kind):
        img, lab = load_pair(img_path, lab_path, full_size)
        imgs.append(img)
        labs.append(lab)
        names.append(img_path.stem)
    if not imgs:
        raise FileNotFoundError(
            "no (%s) page/label pairs under %s" % (kind, corpus_dir))
    return np.stack(imgs), np.stack(labs), names


def meta_for(kind, classes, full_size, width, s2d):
    return dict(kind="unet", type=kind, classes=classes,
                full_size=list(full_size), tile_size=list(full_size),
                tile_beta=50, width=width, s2d=s2d, channels=1,
                version=1)


def train_segmentation(corpus_dir, out_dir, kind, members=5, steps=600,
                       width=1.0, s2d=4, full_size=(1280, 2432),
                       batch=2, learning_rate=3e-4, seed=0,
                       warp_amplitude=10.0, log_every=50, mesh=None,
                       device=None, dtype=torch.bfloat16, on_step=None):
    """Train a k-member ensemble for one kind; returns final losses.
    Member m is written to `out_dir/kind/%02d`."""
    from origami_tpu_torch.train.segment.data import class_weights, k_folds
    from origami_tpu_torch.train.segment.train import (SegmentationTrainer,
                                                       TrainConfig)

    classes = KIND_CLASSES[kind]
    images, labels, names = load_corpus_arrays(corpus_dir, kind,
                                               full_size)
    cw = class_weights(list(labels), len(classes))
    folds = k_folds(names, k=members) if members > 1 else [[]]
    out_dir = Path(out_dir)
    w, h = full_size
    losses = []
    for m in range(members):
        excluded = set(folds[m % len(folds)]) if members > 1 else set()
        idx = [i for i, n in enumerate(names) if n not in excluded]
        if not idx:
            idx = list(range(len(names)))
        # hairline tolerance band for separators: background within 2 px
        # of a GT separator is weighted 0.15
        band = (classes.index("BACKGROUND"), 2, 0.15) \
            if kind == "separator" else None
        cfg = TrainConfig(
            num_classes=len(classes), width=width, s2d=s2d,
            tile_hw=(h, w), steps=steps,
            warmup=max(10, min(100, steps // 10)),
            learning_rate=learning_rate, class_weights=cw,
            band_dontcare=band)
        trainer = SegmentationTrainer(cfg, mesh=mesh, seed=seed + m,
                                      device=device, dtype=dtype)
        # the member's rows live on the card; each step sends indices
        trainer.attach_dataset(images[idx], labels[idx],
                               warp_amplitude=warp_amplitude,
                               seed=seed + m)
        rng = np.random.default_rng(seed + 1000 * m)
        t0 = time.time()
        loss = None
        for step in range(steps):
            sel = rng.integers(0, len(idx), size=batch)
            loss = trainer.train_on_indices(sel)
            if on_step is not None:
                on_step(kind, m, step, loss)
            if step % log_every == 0 or step == steps - 1:
                log.info("[%s %d/%d] step %d/%d loss %.4f (%.2f s/step)",
                         kind, m + 1, members, step, steps, float(loss),
                         (time.time() - t0) / (step + 1))
        trainer.save(out_dir / kind / ("%02d" % m),
                     meta_for(kind, classes, full_size, width, s2d))
        losses.append(float(loss))
    return losses


def _eval_pages(predictor, pairs, batch):
    """(the second item, Segmentation) of each (image path, item) pair,
    `batch` pages a predictor call."""
    from origami_tpu_torch.core import _image
    for start in range(0, len(pairs), batch):
        chunk = pairs[start: start + batch]
        segs = predictor.predict_batch([_image.read_gray(ip)
                                        for ip, _ in chunk])
        for (_, lp), seg in zip(chunk, segs):
            yield lp, seg


def _gt_at(lp, shape):
    """The GT label map of `lp` resized (nearest, as cv2) to `shape`."""
    from origami_tpu_torch.train.segment.data import (read_labels,
                                                      resize_nearest_u8)
    return resize_nearest_u8(read_labels(lp), (shape[1], shape[0]))


def eval_segmentation(models_path, val_dir, target="quality", batch=4,
                      mesh=None, device=None, dtype=torch.bfloat16):
    """Per-kind, per-class IoU of the serving predictor vs GT masks.

    Aggregates intersections/unions over the whole validation set (not
    a mean of per-page IoUs, which over-weights near-empty classes).
    Each page is predicted once for both kinds (the JAX function
    predicts it once a kind; the sums are the same)."""
    from origami_tpu_torch.core.predict import SegmentationPredictor
    from origami_tpu_torch.train.segment.data import page_pairs

    predictor = SegmentationPredictor(models_path, target=target,
                                      device=device, dtype=dtype, mesh=mesh)
    kinds = {"region": "regions", "separator": "separators"}
    gts = {kind: dict(page_pairs(val_dir, kind)) for kind in kinds}
    pages = sorted(set(gts["region"]) | set(gts["separator"]))
    inter = {k: np.zeros(len(KIND_CLASSES[k]), np.int64) for k in kinds}
    union = {k: np.zeros(len(KIND_CLASSES[k]), np.int64) for k in kinds}
    for ip, seg in _eval_pages(predictor, [(p, p) for p in pages], batch):
        for kind, name in kinds.items():
            if ip not in gts[kind]:
                continue
            lab = seg.by_name(name).labels
            gt = _gt_at(gts[kind][ip], lab.shape)
            for c in range(len(KIND_CLASSES[kind])):
                am = lab == c
                bm = gt == c
                inter[kind][c] += np.logical_and(am, bm).sum()
                union[kind][c] += np.logical_or(am, bm).sum()
    report = {}
    for kind in kinds:
        classes = KIND_CLASSES[kind]
        i, u = inter[kind], union[kind]
        report[kind] = {classes[c]: (float(i[c] / u[c]) if u[c] else None)
                        for c in range(len(classes))}
        ious = [v for v in report[kind].values() if v is not None]
        report[kind]["_mean"] = float(np.mean(ious)) if ious else None
    return report


def eval_separator_tolerant(models_path, val_dir, target="quality",
                            tol=3, batch=4, mesh=None, device=None,
                            dtype=torch.bfloat16):
    """Functional separator quality: recall/precision at +-tol px.

    A GT separator pixel counts as found if a predicted pixel of the
    same class lies within `tol` px (dilated-prediction recall), and
    vice versa for precision."""
    from origami_tpu_torch.core.predict import SegmentationPredictor
    from origami_tpu_torch.ops.morphology import dilate
    from origami_tpu_torch.train.segment.data import page_pairs

    predictor = SegmentationPredictor(models_path, target=target,
                                      device=device, dtype=dtype, mesh=mesh)
    classes = KIND_CLASSES["separator"]
    k = 2 * tol + 1

    def grown(m):
        # cv2.dilate with a k x k square: the border never dilates
        t = torch.from_numpy(m.astype(np.float32))
        return (dilate(t, k, k) > 0).numpy().astype(np.uint8)

    hit_r = np.zeros(len(classes), np.int64)
    tot_r = np.zeros(len(classes), np.int64)
    hit_p = np.zeros(len(classes), np.int64)
    tot_p = np.zeros(len(classes), np.int64)
    pairs = list(page_pairs(val_dir, "separator"))
    for lp, seg in _eval_pages(predictor, pairs, batch):
        lab = seg.by_name("separators").labels
        gt = _gt_at(lp, lab.shape)
        for c, name in enumerate(classes):
            if name == "BACKGROUND":
                continue
            pm = (lab == c).astype(np.uint8)
            gm = (gt == c).astype(np.uint8)
            pd = grown(pm)
            gd = grown(gm)
            hit_r[c] += int((gm & pd).sum())
            tot_r[c] += int(gm.sum())
            hit_p[c] += int((pm & gd).sum())
            tot_p[c] += int(pm.sum())
    report = {}
    f1s = []
    for c, name in enumerate(classes):
        if name == "BACKGROUND":
            continue
        r = float(hit_r[c] / tot_r[c]) if tot_r[c] else None
        p = float(hit_p[c] / tot_p[c]) if tot_p[c] else None
        f1 = (2 * r * p / (r + p)) if r and p else None
        report[name] = dict(recall=r, precision=p, f1=f1)
        if f1 is not None:
            f1s.append(f1)
    report["_mean_f1"] = float(np.mean(f1s)) if f1s else None
    report["tol_px"] = tol
    return report


def distill_students(models_path, corpus_dir, out_dir, steps=800,
                     batch=2, seed=0, student_cfg=None,
                     learning_rate=2e-4, kinds=("region", "separator"),
                     mesh=None, device=None, dtype=torch.bfloat16,
                     on_step=None):
    """Fold each trained ensemble (`models_path/<kind>/*`) into ONE
    student per kind, written to `out_dir/<kind>/00`.

    student_cfg: {kind: dict(width=..., s2d=...)}; defaults to the
    teacher's own architecture. `kinds`: the kinds to distill (the JAX
    function does both)."""
    from origami_tpu_torch.models import registry
    from origami_tpu_torch.train.segment.distill import (DistillConfig,
                                                         Distiller)
    from origami_tpu_torch.train.mesh import mesh_or_device

    mesh = mesh_or_device(mesh, device)
    dev = mesh.devices[0]
    models_path = Path(models_path)
    out_dir = Path(out_dir)
    losses = {}
    for kind in kinds:
        gdir = models_path / kind
        members = sorted(d for d in gdir.iterdir()
                         if (d / "meta.json").exists())
        teachers, meta = registry.load_ensemble(members, dev,
                                                conv_dtype=dtype)
        full_w, full_h = meta["full_size"]
        sc = (student_cfg or {}).get(kind, {})
        cfg = DistillConfig(
            num_classes=len(meta["classes"]),
            width=sc.get("width", meta.get("width", 1.0)),
            s2d=sc.get("s2d", meta.get("s2d", 1)),
            tile_hw=(full_h, full_w), steps=steps,
            warmup=max(10, min(100, steps // 10)),
            learning_rate=learning_rate)
        distiller = Distiller(cfg, teachers, mesh=mesh, seed=seed,
                              dtype=dtype)
        images, labels, _ = load_corpus_arrays(
            corpus_dir, kind, (full_w, full_h))
        distiller.attach_dataset(images, labels, seed=seed)
        rng = np.random.default_rng(seed)
        loss = None
        t0 = time.time()
        for step in range(steps):
            sel = rng.integers(0, len(images), size=batch)
            loss = distiller.distill_on_indices(sel)
            if on_step is not None:
                on_step(kind, 0, step, loss)
            if step % 50 == 0 or step == steps - 1:
                log.info("[distill %s] step %d/%d loss %.4f "
                         "(%.2f s/step)", kind, step, steps,
                         float(loss), (time.time() - t0) / (step + 1))
        loss = float(loss)
        smeta = meta_for(kind, meta["classes"],
                         (full_w, full_h), cfg.width, cfg.s2d)
        distiller.save(out_dir / kind / "00", smeta)
        losses[kind] = loss
    return losses


def pool_buckets(pool, charset, height, max_text_len=None):
    """Group (strip u8 (height, w), text) pairs into width buckets
    (recognizer.width_buckets): {bucket: (strips u8 (N, height, b),
    widths (N,), labels, label_pad)}, strips white-padded. Returns
    (buckets, {bucket: count})."""
    from origami_tpu_torch.models.recognizer import width_buckets
    from origami_tpu_torch.train.ocr.train import encode_labels
    by_bucket = {}
    bks = width_buckets([s.shape[1] for s, _ in pool])
    for (s, t), b in zip(pool, bks):
        by_bucket.setdefault(b, []).append((s, t))
    buckets = {}
    for b, items in by_bucket.items():
        x = np.zeros((len(items), height, b), np.uint8)
        wds = np.zeros((len(items),), np.float32)
        for i, (s, _) in enumerate(items):
            sw = min(s.shape[1], b)
            # white-padded raw strips; the step inverts on the card
            x[i, :, :sw] = s[:, :sw]
            x[i, :, sw:] = 255
            wds[i] = sw
        # labels are never truncated against a strip that shows the full
        # text: CTC would learn to stop emitting early
        bucket_max = max(len(t) for _, t in items) + 1
        labels, pad = encode_labels(
            [t for _, t in items], charset,
            max_len=min(max_text_len, bucket_max)
            if max_text_len else bucket_max)
        buckets[b] = (x, wds, labels, pad)
    return buckets, {b: len(v) for b, v in by_bucket.items()}


def train_recognizer_pool(pool, out_dir, charset, steps=2000, batch=64,
                          height=48, seed=0, learning_rate=1e-3,
                          conv_features=(64, 128, 256), lstm_features=256,
                          max_text_len=None, log_every=50, mesh=None,
                          device=None, dtype=torch.bfloat16, on_step=None):
    """Train the CTC recognizer on a pool of (strip u8 (height, w),
    text) pairs: one width bucket a step, chosen by bucket size, `batch`
    rows drawn from it. Saves the model to `out_dir`; returns the last
    loss."""
    from origami_tpu_torch.train.ocr.train import (OCRTrainConfig,
                                                   RecognizerTrainer)
    cfg = OCRTrainConfig(
        num_symbols=len(charset), height=height, steps=steps,
        warmup=max(20, min(200, steps // 10)),
        learning_rate=learning_rate, conv_features=conv_features,
        lstm_features=lstm_features)
    trainer = RecognizerTrainer(cfg, mesh=mesh, seed=seed, device=device,
                                dtype=dtype)
    buckets, counts = pool_buckets(pool, charset, height, max_text_len)
    trainer.attach_pool(buckets)
    keys = sorted(buckets)
    weights = np.array([counts[k] for k in keys], np.float64)
    weights /= weights.sum()

    rng = np.random.default_rng(seed)
    t0 = time.time()
    loss = None
    for step in range(steps):
        b = keys[rng.choice(len(keys), p=weights)]
        sel = rng.integers(0, counts[b], size=batch)
        loss = trainer.train_on_bucket(b, sel)
        if on_step is not None:
            on_step("ocr", 0, step, loss)
        if step % log_every == 0 or step == steps - 1:
            log.info("[ocr] step %d/%d loss %.4f (%.2f s/step)",
                     step, steps, float(loss),
                     (time.time() - t0) / (step + 1))
    trainer.save(Path(out_dir), charset)
    return float(loss)


def synth_pool(n_pool, height=48, seed=0):
    """train_recognizer_synth's strip pool: [(strip u8 (height, w),
    text)], page-extracted strips first (at most half, a seeded
    subsample), then render_line strips."""
    from origami_tpu_torch.train.synth import page_line_pool, render_line
    page_pool = page_line_pool(
        n_pages=max(4, n_pool // 180), height=height,
        seed=7_000_000 + seed)
    rng_pool = np.random.default_rng(seed + 41)
    if len(page_pool) > n_pool // 2:
        sel = rng_pool.choice(len(page_pool), n_pool // 2, replace=False)
        page_pool = [page_pool[i] for i in sel]
    return page_pool + [
        render_line(seed * 100_000 + i, height=height)
        for i in range(n_pool - len(page_pool))]


def train_recognizer_synth(out_dir, steps=2000, batch=64, height=48,
                           seed=0, learning_rate=1e-3,
                           conv_features=(64, 128, 256),
                           lstm_features=256, max_text_len=None,
                           n_pool=6000, log_every=50, mesh=None,
                           device=None, dtype=torch.bfloat16, on_step=None):
    """Train the CTC recognizer on synthetic line strips, rendered into
    a pool once on the host (synth_pool); returns the last loss."""
    from origami_tpu_torch.train.synth import CHARSET
    t0 = time.time()
    pool = synth_pool(n_pool, height, seed)
    log.info("[ocr] pool of %d strips rendered in %.1f s", len(pool),
             time.time() - t0)
    return train_recognizer_pool(
        pool, out_dir, CHARSET, steps=steps, batch=batch, height=height,
        seed=seed, learning_rate=learning_rate,
        conv_features=conv_features, lstm_features=lstm_features,
        max_text_len=max_text_len, log_every=log_every, mesh=mesh,
        device=device, dtype=dtype, on_step=on_step)


def recognizer_predictions(model_dir, n=200, seed=123_456, height=None,
                           decoder="greedy", vote="sequence", device=None,
                           dtype=torch.bfloat16):
    """(true texts, predicted texts, confidences) of the serving
    RecognizerPredictor over render_line(seed + i), i < n. `model_dir`
    may be a list of model dirs: the multi-model voting mode."""
    from origami_tpu_torch.batch.detect.ocr import RecognizerPredictor
    from origami_tpu_torch.device import resolve
    from origami_tpu_torch.train.synth import render_line

    dirs = ([Path(d) for d in model_dir]
            if isinstance(model_dir, (list, tuple)) else [Path(model_dir)])
    predictor = RecognizerPredictor(dirs, resolve(device), decoder=decoder,
                                    vote=vote, conv_dtype=dtype)
    h = height or predictor.line_height
    strips, texts = [], []
    for i in range(n):
        s, t = render_line(seed + i, height=h)
        strips.append((("val", str(i)), s))
        texts.append(t)
    preds, confs = predictor.predict(strips)
    return texts, preds, confs


def eval_recognizer(model_dir, n=200, seed=123_456, height=None,
                    decoder="greedy", vote="sequence", device=None,
                    dtype=torch.bfloat16):
    """Mean CER of the serving RecognizerPredictor on held-out synthetic
    lines (seed-disjoint from training by construction)."""
    from origami_tpu_torch.batch.utils.evaluate import cer
    texts, preds, confs = recognizer_predictions(
        model_dir, n, seed, height, decoder, vote, device, dtype)
    cers = [cer(t, p) for t, p in zip(texts, preds)]
    return dict(cer=float(np.mean(cers)),
                cer_median=float(np.median(cers)),
                n=n, conf=float(np.mean(confs)))


def parser():
    ap = argparse.ArgumentParser(
        prog="python -m origami_tpu_torch.train.bootstrap",
        description="Bootstrap on the synthetic corpus: write it, train "
                    "the segmentation ensembles, distill one student a "
                    "kind, train the recognizer and evaluate everything "
                    "(report.json under --work).")
    ap.add_argument("--work", default="work/bootstrap")
    ap.add_argument("--train-pages", type=int, default=48)
    ap.add_argument("--val-pages", type=int, default=12)
    ap.add_argument("--members", type=int, default=5)
    ap.add_argument("--seg-steps", type=int, default=600)
    ap.add_argument("--distill-steps", type=int, default=1200)
    ap.add_argument("--ocr-steps", type=int, default=4000)
    ap.add_argument("--ocr-pool", type=int, default=8000)
    ap.add_argument("--ocr-seeds", type=int, default=1,
                    help="train N recognizer seeds (recognizer, "
                         "recognizer2, ...) for voting evaluation")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--full-size", default="1280x2432")
    ap.add_argument("--phases", default="gen,seg,distill,ocr,eval")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    return ap


def main(argv=None):
    from origami_tpu_torch.device import resolve
    from origami_tpu_torch.train import synth

    args = parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(message)s")
    dev = resolve(args.device)
    work = Path(args.work)
    work.mkdir(parents=True, exist_ok=True)
    phases = set(args.phases.split(","))
    fw, fh = (int(v) for v in args.full_size.split("x"))
    report_path = work / "report.json"
    report = json.loads(report_path.read_text()) \
        if report_path.exists() else {}

    def save_report():
        report_path.write_text(json.dumps(report, indent=2))

    if "gen" in phases:
        t0 = time.time()
        synth.write_corpus(work / "train", args.train_pages, seed=1)
        synth.write_corpus(work / "val", args.val_pages, seed=7_000_000)
        log.info("corpus generated in %.1f s", time.time() - t0)

    if "seg" in phases:
        t0 = time.time()
        train_segmentation(
            work / "train", work / "models", "region",
            members=args.members, steps=args.seg_steps, width=2.0,
            s2d=4, full_size=(fw, fh), batch=args.batch, device=dev)
        train_segmentation(
            work / "train", work / "models", "separator",
            members=args.members, steps=args.seg_steps, width=1.0,
            s2d=2, full_size=(fw, fh), batch=args.batch, device=dev)
        report["seg_train_seconds"] = round(time.time() - t0, 1)
        save_report()

    if "distill" in phases:
        t0 = time.time()
        distill_students(
            work / "models", work / "train", work / "students",
            steps=args.distill_steps, batch=args.batch, device=dev)
        report["distill_seconds"] = round(time.time() - t0, 1)
        save_report()

    if "ocr" in phases:
        for extra in range(args.ocr_seeds):
            t0 = time.time()
            name = "recognizer%s" % ("" if extra == 0 else extra + 1)
            train_recognizer_synth(
                work / name, steps=args.ocr_steps, n_pool=args.ocr_pool,
                seed=extra, device=dev)
            key = "ocr%s_train_seconds" % ("" if extra == 0 else extra + 1)
            report[key] = round(time.time() - t0, 1)
            save_report()

    if "eval" in phases:
        t0 = time.time()
        report["iou_ensemble"] = eval_segmentation(
            work / "models", work / "val", target="quality", device=dev)
        report["iou_ensemble_speed1"] = eval_segmentation(
            work / "models", work / "val", target="speed", device=dev)
        report["iou_student"] = eval_segmentation(
            work / "students", work / "val", target="speed", device=dev)
        report["sep_tolerant_ensemble"] = eval_separator_tolerant(
            work / "models", work / "val", target="quality", device=dev)
        report["sep_tolerant_student"] = eval_separator_tolerant(
            work / "students", work / "val", target="speed", device=dev)
        rec = work / "recognizer"
        report["ocr"] = eval_recognizer(rec, n=300, device=dev)
        if (work / "recognizer2" / "meta.json").exists():
            pair = [rec, work / "recognizer2"]
            report["ocr_seed2"] = eval_recognizer(
                work / "recognizer2", n=300, device=dev)
            # the 2-model voted beam against the single greedy decode
            report["ocr_voted_beam"] = eval_recognizer(
                pair, n=300, decoder="beam", device=dev)
            report["ocr_voted_frames"] = eval_recognizer(
                pair, n=300, decoder="beam", vote="frames", device=dev)
            report["ocr_voted_greedy"] = eval_recognizer(
                pair, n=300, device=dev)
            report["ocr_beam_single"] = eval_recognizer(
                rec, n=300, decoder="beam", device=dev)
        report["eval_seconds"] = round(time.time() - t0, 1)
        save_report()
        log.info("REPORT: %s", json.dumps(report, indent=2))

    save_report()
    from origami_tpu_torch.batch.detect.flow import kernel_launches
    # one JSON line: how often each kernel ran (read by chip_smoke.py)
    print(json.dumps({"kernel_launches": kernel_launches()}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
