"""Segmentation inference: batched, tiled, ensemble-voted.

Port of origami_tpu/core/predict.py. Per page the device runs: resize
to the net canvas, overlapping-tile extraction, the ensemble's members
in sequence, softmax-sum voting, inner-region stitching and argmax; the
label maps of a page batch come back to the host in one copy.

Two predictor families:

  SegmentationPredictor   loads trained U-Net ensembles from a models
                          directory (region + separator nets; target
                          "speed" uses 1 member each, "quality" all);
  HeuristicSegmentationPredictor
                          model-free device segmentation (Sauvola
                          binarization through the CUDA kernel + oriented
                          morphology), which lets the whole pipeline run
                          without trained weights.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from origami_tpu_torch import device as _device
from origami_tpu_torch.core.segment import Prediction, Segmentation


class _EnsembleGraph:
    """(resize -> tile -> ensemble -> stitch -> vote) for one net group,
    shared by all pages."""

    def __init__(self, models, meta):
        from origami_tpu_torch.ops.tiling import TileLayout
        self._models = models
        self._meta = meta
        full_w, full_h = meta["full_size"]
        self._full_hw = (full_h, full_w)
        self._layout = TileLayout((full_w, full_h), meta["tile_size"],
                                  beta0=meta.get("tile_beta", 50))
        self._n_classes = len(meta["classes"])

    @torch.no_grad()
    def __call__(self, images):
        """images (B, H, W) u8 on the models' device -> label maps
        (B, full_h, full_w) u8 on that device. Pages run one after the
        other: a page's tile batch fills the card, and running pages
        side by side would multiply the peak activation memory by B."""
        from origami_tpu_torch.models.unet import ensemble_apply
        from origami_tpu_torch.ops.resize import resize
        out = []
        for img in images:
            net_in = resize(img.float(), self._full_hw, "area") / 255.0
            tiles = self._layout.extract(net_in[..., None])
            probs = ensemble_apply(self._models, tiles)
            stitched = self._layout.stitch_logits(probs, self._n_classes)
            out.append(torch.argmax(stitched, dim=-1).to(torch.uint8))
        return torch.stack(out)

    @property
    def meta(self):
        return self._meta


def _pad_batch(pages):
    """Stack variable-size grayscale pages into one u8 batch padded with
    255 to multiples of 64.

    Returns (batch, sizes): sizes holds each page's true (h, w); the
    padding fraction must be cropped off the canvas-space output again
    or every downstream coordinate is scaled by content/padded."""
    hs = [p.shape[0] for p in pages]
    ws = [p.shape[1] for p in pages]
    H = -(-max(hs) // 64) * 64
    W = -(-max(ws) // 64) * 64
    out = np.full((len(pages), H, W), 255, dtype=np.uint8)
    for i, p in enumerate(pages):
        out[i, : p.shape[0], : p.shape[1]] = np.asarray(p, np.uint8)
    return out, list(zip(hs, ws))


def _to_host(tensors):
    """The tensors as numpy arrays, through one device-to-host copy."""
    flat = torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy()
    out, i = [], 0
    for t in tensors:
        out.append(flat[i: i + t.numel()].reshape(tuple(t.shape)))
        i += t.numel()
    return out


class SegmentationPredictor:
    """Loads region + separator ensembles and segments page batches.

    Models directory layout: <path>/<group>/<k>/ with group in
    {"region", "separator"}. `dtype` is the convolutions' type: bf16 on
    the main path, float32 for parity runs."""

    def __init__(self, models_path, target="quality", device=None,
                 dtype=torch.bfloat16):
        from origami_tpu_torch.models import registry
        self._device = _device.resolve(device)
        self._graphs = []
        models_path = Path(models_path)
        for group, name in (("region", "regions"),
                            ("separator", "separators")):
            gdir = models_path / group
            members = sorted(
                [d for d in gdir.iterdir() if (d / "meta.json").exists()]
            ) if gdir.exists() else []
            if not members:
                raise FileNotFoundError(
                    "no %s models under %s" % (group, models_path))
            if target == "speed":
                members = members[:1]
            models, meta = registry.load_ensemble(members, self._device,
                                                  conv_dtype=dtype)
            self._graphs.append(_EnsembleGraph(models,
                                               dict(meta, name=name)))

    def predict_batch(self, pages):
        """pages: list of (H, W) uint8 arrays -> list of Segmentation."""
        batch, sizes = _pad_batch(pages)
        _, H, W = batch.shape
        # one upload shared by the region and separator graphs
        batch = torch.from_numpy(batch).to(self._device)
        outs = _to_host([g(batch) for g in self._graphs])
        segs = []
        for i, (h, w) in enumerate(sizes):
            preds = []
            for g, labels in zip(self._graphs, outs):
                meta = g.meta
                lab = labels[i]
                # crop away the pad-bucket fraction: the raster then maps
                # 1:1 onto the page again (stages rescale rasters of any
                # size to page coordinates)
                ch = int(round(lab.shape[0] * h / H))
                cw = int(round(lab.shape[1] * w / W))
                preds.append(Prediction(
                    meta["type"].upper(), meta["name"], lab[:ch, :cw],
                    {c: j for j, c in enumerate(meta["classes"])}))
            segs.append(Segmentation(preds))
        return segs

    def __call__(self, page):
        return self.predict_batch([np.asarray(page)])[0]


def otsu_threshold_u8(gray):
    """cv2.threshold(..., THRESH_OTSU)'s threshold of a u8 image: the
    first maximum of the between-class variance over the 256-bin
    histogram, in cv2's arithmetic (float64, class 1 the levels <= t)."""
    hist = np.bincount(np.asarray(gray, np.uint8).reshape(-1),
                       minlength=256).astype(np.float64)
    scale = 1.0 / max(hist.sum(), 1.0)
    mu = float((hist * np.arange(256)).sum()) * scale
    eps = float(np.finfo(np.float32).eps)
    mu1 = q1 = 0.0
    best, best_t = 0.0, 0
    for t in range(256):
        p = hist[t] * scale
        mu1 *= q1
        q1 += p
        q2 = 1.0 - q1
        if min(q1, q2) < eps or max(q1, q2) > 1.0 - eps:
            continue
        mu1 = (mu1 + t * p) / q1
        mu2 = (mu - q1 * mu1) / q2
        sigma = q1 * q2 * (mu1 - mu2) * (mu1 - mu2)
        if sigma > best:
            best, best_t = sigma, t
    return best_t


class HeuristicSegmentationPredictor:
    """Model-free device segmentation for pipelines without weights.

    Ink comes from Sauvola binarization; separators from oriented
    openings (long thin runs of ink); text regions from closing the
    remaining ink. Output uses the standard BBZ class contracts."""

    REGION_CLASSES = {"TEXT": 0, "TABULAR": 1, "ILLUSTRATION": 2,
                      "BACKGROUND": 3}
    SEP_CLASSES = {"H": 0, "V": 1, "T": 2, "BACKGROUND": 3}

    def __init__(self, sep_len=None, text_gap=None, device=None):
        self._sep_len = sep_len
        self._text_gap = text_gap
        self._device = _device.resolve(device)

    def _run(self, img, sep_len, text_gap):
        """u8 page on the device -> (region, separator) label maps u8."""
        from origami_tpu_torch.ops.binarize import sauvola
        from origami_tpu_torch.ops.morphology import dilate, erode
        ink = (~sauvola(img, 31)).float()
        v = dilate(erode(ink, sep_len, 1), sep_len, 1)
        hmask = dilate(erode(ink, 1, sep_len), 1, sep_len)
        text_ink = torch.clamp(ink - torch.maximum(v, hmask), min=0.0)
        text = erode(dilate(text_ink, text_gap, text_gap),
                     text_gap, text_gap)

        def full(value):
            return torch.full(img.shape, value, dtype=torch.uint8,
                              device=img.device)

        sep = full(self.SEP_CLASSES["BACKGROUND"])
        sep = torch.where(hmask > 0.5, full(self.SEP_CLASSES["H"]), sep)
        sep = torch.where(v > 0.5, full(self.SEP_CLASSES["V"]), sep)
        reg = torch.where(text > 0.5, full(self.REGION_CLASSES["TEXT"]),
                          full(self.REGION_CLASSES["BACKGROUND"]))
        return reg, sep

    @staticmethod
    def estimate_line_pitch(gray):
        """Dominant text-line pitch via autocorrelation of the row ink
        profile (on the host, cheap)."""
        g = np.asarray(gray, dtype=np.uint8)
        binar = g <= otsu_threshold_u8(g)
        prof = binar.sum(axis=1).astype(np.float64)
        prof -= prof.mean()
        h = len(prof)
        if h < 64 or prof.std() < 1e-6:
            return max(12, h // 40)
        ac = np.correlate(prof, prof, mode="full")[h - 1:]
        lo, hi = 8, max(16, h // 10)
        return lo + int(np.argmax(ac[lo:hi]))

    def __call__(self, page):
        gray = np.ascontiguousarray(np.asarray(page), dtype=np.uint8)
        # structuring elements follow the text-line pitch: the closing
        # gap must bridge inter-line whitespace but stay below column
        # gutters (~2-3x the inter-line gap); separators span several
        # pitches
        h = gray.shape[0]
        pitch = self.estimate_line_pitch(gray)
        sep_len = self._sep_len or min(max(21, int(pitch * 1.2) | 1),
                                       max(21, h // 40) | 1)
        text_gap = self._text_gap or max(9, int(pitch * 0.8) | 1)
        img = torch.from_numpy(gray).to(self._device)
        reg, sep = _to_host(self._run(img, sep_len, text_gap))
        return Segmentation([
            Prediction("REGION", "regions", reg, self.REGION_CLASSES),
            Prediction("SEPARATOR", "separators", sep, self.SEP_CLASSES),
        ])

    def predict_batch(self, pages):
        return [self(p) for p in pages]
