"""detect.ocr — batched line text recognition (CLI stage 8), on the card.

Port of origami_tpu/batch/detect/ocr.py: image + lines.3 + tables ->
ocr.zip (one .txt per line path) plus the stage's runtime.json entry,
with FAKE and DRY modes built in. Strips are cut by the strip kernel
(batch.core.lines), stay on the device, and feed the CNN+BiLSTM+CTC
recognizer (models.recognizer), decoded greedily on the device;
ensembles vote per line on the members' texts.

    python -m origami_tpu_torch.batch.detect.ocr \
        -m models_pretrained/recognizer CORPUS [--device cpu]
"""

from __future__ import annotations

import argparse
import collections
import json
import logging
from pathlib import Path

import numpy as np
import torch

from origami_tpu_torch.batch.core.io import Artifact, Input, Output, Stage
from origami_tpu_torch.batch.core.lines import LineExtractor
from origami_tpu_torch.batch.core.processor import (BatchedProcessor,
                                                    Processor)
from origami_tpu_torch.batch.core.prof import span
from origami_tpu_torch.batch.core.utils import RegionsFilter

# the JAX stage's runtime.json key: a page OCR'd by either package reads
# the same to every later stage
STAGE_NAME = "origami_tpu.batch.detect.ocr"


class FakePredictor:
    line_height = 48

    def predict(self, strips):
        return ["text for %s." % "/".join(map(str, path))
                for path, _ in strips], [1.0] * len(strips)


class RecognizerPredictor:
    """One or more recognizer models with greedy / voted decode.

    decoder="greedy" decodes on the device; "beam" runs the host prefix
    beam search over per-frame distributions. With several models the
    default vote="sequence" lets each member decode and votes per line
    on the texts, confidence breaking ties (ocr.py:52-64); vote="frames"
    averages the members' frame log-distributions (comparison only).
    `conv_dtype`: the convolutions' dtype (bf16, the JAX model's; float32
    for parity runs)."""

    def __init__(self, model_paths, device, batch_size=128,
                 decoder="greedy", beam_width=10, vote="sequence",
                 conv_dtype=torch.bfloat16):
        from origami_tpu_torch.models import ctc, registry
        self._device = torch.device(device)
        loaded = [registry.load_model(p, self._device, conv_dtype)
                  for p in model_paths]
        self._models = [m for m, _ in loaded]
        meta = loaded[0][1]
        self._charset = meta["charset"]
        self.line_height = meta.get("height", 48)
        self._batch_size = batch_size
        self._voting = len(self._models) > 1
        self._ctc = ctc
        self._decoder = decoder
        self._beam_width = beam_width
        self._vote = vote

    @torch.no_grad()
    def _infer_members(self, x, widths):
        """[(log_softmax logits (B, T, K), pad (B, T))] per member."""
        out = []
        for m in self._models:
            logits, pad = m(x, widths=widths)
            out.append((torch.log_softmax(logits, dim=-1), pad))
        return out

    @torch.no_grad()
    def _recognize_u8(self, strips_u8, widths):
        """u8 strips (B, H, W) on the device -> (ids, lengths, conf),
        each with a leading member axis under sequence voting."""
        x = 1.0 - strips_u8.float()[..., None] / 255.0
        w = torch.clamp(widths.float(), min=1.0)
        if self._voting and self._vote == "frames":
            members = self._infer_members(x, w)
            logp = torch.stack([lp for lp, _ in members]).mean(0)
            return self._ctc.greedy_decode(logp, members[0][1])
        if self._voting:
            dec = [self._ctc.greedy_decode(lp, pad)
                   for lp, pad in self._infer_members(x, w)]
            return tuple(torch.stack(t) for t in zip(*dec))
        logits, pad = self._models[0](x, widths=w)
        return self._ctc.greedy_decode(logits, pad)

    def supports_device_strips(self, wmax, bucket_cap=2048):
        """Device-resident groups need greedy decode and widths within
        the extractor's largest bucket."""
        return (self._decoder == "greedy"
                and bucket_cap is not None and wmax <= bucket_cap)

    def predict_device_deferred_multi(self, parts):
        """Launch recognition of several on-device strip groups of one
        width bucket; finalize_device() reads the results (texts in part
        order). parts: [(strips (nb_i, H, W) u8, widths (n_i,))]; rows
        past n_i are extractor padding and are not recognized: the
        batch-row ladder of the JAX stage (ocr.py:204-219) keeps its
        chunks of `batch_size` rows, but padding rows would only cost
        time here (no graph is compiled per batch shape)."""
        B = self._batch_size
        outs = []
        n = 0
        for dev, wd in parts:
            n_i = len(wd)
            n += n_i
            w = torch.from_numpy(np.asarray(wd, np.float32)).to(dev.device)
            for off in range(0, n_i, B):
                valid = min(n_i - off, B)
                outs.append((valid, self._recognize_u8(
                    dev[off: off + valid], w[off: off + valid])))
        return outs, n

    @staticmethod
    def _align_ops(pivot, other):
        """Minimal-edit alignment of `other` onto `pivot`.

        Yields (slot, char) events: (k, ch) = member reads ch at pivot
        slot k ('' = the member deletes that slot); (-k - 1, ch) = the
        member inserts ch before pivot slot k."""
        n, m = len(pivot), len(other)
        D = np.zeros((n + 1, m + 1), np.int32)
        D[:, 0] = np.arange(n + 1)
        D[0, :] = np.arange(m + 1)
        for i in range(1, n + 1):
            pi = pivot[i - 1]
            row = D[i]
            prev = D[i - 1]
            for j in range(1, m + 1):
                row[j] = min(prev[j] + 1, row[j - 1] + 1,
                             prev[j - 1] + (pi != other[j - 1]))
        i, j = n, m
        out = []
        while i > 0 or j > 0:
            if i > 0 and j > 0 and \
                    D[i, j] == D[i - 1, j - 1] + (pivot[i - 1]
                                                  != other[j - 1]):
                out.append((i - 1, other[j - 1]))
                i -= 1
                j -= 1
            elif i > 0 and D[i, j] == D[i - 1, j] + 1:
                out.append((i - 1, ""))           # slot deleted
                i -= 1
            else:
                out.append((-i - 1, other[j - 1]))  # insertion before i
                j -= 1
        return out

    def _vote_texts(self, cands):
        """Character-position voting over the member texts (Calamari
        ConfidenceVoter semantics, ocr.py:258-306): each member's text is
        edit-aligned onto the highest-confidence member and every aligned
        position is voted independently — majority char wins, ties keep
        the pivot's reading."""
        texts = [t for t, _ in cands]
        confs = [c for _, c in cands]
        if len(set(texts)) == 1:
            return texts[0], max(confs)
        piv_i = max(range(len(cands)), key=lambda i: confs[i])
        pivot = texts[piv_i]
        n = len(pivot)
        ballots = [collections.Counter() for _ in range(n)]
        ins = [collections.Counter() for _ in range(n + 1)]
        n_members = len(cands)
        for mi, t in enumerate(texts):
            if mi == piv_i:
                for k, ch in enumerate(pivot):
                    ballots[k][ch] += 1
                continue
            for slot, ch in self._align_ops(pivot, t):
                if slot >= 0:
                    ballots[slot][ch] += 1
                else:
                    ins[-slot - 1][ch] += 1
        out = []
        for k in range(n + 1):
            if ins[k]:
                ch, cnt = ins[k].most_common(1)[0]
                if cnt * 2 > n_members:   # strict insertion majority
                    out.append(ch)
            if k == n:
                break
            votes = ballots[k]
            top = max(votes.values())
            tied = [ch for ch, c in votes.items() if c == top]
            out.append(pivot[k] if pivot[k] in tied else tied[0])
        text = "".join(out)
        if text in texts:
            return text, max(c for t, c in zip(texts, confs) if t == text)
        return text, confs[piv_i]

    def _texts(self, ids, lengths, conf, rows):
        """(texts, confs) for rows `rows` of one decoded chunk."""
        ids, lengths, conf = (t.cpu().numpy() for t in (ids, lengths, conf))
        texts, confs = [], []
        for j in rows:
            if ids.ndim == 3:               # sequence voting: (N, B, L)
                cands = [(self._ctc.ids_to_text(ids[m, j], lengths[m, j],
                                                self._charset),
                          float(conf[m, j])) for m in range(ids.shape[0])]
                t, c = self._vote_texts(cands)
            else:
                t = self._ctc.ids_to_text(ids[j], lengths[j], self._charset)
                c = float(conf[j])
            texts.append(t)
            confs.append(c)
        return texts, confs

    def finalize_device(self, deferred):
        """(texts, confs) of a predict_device_deferred_multi result."""
        outs, _ = deferred
        texts, confs = [], []
        for n_valid, (ids, lengths, conf) in outs:
            t, c = self._texts(ids, lengths, conf, range(n_valid))
            texts.extend(t)
            confs.extend(c)
        return texts, confs

    def predict(self, strips):
        """Host strip path (--decoder beam): strips [(path, u8 (H, W))]
        -> (texts, confidences), bucketed on the 256-px ladder."""
        from origami_tpu_torch.models.recognizer import strip_width_bucket
        n = len(strips)
        texts = [""] * n
        confs = [0.0] * n
        groups = {}
        for i, (_, s) in enumerate(strips):
            groups.setdefault(strip_width_bucket(s.shape[1]), []).append(i)
        for bucket, idxs in groups.items():
            for start in range(0, len(idxs), self._batch_size):
                part = idxs[start: start + self._batch_size]
                u8 = np.full((len(part), self.line_height, bucket), 255,
                             np.uint8)
                w = np.ones((len(part),), np.float32)
                for j, i in enumerate(part):
                    s = strips[i][1]
                    if s.shape[1] > bucket:
                        # the JAX host path downscales with cv2 here
                        # (ocr.py:377-386); device_groups already
                        # squeezes every line to the 2048-px cap, so
                        # this cannot be reached from OCRProcessor
                        raise ValueError(
                            "line %s wider than its bucket (%d > %d px)"
                            % ("/".join(map(str, strips[i][0])),
                               s.shape[1], bucket))
                    sh = min(s.shape[0], self.line_height)
                    u8[j, :sh, : s.shape[1]] = s[:sh]
                    w[j] = s.shape[1]
                u8_dev = torch.from_numpy(u8).to(self._device)
                w_dev = torch.from_numpy(w).to(self._device)
                if self._decoder == "greedy":
                    t, c = self._texts(*self._recognize_u8(u8_dev, w_dev),
                                       range(len(part)))
                    for j, i in enumerate(part):
                        texts[i], confs[i] = t[j], c[j]
                    continue
                self._beam(u8_dev, w_dev, part, texts, confs)
        return texts, confs

    def _beam(self, u8_dev, w_dev, part, texts, confs):
        x = 1.0 - u8_dev.float()[..., None] / 255.0
        members = self._infer_members(x, w_dev)
        if self._voting and self._vote == "sequence":
            for j, i in enumerate(part):
                cands = []
                for logp, pad in members:
                    lp = logp[j].cpu().numpy()
                    T = int((pad[j] < 0.5).sum())
                    text, score = self._ctc.beam_search_decode(
                        lp[:T], self._charset, beam_width=self._beam_width)
                    cands.append((text, float(np.exp(
                        score / max(len(text), 1)))))
                texts[i], confs[i] = self._vote_texts(cands)
            return
        logp = torch.stack([lp for lp, _ in members]).mean(0)
        logp = torch.log_softmax(logp, dim=-1).cpu().numpy()
        pad = members[0][1].cpu().numpy()
        for j, i in enumerate(part):
            T = int((pad[j] < 0.5).sum())
            text, score = self._ctc.beam_search_decode(
                logp[j, :T], self._charset, beam_width=self._beam_width)
            texts[i] = text
            confs[i] = float(np.exp(score / max(len(text), 1)))


class OCRProcessor(BatchedProcessor):
    """Batches line strips ACROSS pages, so the width-bucketed
    recognizer batches run fuller than one page provides."""

    def __init__(self, options):
        super().__init__(options,
                         batch_size=options.get("pages_per_batch", 4))
        self._opt = options
        self._model_spec = str(options.get("model", "FAKE"))
        self._predictor = None
        self._ignored = RegionsFilter(options.get(
            "ignored", "regions/ILLUSTRATION"))

    @property
    def processor_name(self):
        return STAGE_NAME

    def artifacts(self):
        return [
            ("reliable", Input(Artifact.LINES, Artifact.TABLES,
                               stage=Stage.RELIABLE)),
            ("output", Output(Artifact.OCR)),
        ]

    def _get_predictor(self):
        if self._predictor is None:
            spec = self._model_spec
            if spec.upper() in ("FAKE", "DRY"):
                self._predictor = FakePredictor()
            else:
                path = Path(spec)
                if (path / "meta.json").exists():
                    members = [path]
                else:
                    members = sorted(d for d in path.iterdir()
                                     if (d / "meta.json").exists())
                if not members:
                    raise FileNotFoundError(
                        "no recognizer models at %s" % path)
                self._predictor = RecognizerPredictor(
                    members, self.device,
                    batch_size=self._opt.get("batch_size", 128),
                    decoder=self._opt.get("decoder", "greedy"),
                    beam_width=self._opt.get("beam_width", 10),
                    vote=self._opt.get("vote", "sequence"))
        return self._predictor

    def process_batch(self, pages):
        predictor = self._get_predictor()
        dry = self._model_spec.upper() == "DRY"
        page_texts = {}
        host_strips = []          # [(page_path, path, strip)]
        by_bucket = {}            # wmax -> [(page_path, paths, dev, widths)]
        infos = {}
        for page_path, kwargs in pages:
            with span("ocr.reliable_load"):
                reliable = kwargs["reliable"]
                extractor = LineExtractor(
                    reliable.tables, predictor.line_height, self._opt,
                    min_confidence=reliable.lines.min_confidence,
                    max_width=2048)
                parts = extractor.parts(reliable.lines.by_path,
                                        ignored=self._ignored)
            page_texts[page_path] = []
            if dry:
                for path, _, _ in parts:
                    logging.info("would OCR %s", "/".join(map(str, path)))
                infos[page_path] = dict(n_lines=len(parts), dry=True)
                continue
            if extractor.binarizer is not None:
                # every strip comes to the host, is binarized (Sauvola:
                # one kernel launch a strip) and goes through predict,
                # as ocr.py:536-560 of the JAX stage does
                with span("ocr.host_strips"):
                    host_strips.extend(
                        (page_path, path, strip)
                        for path, strip in extractor.extract(parts))
                continue
            device_ok = hasattr(predictor, "predict_device_deferred_multi")
            with span("ocr.collect_groups"):
                groups = list(extractor.device_groups(parts))
            for paths, dev, widths, wmax in groups:
                if device_ok and predictor.supports_device_strips(
                        wmax, extractor.bucket_cap):
                    by_bucket.setdefault(wmax, []).append(
                        (page_path, paths, dev, widths))
                else:
                    with span("ocr.host_strips"):
                        strips = dev.cpu().numpy()
                        for i, path in enumerate(paths):
                            host_strips.append(
                                (page_path, path, strips[i, :, : widths[i]]))
        if dry:
            return infos

        deferred = []
        with span("ocr.recognize_dispatch"):
            for wmax in sorted(by_bucket):
                groups = by_bucket[wmax]
                d = predictor.predict_device_deferred_multi(
                    [(dev, widths) for _, _, dev, widths in groups])
                deferred.append((groups, d))
        with span("ocr.finalize"):
            for groups, d in deferred:
                texts, _ = predictor.finalize_device(d)
                i = 0
                for page_path, paths, _, _ in groups:
                    page_texts[page_path].extend(
                        zip(paths, texts[i: i + len(paths)]))
                    i += len(paths)

        if host_strips:
            with span("ocr.host_predict"):
                texts, _ = predictor.predict(
                    [(path, strip) for _, path, strip in host_strips])
                for (page_path, path, _), text in zip(host_strips, texts):
                    page_texts[page_path].append((path, text))

        with span("ocr.write"):
            for page_path, kwargs in pages:
                entries = page_texts[page_path]
                with kwargs["output"].ocr() as zf:
                    for path, text in entries:
                        zf.writestr("/".join(map(str, path)) + ".txt", text)
                infos[page_path] = dict(n_lines=len(entries))
        return infos


def parser():
    p = argparse.ArgumentParser(
        prog="python -m origami_tpu_torch.batch.detect.ocr",
        description="Run OCR on all documents in DATA_PATH.")
    p.add_argument("-m", "--model", type=str, default="FAKE",
                   help="recognizer model dir (or ensemble parent dir), "
                        "FAKE, or DRY")
    p.add_argument("-b", "--batch-size", type=int, default=128)
    p.add_argument("--decoder", choices=["greedy", "beam"],
                   default="greedy",
                   help="device greedy decode vs host prefix beam search")
    p.add_argument("--beam-width", type=int, default=10)
    p.add_argument("--vote", choices=["sequence", "frames"],
                   default="sequence",
                   help="multi-model voting: per-line sequence vote vs "
                        "frame-distribution averaging (comparison only)")
    p.add_argument("--ignored", type=str, default="regions/ILLUSTRATION")
    p.add_argument("data_path", type=str)
    Processor.add_arguments(p, pooled=False)
    LineExtractor.add_arguments(p)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    if not Path(args.data_path).exists():
        raise SystemExit("no such path: %s" % args.data_path)
    from origami_tpu_torch.batch.core import prof
    from origami_tpu_torch.batch.detect.flow import kernel_launches
    OCRProcessor(vars(args)).traverse(args.data_path)
    if prof.enabled:
        prof.report()
    # one JSON line: how often each kernel ran (read by chip_smoke.py;
    # with --binarize the Sauvola kernel runs too)
    print(json.dumps({"kernel_launches": kernel_launches()}), flush=True)


if __name__ == "__main__":
    main()
