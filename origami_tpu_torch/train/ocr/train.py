"""CTC line-recognizer training on the card.

Port of origami_tpu/train/ocr/train.py: `models.ctc.ctc_loss` (optax's
per-sequence loss, batch mean) over width-bucketed padded line batches,
AdamW on optax's warmup + cosine schedule at weight decay 1e-5, and a
device-resident strip pool from which each step gathers its rows, so the
host sends only indices. The LSTM honours each row's length (packed
sequences) and MaskedGroupNorm ignores width padding, as the JAX
model's, so padded rows get the JAX gradients.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from origami_tpu_torch.device import resolve
from origami_tpu_torch.models import ctc as ctc_lib
from origami_tpu_torch.models import recognizer as rec_lib
from origami_tpu_torch.ops.remap import _div
from origami_tpu_torch.train.segment.train import (ScheduledAdamW,
                                                   warmup_cosine_decay)


@dataclass
class OCRTrainConfig:
    num_symbols: int = 96
    height: int = 48
    learning_rate: float = 1e-3
    weight_decay: float = 1e-5
    steps: int = 50_000
    warmup: int = 1000
    conv_features: tuple = (64, 128, 256)
    lstm_features: int = 256


class RecognizerTrainer:
    """`dtype` is the convolutions' (bf16, as the JAX trainer's model;
    float32 for parity runs); the LSTM and head run in float32."""

    def __init__(self, cfg, seed=0, device=None, dtype=torch.bfloat16):
        self.cfg = cfg
        self.device = resolve(device)
        self.model = rec_lib.LineRecognizer(
            cfg.num_symbols, conv_features=tuple(cfg.conv_features),
            lstm_features=cfg.lstm_features, height=cfg.height,
            dtype=dtype)
        rec_lib.init_recognizer(self.model,
                                torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        sched = warmup_cosine_decay(cfg.learning_rate, cfg.warmup,
                                    max(cfg.steps, cfg.warmup + 1))
        self.optimizer = ScheduledAdamW(self.model.parameters(), sched,
                                        weight_decay=cfg.weight_decay)

    def _update(self, images, widths, labels, label_pad):
        self.optimizer.zero_grad()
        logits, pad = self.model(images, widths=widths)
        loss = ctc_lib.ctc_loss(logits, pad, labels, label_pad)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def train_step(self, images, widths, labels, label_pad):
        """images (B, H, W, 1) float in [0, 1] (ink high), widths (B,),
        labels (B, L) int, label_pad (B, L) (1 = padding)."""
        def dev(a, dtype=None):
            t = torch.as_tensor(np.asarray(a))
            return t.to(self.device, dtype) if dtype else t.to(self.device)
        return float(self._update(dev(images, torch.float32),
                                  dev(widths, torch.float32),
                                  dev(labels, torch.long),
                                  dev(label_pad, torch.float32)))

    # -- device-resident-pool path -----------------------------------------
    def attach_pool(self, buckets):
        """buckets: {bucket_width: (strips_u8 (N, H, Wb), widths (N,),
        labels (N, L), label_pad (N, L))}, moved to the card once."""
        self._pool = {
            k: (torch.as_tensor(np.asarray(s, np.uint8)).to(self.device),
                torch.as_tensor(np.asarray(w, np.float32)).to(self.device),
                torch.as_tensor(np.asarray(l, np.int64)).to(self.device),
                torch.as_tensor(np.asarray(p, np.float32)).to(self.device))
            for k, (s, w, l, p) in buckets.items()}

    def train_on_bucket(self, bucket, idx):
        """One step on pool rows `idx` of one width bucket; returns the
        loss as a device tensor (float() only when logging)."""
        strips, widths, labels, pad = self._pool[bucket]
        idx = torch.as_tensor(np.asarray(idx, np.int64)).to(self.device)
        s = strips[idx].float()
        x = (1.0 - _div(s, 255.0))[..., None]
        return self._update(x, widths[idx], labels[idx], pad[idx])

    def save(self, path, charset):
        from origami_tpu_torch.models import registry
        meta = dict(kind="recognizer", charset=charset,
                    height=self.cfg.height,
                    conv_features=list(self.cfg.conv_features),
                    lstm_features=self.cfg.lstm_features, version=1)
        registry.save_model(path, meta, self.model)


def encode_labels(texts, charset, max_len=None):
    """Map strings to padded CTC label arrays (blank=0, chars from 1)."""
    index = {c: i + 1 for i, c in enumerate(charset)}
    seqs = [[index[c] for c in t if c in index] for t in texts]
    L = max_len or max((len(s) for s in seqs), default=1)
    labels = np.zeros((len(seqs), L), np.int32)
    pad = np.ones((len(seqs), L), np.float32)
    for i, s in enumerate(seqs):
        s = s[:L]
        labels[i, : len(s)] = s
        pad[i, : len(s)] = 0.0
    return labels, pad
