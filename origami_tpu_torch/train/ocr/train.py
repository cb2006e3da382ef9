"""CTC line-recognizer training on the card.

Port of origami_tpu/train/ocr/train.py: `models.ctc.ctc_loss` (optax's
per-sequence loss, batch mean) over width-bucketed padded line batches,
AdamW on optax's warmup + cosine schedule at weight decay 1e-5, and a
device-resident strip pool from which each step gathers its rows, so the
host sends only indices. The LSTM honours each row's length (packed
sequences) and MaskedGroupNorm ignores width padding, as the JAX
model's, so padded rows get the JAX gradients.

On a mesh (train/mesh.py) the parameters stay whole on every device, as
the JAX trainer replicates them, and the strips are cut over the data
axis; the loss is the mean over the whole batch, so each block
back-propagates its sequences' summed loss over the global batch size.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from origami_tpu_torch.models import ctc as ctc_lib
from origami_tpu_torch.models import recognizer as rec_lib
from origami_tpu_torch.ops.remap import _div
from origami_tpu_torch.train.mesh import MeshModel, mesh_or_device, upload
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
    float32 for parity runs); the LSTM and head run in float32. `mesh`
    or `device`, not both: no mesh is a one-device mesh on `device`.
    `model` is the first device's replica."""

    def __init__(self, cfg, mesh=None, seed=0, device=None,
                 dtype=torch.bfloat16):
        self.cfg = cfg
        self.mesh = mesh_or_device(mesh, device)
        self.device = self.mesh.devices[0]
        model = rec_lib.LineRecognizer(
            cfg.num_symbols, conv_features=tuple(cfg.conv_features),
            lstm_features=cfg.lstm_features, height=cfg.height,
            dtype=dtype)
        rec_lib.init_recognizer(model, torch.Generator().manual_seed(seed))
        sched = warmup_cosine_decay(cfg.learning_rate, cfg.warmup,
                                    max(cfg.steps, cfg.warmup + 1))
        self.net = MeshModel(self.mesh, model, lambda ps: ScheduledAdamW(
            ps, sched, weight_decay=cfg.weight_decay), split=False)
        self.model = self.net.replicas[0]
        self.optimizer = self.net.optimizers[0]

    def state_dict(self):
        return self.net.state_dict()

    def load_state_dict(self, sd):
        self.net.load_state_dict(sd)

    def _update(self, parts, blocks):
        """One update; blocks: {device index: (images, widths, labels,
        label_pad)} on their devices, for the blocks `parts`. -> the mean
        CTC loss over every block's rows."""
        b = sum(len(x) for x, _, _, _ in blocks.values())

        def run_block(k, replica, rows):
            images, widths, labels, label_pad = blocks[k]
            logits, pad = replica(images, widths=widths)
            total = ctc_lib.ctc_losses(logits, pad, labels, label_pad).sum()
            (total / b).backward()
            return total.detach()

        return self.net.step(parts, run_block) / b

    def train_step(self, images, widths, labels, label_pad):
        """images (B, H, W, 1) float in [0, 1] (ink high), widths (B,),
        labels (B, L) int, label_pad (B, L) (1 = padding)."""
        arrays = [torch.as_tensor(np.asarray(a)).to(dtype) for a, dtype in (
            (images, torch.float32), (widths, torch.float32),
            (labels, torch.long), (label_pad, torch.float32))]
        parts = self.net.blocks(len(arrays[0]))
        return float(self._update(parts, self.net.scatter(parts, arrays)))

    # -- device-resident-pool path -----------------------------------------
    def attach_pool(self, buckets):
        """buckets: {bucket_width: (strips_u8 (N, H, Wb), widths (N,),
        labels (N, L), label_pad (N, L))}, moved once to each device of
        the mesh."""
        self._pool = {
            k: upload(self.mesh, [np.asarray(s, np.uint8),
                                  np.asarray(w, np.float32),
                                  np.asarray(l, np.int64),
                                  np.asarray(p, np.float32)])
            for k, (s, w, l, p) in buckets.items()}

    def train_on_bucket(self, bucket, idx):
        """One step on pool rows `idx` of one width bucket, cut over the
        mesh; returns the loss as a device tensor (float() only when
        logging)."""
        idx = torch.as_tensor(np.asarray(idx, np.int64))
        devices = self.mesh.devices
        parts = self.net.blocks(len(idx))
        blocks = {}
        for k, rows in parts:
            strips, widths, labels, pad = self._pool[bucket][devices[k]]
            sel = idx[rows].to(devices[k])
            x = (1.0 - _div(strips[sel].float(), 255.0))[..., None]
            blocks[k] = (x, widths[sel], labels[sel], pad[sel])
        return self._update(parts, blocks)

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
