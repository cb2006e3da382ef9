"""Ensemble -> single-student distillation for segmentation nets.

Port of origami_tpu/train/segment/distill.py: the teacher is the mean
of its members' softmax at temperature T (members run one after another
under torch.no_grad, their probabilities summed in float32 in member
order, as the JAX scan sums them); the loss is KL(teacher || student)
at T times T^2, plus `hard_weight` times the masked cross entropy on
hard labels. AdamW on optax's warmup + cosine schedule with optax.adamw's
default decay 1e-4 (the JAX Distiller passes none).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from origami_tpu_torch.device import resolve
from origami_tpu_torch.models import unet as unet_lib
from origami_tpu_torch.ops.remap import _div
from origami_tpu_torch.train.segment.train import (ScheduledAdamW,
                                                   warmup_cosine_decay)


@dataclass
class DistillConfig:
    num_classes: int = 4
    width: float = 1.0
    s2d: int = 2
    tile_hw: tuple = (896, 1280)
    temperature: float = 2.0
    hard_weight: float = 0.3
    learning_rate: float = 2e-4
    steps: int = 10_000
    warmup: int = 200


class Distiller:
    """Teacher = a list of U-Net members (same classes, any size) on the
    trainer's device; student = a fresh net of cfg's width and s2d."""

    def __init__(self, cfg, teachers, seed=0, device=None,
                 dtype=torch.bfloat16):
        self.cfg = cfg
        self.device = resolve(device)
        self.teachers = [t.to(self.device).eval() for t in teachers]
        self.student = unet_lib.create_unet(cfg.num_classes,
                                            width=cfg.width, s2d=cfg.s2d,
                                            dtype=dtype)
        unet_lib.init_unet(self.student,
                           torch.Generator().manual_seed(seed))
        self.student.to(self.device)
        sched = warmup_cosine_decay(cfg.learning_rate, cfg.warmup,
                                    max(cfg.steps, cfg.warmup + 1))
        self.optimizer = ScheduledAdamW(self.student.parameters(), sched,
                                        weight_decay=1e-4)

    @torch.no_grad()
    def teacher_probs(self, images):
        """Mean of the members' softmax(logits / T), float32."""
        t = self.cfg.temperature
        acc = None
        for m in self.teachers:
            logits = m(images).float()
            p = torch.softmax(_div(logits, t), dim=-1)
            acc = p if acc is None else acc + p
        return _div(acc, len(self.teachers))

    def loss(self, images, labels, label_mask):
        cfg = self.cfg
        t = cfg.temperature
        tprobs = self.teacher_probs(images)
        slogits = self.student(images).float()
        slogp = torch.log_softmax(_div(slogits, t), dim=-1)
        tlogp = torch.log(torch.clamp(tprobs, min=1e-9))
        # true KL(teacher || student): floor at 0 when matched
        kl = torch.mean(torch.sum(tprobs * (tlogp - slogp), dim=-1)) * t * t
        logp = torch.log_softmax(slogits, dim=-1)
        ce_px = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
        ce = torch.sum(ce_px * label_mask) / torch.clamp(
            torch.sum(label_mask), min=1.0)
        return kl + cfg.hard_weight * ce

    def _update(self, images, labels, label_mask):
        self.optimizer.zero_grad()
        loss = self.loss(images, labels, label_mask)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    # -- device-resident-corpus path ---------------------------------------
    def attach_dataset(self, images_u8, labels_u8, seed=0):
        """Upload the (N, H, W) uint8 corpus once; distill_on_indices
        sends only indices."""
        self._data = (
            torch.as_tensor(np.asarray(images_u8, np.uint8)).to(self.device),
            torch.as_tensor(np.asarray(labels_u8, np.uint8)).to(self.device))

    def distill_on_indices(self, idx):
        """One step on corpus rows `idx`; returns the loss as a device
        tensor (float() it only when logging)."""
        idx = torch.as_tensor(np.asarray(idx, np.int64)).to(self.device)
        imgs = self._data[0][idx].float()
        images = _div(imgs, 255.0)[..., None]
        labels = self._data[1][idx].long()
        return self._update(images, labels,
                            torch.ones(labels.shape, device=self.device))

    def train_step(self, images, labels=None, label_mask=None):
        images = torch.as_tensor(images).to(self.device)
        b, h, w = images.shape[:3]
        if labels is None:
            labels = torch.zeros((b, h, w), dtype=torch.long)
            label_mask = torch.zeros((b, h, w))
        elif label_mask is None:
            label_mask = torch.ones((b, h, w))
        loss = self._update(images,
                            torch.as_tensor(labels).to(self.device),
                            torch.as_tensor(label_mask).float()
                            .to(self.device))
        return float(loss)

    def save(self, path, meta):
        from origami_tpu_torch.models import registry
        registry.save_model(path, meta, self.student)
