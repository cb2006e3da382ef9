"""U-Net segmentation training on the card.

Port of origami_tpu/train/segment/train.py: class-weighted softmax
cross entropy over (tile, label) batches, AdamW on optax's warmup +
cosine schedule, the forward rematerialized in the backward pass
(torch.utils.checkpoint), and a device-resident uint8 corpus whose
batches are gathered, warped (one `remap_batch` launch a step) and
normalized on the card, so the host sends only indices.

The optimizer repeats optax's numbers: `warmup_cosine_decay` gives a
learning rate of 0 at step 0 (the first update moves only the moments;
adamw's decay is scaled by the same rate), and `ScheduledAdamW` is
optax.adamw's defaults (b1 0.9, b2 0.999, eps 1e-8, the decay applied to
every parameter) with the decay the caller gives, never torch's 0.01.
One mesh axis stays out: parameters and batch live on one card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from origami_tpu_torch.device import resolve
from origami_tpu_torch.models import unet as unet_lib
from origami_tpu_torch.ops.remap import _div


@dataclass
class TrainConfig:
    num_classes: int = 4
    width: float = 1.0
    s2d: int = 1
    tile_hw: tuple = (896, 1280)
    learning_rate: float = 3e-4
    weight_decay: float = 1e-4
    steps: int = 10_000
    warmup: int = 500
    remat: bool = True
    class_weights: Any = None   # (num_classes,) loss weights, or None
    # (background_idx, radius_px, factor): down-weight background
    # pixels within radius of any foreground GT pixel (a tolerance band
    # for hairline classes). None = plain CE.
    band_dontcare: Any = None


def warmup_cosine_decay(peak, warmup, decay_steps):
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, decay_steps)
    as a function of the step count (float64)."""
    def schedule(count):
        if warmup > 0 and count < warmup:
            return -peak * (1.0 - count / warmup) + peak
        c = min(float(count - warmup), float(decay_steps - warmup))
        return peak * 0.5 * (1.0 + math.cos(math.pi * c
                                             / (decay_steps - warmup)))
    return schedule


class ScheduledAdamW:
    """optax.adamw(schedule, weight_decay=...): torch.optim.AdamW with
    optax's defaults, its learning rate set from `schedule(count)` before
    each update (count = updates made so far)."""

    def __init__(self, params, schedule, weight_decay=1e-4):
        self.schedule = schedule
        self.count = 0
        self.opt = torch.optim.AdamW(
            [p for p in params if p.requires_grad], lr=0.0,
            betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    def step(self):
        lr = self.schedule(self.count)
        for g in self.opt.param_groups:
            g["lr"] = lr
        self.opt.step()
        self.count += 1

    def state_dict(self):
        return {"opt": self.opt.state_dict(), "count": self.count}

    def load_state_dict(self, state):
        self.opt.load_state_dict(state["opt"])
        self.count = int(state["count"])


def make_optimizer(cfg, params):
    """optax's warmup_cosine_decay_schedule(0, lr, warmup, max(steps,
    warmup + 1)) + adamw at cfg.weight_decay."""
    sched = warmup_cosine_decay(cfg.learning_rate, cfg.warmup,
                                max(cfg.steps, cfg.warmup + 1))
    return ScheduledAdamW(params, sched, weight_decay=cfg.weight_decay)


def weighted_ce_loss(logits, labels, class_weights, band_dontcare=None):
    """Mean class-weighted cross entropy. logits (B, H, W, K), labels
    (B, H, W) int. band_dontcare=(background_idx, radius, factor)
    softens background pixels within `radius` of any foreground GT pixel
    by `factor` (a max pool of the foreground, as lax.reduce_window
    "SAME"); GT foreground keeps full weight."""
    labels = labels.long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    per_px = -torch.gather(logp, -1, labels[..., None])[..., 0]
    w = class_weights[labels]
    if band_dontcare is not None:
        bg, radius, factor = band_dontcare
        fg = (labels != bg).float()[:, None]
        k = 2 * int(radius) + 1
        band = F.max_pool2d(fg, k, stride=1, padding=int(radius))[:, 0]
        w = w * torch.where((band > 0) & (labels == bg), float(factor),
                            1.0)
    # both sums in float64: the quotient is then the float32 rounding of
    # the exact one, which JAX's float32 sums stay within a few ulp of
    num = torch.sum(per_px * w, dtype=torch.float64)
    den = torch.clamp(torch.sum(w, dtype=torch.float64), min=1e-6)
    return (num / den).float()


def _forward(model, remat):
    if remat:
        return lambda x: checkpoint(model, x, use_reentrant=False)
    return model


def make_train_step(model, optimizer, class_weights, remat=True,
                    band_dontcare=None):
    """step(images (B, H, W, 1) float, labels (B, H, W) int) -> the loss
    (a detached 0-dim tensor); one optimizer update."""
    apply = _forward(model, remat)

    def step(images, labels):
        optimizer.zero_grad()
        loss = weighted_ce_loss(apply(images), labels, class_weights,
                                band_dontcare)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_dataset_train_step(model, optimizer, class_weights,
                            warp_amplitude=0.0, remat=True,
                            band_dontcare=None):
    """step(images_u8 (N, H, W), labels_u8 (N, H, W), idx (B,) long,
    generator) over a DEVICE-RESIDENT corpus: gather, warp augmentation
    (per-sample amplitude uniform in [0, A), one remap_batch launch) and
    normalization run on the card."""
    from origami_tpu_torch.train.segment.warp import (
        displacement_field, random_coarse, warp_batch)
    apply = _forward(model, remat)

    def step(images_u8, labels_u8, idx, generator):
        imgs = images_u8[idx].float()
        labs = labels_u8[idx].long()
        if warp_amplitude > 0:
            n = imgs.shape[0]
            amps = torch.rand((n,), generator=generator) * warp_amplitude
            coarse = random_coarse(generator, n, amps).to(imgs.device)
            fields = displacement_field(coarse, imgs.shape[1:])
            imgs, labs = warp_batch(imgs, labs, fields)
        x = _div(imgs, 255.0)[..., None]
        optimizer.zero_grad()
        loss = weighted_ce_loss(apply(x), labs, class_weights,
                                band_dontcare)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


class SegmentationTrainer:
    """Owns the U-Net on its device, the optimizer and the step.
    `dtype` is the convolutions' (bf16, as the JAX trainer's U-Net;
    float32 for parity runs); parameters are float32."""

    def __init__(self, cfg, seed=0, device=None, dtype=torch.bfloat16):
        self.cfg = cfg
        self.device = resolve(device)
        self.model = unet_lib.create_unet(cfg.num_classes, width=cfg.width,
                                          s2d=cfg.s2d, dtype=dtype)
        unet_lib.init_unet(self.model, torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        self.optimizer = make_optimizer(cfg, self.model.parameters())
        cw = cfg.class_weights if cfg.class_weights is not None \
            else np.ones((cfg.num_classes,))
        self.class_weights = torch.as_tensor(
            np.asarray(cw, np.float32)).to(self.device)
        self._step = make_train_step(self.model, self.optimizer,
                                     self.class_weights, remat=cfg.remat,
                                     band_dontcare=cfg.band_dontcare)

    def train_step(self, images, labels):
        """images (B, H, W, 1) float32, labels (B, H, W) int."""
        loss = self._step(torch.as_tensor(images).to(self.device),
                          torch.as_tensor(labels).to(self.device))
        return float(loss)

    # -- device-resident-corpus path ---------------------------------------
    def attach_dataset(self, images_u8, labels_u8, warp_amplitude=0.0,
                       seed=0):
        """Upload the whole (N, H, W) uint8 corpus to the card once;
        train_on_indices then sends only indices."""
        self._data = (
            torch.as_tensor(np.asarray(images_u8, np.uint8)).to(self.device),
            torch.as_tensor(np.asarray(labels_u8, np.uint8)).to(self.device))
        self._data_step = make_dataset_train_step(
            self.model, self.optimizer, self.class_weights,
            warp_amplitude=warp_amplitude, remat=self.cfg.remat,
            band_dontcare=self.cfg.band_dontcare)
        self._data_gen = torch.Generator().manual_seed(seed)

    def train_on_indices(self, idx):
        """One step on corpus rows `idx`. Returns the loss as a DEVICE
        tensor: convert it (float()) only when logging."""
        idx = torch.as_tensor(np.asarray(idx, np.int64)).to(self.device)
        return self._data_step(*self._data, idx, self._data_gen)

    def save(self, path, meta):
        from origami_tpu_torch.models import registry
        registry.save_model(path, meta, self.model)
