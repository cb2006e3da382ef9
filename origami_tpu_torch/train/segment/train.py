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

The trainer runs on a (data x model) mesh as the JAX trainer does
(train/mesh.py): parameters split by parallel/sharding.py's rules, the
batch cut over the data axis. The loss is the weighted mean over the
whole batch: its denominator depends on the labels alone, so it is
summed over every block before any forward, and each block
back-propagates its weighted sum over that global denominator. Without
a mesh the trainer is the one-device case.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from origami_tpu_torch.models import unet as unet_lib
from origami_tpu_torch.ops.remap import _div
from origami_tpu_torch.train.mesh import MeshModel, mesh_or_device, upload


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


def loss_weights(labels, class_weights, band_dontcare=None):
    """Each pixel's loss weight: its class weight, times `factor` for
    background pixels within `radius` of any foreground GT pixel where
    band_dontcare=(background_idx, radius, factor) (a max pool of the
    foreground, as lax.reduce_window "SAME"); GT foreground keeps full
    weight. labels (B, H, W) long -> (B, H, W) float32."""
    w = class_weights[labels]
    if band_dontcare is not None:
        bg, radius, factor = band_dontcare
        fg = (labels != bg).float()[:, None]
        k = 2 * int(radius) + 1
        band = F.max_pool2d(fg, k, stride=1, padding=int(radius))[:, 0]
        w = w * torch.where((band > 0) & (labels == bg), float(factor),
                            1.0)
    return w


def weighted_ce_sum(logits, labels, weights):
    """sum(cross entropy x weight) in float64. logits (B, H, W, K),
    labels (B, H, W) long."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    per_px = -torch.gather(logp, -1, labels[..., None])[..., 0]
    return torch.sum(per_px * weights, dtype=torch.float64)


def weighted_ce_loss(logits, labels, class_weights, band_dontcare=None):
    """Mean class-weighted cross entropy. logits (B, H, W, K), labels
    (B, H, W) int. Both sums in float64: the quotient is then the
    float32 rounding of the exact one, which JAX's float32 sums stay
    within a few ulp of."""
    labels = labels.long()
    w = loss_weights(labels, class_weights, band_dontcare)
    den = torch.clamp(torch.sum(w, dtype=torch.float64), min=1e-6)
    return (weighted_ce_sum(logits, labels, w) / den).float()


def _forward(model, remat):
    if remat:
        return lambda x: checkpoint(model, x, use_reentrant=False)
    return model


class SegmentationTrainer:
    """Owns the U-Net on its mesh, the optimizer and the step.
    `dtype` is the convolutions' (bf16, as the JAX trainer's U-Net;
    float32 for parity runs); parameters are float32. `mesh`
    (parallel.mesh.make_mesh) or `device`, not both: no mesh is a
    one-device mesh on `device`. `model` is the first device's replica
    (its split leaves are empty at rest; `state_dict()` gathers)."""

    def __init__(self, cfg, mesh=None, seed=0, device=None,
                 dtype=torch.bfloat16):
        self.cfg = cfg
        self.mesh = mesh_or_device(mesh, device)
        self.device = self.mesh.devices[0]
        model = unet_lib.create_unet(cfg.num_classes, width=cfg.width,
                                     s2d=cfg.s2d, dtype=dtype)
        unet_lib.init_unet(model, torch.Generator().manual_seed(seed))
        self.net = MeshModel(self.mesh, model,
                             lambda ps: make_optimizer(cfg, ps))
        self.model = self.net.replicas[0]
        self.optimizer = self.net.optimizers[0]
        cw = cfg.class_weights if cfg.class_weights is not None \
            else np.ones((cfg.num_classes,))
        self._cw = {d: w for d, [w] in upload(
            self.mesh, [np.asarray(cw, np.float32)]).items()}
        self._apply = [_forward(r, cfg.remat) for r in self.net.replicas]

    def state_dict(self):
        return self.net.state_dict()

    def load_state_dict(self, sd):
        self.net.load_state_dict(sd)

    def _step(self, parts, blocks):
        """One update over the blocks `parts` of the net's `blocks`;
        blocks: {device index: (x (b, H, W, 1) float, labels (b, H, W)
        long)} on their devices. The loss is the weighted mean over every
        block's pixels: the weights' sum is taken over all blocks before
        any forward."""
        devices = self.mesh.devices
        weights = {k: loss_weights(lab, self._cw[devices[k]],
                                   self.cfg.band_dontcare)
                   for k, (_, lab) in blocks.items()}
        den = torch.clamp(sum(torch.sum(w, dtype=torch.float64)
                              .to(self.device) for w in weights.values()),
                          min=1e-6)

        def run_block(k, replica, rows):
            x, lab = blocks[k]
            num = weighted_ce_sum(self._apply[k](x), lab, weights[k])
            (num / den.to(num.device)).float().backward()
            return num.detach()

        return (self.net.step(parts, run_block) / den).float()

    def train_step(self, images, labels):
        """images (B, H, W, 1) float32, labels (B, H, W) int."""
        images = torch.as_tensor(images)
        parts = self.net.blocks(len(images))
        blocks = self.net.scatter(parts,
                                  (images, torch.as_tensor(labels).long()))
        return float(self._step(parts, blocks))

    # -- device-resident-corpus path ---------------------------------------
    def attach_dataset(self, images_u8, labels_u8, warp_amplitude=0.0,
                       seed=0):
        """Upload the whole (N, H, W) uint8 corpus once to each device of
        the mesh; train_on_indices then sends only indices."""
        self._data = upload(self.mesh, [np.asarray(images_u8, np.uint8),
                                        np.asarray(labels_u8, np.uint8)])
        self._warp = warp_amplitude
        self._data_gen = torch.Generator().manual_seed(seed)

    def train_on_indices(self, idx):
        """One step on corpus rows `idx`: each block gathers its rows on
        its device and, with the warp on, warps them there (one
        remap_batch launch a block) through fields drawn for the whole
        batch from the trainer's one generator, so a mesh run takes the
        one-device run's fields. Returns the loss as a DEVICE tensor:
        convert it (float()) only when logging."""
        from origami_tpu_torch.train.segment.warp import (
            displacement_field, random_coarse, warp_batch)
        idx = torch.as_tensor(np.asarray(idx, np.int64))
        n = len(idx)
        coarse = None
        if self._warp > 0:
            # per-sample amplitude in [0, A): every page is warped a
            # random amount
            amps = torch.rand((n,), generator=self._data_gen) * self._warp
            coarse = random_coarse(self._data_gen, n, amps)
        devices = self.mesh.devices
        parts = self.net.blocks(n)
        blocks = {}
        for k, rows in parts:
            images_u8, labels_u8 = self._data[devices[k]]
            sel = idx[rows].to(devices[k])
            imgs = images_u8[sel].float()
            labs = labels_u8[sel].long()
            if coarse is not None:
                fields = displacement_field(coarse[rows].to(devices[k]),
                                            imgs.shape[1:])
                imgs, labs = warp_batch(imgs, labs, fields)
            blocks[k] = (_div(imgs, 255.0)[..., None], labs)
        return self._step(parts, blocks)

    def save(self, path, meta):
        """The model directory of the whole parameters (a one-device
        trainer's bytes for the same parameters)."""
        from origami_tpu_torch.models import registry
        registry.save_model(path, meta, registry.flax_params(
            self.model, self.state_dict()))
