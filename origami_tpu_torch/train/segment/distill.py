"""Ensemble -> single-student distillation for segmentation nets.

Port of origami_tpu/train/segment/distill.py: the teacher is the mean
of its members' softmax at temperature T (members run one after another
under torch.no_grad, their probabilities summed in float32 in member
order, as the JAX scan sums them); the loss is KL(teacher || student)
at T times T^2, plus `hard_weight` times the masked cross entropy on
hard labels. AdamW on optax's warmup + cosine schedule with optax.adamw's
default decay 1e-4 (the JAX Distiller passes none).

On a mesh (train/mesh.py) the teachers are replicated on every device
and the student is split by parallel/sharding.py's rules. Both terms are
means over the whole batch: the KL term over every pixel, the hard term
over the masked pixels (their count summed over all blocks before any
forward), so each block back-propagates its sums over the global
counts.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np
import torch

from origami_tpu_torch.models import unet as unet_lib
from origami_tpu_torch.ops.remap import _div
from origami_tpu_torch.train.mesh import MeshModel, mesh_or_device, upload
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
    """Teacher = a list of U-Net members (same classes, any size), a copy
    on each device of the mesh; student = a fresh net of cfg's width and
    s2d. `mesh` or `device`, not both: no mesh is a one-device mesh on
    `device`. `student` is the first device's replica (its split leaves
    are empty at rest; `state_dict()` gathers)."""

    def __init__(self, cfg, teachers, mesh=None, seed=0, device=None,
                 dtype=torch.bfloat16):
        self.cfg = cfg
        self.mesh = mesh_or_device(mesh, device)
        self.device = self.mesh.devices[0]
        first = [t.to(self.device).eval() for t in teachers]
        self._teachers = {d: first if d == self.device
                          else [copy.deepcopy(t).to(d) for t in first]
                          for d in dict.fromkeys(self.mesh.devices)}
        self.teachers = first
        student = unet_lib.create_unet(cfg.num_classes, width=cfg.width,
                                       s2d=cfg.s2d, dtype=dtype)
        unet_lib.init_unet(student, torch.Generator().manual_seed(seed))
        sched = warmup_cosine_decay(cfg.learning_rate, cfg.warmup,
                                    max(cfg.steps, cfg.warmup + 1))
        self.net = MeshModel(self.mesh, student, lambda ps: ScheduledAdamW(
            ps, sched, weight_decay=1e-4))
        self.student = self.net.replicas[0]
        self.optimizer = self.net.optimizers[0]

    def state_dict(self):
        return self.net.state_dict()

    def load_state_dict(self, sd):
        self.net.load_state_dict(sd)

    @torch.no_grad()
    def teacher_probs(self, images, k=0):
        """Mean of the members' softmax(logits / T), float32, by the
        members on device k of the mesh (the images' device)."""
        t = self.cfg.temperature
        members = self._teachers[self.mesh.devices[k]]
        acc = None
        for m in members:
            logits = m(images).float()
            p = torch.softmax(_div(logits, t), dim=-1)
            acc = p if acc is None else acc + p
        return _div(acc, len(members))

    def loss_sums(self, k, student, images, labels, label_mask):
        """(sum over pixels of KL(teacher || student) at T, times T^2;
        sum of the hard cross entropy over the masked pixels) of device
        k's block."""
        t = self.cfg.temperature
        tprobs = self.teacher_probs(images, k)
        slogits = student(images).float()
        slogp = torch.log_softmax(_div(slogits, t), dim=-1)
        tlogp = torch.log(torch.clamp(tprobs, min=1e-9))
        # true KL(teacher || student): floor at 0 when matched
        kl = torch.sum(torch.sum(tprobs * (tlogp - slogp), dim=-1)) * t * t
        logp = torch.log_softmax(slogits, dim=-1)
        ce_px = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
        return kl, torch.sum(ce_px * label_mask)

    def _update(self, parts, blocks):
        """One update; blocks: {device index: (images, labels,
        label_mask)} on their devices, for the blocks `parts`."""
        n_px = sum(lab.numel() for _, lab, _ in blocks.values())
        n_mask = torch.clamp(sum(torch.sum(mask).to(self.device)
                                 for _, _, mask in blocks.values()), min=1.0)
        hard = self.cfg.hard_weight

        def run_block(k, replica, rows):
            kl, ce = self.loss_sums(k, replica, *blocks[k])
            share = kl / n_px + hard * ce / n_mask.to(ce.device)
            share.backward()
            return share.detach()

        return self.net.step(parts, run_block)

    # -- device-resident-corpus path ---------------------------------------
    def attach_dataset(self, images_u8, labels_u8, seed=0):
        """Upload the (N, H, W) uint8 corpus once to each device of the
        mesh; distill_on_indices sends only indices."""
        self._data = upload(self.mesh, [np.asarray(images_u8, np.uint8),
                                        np.asarray(labels_u8, np.uint8)])

    def distill_on_indices(self, idx):
        """One step on corpus rows `idx`; returns the loss as a device
        tensor (float() it only when logging)."""
        idx = torch.as_tensor(np.asarray(idx, np.int64))
        devices = self.mesh.devices
        parts = self.net.blocks(len(idx))
        blocks = {}
        for k, rows in parts:
            images_u8, labels_u8 = self._data[devices[k]]
            sel = idx[rows].to(devices[k])
            labels = labels_u8[sel].long()
            blocks[k] = (_div(images_u8[sel].float(), 255.0)[..., None],
                         labels, torch.ones(labels.shape,
                                            device=devices[k]))
        return self._update(parts, blocks)

    def train_step(self, images, labels=None, label_mask=None):
        images = torch.as_tensor(images)
        b, h, w = images.shape[:3]
        if labels is None:
            labels = torch.zeros((b, h, w), dtype=torch.long)
            label_mask = torch.zeros((b, h, w))
        elif label_mask is None:
            label_mask = torch.ones((b, h, w))
        parts = self.net.blocks(b)
        blocks = self.net.scatter(parts, (images, torch.as_tensor(labels),
                                          torch.as_tensor(label_mask).float()))
        return float(self._update(parts, blocks))

    def save(self, path, meta):
        from origami_tpu_torch.models import registry
        registry.save_model(path, meta, registry.flax_params(
            self.student, self.state_dict()))
