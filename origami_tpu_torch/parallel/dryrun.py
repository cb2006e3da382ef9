"""The JAX package's multi-device dry run
(__graft_entry__.dryrun_multichip): a U-Net training step on a data x
model mesh (the parameters split over "model", the batch over "data")
and a recognizer CTC step (the parameters replicated), then the serving
chain: page-batch sharded segmentation through the ensemble graph's mesh
branch and a recognizer forward with the strip batch sharded over the
data axis. Tiny shapes.
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import torch

# the JAX dry run's nets: default_segmentation_meta(kind,
# full_size=(64, 96), width=0.125, s2d=2) and a 12-symbol recognizer
_CLASSES = {"region": ["TEXT", "TABULAR", "ILLUSTRATION", "BACKGROUND"],
            "separator": ["H", "V", "T", "BACKGROUND"]}
_FULL_SIZE = (64, 96)


def _save_tiny_segmenters(root):
    from origami_tpu_torch.models import registry
    for kind, classes in _CLASSES.items():
        meta = dict(kind="unet", type=kind, classes=classes,
                    background="BACKGROUND", full_size=list(_FULL_SIZE),
                    tile_size=list(_FULL_SIZE), tile_beta=50, width=0.125,
                    channels=1, s2d=2, version=1)
        registry.init_and_save(Path(root) / kind / "1", meta)


def _train_steps(devices):
    """__graft_entry__.py:47-67: one U-Net step (width 0.25, 64 x 64
    tiles) on a data x model mesh, model_parallel 2 where the device
    count is even, and one recognizer step on the same mesh; both losses
    finite."""
    from origami_tpu_torch.parallel.mesh import make_mesh
    from origami_tpu_torch.train.ocr.train import (OCRTrainConfig,
                                                   RecognizerTrainer,
                                                   encode_labels)
    from origami_tpu_torch.train.segment.train import (SegmentationTrainer,
                                                       TrainConfig)
    n = len(devices)
    model_parallel = 2 if n % 2 == 0 and n >= 2 else 1
    mesh = make_mesh(devices, model_parallel=model_parallel)
    b = max(2, mesh.shape["data"])

    cfg = TrainConfig(num_classes=4, width=0.25, tile_hw=(64, 64),
                      steps=10, warmup=2, remat=True)
    trainer = SegmentationTrainer(cfg, mesh=mesh)
    images = np.random.default_rng(0).random((b, 64, 64, 1), np.float32)
    loss = trainer.train_step(images, np.zeros((b, 64, 64), np.int64))

    ocr_cfg = OCRTrainConfig(num_symbols=12, height=32, steps=10,
                             warmup=2, conv_features=(16, 32, 48),
                             lstm_features=48)
    rec = RecognizerTrainer(ocr_cfg, mesh=mesh)
    strips = np.random.default_rng(1).random((b, 32, 64, 1), np.float32)
    labels, pad = encode_labels(["ab"] * b, "abcdefghijkl")
    loss2 = rec.train_step(strips, np.full((b,), 64, np.float32), labels,
                           pad)
    if not (np.isfinite(loss) and np.isfinite(loss2)):
        raise RuntimeError("training on a %s mesh: losses %r, %r"
                           % (mesh.shape, loss, loss2))


def dryrun_multichip(n_devices, device=None):
    """The training steps, then sharded inference, on an n-device mesh:
    the first n cards, or n "cpu" entries with device="cpu". Raises
    where a check fails."""
    if device is not None and torch.device(device).type == "cpu":
        devices = ["cpu"] * n_devices
    else:
        if n_devices > torch.cuda.device_count():
            raise RuntimeError("%d devices asked, %d cards visible" % (
                n_devices, torch.cuda.device_count()))
        devices = ["cuda:%d" % i for i in range(n_devices)]
    _train_steps(devices)
    _serve(devices)


@torch.no_grad()
def _serve(devices):
    """The serving chain on a data axis over `devices`."""
    from origami_tpu_torch.core.predict import SegmentationPredictor
    from origami_tpu_torch.models.recognizer import (LineRecognizer,
                                                     init_recognizer)
    from origami_tpu_torch.parallel.mesh import (make_mesh, replicate,
                                                 shard_batch)
    n_devices = len(devices)
    mesh = make_mesh(devices)

    # the segmentation ensemble, the page batch over "data"
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        _save_tiny_segmenters(tmp)
        pred = SegmentationPredictor(tmp, target="speed", mesh=mesh)
    rng = np.random.default_rng(2)
    w, h = _FULL_SIZE
    pages = [rng.integers(0, 255, (h, w)).astype(np.uint8)
             for _ in range(n_devices + 1)]     # pads to 2 a device
    segs = pred.predict_batch(pages)
    if len(segs) != n_devices + 1 or {
            p.name for p in segs[0].predictions} \
            != {"regions", "separators"}:
        raise RuntimeError("sharded segmentation gave %d pages of %s" % (
            len(segs), [p.name for p in segs[0].predictions]))

    # the recognizer: strips over "data", the parameters replicated
    model = init_recognizer(
        LineRecognizer(12, conv_features=(16, 32, 48), lstm_features=48,
                       height=32),
        torch.Generator().manual_seed(0)).eval()
    n = 2 * n_devices
    strips = shard_batch(mesh, np.random.default_rng(3).random(
        (n, 32, 64, 1), np.float32))
    widths = shard_batch(mesh, np.full((n,), 64.0, np.float32))
    outs = [replica(x, widths=wb) for [replica], x, wb in zip(
        replicate(mesh, [model]), strips, widths)]
    logits = torch.cat([o[0].cpu() for o in outs])
    pad = torch.cat([o[1].cpu() for o in outs])
    if not torch.isfinite(logits).all() or pad.shape[0] != n:
        raise RuntimeError("sharded recognizer forward: finite %s, %d "
                           "rows of %d" % (bool(torch.isfinite(logits)
                                                .all()), pad.shape[0], n))

