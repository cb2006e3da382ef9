"""The serving half of the JAX package's multi-device dry run
(__graft_entry__.dryrun_multichip, its inference chain): page-batch
sharded segmentation through the ensemble graph's mesh branch, then a
recognizer forward with the strip batch sharded over the data axis and
the parameters replicated. Tiny shapes.

The training half (a U-Net and a CTC step with the batch over "data" and
the parameters over "model") comes with the data-parallel trainers.
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
    from origami_tpu_torch.models import registry, unet
    for kind, classes in _CLASSES.items():
        meta = dict(kind="unet", type=kind, classes=classes,
                    background="BACKGROUND", full_size=list(_FULL_SIZE),
                    tile_size=list(_FULL_SIZE), tile_beta=50, width=0.125,
                    channels=1, s2d=2, version=1)
        model = unet.init_unet(
            registry.build_unet(meta), torch.Generator().manual_seed(0))
        registry.save_model(Path(root) / kind / "1", meta, model)


@torch.no_grad()
def dryrun_multichip(n_devices, device=None):
    """Sharded inference on an n-device mesh: the first n cards, or n
    "cpu" entries with device="cpu". Raises where a check fails."""
    from origami_tpu_torch.core.predict import SegmentationPredictor
    from origami_tpu_torch.models.recognizer import (LineRecognizer,
                                                     init_recognizer)
    from origami_tpu_torch.parallel.mesh import (make_mesh, replicate,
                                                 shard_batch)
    if device is not None and torch.device(device).type == "cpu":
        devices = ["cpu"] * n_devices
    else:
        if n_devices > torch.cuda.device_count():
            raise RuntimeError("%d devices asked, %d cards visible" % (
                n_devices, torch.cuda.device_count()))
        devices = ["cuda:%d" % i for i in range(n_devices)]
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

