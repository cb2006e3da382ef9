"""Training CLI: GT tile generation + U-Net training on the card.

Port of origami_tpu/train/segment/main.py on argparse:

    python -m origami_tpu_torch.train.segment.main gen CORPUS -o TILES \
        [--kind region|separator] [--augmentations 2] [--device cpu]
    python -m origami_tpu_torch.train.segment.main train TILES -o OUT \
        [--kind region|separator] [--steps 2000] [--device cpu]

`gen` cuts each page of CORPUS (images with <stem>.labels.<kind>.png)
into tiles, warping extra variants on the device; `train` trains a U-Net
on the tiles (their batches read from disk each step, as the JAX
command does) over a data-parallel mesh of every visible card and writes
a model directory that the segment stage of either package loads. Both
run on cuda unless --device cpu (`train` then on a one-device CPU mesh).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def gen(args):
    from origami_tpu_torch.train.segment.data import TileDataset
    from origami_tpu_torch.train.segment.labels import (
        DEFAULT_BBZ_SPEC, LabelSet)
    label_set = LabelSet(args.labels_spec or DEFAULT_BBZ_SPEC)
    ds = TileDataset(args.corpus, label_set, args.kind,
                     full_size=(args.full_width, args.full_height),
                     tile_size=(args.tile_width, args.tile_height),
                     augmentations=args.augmentations, device=args.device)
    names = ds.generate(args.output)
    print("wrote %d tiles to %s" % (len(names), args.output))


def train_mesh(device):
    """The training mesh: every visible card for "cuda" (the JAX command
    trains over every local device), the one device named otherwise."""
    from origami_tpu_torch.parallel.mesh import make_mesh
    return make_mesh() if device == "cuda" else make_mesh([device])


def train(args):
    from origami_tpu_torch.core import _image
    from origami_tpu_torch.train.segment.data import load_tile_batch
    from origami_tpu_torch.train.segment.train import (SegmentationTrainer,
                                                       TrainConfig)

    tiles_dir = Path(args.tiles_dir)
    codes = json.loads((tiles_dir / "codes.json").read_text())
    folds = json.loads((tiles_dir / "folds.json").read_text())["folds"]
    valid_pages = set(folds[args.fold % len(folds)])

    all_names = sorted(p.stem for p in tiles_dir.glob("*.png")
                       if not p.name.endswith(".labels.png"))
    train_names = [n for n in all_names
                   if n.split(".")[0] not in valid_pages]
    if not train_names:
        raise SystemExit("no training tiles found")

    # the tile size of the first tile
    probe = _image.read_gray(tiles_dir / (train_names[0] + ".png"))
    tile_hw = probe.shape[:2]

    # per-kind production defaults
    s2d = args.s2d if args.s2d is not None \
        else (4 if args.kind == "region" else 2)
    width = args.width if args.width is not None \
        else (2.0 if args.kind == "region" else 1.0)
    cfg = TrainConfig(num_classes=len(codes), width=width, s2d=s2d,
                      tile_hw=tile_hw, learning_rate=args.learning_rate,
                      steps=args.steps)
    trainer = SegmentationTrainer(cfg, mesh=train_mesh(args.device),
                                  seed=args.seed)

    rng = np.random.default_rng(args.seed)
    for step in range(args.steps):
        batch_names = [train_names[i] for i in rng.integers(
            0, len(train_names), args.batch_size)]
        images, labels = load_tile_batch(tiles_dir, batch_names, tile_hw)
        loss = trainer.train_step(images, labels)
        if step % 50 == 0:
            print("step %d loss %.4f" % (step, loss), flush=True)

    meta = dict(
        kind="unet", type=args.kind, classes=sorted(codes, key=codes.get),
        background="BACKGROUND", full_size=[probe.shape[1],
                                            probe.shape[0] * 2],
        tile_size=[probe.shape[1], probe.shape[0]], tile_beta=50,
        width=width, s2d=s2d, channels=1, version=1)
    trainer.save(args.output, meta)
    print("saved model to %s" % args.output)


def parser():
    p = argparse.ArgumentParser(
        prog="python -m origami_tpu_torch.train.segment.main",
        description="Segmentation training pipeline.")
    sub = p.add_subparsers(dest="command", required=True)

    g = sub.add_parser("gen", help="Generate training tiles from CORPUS "
                                   "(images + label PNGs).")
    g.add_argument("corpus", type=str)
    g.add_argument("-o", "--output", type=str, required=True)
    g.add_argument("--kind", choices=["region", "separator"],
                   default="region")
    g.add_argument("--labels-spec", type=str, default=None,
                   help="LabelSet JSON (defaults to the BBZ contract)")
    g.add_argument("--full-width", type=int, default=1280)
    g.add_argument("--full-height", type=int, default=2400)
    g.add_argument("--tile-width", type=int, default=1280)
    g.add_argument("--tile-height", type=int, default=896)
    g.add_argument("--augmentations", type=int, default=2,
                   help="variants per page (1 = no warp augmentation)")
    g.set_defaults(func=gen)

    t = sub.add_parser("train", help="Train a segmentation U-Net on "
                                     "generated tiles.")
    t.add_argument("tiles_dir", type=str)
    t.add_argument("-o", "--output", type=str, required=True,
                   help="model directory to write")
    t.add_argument("--kind", choices=["region", "separator"],
                   default="region")
    t.add_argument("--steps", type=int, default=2000)
    t.add_argument("--batch-size", type=int, default=8)
    t.add_argument("--width", type=float, default=None,
                   help="feature width multiplier (defaults per kind)")
    t.add_argument("--s2d", type=int, default=None,
                   help="space-to-depth stem factor (defaults per kind)")
    t.add_argument("--learning-rate", type=float, default=3e-4)
    t.add_argument("--fold", type=int, default=0,
                   help="validation fold to hold out")
    t.add_argument("--seed", type=int, default=0)
    t.set_defaults(func=train)
    for s in (g, t):
        s.add_argument("--device", type=str, default="cuda",
                       help="torch device: cuda (default) or cpu")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    for name in ("corpus", "tiles_dir"):
        path = getattr(args, name, None)
        if path is not None and not Path(path).exists():
            raise SystemExit("no such path: %s" % path)
    args.func(args)


if __name__ == "__main__":
    main()
