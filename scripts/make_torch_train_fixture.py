#!/usr/bin/env python3
"""Build tests/data/torch_train: the JAX trainers' numbers at full width,
which chip_smoke.py phase 14b holds the port's trainers to on the card.

    JAX_PLATFORMS=cpu python scripts/make_torch_train_fixture.py \
        [--only segment_region,segment_separator,distill_region,recognizer]

For each entry of chip_smoke.PARITY_RUNS it runs the JAX trainer
(origami_tpu/train/...) in float32 on one CPU device for 3 steps from
the shipped weights (float16 packs upcast to float32), warp off, on
chip_smoke.train_corpus (the fixture pages and the two real scans with
the JAX f32 auto label maps), and writes `<name>.json`: the run's
settings, the loss of each step and every parameter leaf's L2 norm
after each step. No weights are written. The U-Nets take one page a
step (chip_smoke.PARITY_PAGES); the distiller's student is the
teacher's weights plus chip_smoke.noisy_tree's seeded noise; the
recognizer takes 8 of the 16 strips of chip_smoke.parity_pool a step
(the OCR path's strips, extracted here by the port on the CPU, whose
plain strip extraction equals the card's kernel bit for bit: phase 2).
The full-width U-Nets take some minutes a run and several GB here.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from origami_tpu.models import recognizer as jrec  # noqa: E402
from origami_tpu.models import registry as jax_registry  # noqa: E402
from origami_tpu.models import unet as junet  # noqa: E402
from origami_tpu.parallel.mesh import make_mesh  # noqa: E402
from origami_tpu.train import bootstrap as jax_boot  # noqa: E402
from origami_tpu.train.ocr import train as jax_ocr  # noqa: E402
from origami_tpu.train.segment import data as jax_data  # noqa: E402
from origami_tpu.train.segment import distill as jax_distill  # noqa: E402
from origami_tpu.train.segment import train as jax_train  # noqa: E402

OUT = ROOT / "tests" / "data" / "torch_train"
TILE_HW = (cs.TRAIN_FULL[1], cs.TRAIN_FULL[0])


def _numpy(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _reset(trainer, params):
    """Start `trainer` from `params`: fresh optimizer state (zero
    moments, step count 0), as a new trainer's."""
    with trainer.mesh:
        trainer.params = jax.device_put(jax.tree.map(jnp.asarray, params))
        trainer.opt_state = trainer.optimizer.init(trainer.params)


def run_unet(name, corpus, mesh):
    run = cs.PARITY_RUNS[name]
    _, params, meta = jax_registry.load_model(ROOT / run["start"])
    params = _numpy(params)
    images, labels, names = jax_boot.load_corpus_arrays(
        corpus, run["kind"], cs.TRAIN_FULL)
    f32 = functools.partial(junet.create_unet, dtype=jnp.float32)
    info = dict(pages=names, start=run["start"])
    if run["trainer"] == "segment":
        jax_train.unet_lib.create_unet = f32
        cw = jax_data.class_weights(list(labels), 4)
        cfg = jax_train.TrainConfig(
            num_classes=4, width=meta["width"], s2d=meta["s2d"],
            tile_hw=TILE_HW, learning_rate=run["learning_rate"],
            steps=cs.PARITY_STEPS, warmup=cs.PARITY_WARMUP,
            class_weights=cw, band_dontcare=run["band"])
        tr = jax_train.SegmentationTrainer(cfg, mesh=mesh, seed=0)
        _reset(tr, params)
        tr.attach_dataset(images, labels)
        step, info["class_weights"] = tr.train_on_indices, cw.tolist()
    else:
        jax_distill.unet_lib.create_unet = f32
        teacher = f32(4, width=meta["width"], s2d=meta["s2d"])
        stack = jax.tree.map(lambda a: jnp.asarray(a)[None], params)
        cfg = jax_distill.DistillConfig(
            num_classes=4, width=meta["width"], s2d=meta["s2d"],
            tile_hw=TILE_HW, learning_rate=run["learning_rate"],
            steps=cs.PARITY_STEPS, warmup=cs.PARITY_WARMUP)
        tr = jax_distill.Distiller(cfg, teacher, stack, mesh=mesh, seed=0)
        _reset(tr, cs.noisy_tree(params))
        tr.attach_dataset(images, labels)
        step, info["noise"] = tr.distill_on_indices, cs.PARITY_NOISE
    losses, norms = [], []
    for idx in cs.PARITY_PAGES:
        losses.append(float(step(np.asarray(idx))))
        norms.append(cs.leaf_norms(_numpy(tr.params)))
        print("  %s step %d loss %.6f" % (name, len(losses) - 1,
                                          losses[-1]), flush=True)
    info["indices"] = [list(i) for i in cs.PARITY_PAGES]
    return losses, norms, info


def run_recognizer(name, mesh):
    run = cs.PARITY_RUNS[name]
    _, params, meta = jax_registry.load_model(ROOT / run["start"])
    jax_ocr.rec_lib.create_recognizer = functools.partial(
        jrec.create_recognizer, dtype=jnp.float32)
    cfg = jax_ocr.OCRTrainConfig(
        num_symbols=len(meta["charset"]), height=meta["height"],
        learning_rate=run["learning_rate"], steps=cs.PARITY_STEPS,
        warmup=cs.PARITY_STEPS, conv_features=tuple(meta["conv_features"]),
        lstm_features=meta["lstm_features"])
    tr = jax_ocr.RecognizerTrainer(cfg, mesh=mesh, seed=0)
    _reset(tr, _numpy(params))
    bucket, pool, keys = cs.parity_pool("cpu", meta["charset"])
    tr.attach_pool({bucket: pool})
    losses, norms = [], []
    for idx in cs.PARITY_STRIPS:
        losses.append(float(tr.train_on_bucket(bucket, np.asarray(idx))))
        norms.append(cs.leaf_norms(_numpy(tr.params)))
        print("  %s step %d loss %.6f" % (name, len(losses) - 1,
                                          losses[-1]), flush=True)
    return losses, norms, dict(start=run["start"], bucket=bucket,
                               strips=[list(k) for k in keys],
                               widths=pool[1].tolist(),
                               indices=[list(i) for i in cs.PARITY_STRIPS])


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--only", default=",".join(cs.PARITY_RUNS))
    args = p.parse_args()
    OUT.mkdir(parents=True, exist_ok=True)
    mesh = make_mesh(devices=jax.devices()[:1])
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        corpus = cs.train_corpus(Path(tmp) / "corpus")
        for name in args.only.split(","):
            t0 = time.time()
            if cs.PARITY_RUNS[name]["trainer"] == "recognizer":
                losses, norms, info = run_recognizer(name, mesh)
            else:
                losses, norms, info = run_unet(name, corpus, mesh)
            run = dict(cs.PARITY_RUNS[name])
            if run.get("band") is not None:
                run["band"] = list(run["band"])
            doc = dict(name=name, run=run, steps=cs.PARITY_STEPS,
                       warmup=(cs.PARITY_STEPS
                               if run["trainer"] == "recognizer"
                               else cs.PARITY_WARMUP),
                       dtype="float32", jax=jax.__version__,
                       losses=losses, leaf_norms=norms, **info)
            (OUT / (name + ".json")).write_text(json.dumps(doc, indent=1))
            print("%s: %.1f s, losses %s" % (name, time.time() - t0, losses),
                  flush=True)


if __name__ == "__main__":
    main()
