#!/usr/bin/env python3
"""Build tests/data/torch_synth/synth.json: the JAX package's synthetic
corpus, recognizer evaluation and chain scores, which chip_smoke.py
phase 16 and tests/test_torch_synth_*.py hold the port to.

    JAX_PLATFORMS=cpu python scripts/make_torch_synth_fixture.py \
        [--only pages,lines,pool,eval,eval32,chain,train]

Writes, from the JAX functions run on the CPU through chip_smoke's
helpers given the JAX modules (jax_modules):

    pages    sha256 digests of render_page's image, label maps and
             gt.json document for chip_smoke.SYNTH_PAGES (70000 and
             70001 are write_corpus(seed=7)'s pages, the OCR fixture's
             page images; 55_000_000 with n_columns=2, test_quality's
             pages; 123 with degrade=False)
    lines    digests of render_line(seed) (strip and text) for
             chip_smoke.SYNTH_LINE_SEEDS
    pool     the digest of page_line_pool(n_pages=SYNTH_POOL_PAGES)
    eval     eval_recognizer's lines through the JAX RecognizerPredictor
             (greedy; bf16 convolutions, the model's numeric mode):
             true and predicted texts and the CER, for
             models_pretrained/recognizer and the 2-model sequence vote
             with recognizer2, n = chip_smoke.EVAL_N
    eval32   the same for models_pretrained/recognizer with float32
             convolutions, n = EVAL32_N (tests/test_torch_synth_train.py)
    chain    chip_smoke.chain_scores of the JAX chain's lines.3.zip and
             dewarp.zip of the OCR fixture's pages
             (tests/data/torch_ocr/full) against their gt.json documents
    train    the first loss of JAX's train_recognizer_synth at TRAIN (a
             recognizer with conv (8, 16, 16), LSTM 16, in float32), and
             in rec_init.npz its initial weights ("/"-joined flax paths)

About 3 minutes on a CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("ORIGAMI_TPU_PLATFORM", "cpu")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from origami_tpu_torch.train.synth import page_gt_json  # noqa: E402

OUT = cs.SYNTH_REF / "synth.json"
PARTS = ("pages", "lines", "pool", "eval", "eval32", "chain", "train")
EVAL32_N = 32
# tests/test_torch_synth_train.py's train_recognizer_synth arguments
TRAIN = dict(steps=1, batch=8, height=48, seed=0, conv_features=(8, 16, 16),
             lstm_features=16, n_pool=24)


def jax_modules():
    """The JAX package's modules under chip_smoke.synth_modules' names."""
    from origami_tpu.batch.utils import evaluate
    from origami_tpu.core.dewarp import Grid
    from origami_tpu.train import synth
    return dict(synth=synth, evaluate=evaluate, Grid=Grid)


def jax_predictions(names, n, f32=False):
    """eval_recognizer's lines (render_line(123_456 + i)) through the JAX
    RecognizerPredictor -> (truths, preds, CER)."""
    from origami_tpu.batch.detect.ocr import RecognizerPredictor
    from origami_tpu.batch.utils.evaluate import cer
    from origami_tpu.models import registry
    from origami_tpu.train.synth import render_line
    orig = load = registry.load_model
    if f32:
        import jax.numpy as jnp

        def load(path):
            module, params, meta = orig(path)
            return module.clone(dtype=jnp.float32), params, meta
    registry.load_model = load
    try:
        pred = RecognizerPredictor(
            [ROOT / "models_pretrained" / name for name in names])
    finally:
        registry.load_model = orig
    strips, truths = [], []
    for i in range(n):
        s, t = render_line(123_456 + i, height=pred.line_height)
        strips.append((("val", str(i)), s))
        truths.append(t)
    preds, _ = pred.predict(strips)
    return dict(truths=truths, preds=list(preds),
                cer=float(np.mean([cer(a, b)
                                   for a, b in zip(truths, preds)])))


def jax_first_loss(out_dir):
    """(the first loss, the initial weights as {"/"-joined path: array})
    of JAX's train_recognizer_synth at TRAIN in float32."""
    import functools

    import jax
    import jax.numpy as jnp
    import origami_tpu.train.ocr.train as jax_ocr
    from origami_tpu.models import recognizer
    from origami_tpu.parallel.mesh import make_mesh
    from origami_tpu.train import bootstrap
    jax_ocr.rec_lib.create_recognizer = functools.partial(
        recognizer.create_recognizer, dtype=jnp.float32)
    seen = {}
    init = jax_ocr.RecognizerTrainer.__init__

    def capture(self, *a, **kw):
        init(self, *a, **kw)
        flat = jax.tree_util.tree_flatten_with_path(
            jax.device_get(self.params))[0]
        seen.update({"/".join(str(getattr(k, "key", k)) for k in path):
                     np.asarray(v) for path, v in flat})

    jax_ocr.RecognizerTrainer.__init__ = capture
    loss = bootstrap.train_recognizer_synth(
        out_dir, mesh=make_mesh(devices=jax.devices()[:1]), **TRAIN)
    return float(loss), seen


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=",".join(PARTS))
    args = ap.parse_args()
    parts = set(args.only.split(","))
    ref = json.loads(OUT.read_text()) if OUT.exists() else {}
    mods = jax_modules()
    synth = mods["synth"]
    if "pages" in parts:
        ref["pages"] = {str(seed): cs.synth_page_digests(synth, seed, **kw)
                        for seed, kw in cs.SYNTH_PAGES}
    if "lines" in parts:
        ref["lines"] = cs.synth_line_digests(synth)
    if "pool" in parts:
        ref["pool"] = cs.synth_pool_digest(synth)
    if "eval" in parts:
        ref["eval"] = {mode: jax_predictions(names, cs.EVAL_N)
                       for mode, names in cs.EVAL_MODELS.items()}
    if "eval32" in parts:
        ref["eval32"] = jax_predictions(("recognizer",), EVAL32_N, f32=True)
    if "chain" in parts:
        ref["chain"] = {}
        for stem, (seed, kw) in zip(("synth0000", "synth0001"),
                                    cs.SYNTH_PAGES):
            gt = json.loads(json.dumps(page_gt_json(
                synth.render_page(seed, **kw))))
            ref["chain"][stem] = cs.chain_scores(
                mods, cs.FIXTURE / (stem + ".out"), gt)
    if "train" in parts:
        import tempfile
        with tempfile.TemporaryDirectory() as tmp:
            loss, params = jax_first_loss(Path(tmp))
        ref["train"] = dict(loss=loss, **{k: list(v) if isinstance(v, tuple)
                                          else v for k, v in TRAIN.items()})
        np.savez_compressed(OUT.parent / "rec_init.npz", **params)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(ref, indent=1, sort_keys=True) + "\n")
    print("wrote %s (%d bytes)" % (OUT, OUT.stat().st_size))


if __name__ == "__main__":
    main()
