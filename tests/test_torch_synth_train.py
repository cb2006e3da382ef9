"""The port's recognizer half of train/bootstrap.py against the JAX
package: train_recognizer_synth's pool (its strips, widths and labels as
the trainer receives them, bucketed) equal to what JAX's function
attaches to its trainer, live; the first loss within 1e-3 relative of
JAX's (ROADMAP C12's bar) from JAX's initial weights, both in float32
with a small recognizer (conv (8, 16, 16), LSTM 16); eval_recognizer on
the CPU in float32: every text equal, line for line, to the JAX
predictor's in float32 at n = 32. JAX's first loss, its initial weights
and its n = 32 texts are in tests/data/torch_synth (written by
scripts/make_torch_synth_fixture.py): building the JAX trainer or
predictor takes 20-35 s of compiles on a CPU. Then the bootstrap CLI's
device rule and its gen phase.
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke
import origami_tpu.train.ocr.train as jax_ocr
from origami_tpu.train import bootstrap as jax_boot
from origami_tpu_torch.models import registry
from origami_tpu_torch.train import bootstrap
from origami_tpu_torch.train.ocr import train as port_ocr
from torch_train_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

BAR = 1e-3


class _Capture:
    """Stands in for JAX's RecognizerTrainer: keeps the pool it is given
    and trains nothing."""
    buckets = None

    def __init__(self, cfg, mesh=None, seed=0):
        pass

    def attach_pool(self, buckets):
        _Capture.buckets = buckets

    def train_on_bucket(self, bucket, sel):
        return 0.0

    def save(self, out_dir, charset):
        pass


def _jax_init():
    """JAX's initial weights of the fixture's recognizer as a flax tree."""
    tree = {}
    with np.load(chip_smoke.SYNTH_REF / "rec_init.npz") as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


def test_pool_and_first_loss_match_jax(monkeypatch, tmp_path):
    ref = chip_smoke.synth_ref()["train"]
    train = {k: (tuple(v) if isinstance(v, list) else v)
             for k, v in ref.items() if k != "loss"}
    monkeypatch.setattr(jax_ocr, "RecognizerTrainer", _Capture)
    jax_boot.train_recognizer_synth(tmp_path / "jax", **train)
    init = registry.params_from_flax(_jax_init())
    seen = {}

    class Trainer(port_ocr.RecognizerTrainer):
        """The port's trainer from JAX's initial weights."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.model.load_state_dict(init)

        def attach_pool(self, buckets):
            seen["buckets"] = buckets
            return super().attach_pool(buckets)

    monkeypatch.setattr(port_ocr, "RecognizerTrainer", Trainer)
    got = bootstrap.train_recognizer_synth(
        tmp_path / "port", device="cpu", dtype=torch.float32, **train)

    jb, pb = _Capture.buckets, seen["buckets"]
    assert sorted(jb) == sorted(pb)
    assert sum(len(v[0]) for v in pb.values()) == train["n_pool"]
    for b in jb:
        for a, c in zip(pb[b], jb[b]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(c))
    assert abs(got - ref["loss"]) <= BAR * abs(ref["loss"]), \
        (got, ref["loss"])


def test_eval_recognizer_float32_equals_jax():
    ref = chip_smoke.synth_ref()["eval32"]
    n = len(ref["truths"])
    truths, preds, _ = bootstrap.recognizer_predictions(
        chip_smoke.ROOT / "models_pretrained" / "recognizer", n=n,
        device="cpu", dtype=torch.float32)
    assert truths == ref["truths"]
    assert preds == ref["preds"]
    got = bootstrap.eval_recognizer(
        chip_smoke.ROOT / "models_pretrained" / "recognizer", n=4,
        device="cpu", dtype=torch.float32)
    assert set(got) == {"cer", "cer_median", "n", "conf"} and got["n"] == 4


def test_bootstrap_cli_needs_a_card_and_writes_the_corpus(tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bootstrap.main(["--work", str(tmp_path / "w")])
    bootstrap.main(["--work", str(tmp_path / "w"), "--phases", "gen",
                    "--train-pages", "1", "--val-pages", "1",
                    "--device", "cpu"])
    for part in ("train", "val"):
        d = tmp_path / "w" / part
        assert sorted(p.name for p in d.iterdir()) == [
            "synth0000.gt.json", "synth0000.labels.region.png",
            "synth0000.labels.separator.png", "synth0000.png"]
    gt = json.loads((tmp_path / "w" / "val" / "synth0000.gt.json")
                    .read_text())
    assert gt["size"] == [1312, 1920] and gt["lines"]
    assert json.loads((tmp_path / "w" / "report.json").read_text()) == {}
