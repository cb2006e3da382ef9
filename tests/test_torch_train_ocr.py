"""The port's RecognizerTrainer (origami_tpu_torch/train/ocr/train.py)
against the JAX trainer: float32 weights carried across
(registry.params_from_flax), the same strip pool with rows of several
widths (so MaskedGroupNorm and the sequence-length LSTM see padding)
and labels of several lengths; 3 steps of train_on_bucket, then 2 of the
host-batch train_step. Losses within 1e-4 relative, every leaf within
1e-4 relative (L2 norm of its difference over its own). A recognizer
with conv (8, 16, 16), LSTM 16, height 48.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import origami_tpu.train.ocr.train as jax_ocr
from origami_tpu.models import recognizer as jrec
from origami_tpu_torch.models import registry
from origami_tpu_torch.train.ocr import train as port_ocr
from torch_train_helpers import REC, leaf_errors, one_device_mesh, to_numpy
from torch_train_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

BAR = 1e-4
CHARSET = "abcdefg"
TEXTS = ["abc", "gfed", "a", "bbca", "dd", "efgab"]
WIDTHS = np.array([128, 100, 77, 128, 64, 90], np.float32)
BUCKET = 128


@pytest.fixture
def pair(monkeypatch):
    monkeypatch.setattr(jax_ocr.rec_lib, "create_recognizer",
                        functools.partial(jrec.create_recognizer,
                                          dtype=jnp.float32))
    cfg = jax_ocr.OCRTrainConfig(num_symbols=len(CHARSET), steps=10,
                                 warmup=2, **REC)
    jt = jax_ocr.RecognizerTrainer(cfg, mesh=one_device_mesh(), seed=0)
    pt = port_ocr.RecognizerTrainer(port_ocr.OCRTrainConfig(**cfg.__dict__),
                                    device="cpu", dtype=torch.float32)
    pt.model.load_state_dict(registry.params_from_flax(to_numpy(jt.params)))
    return jt, pt


def _pool(seed=0):
    rng = np.random.default_rng(seed)
    strips = (rng.random((len(TEXTS), REC["height"], BUCKET)) * 255) \
        .astype(np.uint8)
    for i, w in enumerate(WIDTHS):
        strips[i, :, int(w):] = 255
    labels, pad = jax_ocr.encode_labels(TEXTS, CHARSET, max_len=6)
    return strips, labels, pad


def _check(jt, pt, lj, lp, what):
    assert abs(lp - lj) <= BAR * abs(lj), (what, lj, lp)
    errs = leaf_errors(to_numpy(jt.params), registry.flax_params(pt.model))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= BAR, (what, worst, errs[worst])


def test_pool_and_host_steps_match_jax(pair):
    """3 steps of train_on_bucket, then 2 of the host-batch train_step."""
    jt, pt = pair
    strips, labels, pad = _pool()
    pool = {BUCKET: (strips, WIDTHS, labels, pad)}
    jt.attach_pool(pool)
    pt.attach_pool(pool)
    for step in range(3):
        idx = [(step + k) % len(TEXTS) for k in range(4)]
        lj = float(jt.train_on_bucket(BUCKET, idx))
        lp = pt.train_on_bucket(BUCKET, idx)
        assert isinstance(lp, torch.Tensor)
        _check(jt, pt, lj, float(lp), step)
    strips, labels, pad = _pool(seed=1)
    x = (1.0 - strips / 255.0).astype(np.float32)[..., None]
    for step in range(2):
        _check(jt, pt, jt.train_step(x, WIDTHS, labels, pad),
               pt.train_step(x, WIDTHS, labels, pad), "host %d" % step)


def test_encode_labels_equals_jax():
    texts = ["abc", "", "zzz?", "gfedcba"]
    for max_len in (None, 3, 9):
        want = jax_ocr.encode_labels(texts, CHARSET, max_len)
        got = port_ocr.encode_labels(texts, CHARSET, max_len)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


def test_lstm_input_bias_stays_zero():
    """flax's cell has one bias a gate: torch's input bias is frozen at
    0, so the saved tree's bias is the trained one."""
    cfg = port_ocr.OCRTrainConfig(num_symbols=len(CHARSET), steps=10,
                                  warmup=2, **REC)
    pt = port_ocr.RecognizerTrainer(cfg, device="cpu", dtype=torch.float32)
    strips, labels, pad = _pool()
    pt.attach_pool({BUCKET: (strips, WIDTHS, labels, pad)})
    for _ in range(3):
        pt.train_on_bucket(BUCKET, [0, 1, 2])
    lstm = pt.model.lstm
    assert float(lstm.bias_ih_l0.detach().abs().max()) == 0.0
    assert float(lstm.bias_hh_l0.detach().abs().max()) > 0.0
