"""LineRecognizer (PyTorch) against the JAX LineRecognizer, and the CTC
greedy decoder against the JAX one.

A narrow recognizer (conv 8/16/32, LSTM 32) with random flax weights
(seeded), carried across with params_from_flax; both sides in float32,
four strips of different valid widths. Tolerances:
  * logits: |diff| <= 1e-3 on VALID frames only — flax's masked RNN and
    torch's packed cuDNN-style LSTM emit different values past t_len
    (both are masked out downstream); float32 sums in another order
    stay far below 1e-3;
  * pad masks, greedy ids and lengths: equal; confidences: 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from origami_tpu.models import ctc as jax_ctc
from origami_tpu.models import recognizer as jax_rec
from origami_tpu_torch.models import ctc, recognizer, registry

NUM_SYMBOLS = 20
WIDTHS = [256.0, 201.0, 97.0, 30.0]


@pytest.fixture(scope="module")
def narrow():
    model = jax_rec.create_recognizer(
        NUM_SYMBOLS, dtype=jnp.float32, conv_features=(8, 16, 32),
        lstm_features=32, lstm_dtype=jnp.float32)
    params = jax_rec.init_recognizer(model, jax.random.PRNGKey(3),
                                     height=48, width=256)
    tree = jax.tree.map(np.asarray, params)
    port = recognizer.LineRecognizer(
        NUM_SYMBOLS, conv_features=(8, 16, 32), lstm_features=32,
        dtype=torch.float32, lstm_dtype=torch.float32)
    port.load_state_dict(registry.params_from_flax(tree), strict=True)
    port.eval()
    rng = np.random.default_rng(11)
    x = rng.random((4, 48, 256, 1), dtype=np.float32)
    w = np.asarray(WIDTHS, np.float32)
    for i, wi in enumerate(WIDTHS):
        x[i, :, int(wi):] = 0.0            # padding is paper: 1 - 255/255
    jl, jp = model.apply({"params": params}, jnp.asarray(x),
                         widths=jnp.asarray(w))
    with torch.no_grad():
        tl, tp = port(torch.from_numpy(x), widths=torch.from_numpy(w))
    return (np.asarray(jl), np.asarray(jp), tl.numpy(), tp.numpy())


def test_logits_agree_on_valid_frames(narrow):
    jl, jp, tl, tp = narrow
    assert jl.shape == tl.shape
    valid = jp < 0.5
    assert valid.sum() > 0
    err = np.abs(jl - tl)[valid].max()
    assert err <= 1e-3, err


def test_pad_masks_equal(narrow):
    jl, jp, tl, tp = narrow
    np.testing.assert_array_equal(jp, tp)
    # t_len = clip(ceil(w / 4), 1, W')
    np.testing.assert_array_equal(
        (tp < 0.5).sum(1), np.clip(np.ceil(np.asarray(WIDTHS) / 4), 1, 64))


def test_greedy_decode_agrees(narrow):
    jl, jp, tl, tp = narrow
    jids, jlen, jconf = (np.asarray(a) for a in
                         jax_ctc.greedy_decode(jnp.asarray(jl),
                                               jnp.asarray(jp)))
    ids, lens, conf = (a.numpy() for a in
                       ctc.greedy_decode(torch.from_numpy(tl),
                                         torch.from_numpy(tp)))
    np.testing.assert_array_equal(lens, jlen)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(conf, jconf, atol=1e-5)


def test_greedy_decode_on_same_logits():
    """Collapse repeats, drop blanks, kept symbols first then zeros."""
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(6, 40, 7)).astype(np.float32)
    logits[:, ::3, 0] += 4.0                  # plenty of blanks
    logits[2, 5:9, 3] += 9.0                  # a repeated symbol
    pad = np.zeros((6, 40), np.float32)
    pad[1, 25:] = 1.0
    pad[4, 3:] = 1.0
    want = [np.asarray(a) for a in jax_ctc.greedy_decode(
        jnp.asarray(logits), jnp.asarray(pad))]
    got = [a.numpy() for a in ctc.greedy_decode(torch.from_numpy(logits),
                                                torch.from_numpy(pad))]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], atol=1e-6)
    charset = "abcdef"
    for i in range(6):
        assert ctc.ids_to_text(got[0][i], got[1][i], charset) == \
            jax_ctc.ids_to_text(want[0][i], want[1][i], charset)


def test_beam_search_matches_jax():
    rng = np.random.default_rng(9)
    lp = rng.normal(size=(30, 6)).astype(np.float32)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    assert ctc.beam_search_decode(lp, "abcde", 5) == \
        jax_ctc.beam_search_decode(lp, "abcde", 5)


def test_width_ladder_matches_jax():
    for w in (1, 100, 256, 257, 1000, 2047, 2048, 3000):
        assert recognizer.strip_width_bucket(w) == \
            jax_rec.strip_width_bucket(w)
        assert recognizer.strip_width_bucket(w, None) == \
            jax_rec.strip_width_bucket(w, None)
    assert recognizer.strip_width_ladder() == jax_rec.strip_width_ladder()


def test_logits_do_not_depend_on_bucket_padding(narrow):
    """MaskedGroupNorm + packed LSTM: the same strip in a wider bucket
    gives the same valid-frame logits up to the SAME-conv edge (the
    zero padding the JAX model sees too)."""
    model = recognizer.LineRecognizer(
        NUM_SYMBOLS, conv_features=(8, 16, 32), lstm_features=32,
        dtype=torch.float32)
    torch.manual_seed(0)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.2)
    model.eval()
    rng = np.random.default_rng(2)
    x = np.zeros((1, 48, 512, 1), np.float32)
    x[0, :, :100] = rng.random((48, 100, 1))
    with torch.no_grad():
        a, pa = model(torch.from_numpy(x[:, :, :256]),
                      widths=torch.tensor([100.0]))
        b, pb = model(torch.from_numpy(x), widths=torch.tensor([100.0]))
    n = int((pa < 0.5).sum())
    assert n == int((pb < 0.5).sum()) == 25
    np.testing.assert_allclose(a[0, :n].numpy(), b[0, :n].numpy(),
                               atol=1e-4)
