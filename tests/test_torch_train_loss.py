"""The port's training numerics against optax and the JAX losses, where
they can drift (origami_tpu_torch/train/segment/train.py,
models/ctc.py):

  * weighted_ce_loss with and without the band_dontcare max pool, 1e-6
    relative;
  * optax's warmup_cosine_decay_schedule at every step, 1e-6 relative:
    0 at step 0 (the first update moves only the moments);
  * ScheduledAdamW against optax.adamw: its defaults (b1 0.9, b2 0.999,
    eps 1e-8), the decay the caller gives (1e-4, 1e-5), scaled by the
    scheduled rate and applied to every leaf; torch's default decay of
    0.01 must not leak in;
  * ctc_loss against optax.ctc_loss's batch mean, 1e-5 relative,
    including rows whose labels cannot fit their frames (optax's large
    finite loss, where F.ctc_loss gives inf) and repeated labels; the
    gradients of the rows that fit, 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from origami_tpu.models import ctc as jax_ctc
from origami_tpu.train.segment import train as jax_train
from origami_tpu_torch.models import ctc as port_ctc
from origami_tpu_torch.train.segment import train as port_train


@pytest.mark.parametrize("band", [None, (3, 2, 0.15), (3, 1, 0.1)])
def test_weighted_ce_loss_equals_jax(band):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 40, 56, 4)).astype(np.float32) * 3
    labels = np.full((2, 40, 56), 3, np.int64)
    labels[0, 10:12, 5:50] = 0
    labels[1, :, 20] = 1
    labels[1, 30:, 40:] = 2
    cw = np.array([4.0, 4.0, 2.0, 0.25], np.float32)
    want = float(jax_train.weighted_ce_loss(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(cw), band))
    got = float(port_train.weighted_ce_loss(
        torch.tensor(logits), torch.tensor(labels), torch.tensor(cw), band))
    assert abs(got - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("lr,warmup,steps", [
    (3e-4, 10, 100), (2e-4, 100, 80), (1e-3, 0, 50), (3e-4, 3, 3)])
def test_schedule_equals_optax_at_every_step(lr, warmup, steps):
    decay = max(steps, warmup + 1)
    want = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, decay)
    got = port_train.warmup_cosine_decay(lr, warmup, decay)
    for count in range(decay + 5):
        w = float(want(count))
        assert abs(got(count) - w) <= 1e-6 * lr, (count, got(count), w)
    if warmup:
        assert got(0) == 0.0


@pytest.mark.parametrize("weight_decay", [1e-4, 1e-5])
def test_adamw_equals_optax(weight_decay):
    rng = np.random.default_rng(1)
    w0 = {"a": rng.normal(size=(5, 3)).astype(np.float32),
          "b": rng.normal(size=(3,)).astype(np.float32)}
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 6)
    opt = optax.adamw(sched, weight_decay=weight_decay)

    def loss(p):
        return jnp.sum(jnp.tanh(p["a"] @ p["b"]) ** 2) + jnp.sum(p["b"])

    params = jax.tree.map(jnp.asarray, w0)
    state = opt.init(params)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in w0.items()}
    topt = port_train.ScheduledAdamW(
        tp.values(), port_train.warmup_cosine_decay(1e-2, 2, 6),
        weight_decay=weight_decay)
    assert topt.opt.defaults["weight_decay"] == weight_decay
    assert topt.opt.defaults["betas"] == (0.9, 0.999)
    assert topt.opt.defaults["eps"] == 1e-8
    for step in range(5):
        g = jax.grad(loss)(params)
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
        topt.zero_grad()
        (torch.sum(torch.tanh(tp["a"] @ tp["b"]) ** 2)
         + torch.sum(tp["b"])).backward()
        topt.step()
        for k in w0:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(params[k]), rtol=1e-5,
                                       atol=1e-7)
        if step == 0:
            # learning rate 0: neither the update nor the decay moved
            for k in w0:
                np.testing.assert_array_equal(tp[k].detach().numpy(), w0[k])


def _ctc_case(seed=0):
    rng = np.random.default_rng(seed)
    b, t, k, n = 6, 14, 7, 6
    logits = rng.normal(size=(b, t, k)).astype(np.float32) * 2
    lpad = np.zeros((b, t), np.float32)
    lpad[1, 9:] = 1
    lpad[2, 3:] = 1        # 3 frames for 5 labels: cannot fit
    lpad[4, 5:] = 1        # 5 frames for "1122": needs 6 (two blanks)
    lpad[5, 10:] = 1
    labels = rng.integers(1, k, size=(b, n)).astype(np.int32)
    labels[3] = [2, 2, 2, 3, 0, 0]
    labels[4, :4] = [1, 1, 2, 2]
    pad = np.zeros((b, n), np.float32)
    pad[0, 3:] = 1
    pad[2, 5:] = 1
    pad[3, 4:] = 1
    pad[4, 4:] = 1
    return logits, lpad, labels, pad


def test_ctc_loss_equals_optax_including_rows_that_cannot_fit():
    logits, lpad, labels, pad = _ctc_case()
    per = np.asarray(optax.ctc_loss(*map(jnp.asarray, (logits, lpad,
                                                       labels, pad))))
    assert per[2] > 1e4 and per[4] > 1e4      # the two rows that cannot fit
    want = float(jax_ctc.ctc_loss(*map(jnp.asarray,
                                       (logits, lpad, labels, pad))))
    got = port_ctc.ctc_loss(*map(torch.tensor, (logits, lpad, labels, pad)))
    assert np.isfinite(float(got))
    assert abs(float(got) - want) <= 1e-5 * abs(want)
    # F.ctc_loss alone gives such a row inf
    lp = torch.log_softmax(torch.tensor(logits[2:3]), -1).transpose(0, 1)
    inf = torch.nn.functional.ctc_loss(
        lp, torch.tensor(labels[2:3]).long(), torch.tensor([3]),
        torch.tensor([5]), reduction="none")
    assert torch.isinf(inf).all()


def test_ctc_recursion_equals_optax_per_row():
    logits, lpad, labels, pad = _ctc_case(3)
    per = np.asarray(optax.ctc_loss(*map(jnp.asarray, (logits, lpad,
                                                       labels, pad))))
    got = port_ctc._optax_ctc(torch.log_softmax(torch.tensor(logits), -1),
                              torch.tensor(lpad),
                              torch.tensor(labels).long(), torch.tensor(pad))
    np.testing.assert_allclose(got.numpy(), per, rtol=1e-5)


def test_ctc_gradients_of_rows_that_fit_equal_optax():
    logits, lpad, labels, pad = _ctc_case()
    fit = [0, 1, 3, 5]
    args = [a[fit] for a in (logits, lpad, labels, pad)]
    want = np.asarray(jax.grad(lambda x: jax_ctc.ctc_loss(
        x, *map(jnp.asarray, args[1:])))(jnp.asarray(args[0])))
    x = torch.tensor(args[0], requires_grad=True)
    port_ctc.ctc_loss(x, *map(torch.tensor, args[1:])).backward()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
