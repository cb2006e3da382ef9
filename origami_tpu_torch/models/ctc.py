"""CTC loss and decoding for the line recognizer.

Port of origami_tpu/models/ctc.py: `ctc_loss` is the batch mean of
optax.ctc_loss per sequence (:19-24, `ctc_losses`), `greedy_decode` runs on the
logits' device (:26-54), `ids_to_text` and the host prefix
`beam_search_decode` (for --decoder beam) are copied as they are.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

BLANK = 0  # blank index; charset indices start at 1
LOG_EPSILON = -1e5   # optax.ctc_loss's log(0)


def _feasible(labels, label_lens, input_lens):
    """Rows whose labels fit their frames: one frame a label, one more
    for each blank that must part two equal labels."""
    n = labels.shape[1]
    pos = torch.arange(1, n, device=labels.device)[None, :]
    repeats = ((labels[:, 1:] == labels[:, :-1])
               & (pos < label_lens[:, None])).sum(1)
    return input_lens >= label_lens + repeats


def _optax_ctc(logprobs, logit_paddings, labels, label_paddings):
    """optax.ctc_loss per sequence, its forward recursion step by step:
    log(0) is LOG_EPSILON, so a row whose labels cannot fit its frames
    gets a large finite loss (with its gradient) where F.ctc_loss gives
    inf. logprobs (B, T, K) log-softmaxed."""
    b, _, _ = logprobs.shape
    n = labels.shape[1]
    eps = LOG_EPSILON
    label_lens = n - label_paddings.sum(1).long()
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).float(), (0, 1))
    phi_all = logprobs[:, :, BLANK]                               # (B, T)
    emit_all = torch.gather(
        logprobs, 2, labels[:, None, :].expand(-1, logprobs.shape[1], -1))
    phi = torch.full((b, n + 1), eps, dtype=logprobs.dtype,
                     device=logprobs.device)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], 1)
    emit = torch.full((b, n), eps, dtype=logprobs.dtype,
                      device=logprobs.device)

    def update(p, added):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], added)], 1)

    for t in range(logprobs.shape[1]):
        pad = logit_paddings[:, t, None].to(logprobs.dtype)
        lp_emit, lp_phi = emit_all[:, t], phi_all[:, t, None]
        prev_phi_orig = phi
        prev_phi = update(phi, emit + eps * repeat)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit,
                                    emit + lp_emit)
        next_phi = update(prev_phi + lp_phi,
                          emit + lp_phi + eps * (1.0 - repeat))
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    last = update(phi, emit)
    return -torch.gather(last, 1, label_lens[:, None])[:, 0]


def ctc_loss(logits, logit_paddings, labels, label_paddings):
    """Mean CTC loss over the batch (ctc_losses' mean)."""
    return ctc_losses(logits, logit_paddings, labels, label_paddings).mean()


def ctc_losses(logits, logit_paddings, labels, label_paddings):
    """optax.ctc_loss per sequence with blank 0 -> (B,). logits (B, T, K)
    float, logit_paddings (B, T) and label_paddings (B, N) (1 =
    padding), labels (B, N) int. Rows whose labels fit their frames go
    through F.ctc_loss; the others through optax's own recursion
    (_optax_ctc), which gives them optax's large finite loss."""
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    input_lens = (logits.shape[1] - logit_paddings.sum(1)).round().long()
    label_lens = (labels.shape[1] - label_paddings.sum(1)).round().long()
    ok = _feasible(labels, label_lens, input_lens)
    per = torch.zeros(logits.shape[0], dtype=logprobs.dtype,
                      device=logprobs.device)
    if bool(ok.any()):
        rows = ok.nonzero()[:, 0]
        per = per.index_put(
            (rows,),
            F.ctc_loss(logprobs[rows].transpose(0, 1), labels[rows],
                       input_lens[rows], label_lens[rows], blank=BLANK,
                       reduction="none", zero_infinity=False))
    if not bool(ok.all()):
        rows = (~ok).nonzero()[:, 0]
        per = per.index_put(
            (rows,), _optax_ctc(logprobs[rows], logit_paddings[rows],
                                labels[rows], label_paddings[rows]))
    return per


def greedy_decode(logits, logit_paddings):
    """Best-path decode: argmax per frame, collapse repeats, drop blanks.

    logits (B, T, K) float, logit_paddings (B, T) (1 = padding frame).
    Returns (ids (B, T) long, kept symbols first then 0, lengths (B,),
    confidence (B,)): confidence is the mean max-softmax over valid
    frames."""
    probs = torch.softmax(logits.float(), dim=-1)
    pmax, best = probs.max(dim=-1)                          # (B, T)
    valid = logit_paddings < 0.5
    conf = (pmax * valid).sum(-1) / torch.clamp(valid.sum(-1), min=1)
    prev = torch.nn.functional.pad(best[:, :-1], (1, 0), value=BLANK)
    keep = (best != BLANK) & (best != prev) & valid
    t = best.shape[1]
    # stable order: kept frames first, by time
    key = torch.arange(t, device=best.device)[None, :] + (~keep) * t
    order = torch.argsort(key, dim=1, stable=True)
    lengths = keep.sum(-1)
    ids = torch.gather(best, 1, order)
    ids = torch.where(torch.arange(t, device=best.device)[None, :]
                      < lengths[:, None], ids, torch.zeros_like(ids))
    return ids, lengths, conf


def ids_to_text(ids, length, charset):
    """Map decoded ids (blank=0, chars start at 1) to a string."""
    out = []
    for i in np.asarray(ids)[: int(length)]:
        i = int(i)
        if 1 <= i <= len(charset):
            out.append(charset[i - 1])
    return "".join(out)


def beam_search_decode(log_probs, charset, beam_width=10):
    """Host prefix beam search over (T, K) log-probabilities.

    Returns (text, score)."""
    T, K = log_probs.shape
    NEG = -1e30

    def logsum(a, b):
        if a <= NEG:
            return b
        if b <= NEG:
            return a
        m = max(a, b)
        return m + np.log(np.exp(a - m) + np.exp(b - m))

    beams = {(): (0.0, NEG)}
    for t in range(T):
        lp = log_probs[t]
        top = np.argsort(lp)[-max(beam_width * 2, 8):]
        nxt = {}
        for prefix, (pb, pnb) in beams.items():
            total = logsum(pb, pnb)
            for k in top:
                p = float(lp[k])
                if k == BLANK:
                    cpb, cpnb = nxt.get(prefix, (NEG, NEG))
                    nxt[prefix] = (logsum(cpb, total + p), cpnb)
                else:
                    newfix = prefix + (int(k),)
                    if prefix and prefix[-1] == k:
                        # repeat char: extend only from blank path
                        cpb, cpnb = nxt.get(newfix, (NEG, NEG))
                        nxt[newfix] = (cpb, logsum(cpnb, pb + p))
                        cpb2, cpnb2 = nxt.get(prefix, (NEG, NEG))
                        nxt[prefix] = (cpb2, logsum(cpnb2, pnb + p))
                    else:
                        cpb, cpnb = nxt.get(newfix, (NEG, NEG))
                        nxt[newfix] = (cpb, logsum(cpnb, total + p))
        beams = dict(sorted(nxt.items(),
                            key=lambda kv: -logsum(*kv[1]))[:beam_width])
    best_prefix, (pb, pnb) = max(beams.items(), key=lambda kv: logsum(*kv[1]))
    text = "".join(charset[i - 1] for i in best_prefix
                   if 1 <= i <= len(charset))
    return text, logsum(pb, pnb)
