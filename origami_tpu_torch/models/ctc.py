"""CTC decoding for the line recognizer.

Port of origami_tpu/models/ctc.py: `greedy_decode` runs on the logits'
device (:26-54), `ids_to_text` and the host prefix `beam_search_decode`
(for --decoder beam) are copied as they are.
"""

from __future__ import annotations

import numpy as np
import torch

BLANK = 0  # blank index; charset indices start at 1


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
