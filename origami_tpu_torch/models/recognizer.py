"""Line text recognizer: CNN + BiLSTM + CTC head (PyTorch).

Port of origami_tpu/models/recognizer.py (LineRecognizer, :93-133), the
same computation step for step so the JAX checkpoints load unchanged
(registry.params_from_flax):

  * input (B, H, W, 1) in [0, 1], ink high (callers pass 1 - gray/255) —
    the JAX layout at the public function;
  * three 3x3 SAME convolutions without bias, each followed by
    MaskedGroupNorm (8 groups, eps 1e-6, statistics over the valid width
    ceil(w / 2^i) only) and tanh-approximate GELU (flax's nn.gelu);
    max pools 2x2, 2x2, 2x1 (floor on odd sizes);
  * flatten to (B, W', H'*C) with feature index h*C + c;
  * a BiLSTM that honours t_len = clip(ceil(w / 4), 1, W') (packed
    sequences: the backward sweep starts at each row's last valid frame);
  * Dense -> GELU -> Dense head, blank at index 0; pad mask t >= t_len.

Numeric mode (the JAX main path's): convolutions in `dtype` (bf16 by
default), GroupNorm statistics in f32, LSTM and head in `lstm_dtype`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class MaskedGroupNorm(nn.Module):
    """GroupNorm whose statistics ignore width padding (:41-75), so a
    strip's logits do not depend on its compile bucket's padding."""

    def __init__(self, channels, num_groups=8, eps=1e-6):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, t_len):
        # x (B, C, H, W); t_len (B,) int valid width
        b, c, h, w = x.shape
        g = self.num_groups
        xg = x.float().reshape(b, g, c // g, h, w)
        mask = (torch.arange(w, device=x.device)[None, :]
                < t_len[:, None]).float()[:, None, None, None, :]
        cnt = torch.clamp(mask.sum(dim=(2, 3, 4), keepdim=True)
                          * (c // g) * h, min=1e-6)
        mean = (xg * mask).sum(dim=(2, 3, 4), keepdim=True) / cnt
        var = (((xg - mean) * mask) ** 2).sum(dim=(2, 3, 4),
                                             keepdim=True) / cnt
        y = ((xg - mean) / torch.sqrt(var + self.eps)).reshape(b, c, h, w)
        y = y * self.weight[None, :, None, None] \
            + self.bias[None, :, None, None]
        return y.to(x.dtype)


class LineRecognizer(nn.Module):
    """(B, H, W, 1) line strips -> ((B, T, num_symbols+1) CTC logits,
    (B, T) pad mask)."""

    time_downsample = 4

    def __init__(self, num_symbols, conv_features=(64, 128, 256),
                 lstm_features=256, height=48, dtype=torch.bfloat16,
                 lstm_dtype=torch.float32):
        super().__init__()
        self.num_symbols = num_symbols
        self.dtype = dtype
        self.lstm_dtype = lstm_dtype
        chans = (1,) + tuple(conv_features)
        self.convs = nn.ModuleList(
            nn.Conv2d(chans[i], chans[i + 1], 3, padding=1, bias=False)
            for i in range(len(conv_features)))
        self.norms = nn.ModuleList(MaskedGroupNorm(f)
                                   for f in conv_features)
        h = height
        for i in range(len(conv_features)):
            h //= 2
        feat = h * conv_features[-1]
        self.lstm = nn.LSTM(feat, lstm_features, batch_first=True,
                            bidirectional=True, dtype=lstm_dtype)
        # flax's cell has one bias per gate (on the recurrent kernel):
        # torch's input bias stays 0 and out of training
        for name in ("bias_ih_l0", "bias_ih_l0_reverse"):
            b = getattr(self.lstm, name)
            with torch.no_grad():
                b.zero_()
            b.requires_grad_(False)
        self.dense = nn.Linear(2 * lstm_features, lstm_features,
                               dtype=lstm_dtype)
        self.head = nn.Linear(lstm_features, num_symbols + 1,
                              dtype=lstm_dtype)

    def forward(self, x, widths=None):
        x = x.permute(0, 3, 1, 2).to(self.dtype)          # (B, 1, H, W)
        b = x.shape[0]
        if widths is not None:
            cur_w = torch.clamp(widths.float(), min=1.0)
        else:
            cur_w = torch.full((b,), float(x.shape[3]), device=x.device)
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            x = F.conv2d(x, conv.weight.to(self.dtype), padding=1)
            x = norm(x, torch.ceil(cur_w).long())
            x = F.gelu(x, approximate="tanh")
            if i < 2:
                x = F.max_pool2d(x, (2, 2), (2, 2))
                cur_w = cur_w / 2
            else:
                x = F.max_pool2d(x, (2, 1), (2, 1))
        _, cc, hh, ww = x.shape
        # (B, C, H', W') -> (B, W', H'*C), feature index h*C + c
        x = x.permute(0, 3, 2, 1).reshape(b, ww, hh * cc) \
            .to(self.lstm_dtype)
        if widths is not None:
            t_len = torch.clamp(
                torch.ceil(widths.float() / self.time_downsample).long(),
                1, ww)
        else:
            t_len = torch.full((b,), ww, dtype=torch.long,
                               device=x.device)
        packed = nn.utils.rnn.pack_padded_sequence(
            x, t_len.cpu(), batch_first=True, enforce_sorted=False)
        out, _ = self.lstm(packed)
        x, _ = nn.utils.rnn.pad_packed_sequence(out, batch_first=True,
                                                total_length=ww)
        x = F.gelu(self.dense(x), approximate="tanh")
        logits = self.head(x).float()
        pad = (torch.arange(ww, device=x.device)[None, :]
               >= t_len[:, None]).float()
        return logits, pad


@torch.no_grad()
def init_recognizer(model, generator):
    """Fresh parameters from flax's default initializers (recognizer.py's
    init_recognizer): conv and Dense kernels lecun_normal over their fan
    in, Dense biases 0, GroupNorm scale 1 and bias 0; each LSTM gate's
    input kernel lecun_normal, its recurrent kernel orthogonal, its bias
    0 (OptimizedLSTMCell). Float32; draws from `generator`."""
    from origami_tpu_torch.models.unet import lecun_normal_
    for conv, norm in zip(model.convs, model.norms):
        lecun_normal_(conv.weight, conv.in_channels * 9, generator)
        norm.weight.fill_(1.0)
        norm.bias.zero_()
    lstm = model.lstm
    n = lstm.hidden_size
    for suffix in ("", "_reverse"):
        w_ih = getattr(lstm, "weight_ih_l0" + suffix)
        w_hh = getattr(lstm, "weight_hh_l0" + suffix)
        for k in range(4):
            rows = slice(k * n, (k + 1) * n)
            # flax's (in, n) kernel is the transpose of these rows
            lecun_normal_(w_ih[rows], lstm.input_size, generator)
            q = torch.empty(n, n, dtype=torch.float32)
            torch.nn.init.orthogonal_(q, generator=generator)
            w_hh[rows] = q.t().to(w_hh.dtype)
        getattr(lstm, "bias_ih_l0" + suffix).zero_()
        getattr(lstm, "bias_hh_l0" + suffix).zero_()
    for lin in (model.dense, model.head):
        lecun_normal_(lin.weight, lin.in_features, generator)
        lin.bias.zero_()
    return model.float()


STRIP_WIDTH_STEP = 256


def strip_width_bucket(width, cap=2048):
    """Canonical width bucket: the 256-px ladder (recognizer.py:157-170),
    shared by the line extractor and the recognizer dispatch."""
    b = max(STRIP_WIDTH_STEP,
            -(-int(width) // STRIP_WIDTH_STEP) * STRIP_WIDTH_STEP)
    return min(b, cap) if cap else b


def strip_width_ladder(cap=2048):
    """All strip_width_bucket values up to `cap`."""
    return tuple(range(STRIP_WIDTH_STEP, int(cap) + 1, STRIP_WIDTH_STEP))



def width_buckets(widths, time_downsample=4, min_bucket=128,
                  max_bucket=2048):
    """Static bucket sizes (recognizer.py:173-192): 128, then x1.5 down
    to a multiple of `time_downsample`, up to `max_bucket`; each width
    goes to the first bucket that holds it (the last one else). The
    recognizer trainer groups its strip pool by them."""
    buckets = []
    b = min_bucket
    while b < max_bucket:
        buckets.append(b)
        b = int(b * 1.5) // time_downsample * time_downsample
    buckets.append(max_bucket)
    out = []
    for w in widths:
        for b in buckets:
            if w <= b:
                out.append(b)
                break
        else:
            out.append(max_bucket)
    return out
