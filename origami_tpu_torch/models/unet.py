"""U-Net page segmentation model (PyTorch).

Port of origami_tpu/models/unet.py, the same computation step for step
so the JAX checkpoints load unchanged (registry.unet_params_from_flax):

  * input (B, H, W, C) float32 in [0, 1], the JAX layout at the public
    function; H and W divisible by s2d * 2**len(features); NCHW inside;
  * s2d > 1: a space-to-depth stem folds s2d x s2d patches into channels
    in (dy, dx, c) order, so every conv runs at reduced resolution;
  * ConvBlock: twice (3x3 SAME conv without bias in `dtype`, GroupNorm
    with min(8, f) groups and eps 1e-6 in float32, tanh-approximate
    GELU);
  * encoder: ConvBlock then 2x2 max pool per feature width; a bottleneck
    ConvBlock; decoder: nearest 2x upsample, 3x3 conv, concatenate
    [x, skip], ConvBlock;
  * a 1x1 logits conv with bias in float32; with s2d > 1 the logits are
    upsampled linearly (half-pixel centres) to the input resolution.

Numeric mode: convolutions in `dtype` (bf16 on the main path, float32
for parity runs), everything else in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class ConvBlock(nn.Module):
    def __init__(self, in_features, features, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.groups = min(8, features)
        self.convs = nn.ModuleList([
            nn.Conv2d(in_features, features, 3, padding=1, bias=False),
            nn.Conv2d(features, features, 3, padding=1, bias=False)])
        self.norms = nn.ModuleList([
            nn.GroupNorm(self.groups, features, eps=1e-6),
            nn.GroupNorm(self.groups, features, eps=1e-6)])

    def forward(self, x):
        for conv, norm in zip(self.convs, self.norms):
            x = F.conv2d(x.to(self.dtype), conv.weight.to(self.dtype),
                         padding=1)
            x = F.gelu(norm(x.float()), approximate="tanh")
        return x


class UNet(nn.Module):
    """Configurable U-Net emitting per-pixel class logits."""

    def __init__(self, num_classes, features=(32, 64, 128, 256),
                 bottleneck=512, dtype=torch.bfloat16, s2d=1,
                 in_channels=1):
        super().__init__()
        self.num_classes = num_classes
        self.features = tuple(features)
        self.dtype = dtype
        self.s2d = int(s2d)
        # pixel_unshuffle orders the folded channels (c, dy, dx); the
        # checkpoints' stem expects (dy, dx, c): equal for one channel
        if self.s2d > 1 and in_channels != 1:
            raise ValueError("the s2d stem is ported for 1 input channel")
        chans = in_channels * self.s2d * self.s2d
        self.enc = nn.ModuleList()
        for f in self.features:
            self.enc.append(ConvBlock(chans, f, dtype))
            chans = f
        self.mid = ConvBlock(chans, bottleneck, dtype)
        chans = bottleneck
        self.up = nn.ModuleList()
        self.dec = nn.ModuleList()
        for f in reversed(self.features):
            self.up.append(nn.Conv2d(chans, f, 3, padding=1, bias=False))
            self.dec.append(ConvBlock(2 * f, f, dtype))
            chans = f
        self.head = nn.Conv2d(chans, num_classes, 1)

    def forward(self, x):
        b, h0, w0, _ = x.shape
        x = x.permute(0, 3, 1, 2)
        if self.s2d > 1:
            x = F.pixel_unshuffle(x, self.s2d)
        skips = []
        for block in self.enc:
            x = block(x)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        x = self.mid(x)
        for conv, block, skip in zip(self.up, self.dec, reversed(skips)):
            x = F.interpolate(x, size=skip.shape[2:], mode="nearest-exact")
            x = F.conv2d(x.to(self.dtype), conv.weight.to(self.dtype),
                         padding=1)
            x = block(torch.cat([x, skip.to(self.dtype)], dim=1))
        logits = self.head(x.float())
        if self.s2d > 1:
            logits = F.interpolate(logits, size=(h0, w0), mode="bilinear",
                                   align_corners=False)
        return logits.permute(0, 2, 3, 1)


def create_unet(num_classes, width=1.0, dtype=torch.bfloat16, s2d=1,
                features=None, bottleneck=None, in_channels=1):
    """Width scales the encoder features; explicit `features` /
    `bottleneck` override (and are what model metas persist)."""
    if features is None:
        base_feats = (64, 128, 256) if s2d > 1 else (32, 64, 128, 256)
        features = tuple(max(8, int(round(f * width))) for f in base_feats)
    if bottleneck is None:
        bottleneck = max(16, min(int(round(512 * width)), 512)) \
            if s2d > 1 else max(16, int(round(512 * width)))
    return UNet(num_classes, features=tuple(features),
                bottleneck=bottleneck, dtype=dtype, s2d=s2d,
                in_channels=in_channels)


# flax's lecun_normal: a normal truncated to two standard deviations,
# scaled so that its standard deviation is sqrt(1 / fan_in)
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(weight, fan_in, generator):
    torch.nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0,
                                generator=generator)
    weight.mul_((1.0 / fan_in) ** 0.5 / _TRUNC_STD)
    return weight


@torch.no_grad()
def init_unet(model, generator):
    """Fresh parameters from flax's default initializers (unet.py's
    init_unet): every conv kernel lecun_normal over its fan in
    (in_channels x 3 x 3, or x 1 x 1), the logits conv's bias 0,
    GroupNorm scale 1 and bias 0. Float32; draws from `generator`."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            lecun_normal_(m.weight, fan_in, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model.float()


@torch.no_grad()
def ensemble_apply(models, tiles):
    """Softmax-sum ensemble: the members run in sequence on the (T, h,
    w, C) tiles and their softmax probabilities add up in float32 ->
    (T, h, w, K)."""
    probs = None
    for model in models:
        p = torch.softmax(model(tiles).float(), dim=-1)
        probs = p if probs is None else probs + p
    return probs
