"""Model asset registry: reads the JAX package's on-disk model dirs.

Port of origami_tpu/models/registry.py (read side only):

    <model dir>/meta.json        {"kind": "recognizer", "charset", "height",
                                  "conv_features", "lstm_features", "arch",
                                  "params_dtype"?, "lstm_dtype"?, ...} or
                                 {"kind": "unet", "type", "classes",
                                  "full_size", "tile_size", "tile_beta",
                                  "width", "s2d", "channels", ...}
    <model dir>/params.msgpack   flax.serialization bytes of the param tree

`load_params` returns the flax tree as numpy (float16 packs restored to
float32); `params_from_flax` maps a recognizer tree onto the port's
`LineRecognizer.state_dict()` and `unet_params_from_flax` a U-Net tree
onto `UNet.state_dict()`; `load_model` dispatches on the meta's "kind",
builds the module and loads it; `load_ensemble` loads sibling U-Nets.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch

from origami_tpu_torch.models import _msgpack

# The architecture tag the JAX build stamps on recognizer checkpoints
# (registry.py:38): checkpoints of an older architecture load without
# error but decode differently, so they must fail loudly.
RECOGNIZER_ARCH = "masked-gn+seq-lstm/2"

_GATES = ("i", "f", "g", "o")   # torch.nn.LSTM's stacking order


def load_meta(path):
    with open(Path(path) / "meta.json", "r") as f:
        return json.load(f)


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def load_params(path):
    """(flax param tree of numpy arrays, meta). Floating leaves of a
    `params_dtype` pack come back as float32 (registry.py:119-133)."""
    path = Path(path)
    meta = load_meta(path)
    with open(path / "params.msgpack", "rb") as f:
        tree = _msgpack.unpackb(f.read())
    if meta.get("params_dtype") is not None:
        tree = _map_tree(
            tree, lambda x: x.astype(np.float32)
            if isinstance(x, np.ndarray)
            and np.issubdtype(x.dtype, np.floating) else x)
    return tree, meta


def check_arch(path, meta):
    if meta.get("kind") == "recognizer" \
            and meta.get("arch") != RECOGNIZER_ARCH:
        raise ValueError(
            "recognizer checkpoint %s was saved for architecture %r but "
            "this build is %r (masked GroupNorm stats + seq_lengths LSTM "
            "sweeps change logits for identical params) — retrain, or "
            "stamp meta.json \"arch\" if the checkpoint is known to be "
            "post-change" % (path, meta.get("arch"), RECOGNIZER_ARCH))


def lstm_dtype(meta):
    """Serving-time recurrent dtype: env override, then meta, then f32
    (registry.py:83-84)."""
    name = os.environ.get("ORIGAMI_TPU_LSTM_DTYPE",
                          meta.get("lstm_dtype", "float32"))
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[str(name)]


def params_from_flax(tree):
    """Map a flax LineRecognizer param tree onto LineRecognizer's
    state_dict: conv HWIO -> OIHW; Dense (in, out) -> Linear (out, in);
    OptimizedLSTMCell ii/if/ig/io (no bias) + hi/hf/hg/ho (bias) ->
    torch's stacked (i, f, g, o) weight_ih / weight_hh / bias_hh, with
    bias_ih = 0. Returns {name: torch.Tensor}."""
    sd = {}

    def t(a):
        return torch.from_numpy(np.array(a, copy=True))

    i = 0
    while "Conv_%d" % i in tree:
        k = tree["Conv_%d" % i]["kernel"]                 # (3, 3, in, out)
        sd["convs.%d.weight" % i] = t(k.transpose(3, 2, 0, 1))
        gn = tree["GroupNorm_%d" % i]
        sd["norms.%d.weight" % i] = t(gn["scale"])
        sd["norms.%d.bias" % i] = t(gn["bias"])
        i += 1
    cells = tree["BiLSTM_0"]
    for name, suffix in (("OptimizedLSTMCell_0", ""),
                         ("OptimizedLSTMCell_1", "_reverse")):
        c = cells[name]
        w_ih = np.concatenate([c["i" + g]["kernel"].T for g in _GATES])
        w_hh = np.concatenate([c["h" + g]["kernel"].T for g in _GATES])
        b_hh = np.concatenate([c["h" + g]["bias"] for g in _GATES])
        sd["lstm.weight_ih_l0" + suffix] = t(w_ih)
        sd["lstm.weight_hh_l0" + suffix] = t(w_hh)
        sd["lstm.bias_ih_l0" + suffix] = torch.zeros(len(b_hh),
                                                     dtype=torch.float32)
        sd["lstm.bias_hh_l0" + suffix] = t(b_hh)
    for j, name in enumerate(("dense", "head")):
        d = tree["Dense_%d" % j]
        sd[name + ".weight"] = t(d["kernel"].T)
        sd[name + ".bias"] = t(d["bias"])
    return sd


def build_recognizer(meta, conv_dtype=torch.bfloat16):
    from origami_tpu_torch.models.recognizer import LineRecognizer
    return LineRecognizer(
        len(meta["charset"]),
        conv_features=tuple(meta.get("conv_features", (64, 128, 256))),
        lstm_features=meta.get("lstm_features", 256),
        height=meta.get("height", 48),
        dtype=conv_dtype, lstm_dtype=lstm_dtype(meta))


def unet_params_from_flax(tree, meta):
    """Map a flax UNet param tree onto UNet's state_dict. Flax names the
    submodules in call order (unet.py:56-85): ConvBlock_0..n-1 the
    encoder, ConvBlock_n the bottleneck, ConvBlock_n+1..2n the decoder,
    each holding Conv_0/1 and GroupNorm_0/1; Conv_0..n-1 the decoder's
    3x3 convs and Conv_n the 1x1 logits conv with bias. Conv kernels go
    HWIO -> OIHW. Returns {name: torch.Tensor}."""
    n = (sum(k.startswith("ConvBlock_") for k in tree) - 1) // 2
    sd = {}

    def t(a):
        return torch.from_numpy(np.array(a, copy=True))

    def conv(k):
        return t(k.transpose(3, 2, 0, 1))

    def block(src, dst):
        for j in (0, 1):
            sd["%s.convs.%d.weight" % (dst, j)] = \
                conv(src["Conv_%d" % j]["kernel"])
            gn = src["GroupNorm_%d" % j]
            sd["%s.norms.%d.weight" % (dst, j)] = t(gn["scale"])
            sd["%s.norms.%d.bias" % (dst, j)] = t(gn["bias"])

    for i in range(n):
        block(tree["ConvBlock_%d" % i], "enc.%d" % i)
        block(tree["ConvBlock_%d" % (n + 1 + i)], "dec.%d" % i)
        sd["up.%d.weight" % i] = conv(tree["Conv_%d" % i]["kernel"])
    block(tree["ConvBlock_%d" % n], "mid")
    head = tree["Conv_%d" % n]
    if head["bias"].shape[0] != len(meta["classes"]):
        raise ValueError("the checkpoint emits %d classes, its meta lists %d"
                         % (head["bias"].shape[0], len(meta["classes"])))
    sd["head.weight"] = conv(head["kernel"])
    sd["head.bias"] = t(head["bias"])
    known = {"ConvBlock_%d" % i for i in range(2 * n + 1)} \
        | {"Conv_%d" % i for i in range(n + 1)}
    if set(tree) != known:
        raise ValueError("unexpected U-Net parameter groups: %s"
                         % sorted(set(tree) ^ known))
    return sd


def build_unet(meta, dtype=torch.bfloat16):
    from origami_tpu_torch.models.unet import create_unet
    return create_unet(len(meta["classes"]),
                       width=meta.get("width", 1.0), dtype=dtype,
                       s2d=meta.get("s2d", 1),
                       features=meta.get("features"),
                       bottleneck=meta.get("bottleneck"),
                       in_channels=meta.get("channels", 1))


def load_model(path, device, conv_dtype=torch.bfloat16):
    """(module on `device` in eval mode, meta) for a model directory: a
    LineRecognizer for kind "recognizer", a UNet for kind "unet".
    Convolutions run in `conv_dtype` (bf16: the JAX main path's numeric
    mode)."""
    path = Path(path)
    tree, meta = load_params(path)
    kind = meta.get("kind")
    if kind == "recognizer":
        check_arch(path, meta)
        model = build_recognizer(meta, conv_dtype=conv_dtype)
        state = params_from_flax(tree)
    elif kind == "unet":
        model = build_unet(meta, dtype=conv_dtype)
        state = unet_params_from_flax(tree, meta)
    else:
        raise ValueError("%s: unknown model kind %r" % (path, kind))
    model.load_state_dict(state, strict=True)
    return model.to(device).eval(), meta


def load_ensemble(paths, device, conv_dtype=torch.bfloat16):
    """Load N same-architecture U-Nets for `unet.ensemble_apply` ->
    (list of modules, the first member's meta)."""
    loaded = [load_model(p, device, conv_dtype) for p in paths]
    metas = [m for _, m in loaded]
    for m in metas[1:]:
        if m["classes"] != metas[0]["classes"] \
                or m["kind"] != metas[0]["kind"]:
            raise ValueError("ensemble members disagree on architecture")
    return [model for model, _ in loaded], metas[0]
