"""Model asset registry: reads and writes the JAX package's model dirs.

Port of origami_tpu/models/registry.py:

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
onto `UNet.state_dict()`; `params_to_flax` and `unet_params_to_flax` map
them back, so weights go both ways exactly; `load_model` dispatches on
the meta's "kind", builds the module and loads it; `load_ensemble` loads
sibling U-Nets; `save_model` writes a directory that both packages load
(registry.py:41-63).
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


def _sorted_tree(tree):
    """The tree with every dict's keys in sorted order: the order the
    JAX save_model writes (its jax.device_get rebuilds the tree sorted)."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def flax_params(model, state=None):
    """The flax param tree (numpy) of a port LineRecognizer or UNet, from
    its own state_dict or from `state` (the whole parameters of a mesh
    trainer, parallel/sharding.py)."""
    from origami_tpu_torch.models.recognizer import LineRecognizer
    from origami_tpu_torch.models.unet import UNet
    sd = model.state_dict() if state is None else state
    if isinstance(model, LineRecognizer):
        return params_to_flax(sd)
    if isinstance(model, UNet):
        return unet_params_to_flax(sd)
    raise TypeError("no flax layout for %s" % type(model).__name__)


def save_model(path, meta, params, params_dtype=None):
    """Write a model directory: meta.json and params.msgpack (the bytes
    flax.serialization.to_bytes writes). `params` is a flax tree of
    numpy arrays or a port LineRecognizer / UNet. A recognizer's meta
    gets the architecture tag; `params_dtype="float16"` stores floating
    leaves half-size and records it in the meta (load_params restores
    float32)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    if isinstance(params, torch.nn.Module):
        params = flax_params(params)
    if meta.get("kind") == "recognizer":
        meta = dict(meta, arch=meta.get("arch", RECOGNIZER_ARCH))
    params = _map_tree(params, np.asarray)
    if params_dtype is not None:
        dt = np.dtype(params_dtype)
        meta = dict(meta, params_dtype=dt.name)
        params = _map_tree(params, lambda x: x.astype(dt)
                           if np.issubdtype(x.dtype, np.floating) else x)
    else:
        meta = {k: v for k, v in meta.items() if k != "params_dtype"}
    with open(path / "meta.json", "w") as f:
        json.dump(meta, f, indent=2)
    with open(path / "params.msgpack", "wb") as f:
        f.write(_msgpack.packb(_sorted_tree(params)))


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


def _np(t):
    return t.detach().to("cpu", torch.float32).numpy().copy()


def params_to_flax(sd):
    """The inverse of params_from_flax: a LineRecognizer state_dict ->
    the flax param tree of numpy float32 arrays. torch's two LSTM biases
    fold into flax's one (bias_hh + bias_ih; the trainers keep bias_ih
    at 0, so this is exact)."""
    tree = {}
    i = 0
    while "convs.%d.weight" % i in sd:
        tree["Conv_%d" % i] = {
            "kernel": _np(sd["convs.%d.weight" % i]).transpose(2, 3, 1, 0)}
        tree["GroupNorm_%d" % i] = {"scale": _np(sd["norms.%d.weight" % i]),
                                    "bias": _np(sd["norms.%d.bias" % i])}
        i += 1
    cells = {}
    for name, suffix in (("OptimizedLSTMCell_0", ""),
                         ("OptimizedLSTMCell_1", "_reverse")):
        w_ih = _np(sd["lstm.weight_ih_l0" + suffix])
        w_hh = _np(sd["lstm.weight_hh_l0" + suffix])
        b = _np(sd["lstm.bias_hh_l0" + suffix]
                + sd["lstm.bias_ih_l0" + suffix])
        n = w_hh.shape[1]
        c = {}
        for k, g in enumerate(_GATES):
            rows = slice(k * n, (k + 1) * n)
            c["i" + g] = {"kernel": w_ih[rows].T.copy()}
            c["h" + g] = {"kernel": w_hh[rows].T.copy(), "bias": b[rows]}
        cells[name] = c
    tree["BiLSTM_0"] = cells
    for j, name in enumerate(("dense", "head")):
        tree["Dense_%d" % j] = {"kernel": _np(sd[name + ".weight"]).T.copy(),
                                "bias": _np(sd[name + ".bias"])}
    return _sorted_tree(tree)


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


def unet_params_to_flax(sd):
    """The inverse of unet_params_from_flax: a UNet state_dict -> the
    flax param tree of numpy float32 arrays."""
    n = sum(1 for k in sd if k.startswith("up.") and k.endswith(".weight"))

    def conv(name):
        return _np(sd[name]).transpose(2, 3, 1, 0).copy()

    def block(src):
        out = {}
        for j in (0, 1):
            out["Conv_%d" % j] = {"kernel": conv("%s.convs.%d.weight"
                                                 % (src, j))}
            out["GroupNorm_%d" % j] = {
                "scale": _np(sd["%s.norms.%d.weight" % (src, j)]),
                "bias": _np(sd["%s.norms.%d.bias" % (src, j)])}
        return out

    tree = {}
    for i in range(n):
        tree["ConvBlock_%d" % i] = block("enc.%d" % i)
        tree["ConvBlock_%d" % (n + 1 + i)] = block("dec.%d" % i)
        tree["Conv_%d" % i] = {"kernel": conv("up.%d.weight" % i)}
    tree["ConvBlock_%d" % n] = block("mid")
    tree["Conv_%d" % n] = {"kernel": conv("head.weight"),
                           "bias": _np(sd["head.bias"])}
    return _sorted_tree(tree)


def init_and_save(path, meta, seed=0):
    """Write a model directory of freshly initialized parameters (the
    port's flax-default initializers, drawn from a torch.Generator
    seeded with `seed`) for a U-Net or recognizer meta."""
    gen = torch.Generator().manual_seed(seed)
    if meta.get("kind") == "recognizer":
        from origami_tpu_torch.models.recognizer import init_recognizer
        model = init_recognizer(build_recognizer(meta), gen)
    else:
        from origami_tpu_torch.models.unet import init_unet
        model = init_unet(build_unet(meta), gen)
    save_model(path, meta, model)
    return model


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
