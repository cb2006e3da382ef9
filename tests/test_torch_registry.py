"""The port's readers against the JAX package's: weights (msgpack +
params_from_flax) and pages (PNG), plus the port's import boundary.

Tolerance: none — weights and pixels must be bit-identical (the readers
decode the same bytes; f16 packs widen to f32 exactly).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import msgpack
import numpy as np
import PIL.Image
import pytest
import torch

from origami_tpu.models import registry as jax_registry
from origami_tpu_torch.core import _png
from origami_tpu_torch.models import _msgpack, registry

ROOT = Path(__file__).resolve().parent.parent
MODELS = ROOT / "models_pretrained"
RECOGNIZERS = ["recognizer", "recognizer2", "recognizer3"]
ALL_DIRS = RECOGNIZERS + ["students/region/00", "students/separator/00"]
PAGES = sorted((ROOT / "tests/data/torch_ocr/full").glob("*.png"))


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (k,))
    else:
        yield prefix, tree


def assert_same_tree(port_tree, jax_tree):
    port = dict(_flatten(port_tree))
    ref = {k: np.asarray(v) for k, v in _flatten(jax_tree)}
    assert port.keys() == ref.keys()
    for k, v in ref.items():
        assert port[k].dtype == v.dtype, k
        assert port[k].shape == v.shape, k
        np.testing.assert_array_equal(port[k], v, err_msg="/".join(k))


@pytest.mark.parametrize("name", RECOGNIZERS)
def test_params_equal_jax_load_model(name):
    _, jax_params, jax_meta = jax_registry.load_model(MODELS / name)
    params, meta = registry.load_params(MODELS / name)
    assert meta == jax_meta
    assert_same_tree(params, jax_params)


@pytest.mark.parametrize("name", ALL_DIRS)
def test_msgpack_reader_agrees_with_msgpack(name):
    data = (MODELS / name / "params.msgpack").read_bytes()
    ours = _msgpack.unpackb(data)

    def ext(code, payload):
        assert code == 1
        shape, dtype, buf = msgpack.unpackb(payload, raw=True)
        return np.frombuffer(buf, np.dtype(dtype.decode())).reshape(shape)

    ref = msgpack.unpackb(data, ext_hook=ext, raw=False,
                          strict_map_key=False)
    assert_same_tree(ours, ref)


def test_msgpack_reader_rejects_outside_its_subset():
    with pytest.raises(ValueError):
        _msgpack.unpackb(msgpack.packb({"a": None}))
    with pytest.raises(ValueError):
        _msgpack.unpackb(msgpack.packb(msgpack.ExtType(5, b"xx")))
    with pytest.raises(ValueError):
        _msgpack.unpackb(msgpack.packb({"a": 1}) + b"\x00")
    assert _msgpack.unpackb(msgpack.packb(
        {"s": "x", "b": b"y", "i": -70000, "f": 1.5, "l": [1, 2]},
        use_bin_type=True)) == {"s": "x", "b": b"y", "i": -70000,
                                "f": 1.5, "l": [1, 2]}


@pytest.mark.parametrize("name", RECOGNIZERS)
def test_recognizers_load_into_line_recognizer(name):
    params, meta = registry.load_params(MODELS / name)
    model = registry.build_recognizer(meta)
    result = model.load_state_dict(registry.params_from_flax(params),
                                   strict=False)
    assert result.missing_keys == []
    assert result.unexpected_keys == []


def test_arch_tag_mismatch_fails_loudly(tmp_path):
    meta = json.loads((MODELS / "recognizer/meta.json").read_text())
    meta["arch"] = "old"
    (tmp_path / "meta.json").write_text(json.dumps(meta))
    (tmp_path / "params.msgpack").write_bytes(
        (MODELS / "recognizer/params.msgpack").read_bytes())
    with pytest.raises(ValueError, match="architecture"):
        registry.load_model(tmp_path, torch.device("cpu"))


@pytest.mark.parametrize("page", PAGES, ids=lambda p: p.name)
def test_png_reader_matches_pil(page):
    ref = np.asarray(PIL.Image.open(page).convert("L"))
    got = _png.read_gray(page)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    assert _png.read_size(page) == PIL.Image.open(page).size


@pytest.mark.parametrize("mode,channels", [("L", 1), ("RGB", 3)])
def test_png_reader_color_modes(tmp_path, mode, channels):
    rng = np.random.default_rng(3)
    shape = (23, 41) if channels == 1 else (23, 41, channels)
    px = rng.integers(0, 256, shape, dtype=np.uint8)
    px[5:9] = px[4:5]          # flat runs pick other PNG row filters
    path = tmp_path / "p.png"
    PIL.Image.fromarray(px, mode).save(path)
    np.testing.assert_array_equal(_png.read(path), px)
    np.testing.assert_array_equal(
        _png.read_gray(path), np.asarray(PIL.Image.open(path).convert("L")))


@pytest.mark.parametrize("mode", ["LA", "RGBA", "P", "I;16"])
def test_png_reader_rejects_other_formats(tmp_path, mode):
    px = np.zeros((5, 7, 2) if mode == "LA" else (5, 7, 4)
                  if mode == "RGBA" else (5, 7), np.uint8)
    img = PIL.Image.fromarray(px, {"LA": "LA", "RGBA": "RGBA"}.get(
        mode, "L")).convert(mode)
    img.save(tmp_path / "p.png")
    with pytest.raises(ValueError):
        _png.read(tmp_path / "p.png")


def test_port_imports_no_jax_pil_click_msgpack_cv2():
    code = """
import json, pkgutil, importlib, sys
sys.path.insert(0, %r)
import origami_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    origami_tpu_torch.__path__, "origami_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
banned = ("jax", "flax", "optax", "orbax", "origami_tpu", "PIL", "click",
          "msgpack", "cv2", "networkx", "lxml")
print(json.dumps({"modules": names,
                  "banned": sorted(m for m in sys.modules
                                   if m.split(".")[0] in banned)}))
""" % str(ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("batch.detect.ocr", "batch.detect.segment", "core.binarize",
                 "core.predict", "core.segment", "core.utils",
                 "models.unet", "ops.binarize", "ops.morphology",
                 "ops.resize", "ops.tiling", "batch.detect.flow",
                 "batch.detect.dewarp", "core.baselines", "core.flow",
                 "core.separate", "ops.gather", "ops.grid", "geometry",
                 "geometry.booleans", "geometry.native_bindings",
                 "geometry.raster", "geometry.wkt",
                 "geometry.contour_trace", "core.graph", "core.polyline",
                 "core.skeleton", "core.contours", "batch.detect.contours",
                 "core.neighbors", "core.xycut", "core.hull",
                 "core.geometry_ops", "custom.layouts.bbz",
                 "custom.layouts.default", "batch.detect.layout",
                 "batch.core.utils", "batch.detect.lines",
                 "batch.detect.order", "batch.detect.compose",
                 "batch.runner", "pagexml", "pagexml.pagexml"):
        assert "origami_tpu_torch." + name in result["modules"]
    assert result["banned"] == []


@pytest.mark.parametrize("name", ["students/region/00",
                                  "students/separator/00"])
def test_students_load_strictly_into_unet(name):
    params, meta = registry.load_params(MODELS / name)
    model = registry.build_unet(meta)
    result = model.load_state_dict(
        registry.unet_params_from_flax(params, meta), strict=True)
    assert result.missing_keys == [] and result.unexpected_keys == []
    assert model.s2d == meta["s2d"]
    assert model.features == {4: (128, 256, 512), 2: (64, 128, 256)}[
        meta["s2d"]]
    assert model.mid.convs[0].out_channels == 512
    kernel = params["ConvBlock_0"]["Conv_0"]["kernel"]      # HWIO
    np.testing.assert_array_equal(
        model.enc[0].convs[0].weight.detach().numpy(),
        kernel.transpose(3, 2, 0, 1))


def test_segment_entry_points_need_cuda_unless_told_cpu(tmp_path):
    """Without a card, every new entry point raises unless the caller
    asks for the CPU; nothing falls back quietly."""
    from origami_tpu_torch.batch.detect.segment import \
        SegmentationProcessor, parser
    from origami_tpu_torch.core import binarize as core_binarize
    from origami_tpu_torch.core.predict import (
        HeuristicSegmentationPredictor, SegmentationPredictor)
    assert parser().parse_args(["-m", "heuristic", "x"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    students = MODELS / "students"
    for make in (
            lambda: SegmentationProcessor("heuristic", {}),
            lambda: SegmentationProcessor(str(students), {"device": None}),
            lambda: HeuristicSegmentationPredictor(),
            lambda: SegmentationPredictor(students),
            lambda: core_binarize.from_string("sauvola(window_size=15)"),
            lambda: core_binarize.otsu()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert SegmentationProcessor(
        "heuristic", {"device": "cpu"}).device.type == "cpu"
    assert HeuristicSegmentationPredictor(
        device="cpu")._device.type == "cpu"


@pytest.mark.parametrize("stage", ["flow", "dewarp"])
def test_flow_and_dewarp_entry_points_need_cuda_unless_told_cpu(stage):
    """The flow and dewarp CLIs, their processors and the grid factory
    run on the card by default and raise without one; --device cpu /
    device="cpu" runs them on the CPU."""
    import importlib
    from origami_tpu_torch.core.dewarp import GridFactory
    from origami_tpu_torch.core.flow import Samples
    from origami_tpu_torch.core.math import Geometry
    mod = importlib.import_module("origami_tpu_torch.batch.detect." + stage)
    proc = {"flow": "FlowDetectionProcessor",
            "dewarp": "DewarpProcessor"}[stage]
    assert mod.parser().parse_args(["x"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    empty = Samples(Geometry(100, 100))
    for make in (lambda: getattr(mod, proc)({}),
                 lambda: getattr(mod, proc)({"device": None}),
                 lambda: mod.main(["--lock-strategy", "NONE", "."]),
                 lambda: GridFactory((100, 100), empty, empty)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert getattr(mod, proc)({"device": "cpu"}).device.type == "cpu"
    assert GridFactory((100, 100), empty, empty,
                       device="cpu")().points("sample").shape == (16, 16, 2)


@pytest.mark.parametrize("stage", ["lines", "order", "compose"])
def test_lines_order_compose_entry_points_need_cuda_unless_told_cpu(stage):
    """The lines, order and compose CLIs and their processors run on the
    card by default and raise without one; --device cpu / device="cpu"
    runs them on the CPU."""
    import importlib
    mod = importlib.import_module("origami_tpu_torch.batch.detect." + stage)
    proc = {"lines": "LineDetectionProcessor",
            "order": "ReadingOrderProcessor",
            "compose": "ComposeProcessor"}[stage]
    assert mod.parser().parse_args(["x"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    for make in (lambda: getattr(mod, proc)({}),
                 lambda: getattr(mod, proc)({"device": None}),
                 lambda: mod.main(["--lock-strategy", "NONE", "."])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert getattr(mod, proc)({"device": "cpu"}).device.type == "cpu"
