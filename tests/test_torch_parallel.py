"""The port's data axis (origami_tpu_torch/parallel/mesh.py) and the
ensemble graph's mesh branch (core/predict.py) against the unsharded
path and the JAX package's sharded predictor on its 8 virtual CPU
devices (the port of tests/test_parallel.py:58-84), and the serving half
of the multi-device dry run.

Tolerance: the mesh of the port changes nothing (equal maps); against
JAX, float32 label maps agree on >= 99.9 % of the pixels (the default
bar: the two sum their convolutions in other orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from origami_tpu.core import predict as jax_predict
from origami_tpu.models import registry as jax_registry
from origami_tpu.models.unet import create_unet as jax_create_unet
from origami_tpu.parallel.mesh import make_mesh as jax_make_mesh
from origami_tpu_torch.core.predict import SegmentationPredictor
from origami_tpu_torch.parallel.dryrun import dryrun_multichip
from origami_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch


@pytest.mark.parametrize("n_devices,batch,sharded", [
    (3, 6, True), (2, 2, True), (1, 5, True), (3, 5, False),
    (2, 0, True)])
def test_shard_batch(n_devices, batch, sharded):
    mesh = make_mesh(["cpu"] * n_devices)
    assert mesh.shape == {"data": n_devices, "model": 1}
    x = np.arange(batch * 6, dtype=np.float32).reshape(batch, 2, 3)
    parts = shard_batch(mesh, x)
    assert len(parts) == n_devices
    if sharded:
        # contiguous blocks of the leading axis, one a device
        assert all(p.shape == (batch // n_devices, 2, 3) for p in parts)
        np.testing.assert_array_equal(torch.cat(parts).numpy(), x)
    else:
        # the leading axis does not divide: every device has all of it
        for p in parts:
            np.testing.assert_array_equal(p.numpy(), x)


def test_shard_batch_replicates_a_scalar_and_replicate_copies():
    mesh = make_mesh(["cpu", "cpu"])
    assert [float(p) for p in shard_batch(mesh, np.float32(2.5))] \
        == [2.5, 2.5]
    model = torch.nn.Linear(3, 2)
    replicas = replicate(mesh, [model])
    assert len(replicas) == 2 and replicas[0][0] is not replicas[1][0]
    for [r] in replicas:
        assert r is not model
        for a, b in zip(r.parameters(), model.parameters()):
            assert torch.equal(a, b)


def test_make_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(ValueError):
        make_mesh([])


@pytest.fixture(scope="module")
def saved_models(tmp_path_factory):
    root = tmp_path_factory.mktemp("models")
    for kind, group in (("region", "region"), ("separator", "separator")):
        meta = jax_registry.default_segmentation_meta(
            kind, full_size=(64, 96), width=0.125, s2d=2)
        jax_registry.init_and_save(root / group / "1", meta)
    return root


def _jax_f32_sharded(models):
    """JAX's SegmentationPredictor on make_mesh(model_parallel=1) over the
    8 virtual CPU devices, its U-Nets rebuilt in float32."""
    mesh = jax_make_mesh(model_parallel=1)
    assert mesh.shape["data"] == 8
    pred = jax_predict.SegmentationPredictor(models, target="speed",
                                             mesh=mesh)
    graphs = []
    for g in pred._graphs:
        meta = g.meta
        model = jax_create_unet(
            len(meta["classes"]), width=meta.get("width", 1.0),
            dtype=jnp.float32, s2d=meta.get("s2d", 1),
            features=meta.get("features"),
            bottleneck=meta.get("bottleneck"))
        graphs.append(jax_predict._EnsembleGraph(
            model, jax.device_get(g._params), meta, mesh=mesh))
    pred._graphs = graphs
    return pred


def test_sharded_segmentation_equals_unsharded_and_jax(saved_models):
    rng = np.random.default_rng(0)
    pages = [rng.integers(0, 255, (96, 64)).astype(np.uint8)
             for _ in range(5)]    # 5 pages pad to 6 over 3 devices
    sharded = SegmentationPredictor(
        saved_models, target="speed", dtype=torch.float32,
        mesh=make_mesh(["cpu"] * 3)).predict_batch(pages)
    plain = SegmentationPredictor(
        saved_models, target="speed", dtype=torch.float32,
        device="cpu").predict_batch(pages)
    ref = _jax_f32_sharded(saved_models).predict_batch(pages)
    assert len(sharded) == len(plain) == len(ref) == 5
    for got, want, jax_seg in zip(sharded, plain, ref):
        assert [p.name for p in got.predictions] \
            == ["regions", "separators"]
        for name in ("regions", "separators"):
            a = got.by_name(name).labels
            # 96x64 pages pad to the 128x64 bucket; the canvas output is
            # cropped back to the page's content (96/128 of 96 rows)
            assert a.shape == (72, 64)
            np.testing.assert_array_equal(a, want.by_name(name).labels)
            b = jax_seg.by_name(name).labels
            assert b.shape == a.shape
            assert float((a == b).mean()) >= 0.999, name


def test_a_mesh_and_a_device_do_not_mix(saved_models):
    with pytest.raises(ValueError, match="not both"):
        SegmentationPredictor(saved_models, device="cpu",
                              mesh=make_mesh(["cpu"]))


@pytest.mark.parametrize("n_devices", [1, 2])
def test_dryrun_multichip_on_the_cpu(n_devices):
    dryrun_multichip(n_devices, device="cpu")
