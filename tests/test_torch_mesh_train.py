"""The port's mesh training (origami_tpu_torch/parallel/{mesh,sharding}.py,
train/mesh.py and the three trainers' `mesh=`) against the JAX trainers
on meshes of the conftest's virtual CPU devices.

The JAX SegmentationTrainer runs on make_mesh(jax.devices()[:4],
model_parallel=m) for a 4 x 1 and a 2 x 2 mesh, the port's on ["cpu"] * 4
with the same model axis, from JAX's initial parameters (a seeded flax
tree that JAX's init_unet / init_recognizer return here: flax's own init
compiles for about 20 s on the CPU), carried across by registry's flax
mapping: a U-Net of width
0.25, s2d 2, on 64 x 64 tiles, batch 4, float32, class weights (1, 2.5,
4, 0.5) and the band_dontcare tolerance band, on labels whose blocks
carry different weight sums. Over 3 steps the losses agree within 1e-5
relative and every leaf within 1e-4 relative (the L2 norm of its
difference over its own). The Distiller (a masked hard term, 2 x 2) and
the RecognizerTrainer (4 x 1) are held to the same bars, cut down (the
recognizer's losses to the 1e-4 of its one-device test, ROADMAP C12).

Also: the port's rule splits exactly the leaves JAX's does, on the
counterpart axis, over the shipped U-Nets' shapes; the invariants at
rest (slices of Cout / m rows with their moments, replicated leaves
bit-identical, `save` equal to a one-device trainer's bytes); the warp
on a mesh equals the one-device run; averaging the blocks' means would
miss the global weighted mean on this batch; the dry run's training half
and the train CLI.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import origami_tpu.train.ocr.train as jax_ocr
import origami_tpu.train.segment.distill as jax_distill
import origami_tpu.train.segment.train as jax_train
from origami_tpu.models import unet as junet
from origami_tpu.parallel import sharding as jax_sharding
from origami_tpu.parallel.mesh import make_mesh as jax_make_mesh
from origami_tpu_torch.models import registry
from origami_tpu_torch.models.recognizer import (LineRecognizer,
                                                 init_recognizer)
from origami_tpu_torch.models.unet import create_unet, init_unet
from origami_tpu_torch.parallel import sharding
from origami_tpu_torch.parallel.dryrun import dryrun_multichip
from origami_tpu_torch.parallel.mesh import make_mesh, shard_batch
from origami_tpu_torch.train.ocr import train as port_ocr
from origami_tpu_torch.train.segment import distill as port_distill
from origami_tpu_torch.train.segment import main as seg_main
from origami_tpu_torch.train.segment import train as port_train
from origami_tpu_torch.train.segment import warp as port_warp
from torch_train_helpers import (CLASSES, REC, UNET, corpus_arrays,
                                 leaf_errors, to_numpy)
from torch_train_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

TILE = (64, 64)
STEPS = 3
LOSS_BAR = 1e-5
LEAF_BAR = 1e-4
# JAX's float32 CTC is 1.9e-4 relative off the float64 loss, the port's
# 5.9e-5 (ROADMAP C12): test_torch_train_ocr.py's bar
CTC_LOSS_BAR = 1e-4
CW = np.array([1.0, 2.5, 4.0, 0.5], np.float32)
BAND = (3, 2, 0.15)
META = dict(classes=CLASSES)
MESHES = {"4x1": 1, "2x2": 2}
# flax's own init, for the shapes alone (jax_f32 replaces it)
JAX_INIT_UNET = junet.init_unet


def batches():
    """STEPS batches of 4 pages and labels whose 4 blocks carry different
    weight sums (a different share of each class a page)."""
    imgs, labs = corpus_arrays(4 * STEPS, hw=TILE, seed=21)
    for i in range(len(labs)):
        labs[i, : 8 * (i % 4 + 1)] = i % 3
    x = (imgs.astype(np.float32) / np.float32(255.0))[..., None]
    return [(x[4 * s: 4 * s + 4], labs[4 * s: 4 * s + 4].astype(np.int64))
            for s in range(STEPS)]


def seg_cfg(cls):
    # no remat: it changes no number, and JAX compiles faster without
    return cls(num_classes=4, tile_hw=TILE, steps=10, warmup=2,
               class_weights=CW, band_dontcare=BAND, remat=False, **UNET)


def unet_tree(seed):
    """A seeded flax U-Net tree (UNET's architecture), numpy float32."""
    net = create_unet(4, dtype=torch.float32, **UNET)
    return registry.flax_params(init_unet(
        net, torch.Generator().manual_seed(seed)))


def recognizer_tree(seed, num_symbols):
    net = LineRecognizer(num_symbols, conv_features=REC["conv_features"],
                         lstm_features=REC["lstm_features"],
                         height=REC["height"], dtype=torch.float32)
    return registry.flax_params(init_recognizer(
        net, torch.Generator().manual_seed(seed)))


@pytest.fixture(scope="module")
def jax_f32():
    """The JAX trainers' nets in float32, and their initial parameters
    the seeded trees, for the module."""
    trees = {"unet": unet_tree(0), "rec": recognizer_tree(0, 8)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(junet, "create_unet", functools.partial(
            junet.create_unet, dtype=jnp.float32))
        mp.setattr(junet, "init_unet",
                   lambda *a, **k: jax.tree.map(jnp.asarray, trees["unet"]))
        mp.setattr(jax_ocr.rec_lib, "create_recognizer", functools.partial(
            jax_ocr.rec_lib.create_recognizer, dtype=jnp.float32))
        mp.setattr(jax_ocr.rec_lib, "init_recognizer",
                   lambda *a, **k: jax.tree.map(jnp.asarray, trees["rec"]))
        yield


def jax_mesh(model_parallel):
    return jax_make_mesh(jax.devices()[:4], model_parallel=model_parallel)


def port_mesh(model_parallel):
    return make_mesh(["cpu"] * 4, model_parallel=model_parallel)


@pytest.fixture(scope="module", params=sorted(MESHES))
def segment_runs(request, jax_f32):
    """(mesh name, JAX init, [(loss, params)] a step) of the JAX trainer."""
    m = MESHES[request.param]
    jt = jax_train.SegmentationTrainer(seg_cfg(jax_train.TrainConfig),
                                       mesh=jax_mesh(m), seed=0)
    init = to_numpy(jt.params)
    out = []
    for x, lab in batches():
        loss = jt.train_step(x, lab)
        out.append((loss, to_numpy(jt.params)))
    return request.param, init, out


def port_trainer(name, init, seed=0):
    pt = port_train.SegmentationTrainer(
        seg_cfg(port_train.TrainConfig), mesh=port_mesh(MESHES[name]),
        seed=seed, dtype=torch.float32)
    pt.load_state_dict(registry.unet_params_from_flax(init, META))
    return pt


def check_step(step, lj, lp, jparams, model, state, loss_bar=LOSS_BAR):
    assert abs(lp - lj) <= loss_bar * abs(lj), (step, lj, lp)
    errs = leaf_errors(jparams, registry.flax_params(model, state))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= LEAF_BAR, (step, worst, errs[worst])


def test_segmentation_trainer_matches_jax_on_the_mesh(segment_runs):
    name, init, jax_steps = segment_runs
    pt = port_trainer(name, init)
    for step, ((x, lab), (lj, jparams)) in enumerate(zip(batches(),
                                                         jax_steps)):
        lp = pt.train_step(x, lab)
        check_step(step, lj, lp, jparams, pt.model, pt.state_dict())
    assert pt.optimizer.count == STEPS


def test_the_corpus_path_takes_the_host_path_updates(segment_runs):
    """train_on_indices (warp off) over the same pages gives the host
    batches' updates."""
    name, init, jax_steps = segment_runs
    xs = [b for b in batches()]
    imgs = np.concatenate([np.round(x[..., 0] * 255).astype(np.uint8)
                           for x, _ in xs])
    labs = np.concatenate([lab for _, lab in xs]).astype(np.uint8)
    pt = port_trainer(name, init)
    pt.attach_dataset(imgs, labs)
    for step, (lj, jparams) in enumerate(jax_steps):
        lp = pt.train_on_indices(np.arange(4 * step, 4 * step + 4))
        assert isinstance(lp, torch.Tensor) and lp.dim() == 0
        check_step(step, lj, float(lp), jparams, pt.model, pt.state_dict())


def test_slices_at_rest_and_replicas_stay_identical(segment_runs, tmp_path):
    """Each device holds Cout / m rows of a split leaf and the moments of
    those rows; the gathered leaves are freed; the whole leaves are
    bit-identical across the 4 replicas after 3 steps; `save` writes a
    one-device trainer's bytes for the same parameters."""
    name, init, _ = segment_runs
    m = MESHES[name]
    pt = port_trainer(name, init)
    for x, lab in batches():
        pt.train_step(x, lab)
    net = pt.net
    whole = create_unet(4, dtype=torch.float32, **UNET)
    full = dict(whole.named_parameters())
    axes = sharding.param_shardings(pt.mesh, whole)
    assert bool(net.split) == (m > 1)
    # shard_params cuts a module as the trainer holds its leaves
    parts = sharding.shard_params(pt.mesh, whole)
    assert [{k: v.shape for k, v in part.items()} for part in parts] \
        == [{k: v.shape for k, v in part.items()} for part in net.shards]
    for k, part in enumerate(net.shards):
        state = net.optimizers[k].opt.state
        replica = dict(net.replicas[k].named_parameters())
        for leaf, p in part.items():
            rows = full[leaf].shape[0]
            if m > 1 and axes[leaf] is not None:
                assert p.shape[0] == rows // m and replica[leaf].numel() == 0
            else:
                assert p.shape == full[leaf].shape and p is replica[leaf]
                assert torch.equal(p, net.shards[0][leaf]), (k, leaf)
            assert state[p]["exp_avg"].shape == p.shape
            assert state[p]["exp_avg_sq"].shape == p.shape
    one = port_train.SegmentationTrainer(seg_cfg(port_train.TrainConfig),
                                         device="cpu", dtype=torch.float32)
    one.load_state_dict(pt.state_dict())
    meta = dict(kind="unet", type="region", classes=CLASSES)
    pt.save(tmp_path / "mesh", meta)
    one.save(tmp_path / "one", meta)
    for f in ("meta.json", "params.msgpack"):
        assert (tmp_path / "mesh" / f).read_bytes() \
            == (tmp_path / "one" / f).read_bytes()


def test_param_spec_splits_the_leaves_jax_splits():
    """Over the shipped U-Nets' shapes (region width 2, s2d 4; separator
    width 1, s2d 2) and m = 2, 4: the port splits the counterpart of
    every leaf JAX splits (its output channels, JAX's last axis, the
    port's first), and slice j holds JAX's shard j. Shapes only."""
    for width, s2d in ((2.0, 4), (1.0, 2)):
        net = junet.create_unet(4, width=width, s2d=s2d)
        shapes = jax.eval_shape(
            lambda: JAX_INIT_UNET(net, jax.random.PRNGKey(0), (256, 256)))
        port = create_unet(4, width=width, s2d=s2d)
        for m in (2, 4):
            def channels(path, x, m=m):
                # each output channel's index where JAX splits, -1 else
                spec = jax_sharding.param_spec(path, x, m)
                out = np.full(x.shape, -1.0, np.float32)
                if spec != jax.sharding.PartitionSpec():
                    out[...] = np.arange(x.shape[-1])
                return out
            tree = jax.tree_util.tree_map_with_path(channels, shapes)
            marks = registry.unet_params_from_flax(tree, META)
            for leaf, p in port.named_parameters():
                axis = sharding.param_spec(leaf, p, m)
                mark = marks[leaf]
                assert mark.shape == p.shape
                assert (axis is not None) == bool((mark >= 0).all()), leaf
                if axis is None:
                    continue
                c = p.shape[axis]
                for j in range(m):
                    got = sharding.shard_of(mark, axis, m, j)
                    want = torch.arange(j * c // m, (j + 1) * c // m,
                                        dtype=torch.float32)
                    assert torch.equal(
                        got.reshape(c // m, -1)[:, 0], want), (leaf, j)


def test_the_warp_on_a_mesh_equals_the_one_device_run(monkeypatch):
    """train_on_indices with the warp on: a 2 x 2 mesh takes the
    one-device trainer's fields (drawn for the whole batch from one
    generator), one remap_batch call a block."""
    calls = []
    real = port_warp.remap_batch

    def counted(images, *a, **kw):
        calls.append(images.shape[0])
        return real(images, *a, **kw)

    monkeypatch.setattr(port_warp, "remap_batch", counted)
    imgs, labs = corpus_arrays(6, hw=TILE, seed=4)
    cfg = seg_cfg(port_train.TrainConfig)
    runs = []
    for mesh in (port_mesh(2), None):
        pt = port_train.SegmentationTrainer(
            cfg, mesh=mesh, device=None if mesh else "cpu", seed=3,
            dtype=torch.float32)
        pt.attach_dataset(imgs, labs, warp_amplitude=4.0, seed=5)
        calls.clear()
        losses = [float(pt.train_on_indices(idx))
                  for idx in ([0, 1, 2, 3], [5, 4, 3, 2], [1, 3, 5, 0])]
        runs.append((losses, registry.flax_params(pt.model,
                                                  pt.state_dict()),
                     list(calls)))
    (lm, pm, cm), (lo, po, co) = runs
    assert cm == [1, 1, 1, 1] * 3 and co == [4] * 3
    for a, b in zip(lm, lo):
        assert abs(a - b) <= 1e-5 * abs(b), (lm, lo)
    # every leaf's L2 norm (phase 14b's measure): the mesh sums the
    # blocks' gradients, the one device the batch's, in other orders
    norms = [{k: np.linalg.norm(np.asarray(v, np.float64)) for k, v in
              jax.tree_util.tree_flatten_with_path(p)[0]} for p in (pm, po)]
    for k, want in norms[1].items():
        assert abs(norms[0][k] - want) <= 1e-5 * want, k


def test_averaging_block_means_would_miss_the_global_mean():
    """On this module's batch the blocks' weight sums differ, so the mean
    of the 4 blocks' weighted means is measurably off the weighted mean
    of the whole batch, which the trainers compute: the parity tests can
    catch a trainer that averages."""
    x, lab = batches()[0]
    # a net that has learnt the background: each class's pixels lose
    # their own amount, so a block's mean follows its classes
    logits = np.random.default_rng(1).standard_normal((4,) + TILE + (4,))
    logits[..., 3] += 2.0
    logits = torch.from_numpy(logits.astype(np.float32))
    labels = torch.from_numpy(lab)
    cw = torch.from_numpy(CW)
    whole = float(port_train.weighted_ce_loss(logits, labels, cw, BAND))
    blocks = [float(port_train.weighted_ce_loss(logits[i: i + 1],
                                                labels[i: i + 1], cw, BAND))
              for i in range(4)]
    sums = [float(port_train.loss_weights(labels[i: i + 1], cw, BAND).sum())
            for i in range(4)]
    assert len(set(sums)) == 4
    assert abs(np.mean(blocks) - whole) > 100 * LOSS_BAR * whole, \
        (blocks, whole)
    want = float(jax_train.weighted_ce_loss(
        jnp.asarray(logits.numpy()), jnp.asarray(lab), jnp.asarray(CW),
        BAND))
    assert abs(whole - want) <= LOSS_BAR * want


def test_distiller_matches_jax_on_a_2x2_mesh(jax_f32):
    """A masked hard term whose mask sums differ by block, 2 steps."""
    teacher = junet.create_unet(4, **UNET)
    members = [unet_tree(k) for k in (1, 2)]
    stack = jax.tree.map(lambda a, b: jnp.stack([a, b]), *members)
    cfg = jax_distill.DistillConfig(num_classes=4, tile_hw=TILE, steps=10,
                                    warmup=1, **UNET)
    jd = jax_distill.Distiller(cfg, teacher, stack, mesh=jax_mesh(2),
                               seed=0)
    teachers = []
    for mem in members:
        t = registry.build_unet(dict(META, **UNET), dtype=torch.float32)
        t.load_state_dict(registry.unet_params_from_flax(mem, META))
        teachers.append(t)
    pd = port_distill.Distiller(port_distill.DistillConfig(**cfg.__dict__),
                                teachers, mesh=port_mesh(2),
                                dtype=torch.float32)
    pd.load_state_dict(registry.unet_params_from_flax(to_numpy(jd.params),
                                                      META))
    for step, (x, lab) in enumerate(batches()[:2]):
        mask = np.zeros(lab.shape, np.float32)
        for i in range(4):
            mask[i, : 10 * (i + 1 + step)] = 1.0
        lj = jd.train_step(x, lab, mask)
        lp = pd.train_step(x, lab, mask)
        check_step(step, lj, lp, to_numpy(jd.params), pd.student,
                   pd.state_dict())


def test_recognizer_matches_jax_on_a_4x1_mesh(jax_f32):
    """8 strips of different widths and label lengths, one step at the
    peak learning rate (warmup 0)."""
    charset = "abcdefgh"
    cfg = jax_ocr.OCRTrainConfig(num_symbols=len(charset), steps=10,
                                 warmup=0, **REC)
    jt = jax_ocr.RecognizerTrainer(cfg, mesh=jax_mesh(1), seed=0)
    pt = port_ocr.RecognizerTrainer(port_ocr.OCRTrainConfig(**cfg.__dict__),
                                    mesh=port_mesh(1), dtype=torch.float32)
    pt.load_state_dict(registry.params_from_flax(to_numpy(jt.params)))
    strips = np.random.default_rng(8).random(
        (8, REC["height"], 64, 1)).astype(np.float32)
    widths = np.array([64, 48, 64, 40, 56, 64, 32, 64], np.float32)
    texts = ["abc"[: 1 + i % 3] + "h" * (i // 3) for i in range(8)]
    labels, pad = jax_ocr.encode_labels(texts, charset)
    lj = jt.train_step(strips, widths, labels, pad)
    lp = pt.train_step(strips, widths, labels, pad)
    check_step(0, lj, lp, to_numpy(jt.params), pt.model, pt.state_dict(),
               loss_bar=CTC_LOSS_BAR)
    for k, part in enumerate(pt.net.shards[1:], 1):
        for leaf, p in part.items():
            assert torch.equal(p, pt.net.shards[0][leaf]), (k, leaf)


def test_recognizer_pool_on_a_mesh_equals_one_device():
    """train_on_bucket cuts each step's rows over a 4 x 1 mesh: the
    one-device trainer's losses and leaves (1e-5), whole leaves equal on
    every replica."""
    charset = "abcdefgh"
    cfg = port_ocr.OCRTrainConfig(num_symbols=len(charset), steps=10,
                                  warmup=1, **REC)
    rng = np.random.default_rng(9)
    strips = (rng.random((6, REC["height"], 64)) * 255).astype(np.uint8)
    widths = np.array([64, 40, 64, 52, 30, 64], np.float32)
    labels, pad = port_ocr.encode_labels(
        ["ab", "hgf", "a", "cde", "b", "hh"], charset)
    runs = []
    for mesh in (port_mesh(1), None):
        pt = port_ocr.RecognizerTrainer(cfg, mesh=mesh,
                                        device=None if mesh else "cpu",
                                        dtype=torch.float32)
        pt.attach_pool({64: (strips, widths, labels, pad)})
        losses = [float(pt.train_on_bucket(64, idx))
                  for idx in ([0, 1, 2, 3], [5, 4, 3, 2], [1, 3, 5, 0])]
        runs.append((losses, pt))
    (lm, pm), (lo, po) = runs
    for a, b in zip(lm, lo):
        assert abs(a - b) <= 1e-5 * abs(b), (lm, lo)
    errs = leaf_errors(registry.flax_params(po.model),
                       registry.flax_params(pm.model, pm.state_dict()))
    assert max(errs.values()) <= 1e-5, max(errs, key=errs.get)
    for part in pm.net.shards[1:]:
        for leaf, p in part.items():
            assert torch.equal(p, pm.net.shards[0][leaf]), leaf


def test_make_mesh_model_axis_and_shard_batch():
    mesh = make_mesh(["cpu"] * 6, model_parallel=2)
    assert mesh.shape == {"data": 3, "model": 2}
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(["cpu"] * 3, model_parallel=2)
    x = np.arange(6 * 2, dtype=np.float32).reshape(6, 2)
    parts = shard_batch(mesh, x)
    # a block a data group, the same block on both of its devices
    for k, p in enumerate(parts):
        np.testing.assert_array_equal(p.numpy(), x[2 * (k // 2):
                                                    2 * (k // 2) + 2])
    net = port_train.SegmentationTrainer(
        seg_cfg(port_train.TrainConfig), mesh=mesh, dtype=torch.float32).net
    # 6 rows: 2 a group, 1 a device; 9 or 3 rows: 3 or 1 a group, each
    # on its group's first device; 4 or 5 rows do not divide by the data
    # axis and run in the first group, over its model devices where they
    # divide
    def blocks(b):
        return [(k, s.start, s.stop) for k, s in net.blocks(b)]
    assert blocks(6) == [(k, k, k + 1) for k in range(6)]
    assert blocks(9) == [(0, 0, 3), (2, 3, 6), (4, 6, 9)]
    assert blocks(3) == [(0, 0, 1), (2, 1, 2), (4, 2, 3)]
    assert blocks(4) == [(0, 0, 2), (1, 2, 4)]
    assert blocks(5) == [(0, 0, 5)]


def test_dryrun_with_the_training_half_on_four_cpu_devices():
    dryrun_multichip(4, device="cpu")


def test_train_cli_on_a_one_device_cpu_mesh(tmp_path, capsys):
    """`train --device cpu` trains 2 steps on a one-device CPU mesh."""
    from origami_tpu_torch.core import _png
    tiles, out = tmp_path / "tiles", tmp_path / "model"
    tiles.mkdir()
    imgs, labs = corpus_arrays(2, hw=TILE, seed=3)
    for i, (img, lab) in enumerate(zip(imgs, labs)):
        _png.write_gray(tiles / ("p%d.0.png" % i), img)
        _png.write_gray(tiles / ("p%d.0.labels.png" % i), lab)
    (tiles / "codes.json").write_text(
        '{"TEXT": 0, "TABULAR": 1, "ILLUSTRATION": 2, "BACKGROUND": 3}')
    (tiles / "folds.json").write_text('{"folds": [[], []]}')
    assert seg_main.train_mesh("cpu").shape == {"data": 1, "model": 1}
    seg_main.main(["train", str(tiles), "-o", str(out), "--steps", "2",
                   "--batch-size", "2", "--width", "0.25", "--s2d", "2",
                   "--device", "cpu"])
    assert "saved model" in capsys.readouterr().out
    model, _ = registry.load_model(out, "cpu", conv_dtype=torch.float32)
    assert model.head.weight.shape[0] == 4
