"""The port's flagship segmentation graph (origami_tpu_torch/models/
flagship.py) against the JAX package's (origami_tpu/models/flagship.py)
at a canvas small enough for the CPU: both modules' FULL_W/FULL_H and
their nets' dtype set by monkeypatching, 2 members a net, JAX's stacks
carried into the port's members by registry.unet_params_from_flax
(the JAX nets initialised under jax.jit: the weights are only the
graphs' shared input).

Tolerance: float32 label maps agree on >= 99.9 % of the pixels (the
default bar); the pages and the members' copies are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from origami_tpu.models import flagship as jax_flagship
from origami_tpu.models import unet as jax_unet
from origami_tpu_torch.models import flagship, registry

CANVAS_HW = (128, 64)          # divisible by s2d 4 x 2**3
SRC_HW = (90, 70)


def _jit_init(model, rng, tile_hw, in_channels=1):
    """origami_tpu.models.unet.init_unet under one jax.jit: the eager
    init dispatches (and compiles) op by op, most of this file's time."""
    x = jnp.zeros((1,) + tuple(tile_hw) + (in_channels,), jnp.float32)
    return jax.jit(model.init)(rng, x)["params"]


@pytest.fixture(scope="module")
def both_flagships():
    """JAX's and the port's flagship at the small canvas, built once:
    both modules' FULL_W/FULL_H and nets' dtype set by monkeypatching,
    2 members a net, batch 2, JAX's stacks carried into the port's."""
    with pytest.MonkeyPatch.context() as mp:
        for mod, dtype in ((jax_flagship, jnp.float32),
                           (flagship, torch.float32)):
            mp.setattr(mod, "FULL_H", CANVAS_HW[0])
            mp.setattr(mod, "FULL_W", CANVAS_HW[1])
            mp.setattr(mod, "REGION_NET", dict(mod.REGION_NET, dtype=dtype))
            mp.setattr(mod, "SEP_NET", dict(mod.SEP_NET, dtype=dtype))
        mp.setattr(jax_unet, "init_unet", _jit_init)
        jax_built = jax_flagship.build_flagship(
            n_models_per_net=2, batch=2, src_hw=SRC_HW)
        built = flagship.build_flagship(
            n_models_per_net=2, batch=2, src_hw=SRC_HW, device="cpu")
        _, (ja, jb, _) = jax_built
        _, (sa, sb, _) = built
        _carry(ja, sa, ["TEXT", "TABULAR", "ILLUSTRATION", "BACKGROUND"])
        _carry(jb, sb, ["H", "V", "T", "BACKGROUND"])
        # both graphs read the canvas at call time
        want = [np.asarray(x) for x in jax.jit(jax_built[0])(*jax_built[1])]
        got = [x.numpy() for x in built[0](*built[1])]
    return jax_built, built, want, got


def _carry(stack, members, classes):
    """JAX's stacked params -> the port's members, one a leading index."""
    for i, member in enumerate(members):
        tree = jax.tree.map(lambda x: np.asarray(x[i]), stack)
        member.load_state_dict(registry.unet_params_from_flax(
            tree, {"classes": classes}))


def test_labels_equal_jax(both_flagships):
    _, _, want, got = both_flagships
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2,) + CANVAS_HW
        assert g.dtype == np.uint8
        assert float((g == w).mean()) >= 0.999


def test_members_are_one_init_copied():
    _, (sa, sb, _) = flagship.build_flagship(
        n_models_per_net=3, batch=1, src_hw=(8, 8), device="cpu")
    _, (sa2, _, _) = flagship.build_flagship(
        n_models_per_net=1, batch=1, src_hw=(8, 8), device="cpu")
    for stack, n_features in ((sa, 128), (sb, 64)):
        assert len(stack) == 3 and len({id(m) for m in stack}) == 3
        assert stack[0].features[0] == n_features
        first = stack[0].state_dict()
        for m in stack[1:]:
            for k, v in m.state_dict().items():
                assert torch.equal(v, first[k]), k
    # the generator is seeded: every build gives the same net
    for k, v in sa2[0].state_dict().items():
        assert torch.equal(v, sa[0].state_dict()[k]), k


def test_images_equal_jax(both_flagships):
    (_, (_, _, jimages)), (_, (_, _, images)), _, _ = both_flagships
    assert images.dtype == torch.float32
    assert tuple(images.shape) == (2,) + SRC_HW
    np.testing.assert_array_equal(images.numpy(), np.asarray(jimages))
