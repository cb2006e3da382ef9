"""models/unet.py against origami_tpu/models/unet.py on the CPU, with
flax-initialised parameters carried across by
registry.unet_params_from_flax.

Both sides run in float32. Tolerance: the logits agree within 1e-4 of
the logits' largest magnitude (the convolutions and GroupNorm sum in
another order; flax takes the variance as E[x^2] - E[x]^2); summed
ensemble probabilities within 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from origami_tpu.models import unet as jax_unet
from origami_tpu_torch.models import registry, unet

META = {"classes": ["A", "B", "C", "D"]}
# (s2d, features, bottleneck, input (H, W))
NETS = [(1, (8, 16), 16, (32, 48)),
        (2, (8, 16), 16, (64, 48)),
        (4, (16, 8, 24), 16, (128, 96))]


def flax_net(s2d, features, bottleneck, hw, seed):
    model = jax_unet.create_unet(4, dtype=jnp.float32, s2d=s2d,
                                 features=features, bottleneck=bottleneck)
    params = jax_unet.init_unet(model, jax.random.PRNGKey(seed), hw)
    # flax initialises GroupNorm to scale 1, bias 0 and the head's bias
    # to 0: perturb every leaf so a swapped or dropped one shows
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.1 * rng.standard_normal(x.shape)
        .astype(np.float32), params)
    return model, params


def torch_net(params, s2d, features, bottleneck):
    net = unet.create_unet(4, dtype=torch.float32, s2d=s2d,
                           features=features, bottleneck=bottleneck)
    net.load_state_dict(registry.unet_params_from_flax(params, META),
                        strict=True)
    return net.eval()


@pytest.mark.parametrize("s2d,features,bottleneck,hw", NETS)
def test_logits_match_flax(s2d, features, bottleneck, hw):
    model, params = flax_net(s2d, features, bottleneck, hw, seed=s2d)
    net = torch_net(params, s2d, features, bottleneck)
    x = np.random.default_rng(0).random((2,) + hw + (1,)).astype(np.float32)
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2,) + hw + (4,)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_two_member_ensemble_matches_flax():
    s2d, features, bottleneck, hw = NETS[1]
    members = [flax_net(s2d, features, bottleneck, hw, seed=s)
               for s in (5, 6)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs),
                           *[p for _, p in members])
    x = np.random.default_rng(1).random((3,) + hw + (1,)).astype(np.float32)
    ref = np.asarray(jax_unet.ensemble_apply(members[0][0], stacked,
                                             jnp.asarray(x)))
    nets = [torch_net(p, s2d, features, bottleneck) for _, p in members]
    got = unet.ensemble_apply(nets, torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-5
    np.testing.assert_allclose(got.sum(-1), 2.0, atol=1e-5)


@pytest.mark.parametrize("width,s2d", [(1.0, 1), (0.125, 1), (2.0, 4),
                                       (1.0, 2), (0.25, 2)])
def test_create_unet_widths_match(width, s2d):
    ref = jax_unet.create_unet(4, width=width, s2d=s2d)
    got = unet.create_unet(4, width=width, s2d=s2d)
    assert got.features == tuple(ref.features)
    assert got.mid.convs[0].out_channels == ref.bottleneck


def test_bf16_mode_runs_and_stays_close():
    s2d, features, bottleneck, hw = NETS[1]
    _, params = flax_net(s2d, features, bottleneck, hw, seed=9)
    f32 = torch_net(params, s2d, features, bottleneck)
    bf16 = unet.create_unet(4, dtype=torch.bfloat16, s2d=s2d,
                            features=features, bottleneck=bottleneck)
    bf16.load_state_dict(f32.state_dict(), strict=True)
    x = torch.from_numpy(
        np.random.default_rng(2).random((1,) + hw + (1,)).astype(np.float32))
    with torch.no_grad():
        a, b = f32(x), bf16.eval()(x)
    assert b.dtype == torch.float32
    # bf16 keeps 8 bits of mantissa through ten convolutions
    assert (a - b).abs().max() <= 0.1 * a.abs().max()


def test_rejects_other_trees_and_channels():
    _, params = flax_net(*NETS[0], seed=0)
    with pytest.raises(ValueError):
        registry.unet_params_from_flax(dict(params, Dense_0={}), META)
    with pytest.raises(ValueError):
        registry.unet_params_from_flax(params, {"classes": ["A"]})
    with pytest.raises(ValueError):
        unet.create_unet(4, s2d=2, in_channels=3)
