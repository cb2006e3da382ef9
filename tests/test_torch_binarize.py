"""The port's binarization (ops/binarize.py, core/binarize.py,
Page.binarized) against the JAX package, both on the CPU.

On the CPU the port's wrappers run their plain versions, which repeat
the CUDA kernel's arithmetic: exact integer box sums, then the float32
formula. Tolerances, each with its reason:

  * border "zero" vs sauvola_pallas(interpret=True), whole image: the
    Pallas kernel sums in float32; at window 15 its sums stay below 2^24
    and are exact, so >= 99.99 % of pixels must agree (what is left is
    the rounding of s2 / n - m^2 done in another order); at window 31 its
    sums of squares pass 2^24 and round: >= 99.9 %;
  * border "clamp" vs ops.binarize.sauvola: JAX takes its box sums from
    float32 integral images of the whole page, whose differences carry
    rounding error that grows with the page: >= 99.9 %, the bar of the
    JAX package's own tests/test_pallas.py;
  * bit packing and Otsu: exact.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from origami_tpu.core import binarize as jax_core_binarize
from origami_tpu.core.page import Page as JaxPage
from origami_tpu.ops import binarize as jax_binarize
from origami_tpu.ops.pallas.sauvola import sauvola_pallas
from origami_tpu_torch.core import binarize as core_binarize
from origami_tpu_torch.core.page import Page
from origami_tpu_torch.ops import binarize

ROOT = Path(__file__).resolve().parent.parent
FULL = ROOT / "tests/data/torch_ocr/full"
REF = ROOT / "tests/data/torch_segment/ref"
SIZES = [(197, 251), (256, 384), (64, 75)]


def page_like(seed, h, w):
    """Paper-like u8 image: bright noisy background, dark text-like
    runs, a flat patch and a dark border strip."""
    rng = np.random.default_rng(seed)
    img = rng.integers(200, 256, (h, w)).astype(np.uint8)
    for y in range(8, h - 8, 14):
        xs = rng.random(w) < 0.6
        img[y: y + 7, xs] = rng.integers(5, 90)
    img[h // 3: h // 3 + 20, w // 4: w // 4 + 40] = 231
    img[:, :3] = 12
    return img


@pytest.mark.parametrize("window", [15, 31])
@pytest.mark.parametrize("hw", SIZES)
def test_sauvola_zero_border_matches_pallas(hw, window):
    img = page_like(1, *hw)
    ref = np.asarray(sauvola_pallas(jnp.asarray(img), window,
                                    interpret=True)) > 0
    got = binarize.sauvola(torch.from_numpy(img), window,
                           border="zero").numpy()
    assert got.dtype == bool and got.shape == ref.shape
    assert (got == ref).mean() >= (0.9999 if window == 15 else 0.999)


@pytest.mark.parametrize("window", [15, 31])
@pytest.mark.parametrize("hw", SIZES)
def test_sauvola_clamp_border_matches_xla(hw, window):
    img = page_like(2, *hw)
    ref = np.asarray(jax_binarize.sauvola(jnp.asarray(img), window))
    got = binarize.sauvola(torch.from_numpy(img), window).numpy()
    assert (got == ref).mean() >= 0.999
    thr = np.asarray(jax_binarize.sauvola_threshold(jnp.asarray(img),
                                                    window))
    mine = binarize.sauvola_threshold(torch.from_numpy(img), window).numpy()
    # float32 integral images over a small image: a few 1e-2 gray levels
    assert np.abs(thr - mine).max() < 0.25


@pytest.mark.parametrize("hw,window", [((256, 384), 33), ((256, 384), 41),
                                       ((256, 384), 63), ((256, 384), 101),
                                       ((256, 384), 259), ((197, 251), 513)])
def test_sauvola_clamp_border_any_window_matches_xla(hw, window):
    # windows past the earlier limit of 31; 259 needs 64-bit sums on the
    # card (its box's sum of squares passes 2^32); 513 is larger than the
    # image, so every box is the whole image
    img = page_like(6, *hw)
    ref = np.asarray(jax_binarize.sauvola(jnp.asarray(img), window))
    got = binarize.sauvola(torch.from_numpy(img), window).numpy()
    assert got.shape == ref.shape
    assert (got == ref).mean() >= 0.999
    packed = binarize.sauvola_packed(torch.from_numpy(img), window).numpy()
    np.testing.assert_array_equal(packed, np.packbits(got, axis=1))


@pytest.mark.parametrize("window", [33, 63])
def test_sauvola_zero_border_wide_window_matches_pallas(window):
    img = page_like(7, *SIZES[-1])
    ref = np.asarray(sauvola_pallas(jnp.asarray(img), window,
                                    interpret=True)) > 0
    got = binarize.sauvola(torch.from_numpy(img), window,
                           border="zero").numpy()
    # the Pallas kernel's float32 sums of squares pass 2^24 and round
    assert (got == ref).mean() >= 0.999


@pytest.mark.parametrize("page", ["synth0000", "synth0001"])
def test_sauvola_packed_on_fixture_page_matches_stored_jax(page):
    ref = np.load(REF / (page + ".sauvola15.npz"))["packed"]
    pg = Page(FULL / (page + ".png"), device="cpu")
    got = binarize.sauvola_packed(pg.device_pixels, 15).numpy()
    assert got.shape == ref.shape and got.dtype == np.uint8
    w = pg.size()[0]
    a = np.unpackbits(got, axis=1)[:, :w]
    b = np.unpackbits(ref, axis=1)[:, :w]
    assert (a == b).mean() >= 0.999
    np.testing.assert_array_equal(pg.binarized, a.astype(bool))
    assert pg.binarized is Page(FULL / (page + ".png"),
                                device="cpu").binarized   # the LRU


@pytest.mark.parametrize("hw", [(5, 8), (7, 13), (3, 1), (40, 251)])
def test_pack_bits_is_numpy_packbits(hw):
    rng = np.random.default_rng(3)
    mask = rng.random(hw) < 0.5
    packed = binarize.pack_bits(torch.from_numpy(mask))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.packbits(mask, axis=1))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jax_binarize.pack_bits(jnp.asarray(mask))))
    np.testing.assert_array_equal(
        binarize.unpack_bits(packed, hw[1]).numpy(), mask)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_otsu_threshold_matches_jax(seed):
    img = page_like(seed, 120, 160)
    ref = float(jax_binarize.otsu_threshold(jnp.asarray(img)))
    assert float(binarize.otsu_threshold(torch.from_numpy(img))) == ref
    np.testing.assert_array_equal(
        binarize.otsu(torch.from_numpy(img)).numpy(),
        np.asarray(jax_binarize.otsu(jnp.asarray(img))))


@pytest.mark.parametrize("spec", ["sauvola(window_size=15)", "otsu",
                                  "sauvola(31, k=0.3)",
                                  "sauvola(window_size=41)"])
def test_from_string_matches_jax(spec):
    img = page_like(5, 90, 130)
    ref = jax_core_binarize.from_string(spec)(img)
    got = core_binarize.from_string(spec, device="cpu")(img)
    assert got.dtype == np.uint8 and set(np.unique(got)) <= {0, 255}
    assert (got == ref).mean() >= 0.999


def test_wrapper_rejects_what_the_kernel_does_not_take():
    img = torch.zeros((8, 8), dtype=torch.uint8)
    with pytest.raises(TypeError):
        binarize.sauvola(img.float(), 15)
    with pytest.raises(ValueError):
        binarize.sauvola(img, 14)
    for window in (0, -1, -15):
        with pytest.raises(ValueError):
            binarize.sauvola_packed(img, window)
    # any odd window runs, also past the earlier limit of 31
    np.testing.assert_array_equal(
        binarize.sauvola_packed(img, 33).numpy(),
        binarize.sauvola_packed_plain(img, 33).numpy())
    with pytest.raises(ValueError):
        binarize.sauvola(img, 15, border="edge")
    with pytest.raises(ValueError):
        core_binarize.from_string("niblack")
    assert binarize.launches == {"sauvola": 0, "sauvola_packed": 0}


def test_page_binarized_matches_jax_page():
    png = FULL / "synth0001.png"
    ref = JaxPage(png).binarized
    got = Page(png, device="cpu").binarized
    assert got.dtype == bool and got.shape == ref.shape
    assert (got == ref).mean() >= 0.999
