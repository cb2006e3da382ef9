"""The port's glyph-atlas renderer (origami_tpu_torch/train/draw.py)
against PIL with raqm, as origami_tpu/train/synth.py draws: for each of
the 71 (font, size) pairs the synthetic corpus reaches, 30 seeded texts
(random_text, table cells of digits, the masthead's capitalised words and
strings over the whole charset, f-ligatures among them) drawn at whole
and half-pixel starts. textlength must equal PIL's float, textbbox its
box and text every pixel. Then the lines, the frame and the paste of
synth.py against PIL, and the atlas's refusal of what it lacks.
"""

import numpy as np
import PIL.Image
import PIL.ImageDraw
import pytest

from origami_tpu.train import synth as jax_synth
from origami_tpu_torch.train import draw

PAIRS = [(k, s) for k, sizes in draw.FONT_SIZES.items() for s in sizes]
TEXTS_A_PAIR = 30


def _texts(rng):
    out = []
    for i in range(TEXTS_A_PAIR):
        r = i % 6
        if r == 0:
            out.append(str(rng.integers(0, 10000)))
        elif r == 1:
            out.append(" ".join(jax_synth.random_word(rng, capital=True)
                                for _ in range(2)))
        elif r == 2:
            out.append("".join(rng.choice(list(draw.CHARSET),
                                          int(rng.integers(1, 14)))))
        elif r == 3:
            out.append(" ".join(["kaufland", "Kauffrau", "fliff", "ffi",
                                 "schaft"][int(rng.integers(0, 5))]
                                for _ in range(3)))
        else:
            out.append(jax_synth.random_text(rng))
    return out


def test_pairs_are_those_synth_draws():
    assert len(PAIRS) == 71
    assert set(draw.FONT_SIZES) == {"serif", "serif_bold", "sans"}


@pytest.mark.parametrize("kind,size", PAIRS)
def test_text_equals_pil(kind, size):
    rng = np.random.default_rng(size * 7 + len(kind))
    pf = jax_synth._font(kind, size)
    af = draw.font(kind, size)
    for text in _texts(rng):
        x = float(rng.integers(0, 30))
        if rng.random() < 0.5:
            x += int(rng.integers(0, 128)) / 128     # the masthead's starts
        y = int(rng.integers(2 * size, 3 * size))
        w, h = int(pf.getlength(text)) + 60, 4 * size
        img = PIL.Image.new("L", (w, h), 255)
        d = PIL.ImageDraw.Draw(img)
        d.text((x, y), text, font=pf, fill=0, anchor="ls")
        canvas = np.full((h, w), 255, np.uint8)
        dd = draw.Draw(canvas)
        dd.text((x, y), text, font=af, fill=0, anchor="ls")
        assert dd.textlength(text, font=af) == d.textlength(text, font=pf), \
            text
        assert dd.textbbox((x, y), text, font=af, anchor="ls") == \
            d.textbbox((x, y), text, font=pf, anchor="ls"), text
        ref = np.asarray(img)
        assert (canvas != ref).sum() == 0, (text, x, y)


def test_text_blends_over_ink_and_clips():
    """Fill 40 over a seeded background, text running off the canvas on
    the right and the bottom."""
    rng = np.random.default_rng(3)
    bg = rng.integers(0, 256, (30, 90)).astype(np.uint8)
    img = PIL.Image.fromarray(bg.copy())
    canvas = bg.copy()
    for x, y, text in ((5.5, 20, "Haus Berlin"), (60, 29, "Kaufland"),
                       (2, 40, "unter")):
        PIL.ImageDraw.Draw(img).text((x, y), text, fill=40, anchor="ls",
                                     font=jax_synth._font("serif", 17))
        draw.Draw(canvas).text((x, y), text, fill=40, anchor="ls",
                               font=draw.font("serif", 17))
    np.testing.assert_array_equal(canvas, np.asarray(img))


def test_lines_frame_and_paste_equal_pil():
    """synth.py's strokes: axis-aligned lines of width 1 and 2 (seeded
    positions, some off the canvas), the illustration frame of width 2
    and the pasted block, clipped at the bottom."""
    rng = np.random.default_rng(11)
    img = PIL.Image.new("L", (120, 90), 255)
    d = PIL.ImageDraw.Draw(img)
    canvas = np.full((90, 120), 255, np.uint8)
    dd = draw.Draw(canvas)
    for _ in range(20):
        a, b = sorted(int(v) for v in rng.integers(-10, 130, 2))
        c = int(rng.integers(0, 90))
        width = int(rng.integers(1, 3))
        fill = int(rng.integers(0, 80))
        xy = [(a, c), (b, c)] if rng.random() < 0.5 else [(c, a), (c, b)]
        d.line(xy, fill=fill, width=width)
        dd.line(xy, fill=fill, width=width)
    tex = rng.integers(100, 200, (50, 40)).astype(np.uint8)
    img.paste(PIL.Image.fromarray(tex), (70, 60))
    dd.paste(tex, (70, 60))
    d.rectangle([70, 60, 109, 109], outline=60, width=2)
    dd.rectangle([70, 60, 109, 109], outline=60, width=2)
    np.testing.assert_array_equal(canvas, np.asarray(img))


def test_missing_glyph_and_font_raise():
    with pytest.raises(KeyError, match="glyph"):
        draw.font("serif", 15).getlength("Ω")
    with pytest.raises(KeyError, match="sans_bold"):
        draw.font("sans_bold", 15)
    with pytest.raises(KeyError, match="serif at size 50"):
        draw.font("serif", 50)
