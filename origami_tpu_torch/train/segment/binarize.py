"""Binarized GT corpus generation.

Port of origami_tpu/train/segment/binarize.py: Sauvola over every corpus
image into a sibling bin/ directory, as 1-bit PNGs (PIL's mode "1").
Each page goes through core/binarize.sauvola, the Sauvola CUDA kernel on
the card (one launch a page; an even window takes the next odd one, as
the JAX function's box does, ROADMAP C10). Label PNGs (".labels.") and
pages whose output exists are skipped.

    python -m origami_tpu_torch.train.segment.binarize CORPUS \\
        [--window-size 15] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

from origami_tpu_torch.core import _image, _png
from origami_tpu_torch.core.binarize import sauvola


def gen_binarized(corpus_dir, window_size=15, device=None):
    """Write bin/<name>.png beside `corpus_dir` for each page; `device`
    None is the card. Returns the number of pages written."""
    corpus_dir = Path(corpus_dir)
    bin_dir = corpus_dir.parent / "bin"
    bin_dir.mkdir(exist_ok=True)
    binarize = sauvola(window_size, device=device)
    n = 0
    for img_path in sorted(corpus_dir.glob("*.png")):
        if ".labels." in img_path.name:
            continue
        out = bin_dir / img_path.name
        if out.exists():
            continue
        _png.write_bilevel(out, binarize(_image.read_gray(img_path)) > 0)
        n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m origami_tpu_torch.train.segment.binarize",
        description="Generate the binarized corpus next to CORPUS.")
    p.add_argument("corpus", type=str)
    p.add_argument("--window-size", type=int, default=15)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)
    if not Path(args.corpus).exists():
        raise SystemExit("no such path: %s" % args.corpus)
    n = gen_binarized(args.corpus, args.window_size, args.device)
    print("binarized %d images." % n)


if __name__ == "__main__":
    main()
