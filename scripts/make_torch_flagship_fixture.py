"""Build the flagship-graph reference that the PyTorch port is held
against (chip_smoke.py phase 18a).

Runs the JAX package's flagship graph (origami_tpu/models/flagship.py
`build_flagship`'s `segment`) on the CPU at full width, with the shipped
students' weights (models_pretrained/students: the flagship's nets,
region width 2 s2d 4 and separator width 1 s2d 2 at 1280x2432) stacked
into all 5 members of each net, over the two pages of
tests/data/torch_ocr/full, and writes

    tests/data/torch_flagship/labels.npz   regions_<dtype>, separators_<dtype>:
                                           (2, 2432, 1280) u8 label maps of
                                           synth0000 and synth0001

for dtype float32 (REGION_NET and SEP_NET given dtype=jnp.float32 in the
imported module's namespace) and bfloat16 (the graph as it ships).
Nothing is random: the pages and the weights are files of the
repository. About 3.5 minutes and 4.2 GiB of resident memory on the
CPU.

    JAX_PLATFORMS=cpu python scripts/make_torch_flagship_fixture.py
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("ORIGAMI_TPU_PLATFORM", "cpu")

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PAGES = ("synth0000", "synth0001")
STUDENTS = ROOT / "models_pretrained" / "students"


def student_stacks(n_members):
    """The students' region and separator params, each stacked n times."""
    import jax
    import jax.numpy as jnp
    from origami_tpu.models import registry
    stacks = []
    for group in ("region", "separator"):
        _, params, _ = registry.load_model(STUDENTS / group / "00")
        stacks.append(jax.tree.map(
            lambda x: jnp.stack([x] * n_members), params))
    return stacks


def labels(dtype, images, n_members=5, full_hw=None):
    """JAX's flagship label maps of `images` ((B, H, W) float32) with the
    convolutions in `dtype`; full_hw overrides the canvas (the CPU
    tests' small runs)."""
    import jax
    import numpy as np
    from origami_tpu.models import flagship
    saved = (flagship.REGION_NET, flagship.SEP_NET, flagship.FULL_W,
             flagship.FULL_H)
    flagship.REGION_NET = dict(saved[0], dtype=dtype)
    flagship.SEP_NET = dict(saved[1], dtype=dtype)
    if full_hw is not None:
        flagship.FULL_H, flagship.FULL_W = full_hw
    try:
        # build_flagship initializes random nets at batch 1 to get the
        # graph; the students' stacks replace them
        segment, _ = flagship.build_flagship(n_models_per_net=1, batch=1,
                                             src_hw=(8, 8))
        stack_a, stack_b = student_stacks(n_members)
        reg, sep = jax.jit(segment)(stack_a, stack_b, images)
        return np.asarray(reg), np.asarray(sep)
    finally:
        (flagship.REGION_NET, flagship.SEP_NET, flagship.FULL_W,
         flagship.FULL_H) = saved


def main():
    import jax.numpy as jnp
    import numpy as np
    import PIL.Image
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "tests/data/torch_flagship"))
    args = ap.parse_args()
    images = np.stack([np.asarray(PIL.Image.open(
        ROOT / "tests/data/torch_ocr/full" / (p + ".png")).convert("L"))
        for p in PAGES]).astype(np.float32)
    out = {}
    for name, dtype in (("float32", jnp.float32),
                        ("bfloat16", jnp.bfloat16)):
        t0 = time.time()
        out["regions_" + name], out["separators_" + name] = labels(
            dtype, images)
        print("%s: %.1f s" % (name, time.time() - t0), flush=True)
    Path(args.out).mkdir(parents=True, exist_ok=True)
    np.savez_compressed(Path(args.out) / "labels.npz", **out)
    print("wrote %s" % (Path(args.out) / "labels.npz"))


if __name__ == "__main__":
    main()
