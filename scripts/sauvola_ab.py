#!/usr/bin/env python3
"""The Sauvola kernel alone on one CUDA card: its check, then an A/B of
band heights.

    python3 scripts/sauvola_ab.py [--parent DIR] [--extra NAME=FILE ...]

Builds the kernel library (origami_tpu_torch/ops/_build.py; prints
ptxas' registers and spills for csrc/sauvola.cu) and runs
`chip_smoke.check_sauvola` on both fixture pages (tests/data/torch_ocr/
full) and their dewarped pages: every window, output and border held
bit-equal against the plain version, and the main path's rows timed.

Then builds csrc/sauvola.cu into one library per variant under
build/sauvola_ab/, each with one line of it changed:

  * "kernel": as committed (one wave of bands from the SM count, at
    least MIN_BAND = 32 rows);
  * "min16": the same rule with bands of at least 16 rows;
  * "band32", "band128": fixed bands of 32 and 128 rows (more than one
    wave where the page needs it);
  * "mb3", "mb4": the committed rule with registers capped so that 3 or
    4 blocks fit an SM (__launch_bounds__' second argument);
  * "parent": DIR/origami_tpu_torch/csrc/sauvola.cu, a checkout of an
    earlier commit, where --parent is given (a kernel that refuses a
    window shows "n/a" there);
  * NAME: each --extra NAME=FILE, another sauvola.cu to time beside.

On the first page, each variant must equal the plain version on every
A/B case (packed w15 and mask w31 on the page: the main path; packed
w41 on the dewarped page: the layout stage's window; packed w63 and
w259 on the page); then each is timed in turns, variants in order and
then reversed: CUDA events of one launch (median of 20), device time
(torch.profiler, 20 launches) and back to back (50 launches between two
events). Prints the card's name and power limit and one line per (case,
variant) with both turns' times in ms. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# each variant: (line of csrc/sauvola.cu, its replacement)
MIN_BAND = "constexpr int MIN_BAND = 32;"
BAND = "  band = max(band, MIN_BAND);"
BOUNDS = "__global__ void __launch_bounds__(NT)"
VARIANTS = {"kernel": None,
            "min16": (MIN_BAND, "constexpr int MIN_BAND = 16;"),
            "band32": (BAND, "  band = 32;"),
            "band128": (BAND, "  band = 128;"),
            "mb3": (BOUNDS, "__global__ void __launch_bounds__(NT, 3)"),
            "mb4": (BOUNDS, "__global__ void __launch_bounds__(NT, 4)")}
# (image, output, window, border)
CASES = (("page", "sauvola_packed", 15, "clamp"),
         ("page", "sauvola", 31, "clamp"),
         ("dew", "sauvola_packed", 41, "clamp"),
         ("page", "sauvola_packed", 63, "clamp"),
         ("page", "sauvola_packed", 259, "clamp"))


def variants(src):
    """{name: source text} of the A/B."""
    out = {}
    for name, change in VARIANTS.items():
        if change is None:
            out[name] = src
            continue
        old, new = change
        if src.count(old) != 1:
            raise SystemExit("sauvola.cu no longer has the line:\n" + old)
        out[name] = src.replace(old, new)
    return out


def build(sources, out_dir):
    """Compile each source text into its own library, all nvcc processes
    started together; -> {name: loaded library}."""
    from origami_tpu_torch.ops import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = out_dir / (name + ".cu")
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.ARCH, "-std=c++17", "-O3", "-fmad=false",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared", str(cu),
             "-o", str(out_dir / (name + ".so"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit("nvcc failed for %s:\n%s" % (name, log))
        regs = [line.split("info    :")[-1].strip()
                for line in log.splitlines() if "registers" in line]
        print("built %-8s %s" % (name, " | ".join(regs)), flush=True)
        lib = ctypes.CDLL(str(out_dir / (name + ".so")))
        fn = lib.origami_sauvola_u8
        fn.argtypes = _build.SIGNATURES["origami_sauvola_u8"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="checkout of an earlier commit to time beside")
    ap.add_argument("--extra", action="append", default=[],
                    metavar="NAME=FILE",
                    help="another sauvola.cu to time beside (repeatable)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sauvola_ab: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from origami_tpu_torch.ops import _build
    from origami_tpu_torch.ops import binarize as ops
    from origami_tpu_torch.ops import remap
    smi = cs.smi_line()
    print(smi, flush=True)
    for line in _build.build(force=True).split("== ")[1:]:
        if line.startswith("sauvola.cu"):
            print("\n".join("  " + ln.strip() for ln in line.splitlines()
                            if "registers" in ln or "spill" in ln
                            or "sauvola_kernel" in ln), flush=True)
    _build.library()
    dev = torch.device("cuda")
    images = []
    for png in sorted(cs.FIXTURE.glob("*.png")):
        page = cs.page_groups(png, dev, "banded")[1].page
        px = page.device_pixels
        hv = torch.from_numpy(page.grid.points("sample")).to(dev)
        images.append((px, remap.dewarp_u8(px, hv, page.grid.resolution)))
    print("== check_sauvola", flush=True)
    try:
        cs.check_sauvola(images)
    except cs.PhaseError as e:
        print("sauvola_ab: FAILED: %s" % e, file=sys.stderr)
        return 1

    src = ROOT / "origami_tpu_torch" / "csrc" / "sauvola.cu"
    sources = variants(src.read_text())
    if args.parent is not None:
        sources["parent"] = (args.parent / "origami_tpu_torch" / "csrc"
                             / "sauvola.cu").read_text()
    for spec in args.extra:
        name, _, path = spec.partition("=")
        sources[name] = Path(path).read_text()
    libs = build(sources, ROOT / "build" / "sauvola_ab")
    print("== A/B (%s)" % smi, flush=True)

    def stream():
        return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())

    px, dew = images[0]
    failed = []
    for label, name, window, border in CASES:
        img = px if label == "page" else dew
        h, w = img.shape
        packed = name == "sauvola_packed"
        plain = (ops.sauvola_packed_plain if packed else ops.sauvola_plain)(
            img, window, border=border).to(torch.uint8)
        runs = {}
        for vname, fn in libs.items():
            out = torch.empty_like(plain)
            call = (img.data_ptr(), h, w, window, 0.2, 128.0,
                    1 if border == "clamp" else 0, int(packed),
                    out.data_ptr())
            if fn(*call, stream()) != 0:
                runs[vname] = None
                continue

            def run(fn=fn, call=call):
                if fn(*call, stream()) != 0:
                    raise RuntimeError("launch failed")

            torch.cuda.synchronize()
            err = int((out.int() - plain.int()).abs().max())
            if err:
                failed.append("%s w%d %s: max|diff| %d"
                              % (name, window, vname, err))
            runs[vname] = run
        bound, _ = cs.sauvola_bound(img, plain)
        times = {v: [] for v in libs}
        order = list(libs)
        for vname in order + order[::-1]:
            run = runs[vname]
            if run is not None:
                times[vname].append((cs.time_cuda(run),
                                     cs.device_ms(run, reps=20),
                                     cs.time_burst(run, 50)))
        for vname, rows in times.items():
            print("%-14s w%-3d %-4s %-8s events %s | device %s | back to "
                  "back %s | bound %.5f" % (
                      name, window, label, vname,
                      " ".join("%.4f" % r[0] for r in rows) or "n/a",
                      " ".join(cs.fmt_ms(r[1]).replace(" ms", "")
                               for r in rows) or "n/a",
                      " ".join("%.4f" % r[2] for r in rows) or "n/a",
                      bound), flush=True)
    if failed:
        print("sauvola_ab: FAILED: %s" % "; ".join(failed), file=sys.stderr)
        return 1
    print("every variant equal to the plain version (max |diff| 0)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
