#!/usr/bin/env python3
"""A/B of design choices in the strip kernels, on one CUDA card.

    python3 scripts/strips_ab.py

Builds origami_tpu_torch/csrc/strips.cu as it is ("kernel") and two
variants of it, each into its own library under build/strips_ab/:

  * "staged": mode (a) stages each tile's page window (the taps of its
    valid pixels, exact: the coordinates are monotone along x and y) in
    12 KB of shared memory, with a row pitch of 4 mod 8 bytes so a
    warp's byte reads spread over the banks, and its interior chunks
    read their taps there instead of through __ldg;
  * "no_interior": mode (a) without its interior path (every chunk
    takes the clamped, fill-selecting taps).

On both fixture pages (tests/data/torch_ocr/full) and for each mode,
every variant's page-level launch over the main path's strip groups must
equal the plain version (max |diff| 0); then each is timed, in turns
kernel, staged, no_interior, no_interior, staged, kernel: CUDA events
of one launch (median of 20), device time (torch.profiler, 20 launches)
and back to back (50 launches between two events). Prints the card's
name and power limit and one line per (mode, variant) with every turn's
times, in ms per page. Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# the staged variant: mode (a)'s window, and the interior path reading it
STAGE_SETUP = (
    """  const int x0 = blockIdx.x * TILE_W + threadIdx.x * CHUNK;
  const int count = min(CHUNK, sw - x0);
  if (count <= 0) return;  // the tile (or this chunk) is past the strip
""",
    """  const int tx0 = blockIdx.x * TILE_W, ty0 = blockIdx.y * TILE_H;
  if (tx0 >= sw) return;
  const int x0 = tx0 + threadIdx.x * CHUNK;
  const int count = min(CHUNK, sw - x0);
""")
STAGE_WINDOW = (
    """  const int y_end = min(out_h, (int)(blockIdx.y + 1) * TILE_H);
  for (int y = blockIdx.y * TILE_H + threadIdx.y; y < y_end;
       y += THREADS_Y) {
    uint32_t word[4];
    if ((float)x0 >= wf) {""",
    """  const int y_end = min(out_h, (int)(blockIdx.y + 1) * TILE_H);
  __shared__ uint8_t win[12288];
  const int xe = min(min(tx0 + TILE_W, sw), (int)wf) - 1;
  const int ye = y_end - 1;
  int wx0 = 0, wy0 = 0, ww = 0, wh = 0, pitch = 0;
  if (tx0 <= xe && ty0 <= ye) {
    float mnx = 1e30f, mxx = -1e30f, mny = 1e30f, mxy = -1e30f;
    for (int c = 0; c < 4; ++c) {
      const float xf = (float)((c & 1) ? xe : tx0);
      const float yf = (float)((c & 2) ? ye : ty0);
      const float a1y = a1 * yf, b1y = b1 * yf;
      const float px = fminf(fmaxf(a0 * xf + a1y + a2, -2.0f), xhi + 2.0f);
      const float py = fminf(fmaxf(b0 * xf + b1y + b2, -2.0f), yhi + 2.0f);
      mnx = fminf(mnx, px); mxx = fmaxf(mxx, px);
      mny = fminf(mny, py); mxy = fmaxf(mxy, py);
    }
    wx0 = max((int)floorf(mnx), 0);
    wy0 = max((int)floorf(mny), 0);
    ww = min((int)floorf(mxx) + 1, w - 1) - wx0 + 1;
    wh = min((int)floorf(mxy) + 1, h - 1) - wy0 + 1;
    pitch = ((ww + 7) & ~7) + 4;
  }
  const bool staged = ww > 0 && wh > 0 && pitch * wh <= 12288;
  if (staged) {
    const int tid = threadIdx.y * THREADS_X + threadIdx.x;
    for (int r = tid / 32; r < wh; r += THREADS_X * THREADS_Y / 32)
      for (int c = tid % 32; c < ww; c += 32)
        win[r * pitch + c] = __ldg(dew + (wy0 + r) * w + wx0 + c);
    __syncthreads();
  }
  if (count <= 0) return;
  for (int y = blockIdx.y * TILE_H + threadIdx.y; y < y_end;
       y += THREADS_Y) {
    uint32_t word[4];
    if ((float)x0 >= wf) {""")
STAGE_TAPS = (
    """          const uint8_t* r0 = dew + (int)fy * w + (int)fx;
          const float top = (float)__ldg(r0) * (1.0f - tx) +
                            (float)__ldg(r0 + 1) * tx;
          const float bot = (float)__ldg(r0 + w) * (1.0f - tx) +
                            (float)__ldg(r0 + w + 1) * tx;""",
    """          float top, bot;
          if (staged && count == CHUNK) {
            const uint8_t* r0 = win + ((int)fy - wy0) * pitch + (int)fx - wx0;
            top = (float)r0[0] * (1.0f - tx) + (float)r0[1] * tx;
            bot = (float)r0[pitch] * (1.0f - tx) +
                  (float)r0[pitch + 1] * tx;
          } else {
            const uint8_t* r0 = dew + (int)fy * w + (int)fx;
            top = (float)__ldg(r0) * (1.0f - tx) + (float)__ldg(r0 + 1) * tx;
            bot = (float)__ldg(r0 + w) * (1.0f - tx) +
                  (float)__ldg(r0 + w + 1) * tx;
          }""")
INTERIOR_START = "      if (xb < wf && pxa >= 0.0f && pxb < wi && pya >= 0.0f &&"
INTERIOR_END = "        continue;\n      }\n"


def variants(src):
    """{name: source} of the A/B."""
    staged = src
    for old, new in (STAGE_SETUP, STAGE_WINDOW, STAGE_TAPS):
        if staged.count(old) != 1:
            raise SystemExit("strips.cu no longer has the anchor:\n" + old)
        staged = staged.replace(old, new)
    i = src.index(INTERIOR_START)
    j = src.index(INTERIOR_END, i) + len(INTERIOR_END)
    return {"kernel": src, "staged": staged, "no_interior": src[:i] + src[j:]}


def build(sources, out_dir):
    """Compile each source into its own library, all nvcc processes
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
        print("built %-12s %s" % (name, " | ".join(regs)), flush=True)
        lib = ctypes.CDLL(str(out_dir / (name + ".so")))
        for fn, argtypes in _build.SIGNATURES.items():
            if fn.startswith("origami_strips"):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    import torch
    if not torch.cuda.is_available():
        print("strips_ab: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from origami_tpu_torch.ops import remap as ops
    src = (ROOT / "origami_tpu_torch" / "csrc" / "strips.cu").read_text()
    libs = build(variants(src), ROOT / "build" / "strips_ab")
    print(cs.smi_line(), flush=True)
    dev = torch.device("cuda")

    def stream():
        return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())

    times = {}
    failed = []
    for png in sorted(cs.FIXTURE.glob("*.png")):
        groups, reader, _, _ = cs.page_groups(png, dev, "banded")
        page = reader.page
        px = page.device_pixels
        hv = torch.from_numpy(page.grid.points("sample")).to(dev)
        res = float(page.grid.resolution)
        dew = ops.dewarp_u8(px, hv, int(res))
        gh, gw = hv.shape[:2]
        for mode, sg, img in (
                ("a", groups, dew),
                ("b", cs.page_groups(png, dev, "gather")[0], px)):
            fr, wd, desc, end, max_w = cs.strip_page_args(sg)
            want = torch.zeros(end, dtype=torch.uint8, device=dev)
            if mode == "a":
                ops.strips_dewarped_page_plain(dew, fr, wd, desc, want, 48)
            else:
                ops.strips_through_grid_page_plain(px, hv, res, fr, wd, desc,
                                                   want, 48)
            h, w = img.shape
            runs = {}
            for name, lib in libs.items():
                out = torch.zeros(end, dtype=torch.uint8, device=dev)
                if mode == "a":
                    args = (lib.origami_strips_dewarped, img.data_ptr(), h, w,
                            fr.data_ptr(), wd.data_ptr(), desc.data_ptr(),
                            len(fr), 48, max_w, 255.0, out.data_ptr(), end)
                else:
                    args = (lib.origami_strips_through_grid, img.data_ptr(),
                            h, w, hv.data_ptr(), gh, gw, res, fr.data_ptr(),
                            wd.data_ptr(), desc.data_ptr(), len(fr), 48,
                            max_w, 255.0, out.data_ptr(), end)

                def run(args=args):
                    if args[0](*args[1:], stream()) != 0:
                        raise RuntimeError("launch failed")

                run()
                torch.cuda.synchronize()
                err = int((out.int() - want.int()).abs().max())
                if err:
                    failed.append("%s mode %s %s: max|diff| %d"
                                  % (png.stem, mode, name, err))
                runs[name] = run
            order = list(libs)
            for name in order + order[::-1]:
                run = runs[name]
                times.setdefault((mode, name), []).append(
                    (png.stem, cs.time_cuda(run), cs.device_ms(run, reps=20),
                     cs.time_burst(run, 50)))
    for (mode, name), rows in sorted(times.items()):
        print("mode %s %-12s events %s | device %s | back to back %s" % (
            mode, name, " ".join("%.4f" % r[1] for r in rows),
            " ".join(cs.fmt_ms(r[2]).replace(" ms", "") for r in rows),
            " ".join("%.4f" % r[3] for r in rows)), flush=True)
    print("turns per line: page %s x2, then page %s x2" % tuple(
        sorted(p.stem for p in cs.FIXTURE.glob("*.png"))))
    if failed:
        print("strips_ab: FAILED: %s" % "; ".join(failed), file=sys.stderr)
        return 1
    print("every variant equal to the plain version (max |diff| 0)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
