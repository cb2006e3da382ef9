#!/usr/bin/env python3
"""A/B of design choices in the f32 sampler of csrc/remap.cu, on one CUDA
card.

    python3 scripts/remap_ab.py [--parent DIR]

Part 1, the kernel's own choices. Builds origami_tpu_torch/csrc/remap.cu
as it is ("kernel") and variants of it, each with one line changed, into
build/remap_ab/:

  * "staged": remap_affine stages each 128 x 32 tile's source window in
    shared memory with cp.async and reads its taps there (the kernel
    reads them through __ldg), with the same quads of 4 pixels and
    16-byte stores;
  * "rows": dewarp_f32 as a row strip: a block of 16 rows x 128 pixels
    builds the upsample tables of its rows and columns (no window), then
    each thread samples quads of 4 pixels through __ldg as the map form
    does, one 16-byte store each (blocks of 8 or 32 rows, and 2 or 4
    quads a thread at once, took as long or 5-10 % longer);
  * "cells4": dewarp_f32 takes tiles of 4 x 4 grid cells and a 48 KB
    window (opted in above 48 KB of shared memory) instead of 2 x 2
    cells and 16 KB; "cells4_quads" the same with 4 adjacent pixels a
    thread and one 16-byte store, as dewarp_u8 takes its u8 quads (the
    kernel: one pixel a thread a step);
  * "f32_ldg": dewarp_f32 stages no window (kF32Window 16 bytes): every
    tile reads its taps through __ldg;
  * "scalar": the map and affine forms read their map and write their
    output one float at a time (vec 0), still 4 pixels a thread.

At the main path's sites, each variant is held against the plain version
(max |diff|; F32_TOL of chip_smoke.py) and timed in turns, variants in
order and then reversed: CUDA events of one launch (median of 20), device
time (torch.profiler, 10 launches) and back to back (20 launches between
two events), the launches made straight through ctypes. The sites:
"affine" (affine_warp as deskew_pair calls it: the 1400x2143 scan
rotated by -0.015 rad), "layout" (the layout stage's separator mask of
each fixture page through the page's grid, dewarp_f32) and "batch"
(remap_batch on 2 x 2432 x 1280 f32 under a warp field of amplitude 10,
hard border: phase 14a's); beside them F.grid_sample on the same
coordinates, built beforehand.

Part 2, with --parent DIR (DIR holds an earlier commit's
origami_tpu_torch/, e.g. `git archive HEAD~1 origami_tpu_torch | tar -x
-C work/parent`): the wrappers at the same sites, the parent's package
and this one each in a process of its own, in turns parent, current,
current, parent: events, device time, host µs a call (200 calls
enqueued back to back) and the kernels and copies a call runs on the
card. At the layout site the parent's composition is
_upsample_grid + torch.stack + remap, this tree's one dewarp_f32; the
same remap on a map built beforehand, dewarp_u8 and sauvola_packed show
the wrappers' shared host path.

Prints the card's name and power limit and one line per (site, variant)
with every turn's times, and writes them to build/remap_ab/results.json.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# the staged affine form: each 128 x 32 output tile's source window (the
# bounding box of its corners' coordinates, the second tap and a pixel of
# margin) copied into shared memory with cp.async where it fits 24 KB,
# the taps read there (through __ldg where a quad's taps leave it)
STAGED_KERNEL = r"""
constexpr int kAffineTileW = 128;     // output tile: 128 x 32 pixels,
constexpr int kAffineTileH = 32;      // a warp per tile row
constexpr int kAffineThreads = 256;
constexpr int kAffineWindow = 24576;  // the staged source window's budget

__device__ __forceinline__ float2 affine_src2(const Affine& a, int col,
                                              int row) {
  float2 s;
  affine_src(a, col, row, s.x, s.y);
  return s;
}

// One image (h, w) through the inverse-map affine to (oh, ow) at the hard
// border (bilinear_sample_xy). aligned: the image's rows are 16-byte
// aligned (cp.async of whole chunks); vec: the output's rows are (float4
// stores).
__global__ void __launch_bounds__(kAffineThreads)
    remap_affine_kernel(const float* __restrict__ img, int h, int w,
                        Affine a, int oh, int ow, float fill, int aligned,
                        int vec, float* __restrict__ out,
                        int* __restrict__ staged_tiles) {
  __shared__ __align__(16) float window[kAffineWindow / 4];
  __shared__ int win[5];                    // x0, y0, x1, y1, staged
  const int tid = threadIdx.x;
  const int ox0 = blockIdx.x * kAffineTileW, oy0 = blockIdx.y * kAffineTileH;
  const int tw = min(kAffineTileW, ow - ox0), th = min(kAffineTileH, oh - oy0);

  if (tid == 0) {
    // the corners' source coordinates and their bounding box
    float mnx = 0.0f, mxx = 0.0f, mny = 0.0f, mxy = 0.0f;
    bool finite = true;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float2 s = affine_src2(a, ox0 + ((c & 1) ? tw - 1 : 0),
                            oy0 + ((c & 2) ? th - 1 : 0));
      finite = finite && isfinite(s.x) && isfinite(s.y);
      mnx = c ? fminf(mnx, s.x) : s.x;
      mxx = c ? fmaxf(mxx, s.x) : s.x;
      mny = c ? fminf(mny, s.y) : s.y;
      mxy = c ? fmaxf(mxy, s.y) : s.y;
    }
    int2 rx = tap_range(mnx, mxx, w, false);
    int2 ry = tap_range(mny, mxy, h, false);
    if (aligned) {                          // whole 16-byte chunks
      rx.x &= ~3;
      rx.y = min((rx.y + 4) & ~3, w) - 1;
    }
    long bytes = 4L * (rx.y - rx.x + 1) * (ry.y - ry.x + 1);
    win[0] = rx.x;
    win[1] = ry.x;
    win[2] = rx.y;
    win[3] = ry.y;
    win[4] = finite && bytes <= kAffineWindow;
    if (staged_tiles && win[4]) atomicAdd(staged_tiles, 1);
  }
  __syncthreads();
  const int wx0 = win[0], wy0 = win[1], wx1 = win[2], wy1 = win[3];
  const bool staged = win[4];
  const int ww = wx1 - wx0 + 1;
  if (staged) {
    const int nrows = wy1 - wy0 + 1;
    if (aligned) {
      const int chunks = ww >> 2;
      for (int i = tid; i < chunks * nrows; i += kAffineThreads) {
        int r = i / chunks, c = (i - r * chunks) << 2;
        cp_async16(window + r * ww + c, img + (size_t)(wy0 + r) * w + wx0 + c);
      }
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 0;\n" ::);
    } else {
      for (int i = tid; i < ww * nrows; i += kAffineThreads) {
        int r = i / ww, c = i - r * ww;
        window[i] = __ldg(img + (size_t)(wy0 + r) * w + wx0 + c);
      }
    }
  }
  __syncthreads();

  const float wmax = (float)(w - 1), hmax = (float)(h - 1);
  const int c4 = (tid & 31) << 2;
  if (c4 >= tw) return;
  for (int r = tid >> 5; r < th; r += kAffineThreads / 32) {
    const int y = oy0 + r, x = ox0 + c4;
    const int n = min(4, tw - c4);
    // the quad's coordinates and tap indices first, then its 16 taps
    // from one place: the window when all lie in it, else __ldg
    float tx[4], ty[4], v[4][4];
    int xa[4], xb[4], ya[4], yb[4];
    bool inb[4], all_in = staged;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // past a ragged row end: the row's last pixel again (not stored)
      float2 s = affine_src2(a, x + min(k, n - 1), y);
      float fx = floorf(s.x), fy = floorf(s.y);
      tx[k] = s.x - fx;
      ty[k] = s.y - fy;
      int x0 = (int)fminf(fmaxf(fx, -1.0f), (float)w);
      int y0 = (int)fminf(fmaxf(fy, -1.0f), (float)h);
      xa[k] = min(max(x0, 0), w - 1);
      xb[k] = min(max(x0 + 1, 0), w - 1);
      ya[k] = min(max(y0, 0), h - 1);
      yb[k] = min(max(y0 + 1, 0), h - 1);
      inb[k] = s.x >= 0.0f && s.x <= wmax && s.y >= 0.0f && s.y <= hmax;
      all_in = all_in && xa[k] >= wx0 && xb[k] <= wx1 && ya[k] >= wy0 &&
               yb[k] <= wy1;
    }
    if (all_in) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r0 = (ya[k] - wy0) * ww - wx0;
        const int r1 = (yb[k] - wy0) * ww - wx0;
        v[k][0] = window[r0 + xa[k]];
        v[k][1] = window[r0 + xb[k]];
        v[k][2] = window[r1 + xa[k]];
        v[k][3] = window[r1 + xb[k]];
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[k][0] = __ldg(img + (size_t)ya[k] * w + xa[k]);
        v[k][1] = __ldg(img + (size_t)ya[k] * w + xb[k]);
        v[k][2] = __ldg(img + (size_t)yb[k] * w + xa[k]);
        v[k][3] = __ldg(img + (size_t)yb[k] * w + xb[k]);
      }
    }
    float res[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float top = v[k][0] * (1.0f - tx[k]) + v[k][1] * tx[k];
      float bot = v[k][2] * (1.0f - tx[k]) + v[k][3] * tx[k];
      float val = top * (1.0f - ty[k]) + bot * ty[k];
      res[k] = inb[k] ? val : fill;
    }
    float* dst = out + (size_t)y * ow + x;
    if (vec && n == 4) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(res[0], res[1], res[2], res[3]);
    } else {
      for (int k = 0; k < n; ++k) dst[k] = res[k];
    }
  }
}

"""
GRID_FORM = ("// -------------------------------------------------------------"
             "--------------\n// the grid form")
ROWS_KERNEL = r"""
// the f32 grid form as a row strip: a block of kRowsTile rows x 128
// pixels builds the upsample tables of its rows and columns, then each
// thread samples quads through __ldg as the map form does (no window)
constexpr int kRowsTile = 16;
__global__ void __launch_bounds__(256)
    dewarp_rows_f32(const float* __restrict__ img, int h, int w,
                    const float* __restrict__ hv, int gh, int gw, int res,
                    float fill, int vec, int ncs, float* __restrict__ out) {
  extern __shared__ float2 srows[];         // [kRowsTile][ncs]
  __shared__ float ctx[128];
  __shared__ int clx[128];
  const int tid = threadIdx.x;
  const int ox0 = blockIdx.x * 128, oy0 = blockIdx.y * kRowsTile;
  const int ow = gw * res, oh = gh * res;
  const int tw = min(128, ow - ox0), th = min(kRowsTile, oh - oy0);
  const int cx0 = (int)floorf((float)ox0 / (float)res);
  const int nc = (int)floorf((float)(ox0 + tw - 1) / (float)res) - cx0 + 2;
  if (tid < tw) {
    float g = (float)(ox0 + tid) / (float)res;
    float f = floorf(g);
    ctx[tid] = g - f;
    clx[tid] = (int)f - cx0;
  }
  for (int i = tid; i < th * nc; i += 256) {
    int r = i / nc, lx = i - r * nc;
    float g = (float)(oy0 + r) / (float)res;
    float f = floorf(g);
    float ty = g - f, uy = 1.0f - ty;
    int gy0 = min((int)f, gh - 1), gy1 = min((int)f + 1, gh - 1);
    int gx = min(cx0 + lx, gw - 1);
    float2 a = __ldg(reinterpret_cast<const float2*>(hv) + gy0 * gw + gx);
    float2 b = __ldg(reinterpret_cast<const float2*>(hv) + gy1 * gw + gx);
    srows[r * ncs + lx] =
        make_float2(a.x * uy + b.x * ty, a.y * uy + b.y * ty);
  }
  __syncthreads();
  const int c4 = (tid & 31) << 2;
  if (c4 >= tw) return;
  const int n = min(4, tw - c4);
  for (int r = tid >> 5; r < th; r += 8) {
    const float2* row = srows + r * ncs;
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int c = c4 + min(k, n - 1);
      float tx = ctx[c], ux = 1.0f - tx;
      int lx = clx[c];
      float2 r0 = row[lx], r1 = row[lx + 1];
      v[k] = sample_ldg<false>(img, h, w, r0.x * ux + r1.x * tx,
                               r0.y * ux + r1.y * tx, fill);
    }
    float* dst = out + (size_t)(oy0 + r) * ow + ox0 + c4;
    if (vec && n == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int k = 0; k < n; ++k) dst[k] = v[k];
    }
  }
}

"""
F32_LAUNCH = """  return launch_dewarp<float, kF32Cells, kF32Window>(
      img, h, w, hv, gh, gw, res, fill, 1, out, staged_tiles, stream);"""
ROWS_LAUNCH = """  int ow = gw * res, oh = gh * res, ncs = 128 / res + 3;
  dim3 grid((ow + 127) / 128, (oh + kRowsTile - 1) / kRowsTile);
  dewarp_rows_f32<<<grid, 256, kRowsTile * ncs * sizeof(float2),
                    (cudaStream_t)stream>>>(
      img, h, w, hv, gh, gw, res, fill, ow % 4 == 0 && aligned16(out), ncs,
      out);
  return (int)cudaGetLastError();"""
AFFINE_LAUNCH = """  int vec = ow % 4 == 0 && aligned16(out);
  dim3 grid((ow + 127) / 128, (oh + 7) / 8, 1);
  remap_f32_kernel<true, true><<<grid, 256, 0, (cudaStream_t)stream>>>(
      img, h, w, nullptr, nullptr, 1, a, oh, ow, fill, vec, out);"""
STAGED_LAUNCH = """  int aligned = aligned16(img) && w % 4 == 0;
  int vec = ow % 4 == 0 && aligned16(out);
  dim3 grid((ow + kAffineTileW - 1) / kAffineTileW,
            (oh + kAffineTileH - 1) / kAffineTileH);
  remap_affine_kernel<<<grid, kAffineThreads, 0, (cudaStream_t)stream>>>(
      img, h, w, a, oh, ow, fill, aligned, vec, out, nullptr);"""
# each variant: [(text of csrc/remap.cu, its replacement)]
F32 = ("constexpr int kF32Cells = %d;\nconstexpr int kF32Window = %d;\n"
       "constexpr int kF32Pixels = %d;")
CELLS = F32 % (2, 16384, 1)
VEC_MAP = ("  int vec = ow % 4 == 0 && aligned16(mx) && "
           "(stride == 2 || aligned16(my)) &&\n            aligned16(out);")
VEC_AFFINE = "  int vec = ow % 4 == 0 && aligned16(out);"
VARIANTS = {
    "kernel": (),
    "staged": ((GRID_FORM, STAGED_KERNEL + GRID_FORM),
               (AFFINE_LAUNCH, STAGED_LAUNCH)),
    "rows": ((GRID_FORM, ROWS_KERNEL + GRID_FORM),
             (F32_LAUNCH, ROWS_LAUNCH)),
    "cells4": ((CELLS, F32 % (4, 49152, 1)),),
    "cells4_quads": ((CELLS, F32 % (4, 49152, 4)),),
    "f32_ldg": ((CELLS, F32 % (2, 16, 1)),),
    "scalar": ((VEC_MAP, "  int vec = 0;"), (VEC_AFFINE, "  int vec = 0;")),
}


def variants(src):
    """{name: source} of the A/B."""
    out = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit("remap.cu no longer has the anchor:\n" + old)
            text = text.replace(old, new)
        out[name] = text
    return out


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
        print("built %-8s %s" % (name, " | ".join(regs)), flush=True)
        lib = ctypes.CDLL(str(out_dir / (name + ".so")))
        for fn, argtypes in _build.SIGNATURES.items():
            if fn.startswith(("origami_remap", "origami_dewarp")):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def site_inputs(dev):
    """The three sites' inputs on the card: {site: dict}."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from origami_tpu_torch.core import _png, dewarp
    from origami_tpu_torch.core.math import rotation_matrix
    from origami_tpu_torch.ops import remap as ops
    img = torch.from_numpy(_png.read_gray(cs.REAL_SCAN)).to(dev).float()
    h, w = img.shape
    m = rotation_matrix(-0.015, (w / 2, h / 2))
    sx, sy = (torch.from_numpy(v).to(dev) for v in ops.affine_planes(
        m, (h, w)))
    sites = {"affine": dict(img=img, m=m, grid=cs._norm_grid(sx, sy, w, h))}
    pages = []
    for png in sorted(cs.FIXTURE.glob("*.png")):
        px = torch.from_numpy(_png.read_gray(png)).to(dev)
        hv = torch.from_numpy(dewarp.Grid.open(
            cs.FIXTURE / (png.stem + ".out") / "dewarp.zip").points(
                "sample")).to(dev)
        ph, pw = px.shape
        mx, my = ops._upsample_grid(hv, 25)
        pages.append(dict(px=px, hv=hv, sep=cs.separator_mask(
            png, dev, ph, pw), map_xy=torch.stack([mx, my], -1).contiguous(),
            grid=cs._norm_grid(mx, my, pw, ph)))
    sites["layout"] = pages
    imgs, mx, my = cs.warp_inputs(np.random.default_rng(0).integers(
        0, 255, (2, 2432, 1280), np.uint8), dev)
    bh, bw = imgs.shape[1:]
    sites["batch"] = dict(imgs=imgs, mx=mx, my=my,
                          grid=cs._norm_grid(mx, my, bw, bh))
    return sites


def grid_sample(image, grid):
    import torch.nn.functional as F
    return F.grid_sample(image, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=True)


def timed(fn):
    """(events, device, back to back) ms of fn() (chip_smoke's timers)."""
    import chip_smoke as cs
    return cs.time_cuda(fn), cs.device_ms(fn), cs.time_burst(fn)


def kernel_calls(lib, sites, dev):
    """{site: (launch, plain, output)}: each site's launch through `lib`
    (one output tensor, reused), its plain version and the output."""
    import numpy as np
    import torch
    from origami_tpu_torch.ops import remap as ops

    def stream():
        return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
    calls = {}
    a = sites["affine"]
    img = a["img"]
    m = np.asarray(a["m"], np.float32).ravel().tolist()
    h, w = img.shape
    out_a = torch.empty_like(img)
    calls["affine"] = (
        lambda: lib.origami_remap_affine_f32(
            img.data_ptr(), h, w, *m, h, w, 255.0, out_a.data_ptr(),
            stream()),
        lambda: ops.affine_warp_plain(img, a["m"], (h, w), 255.0), out_a)
    outs, launches, plains = [], [], []
    for page in sites["layout"]:
        sep, hv = page["sep"], page["hv"]
        gh, gw = hv.shape[:2]
        out = torch.empty((gh * 25, gw * 25), device=dev)
        sh, sw = sep.shape
        launches.append(lambda sep=sep, hv=hv, out=out, gh=gh, gw=gw, sh=sh,
                        sw=sw: lib.origami_dewarp_f32(
                            sep.data_ptr(), sh, sw, hv.data_ptr(), gh, gw,
                            25, 0.0, out.data_ptr(), None, stream()))
        plains.append(lambda sep=sep, hv=hv: ops.dewarp_f32_plain(sep, hv, 25,
                                                                  0.0))
        outs.append(out)
    calls["layout"] = (lambda: [f() for f in launches][-1],
                       lambda: torch.cat([f().reshape(-1) for f in plains]),
                       outs)
    b = sites["batch"]
    imgs, mx, my = b["imgs"], b["mx"], b["my"]
    _, bh, bw = imgs.shape
    out_b = torch.empty_like(imgs)
    calls["batch"] = (
        lambda: lib.origami_remap_f32(
            imgs.data_ptr(), 2, bh, bw, mx.data_ptr(), my.data_ptr(), 1, bh,
            bw, 255.0, 1, out_b.data_ptr(), stream()),
        lambda: ops.remap_batch_plain(imgs, mx, my, 255.0, "hard"), out_b)
    return calls


def library_calls(sites):
    """{site: F.grid_sample on the site's coordinates}."""
    a, b = sites["affine"], sites["batch"]
    pages = sites["layout"]
    return {
        "affine": lambda: grid_sample(a["img"][None, None], a["grid"][None]),
        "layout": lambda: [grid_sample(p["sep"][None, None], p["grid"][None])
                           for p in pages][-1],
        "batch": lambda: grid_sample(b["imgs"][:, None], b["grid"]),
    }


def part1(dev, results):
    import torch
    import chip_smoke as cs
    src = (ROOT / "origami_tpu_torch" / "csrc" / "remap.cu").read_text()
    libs = build(variants(src), ROOT / "build" / "remap_ab")
    sites = site_inputs(dev)
    calls = {name: kernel_calls(lib, sites, dev)
             for name, lib in libs.items()}
    failed = []
    for name, per_site in calls.items():
        for site, (launch, plain, out) in per_site.items():
            rc = launch()
            torch.cuda.synchronize()
            got = torch.cat([o.reshape(-1) for o in out]) \
                if isinstance(out, list) else out
            err = float((got.double() - plain().double().reshape(
                got.shape)).abs().max())
            ok = rc == 0 and err <= cs.F32_TOL
            print("check %-8s %-7s rc %d max|diff| %.3g %s" % (
                name, site, rc, err, "ok" if ok else "FAIL"), flush=True)
            if not ok:
                failed.append((name, site))
    if failed:
        raise SystemExit("variants off their plain versions: %s" % failed)
    lib_calls = library_calls(sites)
    order = list(calls) + ["grid_sample"]
    times = {}
    for turn in order + order[::-1]:
        for site in ("affine", "layout", "batch"):
            fn = lib_calls[site] if turn == "grid_sample" \
                else calls[turn][site][0]
            times.setdefault((site, turn), []).append(timed(fn))
    for (site, name), runs in sorted(times.items()):
        print("%-7s %-11s events %s  device %s  back to back %s" % (
            site, name, " ".join("%.4f" % r[0] for r in runs),
            " ".join(cs.fmt_ms(r[1]) for r in runs),
            " ".join("%.4f" % r[2] for r in runs)), flush=True)
        results.setdefault("variants", {})["%s %s" % (site, name)] = runs


SITES_OF = "--sites-of"


def sites_of(dev):
    """Part 2 in one process: the wrappers of the package on sys.path at
    the sites -> {name: [events, device, host µs]}."""
    import torch
    import chip_smoke as cs
    from origami_tpu_torch.ops import binarize
    from origami_tpu_torch.ops import remap as ops
    sites = site_inputs(dev)
    a, b = sites["affine"], sites["batch"]
    h, w = a["img"].shape
    pages = sites["layout"]
    if hasattr(ops, "dewarp_f32"):
        def layout():
            return [ops.dewarp_f32(p["sep"], p["hv"], 25, 0.0)
                    for p in pages][-1]
    else:
        def layout():
            return [ops.remap(p["sep"], torch.stack(
                ops._upsample_grid(p["hv"], 25), -1), 0.0) for p in pages][-1]
    calls = {
        "layout site": layout,
        "remap, map built beforehand": lambda: [
            ops.remap(p["sep"], p["map_xy"], 0.0) for p in pages][-1],
        "affine_warp": lambda: ops.affine_warp(a["img"], a["m"], (h, w),
                                               255.0),
        "remap_batch": lambda: ops.remap_batch(b["imgs"], (b["mx"], b["my"]),
                                               255.0, "hard"),
        "dewarp_u8": lambda: ops.dewarp_u8(pages[0]["px"], pages[0]["hv"],
                                           25),
        "sauvola_packed": lambda: binarize.sauvola_packed(pages[0]["px"], 15),
    }
    calls.update({"grid_sample " + k: f
                  for k, f in library_calls(sites).items()})
    out = {}
    for name, fn in calls.items():
        # the layout site runs both pages a call: per page
        n = 2 if name in ("layout site", "remap, map built beforehand",
                          "grid_sample layout") else 1
        out[name] = [cs.time_cuda(fn) / n, (cs.device_ms(fn) or 0.0) / n,
                     cs.host_us(fn, 200) / n,
                     cs.device_events(cs.profiled(fn)) / n]
    return out


def part2(parent, results):
    """Parent, current, current, parent, each a process of its own."""
    runs = {}
    for turn, root in (("parent", parent), ("current", ROOT),
                       ("current", ROOT), ("parent", parent)):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), SITES_OF,
             str(root)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, timeout=600)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode or not lines:
            raise SystemExit("%s run failed:\n%s" % (turn, proc.stdout))
        for name, t in json.loads(lines[-1]).items():
            runs.setdefault(name, {}).setdefault(turn, []).append(t)
    for name, per in runs.items():
        line = []
        for turn in ("parent", "current"):
            ts = per[turn]
            line.append("%s events %s device %s host %s us, %g device "
                        "events" % (
                            turn, "/".join("%.4f" % t[0] for t in ts),
                            "/".join("%.4f" % t[1] for t in ts),
                            "/".join("%.1f" % t[2] for t in ts), ts[0][3]))
        print("%-30s %s" % (name, "; ".join(line)), flush=True)
    results["wrappers"] = {
        name: {turn: {"events_ms": statistics.mean(t[0] for t in ts),
                      "device_ms": statistics.mean(t[1] for t in ts),
                      "host_us": statistics.mean(t[2] for t in ts),
                      "device_events": ts[0][3]}
               for turn, ts in per.items()} for name, per in runs.items()}


def main():
    import torch
    if not torch.cuda.is_available():
        print("remap_ab: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    if len(sys.argv) == 3 and sys.argv[1] == SITES_OF:
        # the package of the tree named, chip_smoke.py of this one
        sys.path[:0] = [sys.argv[2], str(ROOT)]
        print(json.dumps(sites_of(dev)), flush=True)
        return 0
    sys.path.insert(0, str(ROOT))
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None,
                    help="a directory holding an earlier origami_tpu_torch/")
    args = ap.parse_args()
    import chip_smoke as cs
    print(cs.smi_line(), flush=True)
    results = {"card": cs.smi_line()}
    part1(dev, results)
    if args.parent is not None:
        part2(args.parent.resolve(), results)
    (ROOT / "build" / "remap_ab" / "results.json").write_text(
        json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
