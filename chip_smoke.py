#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

  1. build the CUDA kernels from origami_tpu_torch/csrc with nvcc
     (sm_90a), print ptxas' register report and the card's name and
     power limit;
  2. hold each kernel entry point against its plain PyTorch version on
     the card at the main path's shapes (the fixture pages, 1312x1920,
     their grids and their real line frames) and time kernel, plain
     version and one PyTorch yardstick call (F.grid_sample on the
     precomputed sampling grid; the port never calls it) with CUDA
     events, median of 20;
  3. run the OCR CLI (`python -m origami_tpu_torch.batch.detect.ocr`) on
     the card three times, each on a fresh copy of the `full` fixture
     corpus — single model, the 3-member voted ensemble, and
     `--extract-mode gather` — and compare every ocr.zip line by line
     with the JAX reference the fixture holds;
  4. time the single-model stage in process, warm, for pages/s and
     lines/s, and list the device time by kernel (torch.profiler).

The line before the last is the kernel table as JSON, the last line
{"ok": true, "device": {...}}. Imports nothing of JAX or origami_tpu.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import zipfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "data" / "torch_ocr" / "full"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
REPS = 20
MODES = {
    "single": ["-m", "models_pretrained/recognizer"],
    "ensemble": ["-m", "models_pretrained"],
    "gather": ["-m", "models_pretrained/recognizer",
               "--extract-mode", "gather"],
}
# acceptance per OCR run against its JAX reference
MIN_IDENTICAL = 0.99
MAX_CER = 0.005
# kernel vs plain version: same arithmetic in the same order (the
# kernels build with -fmad=false), so u8 outputs should agree exactly;
# one gray level is allowed for a value that lands on a .5 rounding tie
U8_TOL = 1
F32_TOL = 1e-4


class PhaseError(RuntimeError):
    pass


def log(*a):
    print(*a, flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, reps=REPS):
    """Median ms of `fn()` over `reps` runs (CUDA events), after one
    warm-up run."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def levenshtein(a, b):
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def read_zip(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n).decode("utf8") for n in zf.namelist()}


# ---------------------------------------------------------------- phase 2

class _Proc:
    """What io.Input.instantiate needs of a processor."""

    def __init__(self, device):
        self.device = device

    @staticmethod
    def lock_or_open(path, mode):
        return open(path, mode)


def page_groups(page_png, device, mode):
    """The main path's strip groups of one page: [(frames (nb, 2, 3),
    widths (nb,), wmax)] on `device`, as LineExtractor.groups plans them
    for `--extract-mode mode`, and the page's reader."""
    import torch
    from origami_tpu_torch.batch.core.io import Artifact, Input, Stage
    from origami_tpu_torch.batch.core.lines import LineExtractor
    from origami_tpu_torch.batch.core.utils import RegionsFilter
    reader = Input(Artifact.LINES, Artifact.TABLES,
                   stage=Stage.RELIABLE).instantiate(page_png,
                                                     _Proc(device))
    ext = LineExtractor(reader.tables, 48, {"extract_mode": mode},
                        min_confidence=reader.lines.min_confidence,
                        max_width=2048)
    parts = ext.parts(reader.lines.by_path,
                      ignored=RegionsFilter("regions/ILLUSTRATION"))
    return [(torch.from_numpy(fr).to(device), torch.from_numpy(wd).to(device),
             wmax) for _, _, fr, wd, wmax, _ in ext.groups(parts)], reader


def tapped_pixels(x, y, keep, h, w):
    """How many distinct pixels of an (h, w) image the bilinear taps at
    (x, y) read where `keep` holds: the page bytes (u8) a launch must
    read, counted from this run's coordinates."""
    import torch
    fx = torch.floor(x).long()
    fy = torch.floor(y).long()
    mask = torch.zeros(h * w, dtype=torch.bool, device=x.device)
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = fx + dx, fy + dy
            k = keep & (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            mask[(yi * w + xi)[k]] = True
    return int(mask.sum())


def lattice_grid_cells(hv, res, frames, out_h, out_w):
    """How many distinct (gh, gw) grid nodes strip mode (b)'s 8-px
    lattice reads (through_grid_coords' inverse-grid lookup)."""
    import torch
    gh, gw = hv.shape[:2]
    step = 8
    dev = hv.device
    ys = (torch.arange(out_h // step + 2, device=dev) * step).float()
    xs = (torch.arange(out_w // step + 2, device=dev) * step).float()
    f = frames[:, :, :, None, None]
    dx = f[:, 0, 0] * xs + f[:, 0, 1] * ys[:, None] + f[:, 0, 2]
    dy = f[:, 1, 0] * xs + f[:, 1, 1] * ys[:, None] + f[:, 1, 2]
    gx = torch.floor((dx / res).clamp(0.0, gw - 1 - 1e-6)).long()
    gy = torch.floor((dy / res).clamp(0.0, gh - 1 - 1e-6)).long()
    mask = torch.zeros(gh * gw, dtype=torch.bool, device=dev)
    for oy in (0, 1):
        for ox in (0, 1):
            mask[(gy + oy).clamp(max=gh - 1) * gw
                 + (gx + ox).clamp(max=gw - 1)] = True
    return int(mask.sum())


def _norm_grid(x, y, w, h):
    import torch
    return torch.stack([2 * x / max(w - 1, 1) - 1,
                        2 * y / max(h - 1, 1) - 1], dim=-1)


def check_kernels(device):
    """Phase 2: kernel vs plain version at main-path shapes; returns
    {kernel name: row} for the JSON table."""
    import torch
    import torch.nn.functional as F
    from origami_tpu_torch.ops import remap as ops

    pages = sorted(p for p in FIXTURE.glob("*.png"))
    if not pages:
        raise PhaseError("no fixture pages under %s" % FIXTURE)
    rows = {}
    failures = []

    def report(name, got, want, tol, ms, plain_ms, nbytes, lib_ms, shape):
        diff = (got.double() - want.double()).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        ok = err <= tol
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        log("  %-20s %-30s max|diff| %.3g (tol %g) %s  kernel %.4f ms  "
            "plain %.4f ms  bound %.4f ms  grid_sample %s" % (
                name, shape, err, tol, "ok" if ok else "FAIL", ms,
                plain_ms, bound_ms,
                "%.4f ms" % lib_ms))
        if not ok:
            failures.append(name)
        row = rows.setdefault(name, dict(err=0.0, ms=0.0, plain_ms=0.0,
                                          bound_ms=0.0, library_ms=0.0))
        row["err"] = max(row["err"], err)
        row["ms"] += ms
        row["plain_ms"] += plain_ms
        row["bound_ms"] += bound_ms
        row["library_ms"] += lib_ms

    for png in pages:
        log(" page %s" % png.name)
        groups, reader = page_groups(png, device, "banded")
        page = reader.page
        px = page.device_pixels
        h, w = px.shape
        hv = torch.from_numpy(page.grid.points("sample")).to(device)
        res = page.grid.resolution
        gh, gw = hv.shape[:2]

        # dewarp_u8 (the dewarp kernel on the main path)
        got = ops.dewarp_u8(px, hv, res)
        want = ops.dewarp_u8_plain(px, hv, res)
        torch.cuda.synchronize()
        mx, my = ops._upsample_grid(hv, res)
        inb = (mx >= 0) & (mx <= w - 1) & (my >= 0) & (my <= h - 1)
        grid = _norm_grid(mx, my, w, h)[None]
        pxf = px.float()[None, None]
        report("dewarp_u8", got, want, U8_TOL,
               time_cuda(lambda: ops.dewarp_u8(px, hv, res)),
               time_cuda(lambda: ops.dewarp_u8_plain(px, hv, res)),
               tapped_pixels(mx, my, inb, h, w) + hv.numel() * 4
               + got.numel(),
               time_cuda(lambda: F.grid_sample(
                   pxf, grid, mode="bilinear", padding_mode="zeros",
                   align_corners=True)),
               "%dx%d -> %dx%d" % (h, w, gh * res, gw * res))
        dew = got

        # remap (remap_pallas' function, f32, fill 0): parity entry
        # point of the same source, not on the OCR path
        map_xy = torch.stack([mx, my], dim=-1).contiguous()
        img = px.float().contiguous()
        got = ops.remap(img, map_xy, 0.0)
        want = ops.remap_plain(img, map_xy, 0.0)
        torch.cuda.synchronize()
        report("remap_f32", got, want, F32_TOL,
               time_cuda(lambda: ops.remap(img, map_xy, 0.0)),
               time_cuda(lambda: ops.remap_plain(img, map_xy, 0.0)),
               tapped_pixels(map_xy[..., 0].clamp(-2.0, w + 1.0),
                             map_xy[..., 1].clamp(-2.0, h + 1.0),
                             torch.ones_like(mx, dtype=torch.bool), h, w) * 4
               + map_xy.numel() * 4 + got.numel() * 4,
               time_cuda(lambda: F.grid_sample(
                   img[None, None], grid, mode="bilinear",
                   padding_mode="zeros", align_corners=True)),
               "%dx%d -> %dx%d" % (h, w, *map_xy.shape[:2]))

        # strip mode (a): every (bucket, profile) group of the page
        dh, dw = dew.shape
        for fr, wd, wmax in groups:
            n = fr.shape[0]
            got = ops.strips_dewarped(dew, fr, wd, 48, wmax)
            want = ops.strips_dewarped_plain(dew, fr, wd, 48, wmax)
            torch.cuda.synchronize()
            xs = torch.arange(wmax, device=device, dtype=torch.float32)
            ys = torch.arange(48, device=device, dtype=torch.float32)
            sx = (fr[:, 0, 0, None, None] * xs + fr[:, 0, 1, None, None]
                  * ys[:, None] + fr[:, 0, 2, None, None])
            sy = (fr[:, 1, 0, None, None] * xs + fr[:, 1, 1, None, None]
                  * ys[:, None] + fr[:, 1, 2, None, None])
            sgrid = _norm_grid(sx, sy, dw, dh)
            # the page pixels under this group's frames (mode (a) reads
            # taps inside the page, for outputs inside it and its widths)
            keep = ((sx > -0.5) & (sx < dw - 0.5) & (sy > -0.5)
                    & (sy < dh - 0.5)
                    & (xs < wd.float().clamp(min=2.0)[:, None, None]))
            dewf = dew.float()[None, None].expand(n, 1, dh, dw)
            report("strips_dewarped", got, want, U8_TOL,
                   time_cuda(lambda: ops.strips_dewarped(
                       dew, fr, wd, 48, wmax)),
                   time_cuda(lambda: ops.strips_dewarped_plain(
                       dew, fr, wd, 48, wmax)),
                   tapped_pixels(sx, sy, keep, dh, dw) + fr.numel() * 4
                   + wd.numel() * 4 + got.numel(),
                   time_cuda(lambda: F.grid_sample(
                       dewf, sgrid, mode="bilinear", padding_mode="zeros",
                       align_corners=True)),
                   "%d x 48 x %d" % (n, wmax))

        # strip mode (b): the gather route's groups of the page
        ggroups, _ = page_groups(png, device, "gather")
        for fr, wd, wmax in ggroups:
            n = fr.shape[0]
            got = ops.strips_through_grid(px, hv, float(res), fr, wd, 48,
                                          wmax)
            want = ops.strips_through_grid_plain(px, hv, float(res), fr, wd,
                                                 48, wmax)
            torch.cuda.synchronize()
            cx, cy = ops.through_grid_coords(hv, float(res), fr, wd, 48,
                                             wmax)
            ggrid = _norm_grid(cx, cy, w, h)
            keep = (cx >= 0) & (cx <= w - 1) & (cy >= 0) & (cy <= h - 1)
            pxn = px.float()[None, None].expand(n, 1, h, w)
            report("strips_through_grid", got, want, U8_TOL,
                   time_cuda(lambda: ops.strips_through_grid(
                       px, hv, float(res), fr, wd, 48, wmax)),
                   time_cuda(lambda: ops.strips_through_grid_plain(
                       px, hv, float(res), fr, wd, 48, wmax)),
                   tapped_pixels(cx, cy, keep, h, w)
                   + lattice_grid_cells(hv, float(res), fr, 48, wmax) * 8
                   + fr.numel() * 4 + wd.numel() * 4 + got.numel(),
                   time_cuda(lambda: F.grid_sample(
                       pxn, ggrid, mode="bilinear", padding_mode="zeros",
                       align_corners=True)),
                   "%d x 48 x %d" % (n, wmax))
    if failures:
        raise PhaseError("kernel disagrees with its plain version: %s"
                         % ", ".join(sorted(set(failures))))
    n_pages = len(pages)
    # per page: the sum over that page's launches, averaged over pages
    for row in rows.values():
        for k in ("ms", "plain_ms", "bound_ms", "library_ms"):
            row[k] /= n_pages
    return rows


# ---------------------------------------------------------------- phase 3

def run_ocr_cli(mode, workdir, device="cuda"):
    corpus = workdir / mode
    shutil.copytree(FIXTURE, corpus, ignore=shutil.ignore_patterns("ref"))
    cmd = [sys.executable, "-m", "origami_tpu_torch.batch.detect.ocr",
           *MODES[mode], "--lock-strategy", "NONE", "--plain",
           "--device", str(device), str(corpus)]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=str(ROOT), stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True, timeout=600)
    wall = time.time() - t0
    if proc.returncode != 0:
        raise PhaseError("ocr CLI (%s) exited %d:\n%s" % (
            mode, proc.returncode, proc.stderr[-4000:]))
    launches = None
    for line in proc.stdout.splitlines():
        if line.startswith('{"kernel_launches"'):
            launches = json.loads(line)["kernel_launches"]
    if launches is None:
        raise PhaseError("ocr CLI (%s) printed no launch counts" % mode)
    n_lines = same = errs = chars = 0
    elapsed = 0.0
    pages = sorted(corpus.glob("*.png"))
    for png in pages:
        out = corpus / (png.stem + ".out")
        rt = json.loads((out / "runtime.json").read_text())
        entry = rt.get("origami_tpu.batch.detect.ocr", {})
        if entry.get("status") != "COMPLETED":
            raise PhaseError("ocr (%s) on %s: %s" % (
                mode, png.name, entry.get("traceback", entry)))
        elapsed += entry["elapsed"]
        got = read_zip(out / "ocr.zip")
        ref = read_zip(FIXTURE / "ref" / ("%s.%s.ocr.zip"
                                           % (png.stem, mode)))
        if set(got) != set(ref):
            raise PhaseError("ocr (%s) on %s: line set differs from the "
                             "reference" % (mode, png.name))
        for k, t in ref.items():
            n_lines += 1
            same += got[k] == t
            errs += levenshtein(got[k], t)
            chars += len(t)
            if got[k] != t:
                log("    differs %s/%s: %r (JAX %r)" % (png.stem, k,
                                                         got[k], t))
    share = same / max(n_lines, 1)
    cer = errs / max(chars, 1)
    return dict(mode=mode, pages=len(pages), lines=n_lines,
                identical=share, cer=cer, launches=launches,
                wall_s=wall, stage_s=elapsed)


def _cuda_total_ms(table):
    """The profiler table's "Self CUDA time total" in ms."""
    for line in table.splitlines():
        if line.startswith("Self CUDA time total:"):
            value = line.split(":", 1)[1].strip()
            for unit, scale in (("ms", 1.0), ("us", 1e-3), ("s", 1e3)):
                if value.endswith(unit):
                    return float(value[:-len(unit)]) * scale
    return float("nan")


def check_pass(corpus, mode="single"):
    """Raise unless every page of a pass over `corpus` COMPLETED and its
    ocr.zip holds the reference's lines; -> the number of lines."""
    n_lines = 0
    for png in sorted(corpus.glob("*.png")):
        out = corpus / (png.stem + ".out")
        entry = json.loads((out / "runtime.json").read_text()).get(
            "origami_tpu.batch.detect.ocr", {})
        if entry.get("status") != "COMPLETED":
            raise PhaseError("ocr pass over %s, %s: %s" % (
                corpus.name, png.name, entry.get("traceback", entry)))
        got = read_zip(out / "ocr.zip")
        ref = read_zip(FIXTURE / "ref" / ("%s.%s.ocr.zip"
                                           % (png.stem, mode)))
        if set(got) != set(ref):
            raise PhaseError("ocr pass over %s, %s: %d lines, the reference "
                             "has %d" % (corpus.name, png.name, len(got),
                                         len(ref)))
        n_lines += len(got)
    return n_lines


def throughput(device, workdir, reps=5):
    """Phase 4: the single-model stage in process, warm: `reps` timed
    passes over fresh copies of the fixture after one warm-up pass, then
    one profiled pass for the device time by kernel."""
    import torch
    from origami_tpu_torch.batch.detect.ocr import OCRProcessor
    opts = dict(model=str(ROOT / "models_pretrained" / "recognizer"),
                lock_strategy="NONE", plain=True, device=str(device))
    proc = OCRProcessor(opts)
    times = []
    for i in range(reps + 1):
        corpus = workdir / ("tp%d" % i)
        shutil.copytree(FIXTURE, corpus, ignore=shutil.ignore_patterns("ref"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proc.traverse(str(corpus))
        torch.cuda.synchronize()
        if i:                       # the first pass warms cuDNN
            times.append(time.perf_counter() - t0)
        n_lines = check_pass(corpus)
    n_pages = len(list(FIXTURE.glob("*.png")))
    from torch.profiler import ProfilerActivity, profile
    corpus = workdir / "prof"
    shutil.copytree(FIXTURE, corpus, ignore=shutil.ignore_patterns("ref"))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        proc.traverse(str(corpus))
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    check_pass(corpus)
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=15)
    med = statistics.median(times)
    return dict(pages=n_pages, lines=n_lines, times=times, seconds=med,
                pages_per_s=n_pages / med, lines_per_s=n_lines / med,
                device_ms=_cuda_total_ms(table), prof_wall_s=prof_wall,
                profile=table)


# ---------------------------------------------------------------- main

def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "origami_tpu_torch").is_dir() or not FIXTURE.is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(origami_tpu_torch/ and tests/data/torch_ocr/ missing)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    t_start = time.time()

    log("== phase 1: build")
    smi = smi_line()
    log("card: %s (torch %s, CUDA %s)" % (smi, torch.__version__,
                                          torch.version.cuda))
    from origami_tpu_torch.ops import _build
    from origami_tpu_torch.ops import remap as ops
    t0 = time.time()
    nvcc_log = _build.build(force=True)
    _build.library()
    log("built %s from %s in %.1f s" % (
        _build.LIBRARY.relative_to(ROOT),
        ", ".join("origami_tpu_torch/csrc/" + s for s in _build.SOURCES),
        time.time() - t0))
    for line in nvcc_log.splitlines():
        if "registers" in line or line.startswith("==") or "spill" in line:
            log("  " + line.strip())

    log("== phase 2: kernels vs plain versions (median of %d, CUDA "
        "events; %s)" % (REPS, smi))
    rows = check_kernels(device)

    log("== phase 3: OCR CLI on the card vs the JAX references (%s)"
        % smi)
    failed = []
    runs = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = Path(tmp)
        for mode in MODES:
            r = run_ocr_cli(mode, work)
            runs.append(r)
            ok = r["identical"] >= MIN_IDENTICAL and r["cer"] <= MAX_CER
            # the dewarp kernel and strip mode (a) at least once per page
            # in the banded runs; strip mode (b) in the gather run
            need = ["strips_through_grid"] if mode == "gather" \
                else ["dewarp_u8", "strips_dewarped"]
            starved = [k for k in need if r["launches"][k] < r["pages"]]
            log("  %-8s %d pages %d lines: identical %.4f  CER %.5f  "
                "launches %s  stage %.2f s (%.2f pages/s, %.1f lines/s, "
                "cold process)  %s" % (
                    mode, r["pages"], r["lines"], r["identical"], r["cer"],
                    json.dumps(r["launches"]), r["stage_s"],
                    r["pages"] / r["stage_s"], r["lines"] / r["stage_s"],
                    "ok" if ok and not starved else "FAIL"))
            if not ok:
                failed.append("%s: identical %.4f < %.2f or CER %.5f > %.3f"
                              % (mode, r["identical"], MIN_IDENTICAL,
                                 r["cer"], MAX_CER))
            if starved:
                failed.append("%s: kernels not launched: %s"
                              % (mode, starved))
        if failed:
            raise PhaseError("; ".join(failed))

        log("== phase 4: OCR stage throughput, single model, warm (%s)"
            % smi)
        tp = throughput(device, work)
        log("  %d pages, %d lines; median of %d warm passes %.4f s "
            "(min %.4f, max %.4f): %.3f pages/s, %.1f lines/s" % (
                tp["pages"], tp["lines"], len(tp["times"]), tp["seconds"],
                min(tp["times"]), max(tp["times"]), tp["pages_per_s"],
                tp["lines_per_s"]))
        log("  profiled pass: %.4f s wall, %.1f ms device (kernel) time, "
            "device busy %.1f %%" % (
                tp["prof_wall_s"], tp["device_ms"],
                100.0 * tp["device_ms"] / 1e3 / tp["prof_wall_s"]))
        log(tp["profile"])

    total = {k: sum(r["launches"][k] for r in runs) for k in ops.launches}
    sources = {"dewarp_u8": "remap.cu", "strips_dewarped": "strips.cu",
               "strips_through_grid": "strips.cu"}
    replaces = {"dewarp_u8": "origami_tpu/ops/pallas/remap.py:392",
                "strips_dewarped": "origami_tpu/ops/pallas/remap.py:227",
                "strips_through_grid": "origami_tpu/ops/pallas/remap.py:227"}
    kernels = []
    for name in ("dewarp_u8", "strips_dewarped", "strips_through_grid"):
        row = rows[name]
        kernels.append(dict(
            name=name, route="cuda",
            source="origami_tpu_torch/csrc/" + sources[name],
            replaces=replaces[name], launches=total[name],
            max_abs_err=row["err"], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by="bytes",
            library_ms=row["library_ms"]))
    log("total %.1f s" % (time.time() - t_start))
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except PhaseError as e:
        print("chip_smoke: FAILED: %s" % e, file=sys.stderr)
        code = 1
    sys.exit(code)
