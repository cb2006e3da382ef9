#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

  1. build the CUDA kernels from origami_tpu_torch/csrc with nvcc
     (sm_90a) and, beside them, the host geometry library
     (origami_tpu_torch/geometry/native.cpp and contour_trace.cpp, g++);
     print ptxas' register report and the card's name and power limit;
  2. hold each kernel entry point against its plain PyTorch version on
     the card at the main path's shapes (the fixture pages, 1312x1920,
     their grids and their real line frames) and time kernel, plain
     version and one PyTorch yardstick call (F.grid_sample on the
     precomputed sampling grid; the port never calls it) with CUDA
     events, median of 20, and each one's device time alone
     (torch.profiler); then the host µs of a wrapper call;
  3. run the OCR CLI (`python -m origami_tpu_torch.batch.detect.ocr`) on
     the card three times, each on a fresh copy of the `full` fixture
     corpus — single model, the 3-member voted ensemble, and
     `--extract-mode gather` — and compare every ocr.zip line by line
     with the JAX reference the fixture holds; a page's strips must
     take exactly one launch of their mode's kernel (strips_dewarped in
     the banded runs, strips_through_grid in the gather run);
  4. time the single-model stage in process, warm, for pages/s and
     lines/s, and list the device time by kernel (torch.profiler);
  5. run the segment CLI (`python -m
     origami_tpu_torch.batch.detect.segment`) on the card three times
     over the fixture's two pages: the students at full width in bf16
     (the main path) against the fixture's JAX segment.zip, the students
     in float32 with TF32 off against the JAX float32 reference, and
     `-m heuristic` against the JAX heuristic reference
     (tests/data/torch_segment/ref); per predictor the share of equal
     pixels is printed and gated, and the Sauvola kernel must have run
     once per page (students) or twice per page (heuristic);
  6. time the trained segment stage in process, warm, for pages/s, and
     list the device time by kernel;
  7. run the flow CLI (`python -m origami_tpu_torch.batch.detect.flow`)
     and then the dewarp CLI on the card over the fixture's two pages
     (their PNG and segment.zip, the JAX contours.0.zip of
     tests/data/torch_flow), and the dewarp CLI once more on the JAX
     flow.zip, which isolates the grid build; flow.zip, lines.0.zip,
     dewarp.zip and contours.1.zip are held against the JAX stages'
     (tests/data/torch_flow) and each kernel's launches per page are
     checked;
  8. time the flow and dewarp stages in process, warm, for pages/s, list
     the device time by kernel, and count the launches of one grid
     build;
  9. run the layout CLI on the JAX stages' artifacts (contours.2.zip and
     tables.json must equal tests/data/torch_layout); the contours, flow,
     dewarp and layout CLIs in turn from the fixture's JAX segment.zip
     (contours.0.zip equal to tests/data/torch_flow's, the flow and
     dewarp artifacts under phase 7's bars, contours.2.zip within 0.01 px
     of tests/data/torch_layout's and tables.json equal); and the port
     alone from the page images: segment (the students in bf16),
     contours, flow, dewarp and layout, whose contours.2.zip must keep
     the JAX keys and vertex counts and whose tables.json the JAX tables
     and their counts of columns and dividers, both within CHAIN_PX
     (the bf16 label maps move shapes by up to a label pixel). Every
     stage's launches per page are checked
     exactly (STAGE_LAUNCHES: the layout stage launches sauvola_packed,
     dewarp_u8 and remap once a page), and the layout stage's Sauvola
     windows are printed;
  10. time the contours and layout stages in process, warm, for pages/s,
     with the device time by kernel and the busy share of one profiled
     pass;
  11. run the lines CLI on the JAX stages' artifacts (contours.3.zip and
     lines.3.zip against the fixture's: the JAX keys, vertex counts and
     meta.json, within CONTOUR_PX and LINES_PX, evidence within
     LINE_CONF; one launch of dewarp_u8 and of sauvola_packed a page),
     the order CLI on the JAX artifacts (order.json equal to
     tests/data/torch_compose's), the compose CLI on the JAX order.json
     and single-model ocr.zip (page.txt byte-equal; with --page-xml,
     page.xml equal apart from its timestamps), and the chain lines ->
     order -> ocr -> compose from the JAX contours.2.zip (page.txt:
     MIN_IDENTICAL of the JAX chain's lines, CER <= MAX_CER); then time
     the lines, order and compose stages as phase 10 does;
  12. run the port alone from the page images through PipelinedRunner
     (all nine stages in process, waves of one page), once on the main
     path (the students in bf16, banded strips: every page COMPLETED in
     every stage, the "*" order ranks every region of contours.3.zip
     that the stage ranks, page.txt within PORT_CHAIN_MAX_CER of the JAX
     chain's) and once with `-m heuristic` and gather strips (every page
     COMPLETED), the launch counts set to 0 just before each run and
     read just after it, each kernel's launches per page as
     WHOLE_CHAIN_LAUNCHES says (so the two runs launch every kernel that
     phases 3, 5, 7 and 9 launch); print each stage's seconds and each
     kernel's launches. The kernels line gives each kernel's launches in
     the run of its own path (OTHER_PATH_KERNELS from the second run).

Phase 2 also holds the Sauvola kernel (both borders, u8 mask and
bit-packed, windows 15, 31, 33, 41, 63, 101, 259 and 513) against its
plain version at a fixture page, a dewarped page and a ragged crop: the two
must agree exactly (scripts/sauvola_ab.py runs this check alone); and
the gather kernel (lane and sublane) over the sweep of
scripts/pallas_gather_repro.py and at the grid build's own inputs, which
must agree exactly with numpy's take_along_axis and the plain version;
remap (f32, within 1e-4) on the separator mask the layout stage dewarps
and on the page itself; dewarp_u8 (bit-equal) on both of its tile routes: the pages' own grids
(every tile staged in shared memory), a scrambled grid (every tile
through __ldg), a sheared grid and a ragged crop; and the grid scan
kernels against the plain build (nodes within 1e-3 px; the chosen
segments equal on the fixture pages) on the fixture pages' inputs,
seeded samples at 400x300 and 1312x1920, rays that miss their row
(some at 400x300, all at 1312x1920), and no samples at all. Both strip
kernels must equal their plain versions exactly, each main-path group
through the group-level entry and a whole page through one page-level
launch, on the fixture pages and on crafted cases (strip_cases; mode
(b) through a seeded warped grid and frames that leave it); the page
launch is timed against the per-group launches, and the OCR stage's
device_groups (one upload, one launch per mode) against the earlier
per-group path.

The line before the last is the kernel table as JSON (the kernels of the
driven paths; the gather's entry points, which no path runs, are printed
on a line of their own before it), the last line {"ok": true, "device":
{...}}. Imports nothing of JAX or origami_tpu.
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
SEG_REF = ROOT / "tests" / "data" / "torch_segment" / "ref"
FLOW_REF = ROOT / "tests" / "data" / "torch_flow"
STUDENTS = "models_pretrained/students"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12           # H100 SXM, float32 outside tensor cores
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
# segment runs: CLI arguments, the JAX reference of a page, the least
# share of equal pixels per predictor. float32 and heuristic: the bar of
# the CPU tests; bf16: cuDNN and XLA round bf16 convolutions at other
# places, so near-tie pixels at region borders may flip
SEG_MODES = {
    "students_bf16": (["-m", STUDENTS],
                      lambda stem: FIXTURE / (stem + ".out") / "segment.zip",
                      0.99),
    "students_f32": (["-m", STUDENTS, "--dtype", "float32"],
                     lambda stem: SEG_REF / (stem + ".f32.segment.zip"),
                     0.999),
    "heuristic": (["-m", "heuristic"],
                  lambda stem: SEG_REF / (stem + ".heuristic.segment.zip"),
                  0.999),
}
SEG_STAGE = "origami_tpu.batch.detect.segment"
REGION_CLASSES = {"TEXT": 0, "TABULAR": 1, "ILLUSTRATION": 2,
                  "BACKGROUND": 3}
SEP_CLASSES = {"H": 0, "V": 1, "T": 2, "BACKGROUND": 3}
# what one pixel of Sauvola needs at least, with separable running box
# sums: v*v, 8 integer adds, 2 conversions, and the formula's 3
# divisions, 4 multiplications, 4 additions, max, sqrt and compare
SAUVOLA_OPS_PER_PIXEL = 25
# kernel vs plain version: same arithmetic in the same order (the
# kernels build with -fmad=false), so u8 outputs must agree exactly;
# remap's f32 output is held to F32_TOL
F32_TOL = 1e-4
# flow/dewarp runs vs the JAX stages (ROADMAP.md queue A4): samples and
# line frames follow the binarized mask, which the port's exact-integer
# Sauvola and JAX's float32 integral images may set differently on a
# few pixels; the grid is float32 built in another summation order
FLOW_PX = 0.5
FLOW_RAD = 1e-3
LINES_PX = 0.5
GRID_PX = 1e-3
CONTOUR_PX = 0.01
FLOW_STAGE = "origami_tpu.batch.detect.flow"
DEWARP_STAGE = "origami_tpu.batch.detect.dewarp"
CONTOURS_STAGE = "origami_tpu.batch.detect.contours"
LAYOUT_STAGE = "origami_tpu.batch.detect.layout"
LINES_STAGE = "origami_tpu.batch.detect.lines"
ORDER_STAGE = "origami_tpu.batch.detect.order"
OCR_STAGE = "origami_tpu.batch.detect.ocr"
COMPOSE_STAGE = "origami_tpu.batch.detect.compose"
STAGE_KEYS = {"segment": SEG_STAGE, "contours": CONTOURS_STAGE,
              "flow": FLOW_STAGE, "dewarp": DEWARP_STAGE,
              "layout": LAYOUT_STAGE, "lines": LINES_STAGE,
              "order": ORDER_STAGE, "ocr": OCR_STAGE,
              "compose": COMPOSE_STAGE}
LAYOUT_REF = ROOT / "tests" / "data" / "torch_layout"
# the JAX order stage's order.json and the JAX compose stage's
# compose.zip (page.txt; compose_xml.zip with page.xml) over the fixture
# (scripts/make_torch_compose_fixture.py)
COMPOSE_REF = ROOT / "tests" / "data" / "torch_compose"
# the lines stage on the JAX inputs (phase 11): its lines follow the
# Sauvola mask of the dewarped page, whose exact integer sums may set a
# few pixels otherwise than JAX's float32 integral images
LINE_CONF = 1e-3
# the port alone from the page images (phase 12): CER of page.txt
# against the JAX chain's; the bf16 label maps move the layout by up to
# a label pixel (phase 9), which may move a line's strip
PORT_CHAIN_MAX_CER = 0.02
# the chain from the port's own bf16 label maps (phase 9): they differ
# from the JAX stage's on ~0.013 % of the pixels (phase 5), which moves a
# region's vertices by up to a label pixel (1.05 page px across)
CHAIN_PX = 2.5
# each stage's launches per page: the Sauvola prefetch (packed, window
# 15) in segment, flow and dewarp; the dewarp kernel and both grid scans
# in dewarp; the layout stage's Sauvola at its own window, the dewarp of
# its page and the remap of its separator mask; the lines stage's
# dewarp of its page and Sauvola (window 15) on it; nothing else
STAGE_LAUNCHES = {
    "segment": {"sauvola_packed": 1},
    "contours": {},
    "flow": {"sauvola_packed": 1},
    "dewarp": {"sauvola_packed": 1, "dewarp_u8": 1, "grid_scan_h": 1,
               "grid_scan_v": 1},
    "layout": {"sauvola_packed": 1, "dewarp_u8": 1, "remap": 1},
    "lines": {"sauvola_packed": 1, "dewarp_u8": 1},
    "order": {},
    "compose": {},
}
# each kernel's launches per page in the whole chain (phase 12): one
# process, so the stages share a page's cache. The packed Sauvola runs
# on the warped page (window 15; segment, flow and dewarp read it), on
# the dewarped page at the layout stage's window and at window 15 for
# the lines stage; the dewarp stage's dewarped page serves layout, lines
# and ocr. The banded OCR run launches strips_through_grid at most once
# a page (lines past the banded profiles: WHOLE_CHAIN_AT_MOST).
WHOLE_CHAIN_LAUNCHES = {
    "banded": {"sauvola_packed": 3, "sauvola": 0, "dewarp_u8": 1,
               "remap": 1, "grid_scan_h": 1, "grid_scan_v": 1,
               "strips_dewarped": 1, "strips_through_grid": 1},
    "gather": {"sauvola_packed": 3, "sauvola": 1, "dewarp_u8": 1,
               "remap": 1, "grid_scan_h": 1, "grid_scan_v": 1,
               "strips_dewarped": 0, "strips_through_grid": 1},
}
WHOLE_CHAIN_AT_MOST = {("banded", "strips_through_grid")}
# the kernels line takes each kernel's launches from the phase-12 run of
# its own path: the heuristic segmenter's mask and the gather strips
# from the second run, every other kernel from the main path's
OTHER_PATH_KERNELS = ("sauvola", "strips_through_grid")
# what the grid scans need at least: per sample of a field evaluation
# 2 subtractions, 2 multiplications and 1 addition for d2, the softening
# addition, 1 division and 3 accumulations with 2 multiplications; per
# segment of a V step's intersection the segment and offset (4), the
# two cross products with their division (2 x 4 + 2), the denominator
# (3), its clamp (2), 3 comparisons, the select and the argmin compare
GRID_OPS_PER_SAMPLE = 12
GRID_OPS_PER_SEGMENT = 22
# the gather probe's sweep (scripts/pallas_gather_repro.py:97-99)
GATHER_SHAPES = ((8, 128, 128), (8, 256, 128), (8, 384, 256),
                 (32, 384, 256), (64, 384, 256), (64, 512, 256))


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


def time_cuda(fn, reps=REPS, flush=None):
    """Median ms of `fn()` over `reps` runs (CUDA events), after one
    warm-up run. `flush`: a tensor larger than the L2 cache, rewritten
    before each run so that `fn` finds its inputs in device memory."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush.zero_()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_burst(fn, n=REPS):
    """ms per call of `n` calls of `fn()` enqueued back to back between
    one pair of CUDA events: a kernel of tens of microseconds without
    the gap that timing each launch on its own puts around it."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def device_ms(fn, reps=10):
    """Device time per call of `fn()` in ms: the summed device time of
    the kernels (and copies) that torch.profiler records over `reps`
    calls, after one warm-up call; the host's time between launches is
    not in it. None when the profiler records no device event."""
    import torch
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()

    ms = _device_ms(profiled(run))
    return None if ms is None else ms / reps


def profiled(fn, attempts=3):
    """torch.profiler's record of `fn()` (CPU and CUDA activity, ending
    in a synchronize). The profiler sometimes returns a record without
    any device event for work that ran on the card; such a record is
    taken again, up to `attempts` times, and the last one returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        if _device_ms(prof) is not None:
            break
    return prof


def wall_ms(fn, reps):
    """Median host ms of `fn()` over `reps` runs, each between two
    synchronisations, after one warm-up run."""
    import torch
    fn()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def host_us(fn, n=200):
    """Host time per call of `fn()` in µs, `n` calls enqueued back to
    back (the card runs behind; synchronised after the clock stops)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def fmt_ms(ms):
    return "not measured" if ms is None else "%.4f ms" % ms


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
    widths (nb,), wmax, real rows)] on `device`, as LineExtractor.groups
    plans them for `--extract-mode mode`; the page's reader, the
    extractor and its parts."""
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
             wmax, len(paths))
            for _, paths, fr, wd, wmax, _ in ext.groups(parts)], reader, ext, \
        parts


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


def lattice_grid_cells(hv, res, groups, out_h):
    """How many distinct (gh, gw) grid nodes strip mode (b)'s 8-px
    lattice reads (through_grid_coords' inverse-grid lookup) for groups
    [(frames (N, 2, 3), out_w)]."""
    import torch
    gh, gw = hv.shape[:2]
    step = 8
    dev = hv.device
    mask = torch.zeros(gh * gw, dtype=torch.bool, device=dev)
    ys = (torch.arange(out_h // step + 2, device=dev) * step).float()
    for frames, out_w in groups:
        xs = (torch.arange(out_w // step + 2, device=dev) * step).float()
        f = frames[:, :, :, None, None]
        dx = f[:, 0, 0] * xs + f[:, 0, 1] * ys[:, None] + f[:, 0, 2]
        dy = f[:, 1, 0] * xs + f[:, 1, 1] * ys[:, None] + f[:, 1, 2]
        gx = torch.floor((dx / res).clamp(0.0, gw - 1 - 1e-6)).long()
        gy = torch.floor((dy / res).clamp(0.0, gh - 1 - 1e-6)).long()
        for oy in (0, 1):
            for ox in (0, 1):
                mask[(gy + oy).clamp(max=gh - 1) * gw
                     + (gx + ox).clamp(max=gw - 1)] = True
    return int(mask.sum())


def _norm_grid(x, y, w, h):
    import torch
    return torch.stack([2 * x / max(w - 1, 1) - 1,
                        2 * y / max(h - 1, 1) - 1], dim=-1)


def dewarp_grids(hv, h, w, res):
    """Phase 2's dewarp_u8 grids beyond a page's own, each of hv's
    shape: "scrambled" (every node drawn uniformly over the page, so
    every 4x4-cell tile's source window is about the whole page and every
    tile reads its taps through the read-only cache) and "sheared" (1 px
    per px along x, 0.5 along y, with a wave: windows of about 224 x 153
    bytes, over the 32 KB budget inside the page and under it where the
    page clamps them, so the tiles take both routes)."""
    import numpy as np
    import torch
    gh, gw = hv.shape[:2]
    rng = np.random.default_rng(11)
    scrambled = np.stack([rng.uniform(0, w - 1, (gh, gw)),
                          rng.uniform(0, h - 1, (gh, gw))], -1)
    ii, jj = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    sheared = np.stack([
        -600.0 + res * jj + 1.0 * res * ii + 3.1 * np.sin(ii / 2.3),
        -400.0 + res * ii + 0.5 * res * jj + 2.7 * np.cos(jj / 3.1)], -1)
    return {k: torch.from_numpy(v.astype(np.float32)).to(hv.device)
            for k, v in (("scrambled", scrambled), ("sheared", sheared))}


def strip_fns(name, src, grid=None):
    """Strip mode `name` on the page `src` (mode (b): through `grid` =
    (hv, res)) as four callables: the group-level kernel (frames, widths,
    out_w) and its plain version, the page-level kernel (frames, widths,
    desc, out, max_w) and its plain version."""
    from origami_tpu_torch.ops import remap as ops
    if name == "strips_dewarped":
        return (lambda fr, wd, ow: ops.strips_dewarped(src, fr, wd, 48, ow),
                lambda fr, wd, ow: ops.strips_dewarped_plain(src, fr, wd, 48,
                                                             ow),
                lambda fr, wd, d, out, mw: ops.strips_dewarped_page(
                    src, fr, wd, d, out, 48, mw),
                lambda fr, wd, d, out, mw: ops.strips_dewarped_page_plain(
                    src, fr, wd, d, out, 48, mw))
    hv, res = grid
    return (lambda fr, wd, ow: ops.strips_through_grid(src, hv, res, fr, wd,
                                                       48, ow),
            lambda fr, wd, ow: ops.strips_through_grid_plain(
                src, hv, res, fr, wd, 48, ow),
            lambda fr, wd, d, out, mw: ops.strips_through_grid_page(
                src, hv, res, fr, wd, d, out, 48, mw),
            lambda fr, wd, d, out, mw: ops.strips_through_grid_page_plain(
                src, hv, res, fr, wd, d, out, 48, mw))


def strip_page_args(groups):
    """Groups [(frames, widths, wmax, real rows)] on the card laid out in
    one buffer as LineExtractor.device_groups lays out a page: (frames
    (N, 2, 3), widths (N,), desc (N, 4), buffer bytes, widest wmax)."""
    import torch
    from origami_tpu_torch.ops import remap as ops
    desc, _, end = ops.strip_layout(
        [(len(fr), n, wmax) for fr, _, wmax, n in groups], 48)
    dev = groups[0][0].device
    return (torch.cat([g[0] for g in groups]),
            torch.cat([g[1] for g in groups]),
            torch.from_numpy(desc).to(dev), end,
            max(g[2] for g in groups))


def check_strip_groups(name, fns, groups, label):
    """Strip mode `name` against its plain version on `groups`: each
    group through the group-level entry, and all of them through one
    page-level launch -> max |diff| over both (it must be 0)."""
    import torch
    group_k, group_p, page_k, page_p = fns
    errs = [(group_k(fr, wd, wmax).int() - group_p(fr, wd, wmax).int())
            .abs().max() for fr, wd, wmax, _ in groups]
    fr, wd, desc, end, max_w = strip_page_args(groups)
    got = page_k(fr, wd, desc, torch.zeros(end, dtype=torch.uint8,
                                           device=fr.device), max_w)
    want = page_p(fr, wd, desc, torch.zeros(end, dtype=torch.uint8,
                                            device=fr.device), max_w)
    errs.append((got.int() - want.int()).abs().max())
    torch.cuda.synchronize()
    err = max(int(e) for e in errs)
    log("  %-20s %-26s %d groups of %s rows (%d real), wmax %s: max|diff| "
        "%d (tol 0) %s" % (
            name, label, len(groups), [len(g[0]) for g in groups],
            sum(g[3] for g in groups), [g[2] for g in groups], err,
            "ok" if err == 0 else "FAIL"))
    return err


def strip_times(name, fns, groups, src, grid=None):
    """One page's strip groups of mode `name`, timed: the page-level
    launch (events, device time), the group-level launches one after
    another (the earlier per-group path), the page-level plain version,
    the yardstick (one F.grid_sample per group at the precomputed
    coordinates; the port never calls it) and the bound (bytes: the
    distinct page pixels the taps read, mode (b)'s distinct grid nodes,
    the tables once, the strips written once)."""
    import torch
    import torch.nn.functional as F
    from origami_tpu_torch.ops import remap as ops
    group_k, _, page_k, page_p = fns
    fr, wd, desc, end, max_w = strip_page_args(groups)
    dev = fr.device
    h, w = src.shape
    out = torch.empty(end, dtype=torch.uint8, device=dev)
    plain_out = torch.empty_like(out)
    srcf = src.float()[None, None]
    taps, libs = [], []
    for gfr, gwd, wmax, _ in groups:
        if name == "strips_dewarped":
            xs = torch.arange(wmax, device=dev, dtype=torch.float32)
            ys = torch.arange(48, device=dev, dtype=torch.float32)
            sx = (gfr[:, 0, 0, None, None] * xs + gfr[:, 0, 1, None, None]
                  * ys[:, None] + gfr[:, 0, 2, None, None])
            sy = (gfr[:, 1, 0, None, None] * xs + gfr[:, 1, 1, None, None]
                  * ys[:, None] + gfr[:, 1, 2, None, None])
            keep = ((sx > -0.5) & (sx < w - 0.5) & (sy > -0.5)
                    & (sy < h - 0.5)
                    & (xs < gwd.float().clamp(min=2.0)[:, None, None]))
        else:
            sx, sy = ops.through_grid_coords(grid[0], grid[1], gfr, gwd, 48,
                                             wmax)
            keep = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
        taps.append((sx.reshape(-1), sy.reshape(-1), keep.reshape(-1)))
        libs.append((srcf.expand(len(gfr), 1, h, w), _norm_grid(sx, sy, w, h)))
    nbytes = (tapped_pixels(*(torch.cat(t) for t in zip(*taps)), h, w)
              + len(fr) * (16 + 24 + 4)
              + sum(len(g[0]) * 48 * g[2] for g in groups))
    if name == "strips_through_grid":
        nbytes += lattice_grid_cells(grid[0], grid[1],
                                     [(g[0], g[2]) for g in groups], 48) * 8

    def kernel():
        page_k(fr, wd, desc, out, max_w)

    def per_group():
        for gfr, gwd, wmax, _ in groups:
            group_k(gfr, gwd, wmax)

    def plain():
        page_p(fr, wd, desc, plain_out, max_w)

    def library():
        for img, g in libs:
            F.grid_sample(img, g, mode="bilinear", padding_mode="zeros",
                          align_corners=True)

    return dict(ms=time_cuda(kernel), device_ms=device_ms(kernel),
                group_ms=time_cuda(per_group),
                group_device_ms=device_ms(per_group),
                plain_ms=time_cuda(plain), library_ms=time_cuda(library),
                library_device_ms=device_ms(library),
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)


def strip_cases(device, h, w):
    """Phase 2's crafted strip groups over an (h, w) page, each [(frames
    (nb, 2, 3), widths (nb,), wmax, real rows)] on `device`: -> [(label,
    groups)]. A frame maps strip (x, y) to the page as a rotation by
    slope t and a scale s from its left top corner (x0, y0): x' = s x -
    t s y + x0, y' = t s x + s y + y0. The last case is every group in
    one page-level launch."""
    import numpy as np
    import torch
    rng = np.random.default_rng(23)

    def group(specs, nb, wmax):
        fr = np.zeros((nb, 2, 3), np.float32)
        wd = np.zeros(nb, np.int32)
        for k, (x0, y0, sc, t, width) in enumerate(specs):
            fr[k] = [[sc, -t * sc, x0], [t * sc, sc, y0]]
            wd[k] = width
        return (torch.from_numpy(fr).to(device),
                torch.from_numpy(wd).to(device), wmax, len(specs))

    tilted = group([(rng.uniform(20, w - 1000), rng.uniform(40, h - 100),
                     rng.uniform(0.6, 1.4), t, int(rng.integers(300, 2049)))
                    for t in (2e-2, -2e-2, 1e-2, -1e-2, 2e-2, 0.0)],
                   8, 2048)
    off_page = group([(-40.0, 100.0, 1.0, 0.0, 400),
                      (w - 200.0, 300.0, 1.0, 2e-2, 500),
                      (300.0, -30.0, 0.8, 0.0, 512),
                      (500.0, h - 20.0, 1.2, -2e-2, 512),
                      (-600.0, -600.0, 1.0, 0.0, 512),
                      (w - 0.4, h - 0.6, 1.0, 0.0, 300)], 8, 512)
    narrow = group([(100.0 + 40 * k, 200.0, 1.0, 2e-2, width)
                    for k, width in enumerate((0, 1, 2, 3, 17))], 8, 256)
    padded = group([(60.0, 400.0, 1.0, 5e-3, 200),
                    (80.0, 460.0, 0.9, 0.0, 230)], 32, 256)
    ragged = group([(120.0, 700.0, 1.0, 2e-2, 197),
                    (140.0, 760.0, 1.1, 0.0, 150),
                    (160.0, 820.0, 0.7, -1e-2, 300)], 5, 197)
    groups = [tilted, off_page, narrow, padded, ragged]
    return [("tilted 2e-2, wmax 2048", [tilted]),
            ("off the page", [off_page]), ("widths 0-3 and 17", [narrow]),
            ("padded rows 2 of 32", [padded]),
            ("ragged out_w 197", [ragged]),
            ("all five, one launch", groups)]


def warped_grid(hv, res):
    """A seeded warp of the grid hv: each node moved by a smooth field of
    up to ~8 px and a shear, so the lattice of mode (b) bends."""
    import numpy as np
    import torch
    gh, gw = hv.shape[:2]
    rng = np.random.default_rng(29)
    ii, jj = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    ph = rng.uniform(0, 2 * np.pi, 4)
    dx = 5.0 * np.sin(ii / 3.3 + ph[0]) + 3.0 * np.sin(jj / 5.1 + ph[1]) \
        + 0.02 * res * ii
    dy = 4.0 * np.cos(jj / 4.7 + ph[2]) + 2.5 * np.sin(ii / 2.9 + ph[3])
    d = torch.from_numpy(np.stack([dx, dy], -1).astype(np.float32))
    return (hv + d.to(hv.device)).contiguous()


def check_strip_cases(device, dew, px, hv, res):
    """Phase 2's crafted cases for both strip modes (strip_cases over the
    dewarped page; mode (b) through a seeded warped grid, plus frames
    whose dewarped coordinates leave the grid, so the inverse grid
    clamps): -> the failed cases."""
    import torch
    gh, gw = hv.shape[:2]
    failed = []
    cases = strip_cases(device, *dew.shape)
    hv_w = warped_grid(hv, res)
    fr = torch.tensor([[[1.0, 0.0, -300.0], [0.0, 1.0, -200.0]],
                       [[1.0, -0.02, (gw - 1) * res - 60.0],
                        [0.02, 1.0, 300.0]],
                       [[1.2, 0.0, 500.0], [0.0, 1.2, (gh - 1) * res + 40.0]],
                       [[0.8, 0.01, (gw + 3) * res], [-0.01, 0.8, -90.0]]],
                      device=device)
    leave = [(torch.cat([fr, torch.zeros_like(fr)]),
              torch.tensor([700, 600, 800, 512, 0, 0, 0, 0], device=device,
                           dtype=torch.int32), 1024, 4)]
    for name, src, grid, extra in (
            ("strips_dewarped", dew, None, []),
            ("strips_through_grid", px, (hv_w, res),
             [("leaving the grid", leave)])):
        fns = strip_fns(name, src, grid)
        for label, groups in cases + extra:
            if check_strip_groups(name, fns, groups, label) != 0:
                failed.append("%s %s" % (name, label))
    return failed


def earlier_device_groups(ext, parts):
    """LineExtractor.device_groups as it ran before the page-level
    launch: per group, its frames and widths uploaded (mode (b): the grid
    too) and one group-level launch."""
    import numpy as np
    import torch
    from origami_tpu_torch.ops import remap as ops
    for page, paths, fr, wd, wmax, prof in ext.groups(parts):
        dev = page.device
        fr_dev = torch.from_numpy(fr).to(dev)
        wd_dev = torch.from_numpy(wd).to(dev)
        if prof == "gather":
            hv = torch.from_numpy(np.ascontiguousarray(
                page.grid.points("sample"))).to(dev)
            strips = ops.strips_through_grid(
                page.device_pixels, hv, float(page.grid.resolution), fr_dev,
                wd_dev, 48, wmax, 255.0)
        else:
            strips = ops.strips_dewarped(page.dewarped_dev, fr_dev, wd_dev,
                                         48, wmax, 255.0)
        yield paths, strips, wd[: len(paths)].copy(), wmax


def counted(fn):
    """Run `fn()` once -> (host-to-device copies it made through
    Tensor.to, the uploads of LineExtractor.device_groups and of the
    earlier path; strip kernel launches, from the wrappers' counters).
    Counted at the call: torch.profiler's record may miss an event."""
    import torch
    from origami_tpu_torch.ops import remap as ops
    to = torch.Tensor.to
    copies = [0]

    def counting(self, *a, **k):
        out = to(self, *a, **k)
        copies[0] += self.device.type == "cpu" and out.device.type == "cuda"
        return out

    names = ("strips_dewarped", "strips_through_grid")
    before = sum(ops.launches[k] for k in names)
    own = "to" in vars(torch.Tensor)
    torch.Tensor.to = counting
    try:
        fn()
    finally:
        if own:
            torch.Tensor.to = to
        else:
            del torch.Tensor.to
    return copies[0], sum(ops.launches[k] for k in names) - before


def device_groups_ab(device):
    """One fixture page's LineExtractor.device_groups (one upload, one
    launch per mode) against the earlier per-group path
    (earlier_device_groups), both extract modes: the strips must be
    equal; host ms a call (median of 10, synchronised; in turns earlier,
    current, current, earlier), and the host-to-device copies and strip
    launches of one call (`counted`)."""
    import torch
    png = sorted(FIXTURE.glob("*.png"))[0]
    out = {}
    for mode in ("banded", "gather"):
        _, _, ext, parts = page_groups(png, device, mode)
        fns = {"current": lambda: list(ext.device_groups(parts)),
               "earlier": lambda: list(earlier_device_groups(ext, parts))}
        a, b = fns["current"](), fns["earlier"]()
        torch.cuda.synchronize()
        if len(a) != len(b) or not all(
                x[0] == y[0] and x[3] == y[3] and torch.equal(x[1], y[1])
                for x, y in zip(a, b)):
            raise PhaseError("device_groups (%s) cuts other strips than the "
                             "per-group path" % mode)
        walls = {"earlier": [], "current": []}
        for turn in ("earlier", "current", "current", "earlier"):
            walls[turn].append(wall_ms(fns[turn], 10))
        r = {}
        for turn, fn in fns.items():
            copies, launches = counted(fn)
            r[turn] = dict(ms=statistics.mean(walls[turn]), copies=copies,
                           launches=launches)
        out[mode] = r
        log("  device_groups %-7s %d groups: %.3f ms a page, %d host-to-device "
            "copies, %d strip launches (earlier per-group path %.3f ms, %d "
            "copies, %d launches); strips equal" % (
                mode, len(a), r["current"]["ms"], r["current"]["copies"],
                r["current"]["launches"], r["earlier"]["ms"],
                r["earlier"]["copies"], r["earlier"]["launches"]))
    return out


def separator_mask(png, device, h, w):
    """The page's separator label mask (its JAX segment.zip), resized
    onto the (h, w) warped page as the layout stage resizes it before
    the remap: f32 on the card."""
    import torch
    from origami_tpu_torch.core.segment import PredictorType, Segmentation
    from origami_tpu_torch.ops import binarize
    from origami_tpu_torch.ops.resize import resize
    seg = Segmentation.open(FIXTURE / (png.stem + ".out") / "segment.zip")
    sep = [p.labels != p.classes["BACKGROUND"].value
           for p in seg.predictions if p.type == PredictorType.SEPARATOR][0]
    return resize(torch.from_numpy(sep).to(device).float(), (h, w),
                  binarize._JAX_LINEAR).contiguous()


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
    images = []          # [(page u8, dewarped page u8)] for check_sauvola
    timed = ("ms", "plain_ms", "bound_ms", "library_ms", "device_ms",
             "library_device_ms")

    def report(name, got, want, tol, kernel, plain, nbytes, library, shape):
        diff = (got.double() - want.double()).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        ok = err <= tol
        t = dict(ms=time_cuda(kernel), plain_ms=time_cuda(plain),
                 bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                 library_ms=time_cuda(library), device_ms=device_ms(kernel),
                 library_device_ms=device_ms(library))
        log("  %-20s %-30s max|diff| %.3g (tol %g) %s  kernel %.4f ms "
            "(device %s)  plain %.4f ms  bound %.4f ms  grid_sample %.4f ms "
            "(device %s)" % (
                name, shape, err, tol, "ok" if ok else "FAIL", t["ms"],
                fmt_ms(t["device_ms"]), t["plain_ms"], t["bound_ms"],
                t["library_ms"], fmt_ms(t["library_device_ms"])))
        if not ok:
            failures.append(name)
        row = rows.setdefault(name, dict({k: 0.0 for k in timed}, err=0.0))
        row["err"] = max(row["err"], err)
        for k in timed:
            row[k] = None if row[k] is None or t[k] is None \
                else row[k] + t[k]

    def dewarp_only(label, page, grid, res, want_route):
        """dewarp_u8 against its plain version (bit-equal) on a grid off
        the main path, with the count of tiles that staged a window."""
        staged = torch.zeros(1, dtype=torch.int32, device=device)
        got = ops.dewarp_u8(page, grid, res, staged_tiles=staged)
        want = ops.dewarp_u8_plain(page, grid, res)
        torch.cuda.synchronize()
        err = float((got.int() - want.int()).abs().max())
        gh, gw = grid.shape[:2]
        tiles = -(-gh // 4) * -(-gw // 4)
        n_staged = int(staged)
        route_ok = {"staged": n_staged == tiles, "direct": n_staged == 0,
                    "any": True}[want_route]
        log("  %-20s %-30s max|diff| %g (tol 0) %s  tiles %d: %d staged, "
            "%d read through __ldg  kernel %.4f ms  plain %.4f ms" % (
                "dewarp_u8", "%s %dx%d" % ((label,) + tuple(page.shape)),
                err, "ok" if err == 0 and route_ok else "FAIL", tiles,
                n_staged, tiles - n_staged,
                time_cuda(lambda: ops.dewarp_u8(page, grid, res)),
                time_cuda(lambda: ops.dewarp_u8_plain(page, grid, res))))
        if err != 0 or not route_ok:
            failures.append("dewarp_u8 %s" % label)
        return n_staged, tiles

    for i, png in enumerate(pages):
        log(" page %s" % png.name)
        groups, reader, _, _ = page_groups(png, device, "banded")
        page = reader.page
        px = page.device_pixels
        h, w = px.shape
        hv = torch.from_numpy(page.grid.points("sample")).to(device)
        res = page.grid.resolution
        gh, gw = hv.shape[:2]

        # dewarp_u8 (the dewarp kernel on the main path): bit-equal
        got = ops.dewarp_u8(px, hv, res)
        want = ops.dewarp_u8_plain(px, hv, res)
        torch.cuda.synchronize()
        mx, my = ops._upsample_grid(hv, res)
        inb = (mx >= 0) & (mx <= w - 1) & (my >= 0) & (my <= h - 1)
        grid = _norm_grid(mx, my, w, h)[None]
        pxf = px.float()[None, None]
        report("dewarp_u8", got, want, 0,
               lambda: ops.dewarp_u8(px, hv, res),
               lambda: ops.dewarp_u8_plain(px, hv, res),
               tapped_pixels(mx, my, inb, h, w) + hv.numel() * 4
               + got.numel(),
               lambda: F.grid_sample(pxf, grid, mode="bilinear",
                                     padding_mode="zeros",
                                     align_corners=True),
               "%dx%d -> %dx%d" % (h, w, gh * res, gw * res))
        dew = got
        images.append((px, dew))
        # both tile routes: the page's own grid stages every tile's
        # window, the scrambled grid none; the sheared grid mixes them;
        # a ragged crop (rows not 16-byte aligned) stages with byte loads
        dewarp_only("own grid", px, hv, res, "staged")
        if i == 0:
            extra = dewarp_grids(hv, h, w, res)
            dewarp_only("scrambled grid", px, extra["scrambled"], res,
                        "direct")
            dewarp_only("sheared grid", px, extra["sheared"], res, "any")
            crop = px[100:297, 60:311].contiguous()
            shift = torch.tensor([60.0, 100.0], device=device)
            dewarp_only("ragged crop", crop, (hv - shift).contiguous(), res,
                        "any")

        # remap (remap_pallas' function, f32, fill 0): on the layout
        # stage's path it dewarps the separator mask, resized onto the
        # warped page as that stage resizes it ("remap"); the page's own
        # pixels through the same map are a second case ("remap_page")
        map_xy = torch.stack([mx, my], dim=-1).contiguous()
        for name, img in (("remap", separator_mask(png, device, h, w)),
                          ("remap_page", px.float().contiguous())):
            got = ops.remap(img, map_xy, 0.0)
            want = ops.remap_plain(img, map_xy, 0.0)
            torch.cuda.synchronize()
            report(name, got, want, F32_TOL,
                   lambda: ops.remap(img, map_xy, 0.0),
                   lambda: ops.remap_plain(img, map_xy, 0.0),
                   tapped_pixels(map_xy[..., 0].clamp(-2.0, w + 1.0),
                                 map_xy[..., 1].clamp(-2.0, h + 1.0),
                                 torch.ones_like(mx, dtype=torch.bool), h,
                                 w) * 4
                   + map_xy.numel() * 4 + got.numel() * 4,
                   lambda: F.grid_sample(img[None, None], grid,
                                         mode="bilinear",
                                         padding_mode="zeros",
                                         align_corners=True),
                   "%dx%d -> %dx%d" % (h, w, *map_xy.shape[:2]))

        # the strip kernels: every main-path group of the page through
        # the group-level entry and all of them through one page-level
        # launch per mode, bit-equal; timed per page; the crafted cases
        # on the first page
        for name, sgroups, src, grid in (
                ("strips_dewarped", groups, dew, None),
                ("strips_through_grid",
                 page_groups(png, device, "gather")[0], px,
                 (hv, float(res)))):
            fns = strip_fns(name, src, grid)
            if check_strip_groups(name, fns, sgroups,
                                  "page %s" % png.stem) != 0:
                failures.append(name)
            t = strip_times(name, fns, sgroups, src, grid)
            log("  %-20s page %s, %d launches -> 1: page launch %.4f ms "
                "(device %s)  per-group launches %.4f ms (device %s)  plain "
                "%.4f ms  bound %.5f ms  grid_sample x %d %.4f ms (device %s)"
                % (name, png.stem, len(sgroups), t["ms"],
                   fmt_ms(t["device_ms"]), t["group_ms"],
                   fmt_ms(t["group_device_ms"]), t["plain_ms"],
                   t["bound_ms"], len(sgroups), t["library_ms"],
                   fmt_ms(t["library_device_ms"])))
            row = rows.setdefault(name, dict({k: 0.0 for k in t}, err=0.0))
            for k, v in t.items():
                row[k] = None if row[k] is None or v is None else row[k] + v
        if i == 0:
            failures += check_strip_cases(device, dew, px, hv, float(res))
    if failures:
        raise PhaseError("kernel disagrees with its plain version: %s"
                         % ", ".join(sorted(set(failures))))
    n_pages = len(pages)
    # per page: the sum over that page's launches, averaged over pages
    for name, row in rows.items():
        for k in row:
            if k != "err" and row[k] is not None:
                row[k] /= n_pages
        row["bound_by"] = "bytes"
        log("  %s per page: kernel %.4f ms (device %s)%s  plain %.4f ms  "
            "bound %.5f ms  grid_sample %.4f ms (device %s)" % (
                name, row["ms"], fmt_ms(row["device_ms"]),
                "" if "group_ms" not in row else
                "  [per-group launches %.4f ms (device %s)]" % (
                    row["group_ms"], fmt_ms(row["group_device_ms"])),
                row["plain_ms"], row["bound_ms"], row["library_ms"],
                fmt_ms(row["library_device_ms"])))
    rows.update(check_sauvola(images))
    return rows


def sauvola_library(image, window, k=0.2, r=128.0, border="clamp"):
    """The yardstick: Sauvola from two F.avg_pool2d calls (the window's
    mean of v and of v^2; count_include_pad picks the border rule) and
    the elementwise formula. The port never calls it."""
    import torch
    import torch.nn.functional as F
    v = image.float()[None, None]
    pad = border == "zero"
    mean = F.avg_pool2d(v, window, 1, window // 2, count_include_pad=pad)
    sq = F.avg_pool2d(v * v, window, 1, window // 2, count_include_pad=pad)
    std = torch.sqrt(torch.clamp(sq - mean * mean, min=0.0))
    return (v > mean * (1.0 + k * (std / r - 1.0)))[0, 0]


# the Sauvola windows of phase 2's sweep: the main path's 15 and 31, the
# layout stage's range (33 and up), 259 (64-bit sums on a full page) and
# 513, larger than the ragged crop
SAUVOLA_WINDOWS = (15, 31, 33, 41, 63, 101, 259, 513)


def sauvola_bound(img, out):
    """(bound ms, "bytes" or "operations") of one Sauvola call."""
    t_bytes = (img.numel() + out.numel()) / HBM_BYTES_PER_S * 1e3
    t_ops = img.numel() * SAUVOLA_OPS_PER_PIXEL / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sauvola_times(kernel, plain, img, window, border, flush):
    """A Sauvola call's times: events, back to back, L2-cold, device, the
    plain version's events and the F.avg_pool2d yardstick's events and
    device time."""
    def library():
        return sauvola_library(img, window, border=border)
    return dict(ms=time_cuda(kernel), burst_ms=time_burst(kernel),
                cold_ms=time_cuda(kernel, flush=flush),
                plain_ms=time_cuda(plain), library_ms=time_cuda(library),
                device_ms=device_ms(kernel) or 0.0,
                library_device_ms=device_ms(library) or 0.0)


def layout_windows():
    """The Sauvola window the layout stage takes on each fixture page
    (from the median dewarped height of the JAX stage's lines)."""
    import tempfile
    import torch
    from origami_tpu_torch.batch.core.io import Artifact, Input, Stage
    from origami_tpu_torch.batch.detect.layout import RegionState
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        corpus = layout_corpus(Path(tmp) / "c")
        proc = _Proc(torch.device("cuda"))
        for png in sorted(corpus.glob("*.png")):
            warped = Input(Artifact.CONTOURS, Artifact.LINES,
                           Artifact.SEGMENTATION, stage=Stage.WARPED) \
                .instantiate(png, proc)
            dew = Input(Artifact.CONTOURS, stage=Stage.DEWARPED) \
                .instantiate(png, proc)
            out.append(RegionState(
                dew.page, warped.lines.by_path,
                [(k, b.image_space_polygon)
                 for k, b in dew.regions.by_path.items()],
                dew.separators, warped.segmentation,
                grid=dew.grid).sauvola_window())
    return out


def check_sauvola(images):
    """Phase 2, the Sauvola kernel: every variant (both outputs, both
    borders, SAUVOLA_WINDOWS and the layout stage's windows) against its
    plain version (they must agree exactly) at a fixture page, its
    dewarped page and a ragged crop; the rows are the main path's two
    launches (packed, window 15 and mask, window 31, both "clamp", on
    the warped page), per page. Also timed: the layout stage's launch
    (packed on the dewarped page at its window), window 41 packed on the
    dewarped page and window 63 on the page, beside window 15."""
    import itertools
    import torch
    from origami_tpu_torch.ops import binarize as ops
    wrappers = {"sauvola": (ops.sauvola, ops.sauvola_plain),
                "sauvola_packed": (ops.sauvola_packed,
                                   ops.sauvola_packed_plain)}
    main = {("sauvola_packed", 15, "clamp"), ("sauvola", 31, "clamp")}
    layout = {("dew", "sauvola_packed", w, "clamp")
              for w in layout_windows()}
    extra = {("dew", "sauvola_packed", 41, "clamp"),
             ("page", "sauvola_packed", 63, "clamp"),
             ("page", "sauvola", 63, "clamp")} | layout
    windows = sorted(set(SAUVOLA_WINDOWS) | {w for *_, w, _ in layout})
    timed = ("ms", "burst_ms", "cold_ms", "plain_ms", "bound_ms",
             "library_ms", "device_ms", "library_device_ms")
    rows = {name: dict({k: 0.0 for k in timed}, err=0.0, bound_by="bytes")
            for name in wrappers}
    flush = torch.empty(64 << 20, dtype=torch.uint8,
                        device=images[0][0].device)
    # every variant at three shapes on the first page, then the main
    # path's two launches on every other page
    px0, dew0 = images[0]
    shapes = (("page", px0), ("dew", dew0),
              ("crop", px0[100:297, 60:311].contiguous()))
    cases = [(label, img, *v) for label, img in shapes
             for v in itertools.product(wrappers, windows,
                                        ("clamp", "zero"))]
    cases += [("page", px, *v) for px, _ in images[1:] for v in sorted(main)]
    pages = {id(px) for px, _ in images}
    failures = []
    for label, img, name, window, border in cases:
        fn, plain = wrappers[name]
        h, w = img.shape
        row = rows[name]

        def kernel():
            return fn(img, window, border=border)

        def plain_call():
            return plain(img, window, border=border)

        got = kernel()
        want = plain_call()
        torch.cuda.synchronize()
        err = float((got.to(torch.int16) - want.to(torch.int16))
                    .abs().max())
        row["err"] = max(row["err"], err)
        if err != 0:
            failures.append("%s %dx%d w%d %s" % (name, h, w, window, border))
        ms = time_cuda(kernel)
        bound, bound_by = sauvola_bound(img, got)
        line = ("  %-15s %-4s %4dx%-4d w%-3d %-5s max|diff| %g %s  kernel "
                "%.4f ms  bound %.5f ms (%s)" % (
                    name, label, h, w, window, border, err,
                    "ok" if err == 0 else "FAIL", ms, bound, bound_by))
        is_main = id(img) in pages and (name, window, border) in main
        if is_main or (label, name, window, border) in extra:
            lib = sauvola_library(img, window, border=border)
            mask = ops.sauvola_plain(img, window, border=border)
            times = sauvola_times(kernel, plain_call, img, window, border,
                                  flush)
            times["bound_ms"] = bound
            line += ("  back to back %.4f ms  L2-cold %.4f ms  device %.4f "
                     "ms  plain %.4f ms  avg_pool2d %.4f ms (device %.4f ms;"
                     " %.5f of its pixels equal)%s" % (
                         times["burst_ms"], times["cold_ms"],
                         times["device_ms"], times["plain_ms"],
                         times["library_ms"], times["library_device_ms"],
                         float((lib == mask).float().mean()),
                         "" if is_main else "  [the layout stage's launch]"
                         if (label, name, window, border) in layout
                         else "  [off the main path]"))
            if is_main:
                for k in timed:
                    row[k] += times[k]
                row["bound_by"] = bound_by
        log(line)
    if failures:
        raise PhaseError("the Sauvola kernel disagrees with its plain "
                         "version: %s" % ", ".join(failures))
    for name, row in rows.items():
        for k in timed:
            row[k] /= len(images)
        log("  %s per page: kernel %.4f ms (back to back %.4f, L2-cold "
            "%.4f, device %.4f)  plain %.4f ms  bound %.5f ms (%s)  "
            "avg_pool2d %.4f ms (device %.4f)"
            % (name, row["ms"], row["burst_ms"], row["cold_ms"],
               row["device_ms"], row["plain_ms"], row["bound_ms"],
               row["bound_by"], row["library_ms"], row["library_device_ms"]))
    return rows


def gather_probe_case(kind, r, w, c, pattern, seed=0):
    """The probe's inputs (scripts/pallas_gather_repro.py:32-60) as
    numpy: source, indices and the numpy truth."""
    import numpy as np
    rng = np.random.default_rng(seed)
    if kind == "lane":
        arr = np.arange(r * w, dtype=np.float32).reshape(r, w) % 251.0
        if pattern == "random":
            idx = rng.integers(0, w, size=(r, c))
        elif pattern == "affine":
            idx = np.linspace(0, w - 1, c)[None, :] \
                + rng.uniform(-3, 3, size=(r, 1))
        else:
            idx = np.tile(np.arange(c) % w, (r, 1))
    else:
        arr = np.arange(w * c, dtype=np.float32).reshape(w, c) % 251.0
        if pattern == "random":
            idx = rng.integers(0, w, size=(r, c))
        elif pattern == "affine":
            idx = np.linspace(0, w - 1, r)[:, None] \
                + rng.uniform(-3, 3, size=(1, c))
        else:
            idx = np.tile((np.arange(r) % w)[:, None], (1, c))
    idx = np.clip(idx, 0, w - 1).astype(np.int32)
    axis = 1 if kind == "lane" else 0
    return arr, idx, np.take_along_axis(arr, idx, axis=axis)


def grid_case(kind, w, h, seed=3, n=60):
    """Padded grid-build inputs over a w x h page: [h_xy, h_phi, h_mask,
    v_xy, v_phi, v_mask] (numpy float32, 1024 samples) and (n_gy, n_gx),
    as GridFactory shapes them. `kind`: "seeded" (H samples near 0 rad,
    V near pi/2, a smooth warp and noise), "miss" (the same, but the V
    samples of the left 30 % point up, so the rays there miss the next
    H row and take the field step; at the full page the rays that turn
    through the horizontal between the two halves make the grid
    ill-conditioned, ROADMAP.md queue C), "upward" (every V sample
    points up: every ray misses every row), "empty" (no samples: the fields fall
    back to phi0 and the grid is the regular lattice, every ray through a
    vertex, an exact tie of two segments)."""
    import math
    import numpy as np
    from origami_tpu_torch.core import dewarp
    rng = np.random.default_rng(seed)
    padded = []
    for base in (0.0, math.pi / 2):
        pts = np.c_[rng.uniform(0, w, n), rng.uniform(0, h, n)]
        phi = base + 0.03 * np.sin(pts[:, 0] / 70.0) + rng.normal(0, 0.01, n)
        if kind == "miss" and base > 0:
            phi = np.where(pts[:, 0] < 0.3 * w,
                           -math.pi / 2 + rng.normal(0, 0.01, n), phi)
        if kind == "upward" and base > 0:
            phi = -math.pi / 2 + rng.normal(0, 0.01, n)
        if kind == "empty":
            pts, phi = pts[:0], phi[:0]
        padded += list(dewarp._pad_samples(pts, phi, 1024))
    n_gx = dewarp._round_up(math.ceil(w / 25) + 6, 8)
    n_gy = dewarp._round_up(math.ceil(h / 25) + 6, 8)
    return padded, (n_gy, n_gx)


def page_grid_inputs(png, device):
    """A fixture page's grid-build inputs, as the dewarp stage makes
    them from the JAX flow.zip: the padded H and V samples on `device`
    and the grid shape (n_gy, n_gx)."""
    import torch
    from origami_tpu_torch.batch.core.io import Artifact, Input, Stage
    from origami_tpu_torch.core import dewarp
    corpus = Path(tempfile.mkdtemp(prefix="chip_smoke_site_"))
    try:
        flow_corpus(corpus, [png], with_flow=True)
        reader = Input(Artifact.CONTOURS, Artifact.FLOW,
                       stage=Stage.WARPED).instantiate(
            corpus / png.name, _Proc(device))
        fh, fv = reader.flow["h"], reader.flow["v"]
        shape = dewarp.GridFactory(reader.page.size(), fh, fv,
                                   device=device).shape()
    finally:
        shutil.rmtree(corpus, ignore_errors=True)
    padded = [torch.from_numpy(a).to(device)
              for f in (fh, fv)
              for a in dewarp._pad_samples(f.points, f.values, 1024)]
    return padded, shape


def site_inputs(device):
    """The lane gather's inputs at the grid build's site: every (t_sel,
    best) pair that the V scan of the first fixture page's grid build
    gathers from (its JAX flow.zip), recorded from the plain build on the
    card; the stage's own build gathers inside the V scan kernel."""
    from origami_tpu_torch.ops import gather, grid
    padded, shape = page_grid_inputs(sorted(FIXTURE.glob("*.png"))[0],
                                     device)
    recorded = []
    plain = gather.take_along_axis_plain

    def record(src, idx, axis):
        recorded.append((src.clone(), idx.clone(), axis))
        return plain(src, idx, axis)

    gather.take_along_axis_plain = record
    try:
        grid.build_grid_plain(*padded, *shape, 25)
    finally:
        gather.take_along_axis_plain = plain
    return recorded


def check_gather(device):
    """Phase 2, the gather kernel: lane and sublane over the probe's
    sweep and at the grid build's inputs, each against numpy's
    take_along_axis and the plain version (max |diff| must be 0); times
    at the probe's largest shape and per page at the site (the inputs
    of the plain grid build's 87 gathers; the stage's build gathers
    inside the V scan kernel). Returns the lane and sublane rows, both
    off the stages' paths."""
    import numpy as np
    import torch
    from origami_tpu_torch.ops import gather
    failures = []
    rows = {name: dict(err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                       library_ms=0.0, bound_by="bytes")
            for name in ("take_along_axis_lane", "take_along_axis_sublane")}

    def gather_bytes(src, idx, axis):
        # indices and outputs once, plus the distinct source elements
        # the indices name (4 bytes each)
        n = src.shape[axis]
        k = idx.long().clamp(0, n - 1)
        other = torch.arange(idx.shape[1 - axis], device=idx.device)
        other = other[:, None] if axis == 1 else other[None, :]
        flat = other * n + k
        return (idx.numel() * 8
                + int(torch.unique(flat).numel()) * 4)

    def compare(name, src, idx, axis, truth=None):
        got = gather.take_along_axis(src, idx, axis)
        want = gather.take_along_axis_plain(src, idx, axis)
        torch.cuda.synchronize()
        errs = [float((got - want).abs().nan_to_num(0.0).max())
                if got.numel() else 0.0]
        same_inf = bool(torch.equal(torch.isinf(got), torch.isinf(want)))
        if truth is not None:
            errs.append(float(np.abs(got.cpu().numpy() - truth).max()))
        err = max(errs)
        rows[name]["err"] = max(rows[name]["err"], err)
        if err != 0 or not same_inf:
            failures.append("%s %s -> %s" % (name, tuple(src.shape),
                                             tuple(idx.shape)))
        return err

    for kind in ("lane", "sublane"):
        name = "take_along_axis_" + kind
        axis = 1 if kind == "lane" else 0
        for pattern in ("identity", "affine", "random"):
            for r, w, c in GATHER_SHAPES:
                arr, idx, truth = gather_probe_case(kind, r, w, c, pattern)
                src = torch.from_numpy(arr).to(device)
                ix = torch.from_numpy(idx).to(device)
                compare(name, src, ix, axis, truth)
        # the probe's largest shape, timed per launch (the sublane row
        # of the table: no stage launches that variant)
        arr, idx, _ = gather_probe_case(kind, *GATHER_SHAPES[-1], "affine")
        src = torch.from_numpy(arr).to(device)
        ix = torch.from_numpy(idx).to(device)
        ix64 = ix.long()
        probe = dict(
            ms=time_cuda(lambda: gather.take_along_axis(src, ix, axis)),
            burst_ms=time_burst(lambda: gather.take_along_axis(src, ix,
                                                               axis)),
            plain_ms=time_cuda(lambda: gather.take_along_axis_plain(
                src, ix, axis)),
            library_ms=time_cuda(lambda: torch.gather(src, axis, ix64)),
            bound_ms=gather_bytes(src, ix, axis) / HBM_BYTES_PER_S * 1e3,
            device_ms=device_ms(lambda: gather.take_along_axis(src, ix,
                                                               axis)),
            library_device_ms=device_ms(lambda: torch.gather(src, axis,
                                                             ix64)))
        log("  %-24s affine probe r,w,c=%s, per launch: kernel %.4f ms "
            "(back to back %.4f, device %s)  plain %.4f ms  torch.gather "
            "%.4f ms (device %s)  bound %.6f ms (bytes)" % (
                name, GATHER_SHAPES[-1], probe["ms"], probe["burst_ms"],
                fmt_ms(probe["device_ms"]), probe["plain_ms"],
                probe["library_ms"], fmt_ms(probe["library_device_ms"]),
                probe["bound_ms"]))
        if kind == "sublane":
            rows[name].update({k: probe[k] for k in
                               ("ms", "plain_ms", "library_ms",
                                "bound_ms")})

    # the grid build's own inputs: (n_gx, n_gx - 1) t values with inf
    # where a ray misses, gathered at the argmin of each row
    site = site_inputs(device)
    n_inf = 0
    for src, idx, axis in site:
        truth = np.take_along_axis(src.cpu().numpy(),
                                   idx.long().cpu().numpy(), axis=axis)
        n_inf += int(np.isinf(truth).sum())
        compare("take_along_axis_lane", src, idx, axis, None)
        got = gather.take_along_axis(src, idx, axis).cpu().numpy()
        if not np.array_equal(got, truth):
            failures.append("take_along_axis_lane at the site")
    idx64 = [i.long() for _, i, _ in site]

    def per_page(fn):
        def run():
            for (src, idx, axis), i64 in zip(site, idx64):
                fn(src, idx, axis, i64)
        return run

    row = rows["take_along_axis_lane"]
    row.update(
        ms=time_cuda(per_page(lambda s, i, a, i64:
                              gather.take_along_axis(s, i, a))),
        plain_ms=time_cuda(per_page(lambda s, i, a, i64:
                                    gather.take_along_axis_plain(s, i, a))),
        library_ms=time_cuda(per_page(lambda s, i, a, i64:
                                      torch.gather(s, a, i64))),
        bound_ms=sum(gather_bytes(s, i, a) for s, i, a in site)
        / HBM_BYTES_PER_S * 1e3)
    burst = time_burst(per_page(lambda s, i, a, i64:
                                gather.take_along_axis(s, i, a)))
    # the kernel's own device time over a page's launches: the events
    # above also hold the host's time between launches
    prof = profiled(per_page(lambda s, i, a, i64:
                             gather.take_along_axis(s, i, a)))
    dev_ms = sum(e.device_time for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "gather_kernel" in e.name) / 1e3
    row["library_device_ms"] = device_ms(
        per_page(lambda s, i, a, i64: torch.gather(s, a, i64)), reps=3)
    log("  take_along_axis_lane    at the grid build site: %d launches per "
        "page of %s -> %s (%d of the gathered values inf): per page "
        "kernel %.4f ms (back to back %.4f; device time of the kernels "
        "alone %.4f ms)  plain %.4f ms  torch.gather %.4f ms (device %s)  "
        "bound %.6f ms (bytes)" % (
            len(site), tuple(site[0][0].shape), tuple(site[0][1].shape),
            n_inf, row["ms"], burst, dev_ms, row["plain_ms"],
            row["library_ms"], fmt_ms(row["library_device_ms"]),
            row["bound_ms"]))
    row["device_ms"] = dev_ms
    if failures:
        raise PhaseError("the gather kernel disagrees: %s"
                         % ", ".join(failures[:10]))
    return rows


def check_grid(device, lane_row):
    """Phase 2, the grid scan kernels: grid_scan (the H and the V kernel)
    against the plain build on the card over the fixture pages' inputs
    and the cases of grid_case (seeded samples at 400x300 and the full
    page, rays that miss at 400x300, every ray missing at the full page,
    no samples); nodes within GRID_PX, and the
    segment each V step chose equal on the fixture pages. Times per page
    at the fixture pages' inputs. `lane_row`: the lane gather's row, whose
    torch.gather time at the site is the V kernel's yardstick. Returns
    the grid_scan_h and grid_scan_v rows."""
    import torch
    from origami_tpu_torch.ops import grid
    from origami_tpu_torch.ops import remap as ops
    pages = sorted(FIXTURE.glob("*.png"))
    cases = [("fixture %s" % p.stem, *page_grid_inputs(p, device), True)
             for p in pages]
    for kind, w, h in (("seeded", 400, 300), ("seeded", 1312, 1920),
                       ("miss", 400, 300), ("upward", 1312, 1920),
                       ("empty", 1312, 1920)):
        padded, shape = grid_case(kind, w, h)
        cases.append(("%s %dx%d" % (kind, w, h),
                      [torch.from_numpy(a).to(device) for a in padded],
                      shape, False))
    failures = []
    worst = 0.0
    nearest = grid._nearest_hit

    def dm(fn, reps=10):
        ms = device_ms(fn, reps)
        return float("nan") if ms is None else ms

    misses = []

    def count_misses(t_sel):
        best, t_best = nearest(t_sel)
        misses.append(int((~torch.isfinite(t_best)).sum()))
        return best, t_best

    for label, padded, shape, gate_best in cases:
        n_gy, n_gx = shape
        bk = torch.full((n_gy - 1, n_gx), -1, dtype=torch.int32,
                        device=device)
        bp = torch.full_like(bk, -1)
        got = grid.grid_scan(*padded, n_gy, n_gx, 25, best=bk)
        misses.clear()
        grid._nearest_hit = count_misses
        try:
            want = grid.build_grid_plain(*padded, n_gy, n_gx, 25, best=bp)
        finally:
            grid._nearest_hit = nearest
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(got).all())
        err = float((got - want).abs().max())
        same_best = float((bk == bp).float().mean())
        ok = finite and err <= GRID_PX and (same_best == 1.0
                                            or not gate_best)
        worst = max(worst, err)
        log("  grid_scan  %-22s grid %dx%d: nodes max|diff| %.3g px (tol "
            "%g)  segment choice equal %.4f%s  rays that missed %d  %s" % (
                label, n_gy, n_gx, err, GRID_PX, same_best,
                " (gated)" if gate_best else "", sum(misses),
                "ok" if ok else "FAIL"))
        if not ok:
            failures.append(label)
    if failures:
        raise PhaseError("the grid scan kernels disagree with the plain "
                         "build: %s" % ", ".join(failures))

    names = ("grid_scan_h", "grid_scan_v")
    timed = ("ms", "device_ms", "plain_ms", "plain_device_ms", "bound_ms",
             "chain_ms", "build_wall_ms", "build_device_ms",
             "plain_wall_ms", "plain_build_device_ms")
    rows = {n: dict({k: 0.0 for k in timed}, err=worst, library_ms=None,
                    bound_by="operations") for n in names}
    for label, padded, shape, _ in cases[:len(pages)]:
        n_gy, n_gx = shape
        h_xy, h_phi, h_mask, v_xy, v_phi, v_mask = padded
        n_h, n_v = h_xy.shape[0], v_xy.shape[0]
        grid_h = torch.empty((n_gy, n_gx, 2), device=device)
        out = torch.empty_like(grid_h)
        short = torch.empty((n_gy, 8, 2), device=device)

        def run_h(cols=n_gx, dst=grid_h):
            ops._launch("origami_grid_scan_h", ops._ptr(h_xy),
                        ops._ptr(h_phi), ops._ptr(h_mask), n_h, n_gy, cols,
                        25.0, -50.0, ops._ptr(dst))

        def run_v(rows_=n_gy):
            ops._launch("origami_grid_scan_v", ops._ptr(grid_h),
                        ops._ptr(v_xy), ops._ptr(v_phi), ops._ptr(v_mask),
                        n_v, rows_, n_gx, 25.0, ops._ptr(out), None)

        run_h()
        gh_plain = grid.scan_h_plain(h_xy, h_phi, h_mask, n_gy, n_gx, 25)
        torch.cuda.synchronize()
        dev = {"h": dm(run_h), "v": dm(run_v)}
        # one step's latency: the slope of a kernel's device time over
        # its number of steps (H: 8 columns against n_gx; V: 8 rows
        # against n_gy)
        h_step = (dev["h"] - dm(lambda: run_h(8, short))) / (n_gx - 8)
        v_step = (dev["v"] - dm(lambda: run_v(8))) / (n_gy - 8)
        real_h, real_v = float(h_mask.sum()), float(v_mask.sum())
        ops_h = n_gy * (n_gx - 1) * real_h * GRID_OPS_PER_SAMPLE
        ops_v = n_gx * (n_gy - 1) * (real_v * GRID_OPS_PER_SAMPLE
                                     + (n_gx - 1) * GRID_OPS_PER_SEGMENT)
        grid_bytes = n_gy * n_gx * 8
        bytes_h = n_h * 16 + grid_bytes
        bytes_v = n_v * 16 + 2 * grid_bytes
        t = {
            "grid_scan_h": dict(
                ms=time_cuda(run_h), device_ms=dev["h"],
                plain_ms=time_cuda(lambda: grid.scan_h_plain(
                    h_xy, h_phi, h_mask, n_gy, n_gx, 25), reps=5),
                plain_device_ms=dm(lambda: grid.scan_h_plain(
                    h_xy, h_phi, h_mask, n_gy, n_gx, 25), reps=2),
                ops=ops_h, bytes=bytes_h, chain_ms=(n_gx - 1) * h_step),
            "grid_scan_v": dict(
                ms=time_cuda(run_v), device_ms=dev["v"],
                plain_ms=time_cuda(lambda: grid.scan_v_plain(
                    gh_plain, v_xy, v_phi, v_mask, 25), reps=5),
                plain_device_ms=dm(lambda: grid.scan_v_plain(
                    gh_plain, v_xy, v_phi, v_mask, 25), reps=2),
                ops=ops_v, bytes=bytes_v, chain_ms=(n_gy - 1) * v_step)}

        def build():
            grid.grid_scan(*padded, n_gy, n_gx, 25)

        def plain_build():
            grid.build_grid_plain(*padded, n_gy, n_gx, 25)

        whole = dict(build_wall_ms=wall_ms(build, 5),
                     build_device_ms=dm(build, reps=5),
                     plain_wall_ms=wall_ms(plain_build, 3),
                     plain_build_device_ms=dm(plain_build, reps=1))
        for name in names:
            r = t[name]
            t_ops = r["ops"] / FP32_OPS_PER_S * 1e3
            t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
            r["bound_ms"] = max(t_ops, t_bytes)
            if t_bytes > t_ops:
                rows[name]["bound_by"] = "bytes"
            r.update(whole)
            log("  %-11s %-22s kernel %.4f ms (device %.4f)  plain %.3f ms "
                "(device %.3f)  bound %.5f ms (%.3g operations at the FP32 "
                "rate; %d bytes %.6f ms)  dependency chain %.4f ms (steps x "
                "%.2f us a step)" % (
                    name, label, r["ms"], r["device_ms"], r["plain_ms"],
                    r["plain_device_ms"], r["bound_ms"], r["ops"],
                    r["bytes"], t_bytes, r["chain_ms"],
                    1e3 * (h_step if name == "grid_scan_h" else v_step)))
            for k in timed:
                rows[name][k] += r[k] / len(pages)
        log("  grid build %-22s grid_scan %.3f ms wall, %.4f ms device;  "
            "plain build %.2f ms wall, %.3f ms device" % (
                label, whole["build_wall_ms"], whole["build_device_ms"],
                whole["plain_wall_ms"], whole["plain_build_device_ms"]))
    rows["grid_scan_v"]["library_ms"] = lane_row["library_ms"]
    rows["grid_scan_v"]["library_device_ms"] = lane_row["library_device_ms"]
    for name in names:
        r = rows[name]
        log("  %s per page: kernel %.4f ms (device %.4f)  plain %.3f ms "
            "(device %.3f)  bound %.5f ms (%s)  dependency chain %.4f ms  "
            "yardstick %s" % (
                name, r["ms"], r["device_ms"], r["plain_ms"],
                r["plain_device_ms"], r["bound_ms"], r["bound_by"],
                r["chain_ms"],
                "none (no single PyTorch call)" if r["library_ms"] is None
                else "torch.gather x 87 at the site %.4f ms (device %s)"
                % (r["library_ms"], fmt_ms(r["library_device_ms"]))))
    return rows


def host_path_ab(device):
    """Host µs per wrapper call: the launch path the wrappers share
    (ops/remap.py `_launch`, `_ptr`: the raw current stream, the
    pointer as an int) against the earlier one (a torch.cuda.Stream
    object and a ctypes.c_void_p per pointer, re-created here), in
    turns earlier, current, current, earlier."""
    import ctypes
    import torch
    from origami_tpu_torch.core import _png, dewarp
    from origami_tpu_torch.ops import _build, binarize, gather, grid
    from origami_tpu_torch.ops import remap as ops
    mods = (ops, gather, grid, binarize)
    current = {m: (m._launch, m._ptr) for m in mods}

    def earlier_launch(fn_name, *args):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(_build.library(), fn_name)(*args, stream)
        if rc != 0:
            raise RuntimeError("%s: CUDA error %d at launch" % (fn_name, rc))

    def earlier_ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    png = sorted(FIXTURE.glob("*.png"))[0]
    px = torch.from_numpy(_png.read_gray(png)).to(device)
    hv = torch.from_numpy(dewarp.Grid.open(
        FIXTURE / (png.stem + ".out") / "dewarp.zip").points(
            "sample")).to(device)
    src = torch.rand((64, 63), device=device)
    idx = torch.zeros((64, 1), dtype=torch.int32, device=device)
    padded, shape = page_grid_inputs(png, device)
    calls = {
        "dewarp_u8": (lambda: ops.dewarp_u8(px, hv, 25), 200),
        "sauvola_packed": (lambda: binarize.sauvola_packed(px, 15), 200),
        "take_along_axis_lane": (lambda: gather.take_along_axis(src, idx, 1),
                                 200),
        "grid_scan": (lambda: grid.grid_scan(*padded, *shape, 25), 50),
    }
    got = {name: {"earlier": [], "current": []} for name in calls}
    try:
        for turn in ("earlier", "current", "current", "earlier"):
            for m in mods:
                m._launch, m._ptr = current[m] if turn == "current" \
                    else (earlier_launch, earlier_ptr)
            for name, (fn, n) in calls.items():
                got[name][turn].append(host_us(fn, n))
    finally:
        for m in mods:
            m._launch, m._ptr = current[m]
    out = {}
    for name, t in got.items():
        out[name] = {k: statistics.mean(v) for k, v in t.items()}
        log("  host path %-22s %.1f us a call (earlier launch path %.1f us)"
            % (name, out[name]["current"], out[name]["earlier"]))
    return out


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


def _device_ms(prof):
    """Device time of the kernels a profile recorded, in ms, or None when
    it recorded no device event."""
    import torch
    times = [e.device_time for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(times) / 1e3 if times else None


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


# ---------------------------------------------------------------- phase 5

def copy_pages(dst):
    """A corpus of the fixture's page images alone."""
    dst.mkdir()
    for png in sorted(FIXTURE.glob("*.png")):
        shutil.copy(png, dst / png.name)
    return dst


def check_segment_pass(corpus, mode):
    """Raise unless every page of a segment pass COMPLETED and its
    segment.zip opens with the regions and separators predictors, the
    JAX class dicts and u8 label maps of the reference's shape; ->
    {predictor: share of pixels equal to the mode's JAX reference}."""
    from origami_tpu_torch.core.segment import Segmentation
    _, ref_of, _ = SEG_MODES[mode]
    same = {"regions": 0, "separators": 0}
    total = dict(same)
    for png in sorted(corpus.glob("*.png")):
        out = corpus / (png.stem + ".out")
        entry = json.loads((out / "runtime.json").read_text()).get(
            SEG_STAGE, {})
        if entry.get("status") != "COMPLETED":
            raise PhaseError("segment (%s) on %s: %s" % (
                mode, png.name, entry.get("traceback", entry)))
        got = Segmentation.open(out / "segment.zip")
        ref = Segmentation.open(ref_of(png.stem))
        if [p.name for p in got.predictions] != ["regions", "separators"]:
            raise PhaseError("segment (%s) on %s: predictors %s" % (
                mode, png.name, [p.name for p in got.predictions]))
        for name, classes in (("regions", REGION_CLASSES),
                              ("separators", SEP_CLASSES)):
            a, b = got.by_name(name), ref.by_name(name)
            if a.classes.as_dict() != classes \
                    or a.type != b.type \
                    or a.labels.shape != b.labels.shape \
                    or a.labels.dtype.name != "uint8" \
                    or int(a.labels.max()) >= len(classes):
                raise PhaseError(
                    "segment (%s) on %s: %s is %s %s with classes %s" % (
                        mode, png.name, name, a.labels.dtype,
                        a.labels.shape, a.classes.as_dict()))
            same[name] += int((a.labels == b.labels).sum())
            total[name] += a.labels.size
    return {k: same[k] / max(total[k], 1) for k in same}


def run_segment_cli(mode, workdir):
    corpus = copy_pages(workdir / ("seg_" + mode))
    args, _, min_equal = SEG_MODES[mode]
    cmd = [sys.executable, "-m", "origami_tpu_torch.batch.detect.segment",
           *args, "--lock-strategy", "NONE", "--plain", "--device", "cuda",
           str(corpus)]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=str(ROOT), stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True, timeout=600)
    wall = time.time() - t0
    if proc.returncode != 0:
        raise PhaseError("segment CLI (%s) exited %d:\n%s" % (
            mode, proc.returncode, proc.stderr[-4000:]))
    launches = None
    for line in proc.stdout.splitlines():
        if line.startswith('{"kernel_launches"'):
            launches = json.loads(line)["kernel_launches"]
    if launches is None:
        raise PhaseError("segment CLI (%s) printed no launch counts" % mode)
    pages = sorted(corpus.glob("*.png"))
    stage_s = sum(json.loads((corpus / (p.stem + ".out") / "runtime.json")
                             .read_text()).get(SEG_STAGE, {})
                  .get("elapsed", 0.0) for p in pages)
    return dict(mode=mode, pages=len(pages), launches=launches,
                equal=check_segment_pass(corpus, mode),
                min_equal=min_equal, wall_s=wall, stage_s=stage_s)


def segment_throughput(workdir, reps=5):
    """Phase 6: the trained segment stage in process, warm: `reps` timed
    passes over fresh copies of the fixture's pages after one warm-up
    pass, then one profiled pass for the device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from origami_tpu_torch.batch.detect.segment import SegmentationProcessor
    proc = SegmentationProcessor(str(ROOT / STUDENTS), dict(
        lock_strategy="NONE", plain=True, device="cuda"))
    # the peak below is this phase's own, not the earlier phases'
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(reps + 1):
        corpus = copy_pages(workdir / ("seg_tp%d" % i))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proc.traverse(str(corpus))
        torch.cuda.synchronize()
        if i:                       # the first pass warms cuDNN
            times.append(time.perf_counter() - t0)
        check_segment_pass(corpus, "students_bf16")
    corpus = copy_pages(workdir / "seg_prof")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        proc.traverse(str(corpus))
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    check_segment_pass(corpus, "students_bf16")
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=15)
    n_pages = len(list(FIXTURE.glob("*.png")))
    med = statistics.median(times)
    return dict(pages=n_pages, times=times, seconds=med,
                pages_per_s=n_pages / med, device_ms=_cuda_total_ms(table),
                prof_wall_s=prof_wall, profile=table,
                peak_mb=torch.cuda.max_memory_allocated() / 2**20)


# ---------------------------------------------------------------- phase 7

def flow_corpus(dst, pages=None, with_flow=False):
    """A corpus for the flow stage (or, `with_flow`, the dewarp stage):
    the fixture's page PNGs and segment.zip, the JAX contours.0.zip (and
    flow.zip), and a runtime.json of the stages before."""
    dst.mkdir(parents=True, exist_ok=True)
    for png in pages or sorted(FIXTURE.glob("*.png")):
        shutil.copy(png, dst / png.name)
        out = dst / (png.stem + ".out")
        out.mkdir()
        ref = FLOW_REF / (png.stem + ".out")
        shutil.copy(FIXTURE / (png.stem + ".out") / "segment.zip", out)
        shutil.copy(ref / "contours.0.zip", out)
        keep = ("segment", "contours") + (("flow",) if with_flow else ())
        if with_flow:
            shutil.copy(ref / "flow.zip", out)
        rt = json.loads((ref / "runtime.json").read_text())
        (out / "runtime.json").write_text(json.dumps(
            {k: v for k, v in rt.items() if k.rsplit(".", 1)[-1] in keep}))
    return dst


def _coords(g):
    t = g.geom_type
    if t == "Polygon":
        return [g.np_shell] + list(g.np_holes)
    if t in ("LineString", "LinearRing"):
        return [g.np_coords]
    if t == "Point":
        return [g._all_coords()]
    return [c for p in g.geoms for c in _coords(p)]


def compare_flow_outputs(out, ref, artifacts):
    """Hold a page's flow/dewarp artifacts in `out` against the JAX
    stage's in `ref`: raises PhaseError on a different shape, sample
    count, key set or vertex count; -> {measure: largest difference}
    (flow samples in px and rad, line p/right in px, grid nodes in px,
    contour vertices in px; `lines_identical`: share of line JSONs
    equal to the JAX ones)."""
    import io
    import numpy as np
    from origami_tpu_torch import geometry as G
    r = {}

    def entries(path):
        with zipfile.ZipFile(path) as zf:
            return {n: zf.read(n) for n in zf.namelist()}

    if "flow.zip" in artifacts:
        a, b = entries(out / "flow.zip"), entries(ref / "flow.zip")
        for k in ("h", "v"):
            x = np.load(io.BytesIO(a[k + ".npy"]))
            y = np.load(io.BytesIO(b[k + ".npy"]))
            if x.shape != y.shape:
                raise PhaseError("%s flow %s: %s samples, JAX %s"
                                 % (out.name, k, x.shape, y.shape))
            d = np.abs(x - y).reshape(-1, 3)
            r["flow_px"] = max(r.get("flow_px", 0.0),
                               float(d[:, :2].max(initial=0.0)))
            r["flow_rad"] = max(r.get("flow_rad", 0.0),
                                float(d[:, 2].max(initial=0.0)))
    if "lines.0.zip" in artifacts:
        a, b = entries(out / "lines.0.zip"), entries(ref / "lines.0.zip")
        if a.keys() != b.keys():
            raise PhaseError("%s lines.0.zip: %d entries, JAX %d (%s)" % (
                out.name, len(a), len(b), sorted(set(a) ^ set(b))[:4]))
        d = same = n = 0
        for k in b:
            if k == "meta.json":
                continue
            x, y = json.loads(a[k]), json.loads(b[k])
            d = max(d, float(np.abs(np.array(x["p"] + x["right"])
                                    - np.array(y["p"] + y["right"])).max()))
            same += x == y
            n += 1
        r["lines_px"] = d
        r["lines_identical"] = same / max(n, 1)
    if "dewarp.zip" in artifacts:
        a, b = entries(out / "dewarp.zip"), entries(ref / "dewarp.zip")
        x = np.load(io.BytesIO(a["data.npy"]))
        y = np.load(io.BytesIO(b["data.npy"]))
        if x.shape != y.shape or json.loads(a["meta.json"]) != \
                json.loads(b["meta.json"]):
            raise PhaseError("%s dewarp.zip: grid %s, JAX %s" % (
                out.name, x.shape, y.shape))
        r["grid_px"] = float(np.abs(x - y).max())
    if "contours.1.zip" in artifacts:
        a, b = entries(out / "contours.1.zip"), entries(ref / "contours.1.zip")
        if a.keys() != b.keys():
            raise PhaseError("%s contours.1.zip: keys differ (%s)" % (
                out.name, sorted(set(a) ^ set(b))[:4]))
        d = 0.0
        for k in b:
            if not k.endswith(".wkt"):
                if a[k] != b[k]:
                    raise PhaseError("%s contours.1.zip: %s differs"
                                     % (out.name, k))
                continue
            x = _coords(G.wkt.loads(a[k].decode("utf8")))
            y = _coords(G.wkt.loads(b[k].decode("utf8")))
            if [len(c) for c in x] != [len(c) for c in y]:
                raise PhaseError("%s contours.1.zip %s: vertex counts %s, "
                                 "JAX %s" % (out.name, k,
                                             [len(c) for c in x],
                                             [len(c) for c in y]))
            for c1, c2 in zip(x, y):
                if len(c1):
                    d = max(d, float(np.abs(c1 - c2).max()))
        r["contours_px"] = d
    return r


FLOW_BARS = {"flow_px": FLOW_PX, "flow_rad": FLOW_RAD, "lines_px": LINES_PX,
             "grid_px": GRID_PX, "contours_px": CONTOUR_PX}


def run_stage_cli(stage, corpus, device="cuda", args=()):
    """Run `python -m origami_tpu_torch.batch.detect.<stage> [args]`
    over `corpus`; raise unless every page COMPLETED; -> (launch counts,
    process seconds, summed stage seconds)."""
    cmd = [sys.executable, "-m", "origami_tpu_torch.batch.detect." + stage,
           *args, "--lock-strategy", "NONE", "--plain", "--device",
           str(device), str(corpus)]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=str(ROOT), stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True, timeout=600)
    wall = time.time() - t0
    if proc.returncode != 0:
        raise PhaseError("%s CLI exited %d:\n%s" % (
            stage, proc.returncode, proc.stderr[-4000:]))
    launches = None
    for line in proc.stdout.splitlines():
        if line.startswith('{"kernel_launches"'):
            launches = json.loads(line)["kernel_launches"]
    if launches is None:
        raise PhaseError("%s CLI printed no launch counts" % stage)
    key = STAGE_KEYS[stage]
    stage_s = 0.0
    for png in sorted(corpus.glob("*.png")):
        entry = json.loads((corpus / (png.stem + ".out") / "runtime.json")
                           .read_text()).get(key, {})
        if entry.get("status") != "COMPLETED":
            raise PhaseError("%s on %s: %s" % (
                stage, png.name, entry.get("traceback", entry)))
        stage_s += entry["elapsed"]
    return launches, wall, stage_s


def check_flow_dewarp(workdir):
    """Phase 7: the flow and dewarp CLIs on the card against the JAX
    stages' artifacts. -> {run name: launch counts} for the kernel
    table."""
    pages = sorted(FIXTURE.glob("*.png"))
    n = len(pages)
    failed = []
    runs = {}
    chain = flow_corpus(workdir / "flow_chain")
    isolated = flow_corpus(workdir / "dewarp_on_jax_flow", with_flow=True)
    plan = (("flow", chain, ("flow.zip", "lines.0.zip")),
            ("dewarp", chain, ("dewarp.zip", "contours.1.zip")),
            ("dewarp", isolated, ("dewarp.zip", "contours.1.zip")))
    for stage, corpus, arts in plan:
        name = "%s (%s)" % (stage, corpus.name)
        launches, wall, stage_s = run_stage_cli(stage, corpus)
        runs[name] = launches
        worst = {}
        for png in pages:
            got = compare_flow_outputs(corpus / (png.stem + ".out"),
                                       FLOW_REF / (png.stem + ".out"), arts)
            for k, v in got.items():
                worst[k] = max(worst.get(k, 0.0), v) if k != \
                    "lines_identical" else min(worst.get(k, 1.0), v)
        # per page: the Sauvola prefetch once in each stage; the dewarp
        # kernel and each grid scan kernel once in dewarp; the standalone
        # gather never (the V scan kernel gathers inside)
        want = {"sauvola_packed": n, "sauvola": 0, "take_along_axis_lane": 0,
                "take_along_axis_sublane": 0}
        once = n if stage == "dewarp" else 0
        want.update(dewarp_u8=once, grid_scan_h=once, grid_scan_v=once)
        bad_launch = {k: launches.get(k) for k, v in want.items()
                      if launches.get(k) != v}
        # the chained dewarp runs on the port's own flow.zip: its grid
        # is held to the bar only where that flow.zip equals JAX's
        gate = dict(FLOW_BARS)
        if stage == "dewarp" and corpus is chain and not all(
                compare_flow_outputs(
                    corpus / (p.stem + ".out"), FLOW_REF / (p.stem + ".out"),
                    ("flow.zip",)) == {"flow_px": 0.0, "flow_rad": 0.0}
                for p in pages):
            gate = {}
        over = {k: v for k, v in worst.items() if k in gate and v > gate[k]}
        log("  %-30s %d pages: %s  launches %s  stage %.2f s, process "
            "%.2f s (cold)  %s" % (
                name, n, "  ".join("%s %.3g" % kv for kv in
                                   sorted(worst.items())),
                json.dumps({k: v for k, v in launches.items() if v}),
                stage_s, wall, "ok" if not over and not bad_launch
                else "FAIL"))
        if over:
            failed.append("%s: %s over the bars %s" % (
                name, over, {k: gate[k] for k in over}))
        if bad_launch:
            failed.append("%s: launches %s, expected %s" % (
                name, bad_launch, {k: want[k] for k in bad_launch}))
    if failed:
        raise PhaseError("; ".join(failed))
    return runs


# ---------------------------------------------------------------- phase 8

def flow_dewarp_throughput(workdir, reps=5):
    """Phase 8: the flow and dewarp stages in process, warm (each as
    stage_throughput); and the launches of one grid build."""
    import torch
    from origami_tpu_torch.batch.core.io import Artifact, Input, Stage
    from origami_tpu_torch.batch.detect.dewarp import DewarpProcessor
    from origami_tpu_torch.batch.detect.flow import FlowDetectionProcessor
    from origami_tpu_torch.core import dewarp
    out = {}
    for stage, cls, with_flow in (("flow", FlowDetectionProcessor, False),
                                  ("dewarp", DewarpProcessor, True)):
        out[stage] = stage_throughput(
            workdir, stage, cls,
            lambda dst, w=with_flow: flow_corpus(dst, with_flow=w), reps)

    # one grid build (the first page's JAX flow.zip): wall time on the
    # card and the number of device kernels it launches
    png = sorted(FIXTURE.glob("*.png"))[0]
    corpus = flow_corpus(workdir / "grid_build", [png], with_flow=True)
    reader = Input(Artifact.CONTOURS, Artifact.FLOW, stage=Stage.WARPED) \
        .instantiate(corpus / png.name, _Proc(torch.device("cuda")))
    size, fh, fv = reader.page.size(), reader.flow["h"], reader.flow["v"]
    dewarp.Grid.create(size, fh, fv, device="cuda")
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dewarp.Grid.create(size, fh, fv, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    prof = profiled(lambda: dewarp.Grid.create(size, fh, fv, device="cuda"))
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    out["grid"] = dict(wall_ms=statistics.median(walls) * 1e3,
                       launches=len(kernels),
                       scans=sum("grid_scan" in e.name for e in kernels),
                       device_ms=sum(e.device_time for e in kernels) / 1e3)
    return out


# ---------------------------------------------------------------- phase 9

def chain_corpus(dst, jax_segmentation):
    """The fixture's page PNGs and, `jax_segmentation`, the JAX
    segment.zip of each (tests/data/torch_ocr/full)."""
    dst.mkdir(parents=True)
    for png in sorted(FIXTURE.glob("*.png")):
        shutil.copy(png, dst / png.name)
        if jax_segmentation:
            out = dst / (png.stem + ".out")
            out.mkdir()
            shutil.copy(FIXTURE / (png.stem + ".out") / "segment.zip", out)
    return dst


def layout_corpus(dst):
    """The layout stage's JAX inputs: the fixture's PNG and segment.zip
    with tests/data/torch_flow's contours, lines and grid."""
    dst.mkdir(parents=True)
    for png in sorted(FIXTURE.glob("*.png")):
        shutil.copy(png, dst / png.name)
        out = dst / (png.stem + ".out")
        out.mkdir()
        shutil.copy(FIXTURE / (png.stem + ".out") / "segment.zip", out)
        for name in ("contours.0.zip", "lines.0.zip", "contours.1.zip",
                     "dewarp.zip", "runtime.json"):
            shutil.copy(FLOW_REF / (png.stem + ".out") / name, out)
    return dst


def _entries(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def compare_contours0(out, ref):
    """(share of the JAX stage's contours.0.zip entries, WKT and
    meta.json, that the port's holds byte-equal; the entries in only one
    of the two)."""
    a, b = _entries(out / "contours.0.zip"), _entries(ref / "contours.0.zip")
    return (sum(a.get(k) == v for k, v in b.items()) / max(len(b), 1),
            sorted(set(a) ^ set(b)))


def compare_layout_outputs(out, ref):
    """Hold a page's contours.2.zip and tables.json against the JAX
    stage's: raises PhaseError on another key set or vertex count; ->
    (largest vertex difference in px, share of entries byte-equal,
    tables equal, the meta.json entries that differ: the separators'
    widths, copied from contours.1.zip)."""
    import numpy as np
    from origami_tpu_torch import geometry as G
    a, b = _entries(out / "contours.2.zip"), _entries(ref / "contours.2.zip")
    if a.keys() != b.keys():
        raise PhaseError("%s contours.2.zip: keys differ (%s)" % (
            out.name, sorted(set(a) ^ set(b))[:4]))
    d = 0.0
    meta = []
    for k in b:
        if not k.endswith(".wkt"):
            if a[k] != b[k]:
                meta.append(k)
            continue
        x = _coords(G.wkt.loads(a[k].decode("utf8")))
        y = _coords(G.wkt.loads(b[k].decode("utf8")))
        if [len(c) for c in x] != [len(c) for c in y]:
            raise PhaseError("%s contours.2.zip %s: vertex counts %s, JAX "
                             "%s" % (out.name, k, [len(c) for c in x],
                                     [len(c) for c in y]))
        for c1, c2 in zip(x, y):
            if len(c1):
                d = max(d, float(np.abs(c1 - c2).max()))
    same = sum(a[k] == b[k] for k in b) / max(len(b), 1)
    tables = json.loads((out / "tables.json").read_text()) == \
        json.loads((ref / "tables.json").read_text())
    return d, same, tables, meta


def tables_px(out, ref):
    """Largest difference in px between the column and divider positions
    of the port's tables.json and the JAX stage's; inf where the tables,
    or their counts of columns or dividers, differ."""
    a = json.loads((out / "tables.json").read_text())
    b = json.loads((ref / "tables.json").read_text())
    d = 0.0
    for kind in ("columns", "dividers"):
        if a[kind].keys() != b[kind].keys():
            return float("inf")
        for k, xs in b[kind].items():
            if len(a[kind][k]) != len(xs):
                return float("inf")
            d = max([d] + [abs(x - y) for x, y in zip(a[kind][k], xs)])
    return d


def launch_errors(stage, launches, n_pages, device):
    """{kernel: (count, expected)} where a stage's run launched a kernel
    other than STAGE_LAUNCHES says; on the CPU nothing launches."""
    per_page = STAGE_LAUNCHES[stage] if str(device) != "cpu" else {}
    return {k: (v, per_page.get(k, 0) * n_pages)
            for k, v in launches.items()
            if v != per_page.get(k, 0) * n_pages}


def windows(corpus):
    """The Sauvola window the layout stage chose on each page."""
    return [json.loads((corpus / (p.stem + ".out") / "runtime.json")
                       .read_text())[LAYOUT_STAGE]["sauvola_window"]
            for p in sorted(corpus.glob("*.png"))]


def run_chain(name, corpus, stages, device, runs, failed, seg_args=()):
    """Run the stage CLIs in turn over `corpus`, each in its own process
    (its launch counts start at 0), and check each one's launches."""
    n = len(list(corpus.glob("*.png")))
    for stage in stages:
        launches, wall, stage_s = run_stage_cli(
            stage, corpus, device, seg_args if stage == "segment" else ())
        runs["%s (%s)" % (stage, name)] = launches
        bad = launch_errors(stage, launches, n, device)
        log("  %-34s %d pages: launches %s  stage %.2f s, process %.2f s "
            "(cold)  %s" % ("%s (%s)" % (stage, name), n,
                            json.dumps({k: v for k, v in launches.items()
                                        if v}),
                            stage_s, wall, "ok" if not bad else "FAIL"))
        if bad:
            failed.append("%s (%s): launches (got, expected) %s"
                          % (stage, name, bad))


def check_chain_from_jax_segmentation(workdir, device="cuda"):
    """The port's contours, flow, dewarp and layout CLIs in turn from
    the JAX segment.zip: contours.0.zip equal to the JAX stage's, the
    flow and dewarp artifacts under phase 7's bars, contours.2.zip within
    CONTOUR_PX of the JAX stage's and tables.json equal. -> launch
    counts of each run."""
    runs, failed = {}, []
    corpus = chain_corpus(workdir / "chain_from_jax_segment", True)
    run_chain("from the JAX segment.zip", corpus,
              ("contours", "flow", "dewarp", "layout"), device, runs, failed)
    pages = sorted(FIXTURE.glob("*.png"))
    worst = {}
    for png in pages:
        out, ref = corpus / (png.stem + ".out"), FLOW_REF / (png.stem + ".out")
        equal0, keys = compare_contours0(out, ref)
        equal0 = 0.0 if keys else equal0
        got = compare_flow_outputs(out, ref, ("flow.zip", "lines.0.zip",
                                              "dewarp.zip", "contours.1.zip"))
        px, same, tables, meta = compare_layout_outputs(
            out, LAYOUT_REF / (png.stem + ".out"))
        got.update(contours0_equal=equal0, layout_px=px, layout_equal=same,
                   tables_equal=float(tables), meta_equal=float(not meta))
        for k, v in got.items():
            worst[k] = min(worst.get(k, 1.0), v) if k in (
                "lines_identical", "contours0_equal", "layout_equal",
                "tables_equal", "meta_equal") else max(worst.get(k, 0.0), v)
    gate = dict(FLOW_BARS, layout_px=CONTOUR_PX)
    if worst["flow_px"] or worst["flow_rad"]:
        gate.pop("grid_px")   # the grid is held only on JAX's flow.zip
    over = {k: v for k, v in worst.items() if k in gate and v > gate[k]}
    for k in ("contours0_equal", "tables_equal", "meta_equal"):
        if worst[k] != 1.0:
            over[k] = worst[k]
    log("  chain from the JAX segment.zip vs the JAX stages: %s  %s" % (
        "  ".join("%s %.4g" % kv for kv in sorted(worst.items())),
        "ok" if not over else "FAIL"))
    if over:
        failed.append("chain from the JAX segment.zip: %s (bars %s)" % (
            over, {k: gate.get(k, 1.0) for k in over}))
    if failed:
        raise PhaseError("; ".join(failed))
    return runs


def check_port_chain(workdir, device="cuda"):
    """The port alone, from the page images: segment (the students in
    bf16), contours, flow, dewarp and layout CLIs in turn. Every stage
    COMPLETED with its launches; contours.2.zip holds the JAX stage's
    keys and vertex counts within CHAIN_PX, tables.json the JAX tables
    with as many columns and dividers each, within CHAIN_PX. -> launch
    counts of each run."""
    runs, failed = {}, []
    corpus = chain_corpus(workdir / "chain_port_only", False)
    run_chain("port only", corpus,
              ("segment", "contours", "flow", "dewarp", "layout"), device,
              runs, failed, seg_args=("-m", str(ROOT / STUDENTS)))
    worst = dict(layout_px=0.0, layout_equal=1.0, contours0_equal=1.0,
                 tables_equal=1.0, tables_px=0.0)
    only = []
    for png in sorted(FIXTURE.glob("*.png")):
        out = corpus / (png.stem + ".out")
        equal0, keys = compare_contours0(out, FLOW_REF / (png.stem + ".out"))
        worst["contours0_equal"] = min(worst["contours0_equal"], equal0)
        only += ["%s:%s" % (png.stem, k) for k in keys]
        px, same, tables, meta = compare_layout_outputs(
            out, LAYOUT_REF / (png.stem + ".out"))
        only += ["%s:%s differs" % (png.stem, k) for k in meta]
        worst["layout_px"] = max(worst["layout_px"], px)
        worst["layout_equal"] = min(worst["layout_equal"], same)
        worst["tables_equal"] = min(worst["tables_equal"], float(tables))
        worst["tables_px"] = max(worst["tables_px"], tables_px(
            out, LAYOUT_REF / (png.stem + ".out")))
    ok = worst["layout_px"] <= CHAIN_PX and worst["tables_px"] <= CHAIN_PX
    log("  port-only chain vs the JAX stages: %s  entries in one of the "
        "two only or differing (contours.0.zip, contours.2.zip's "
        "meta.json): %s  windows %s  %s" % (
            "  ".join("%s %.4g" % kv for kv in sorted(worst.items())),
            only or "none", windows(corpus), "ok" if ok else "FAIL"))
    if not ok:
        failed.append("port-only chain: %s (bars layout_px and tables_px "
                      "%g)" % (worst, CHAIN_PX))
    if failed:
        raise PhaseError("; ".join(failed))
    return runs


def check_layout_on_jax_inputs(workdir, device="cuda"):
    """The layout CLI on the JAX stages' artifacts: contours.2.zip and
    tables.json equal to tests/data/torch_layout. -> launch counts."""
    runs, failed = {}, []
    corpus = layout_corpus(workdir / "layout_on_jax_inputs")
    run_chain("on the JAX inputs", corpus, ("layout",), device, runs, failed)
    for png in sorted(FIXTURE.glob("*.png")):
        out, ref = corpus / (png.stem + ".out"), LAYOUT_REF / (png.stem
                                                               + ".out")
        a, b = _entries(out / "contours.2.zip"), _entries(
            ref / "contours.2.zip")
        tables = json.loads((out / "tables.json").read_text()) == \
            json.loads((ref / "tables.json").read_text())
        same = a == b
        log("  layout on the JAX inputs, %s: contours.2.zip %d entries, %s; "
            "tables.json %s" % (png.stem, len(a), "equal" if same else
                                "DIFFERENT", "equal" if tables else
                                "DIFFERENT"))
        if not (same and tables):
            failed.append("layout on the JAX inputs, %s: contours.2.zip "
                          "equal %s, tables.json equal %s"
                          % (png.stem, same, tables))
    log("  layout Sauvola windows (median line height // 2, in steps of "
        "8, odd): %s" % windows(corpus))
    if failed:
        raise PhaseError("; ".join(failed))
    return runs


# ---------------------------------------------------------------- phase 10

def stage_throughput(workdir, stage, cls, make_corpus, reps=5):
    """A stage in process, warm: `reps` timed passes over fresh corpora
    (`make_corpus(dst)`) after one warm-up pass, and one profiled pass
    for the device time by kernel."""
    import torch
    key = STAGE_KEYS[stage]
    proc = cls(dict(lock_strategy="NONE", plain=True, device="cuda"))
    n_pages = len(list(FIXTURE.glob("*.png")))

    def one_pass(tag):
        corpus = make_corpus(workdir / ("%s_%s" % (stage, tag)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proc.traverse(str(corpus))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        for png in sorted(corpus.glob("*.png")):
            st = json.loads((corpus / (png.stem + ".out") /
                             "runtime.json").read_text()).get(key, {})
            if st.get("status") != "COMPLETED":
                raise PhaseError("%s pass %s, %s: %s" % (
                    stage, tag, png.name, st.get("traceback", st)))
        return dt

    times = [one_pass("tp%d" % i) for i in range(reps + 1)][1:]
    walls = []
    prof = profiled(lambda: walls.append(one_pass("prof%d" % len(walls))))
    med = statistics.median(times)
    return dict(times=times, seconds=med, pages_per_s=n_pages / med,
                device_ms=_device_ms(prof), prof_wall_s=walls[-1],
                profile=prof.key_averages().table(
                    sort_by="self_cuda_time_total", row_limit=12))


def log_throughput(stage, r):
    log("  %s: median of %d warm passes %.4f s (min %.4f, max %.4f): "
        "%.3f pages/s" % (stage, len(r["times"]), r["seconds"],
                          min(r["times"]), max(r["times"]),
                          r["pages_per_s"]))
    if r["device_ms"] is None:
        log("  %s profiled pass: %.4f s wall; the profiler recorded no "
            "device event (device time not measured)"
            % (stage, r["prof_wall_s"]))
    else:
        log("  %s profiled pass: %.4f s wall, %.3f ms device (kernel) "
            "time, device busy %.2f %%" % (
                stage, r["prof_wall_s"], r["device_ms"],
                100.0 * r["device_ms"] / 1e3 / r["prof_wall_s"]))
    log(r["profile"])


# ---------------------------------------------------------------- phase 11

def lines_corpus(dst, stems=None):
    """The lines stage's JAX inputs: the fixture's PNG, segment.zip,
    dewarp.zip and tables.json, tests/data/torch_flow's contours.1.zip
    and tests/data/torch_layout's contours.2.zip."""
    dst.mkdir(parents=True)
    for png in sorted(FIXTURE.glob("*.png")):
        if stems is not None and png.stem not in stems:
            continue
        shutil.copy(png, dst / png.name)
        out = dst / (png.stem + ".out")
        out.mkdir()
        for name in ("segment.zip", "dewarp.zip", "tables.json"):
            shutil.copy(FIXTURE / (png.stem + ".out") / name, out)
        shutil.copy(FLOW_REF / (png.stem + ".out") / "contours.1.zip", out)
        shutil.copy(LAYOUT_REF / (png.stem + ".out") / "contours.2.zip", out)
    return dst


def order_corpus(dst, stems=None):
    """The order stage's JAX inputs: lines_corpus with the fixture's
    contours.3.zip and lines.3.zip."""
    lines_corpus(dst, stems)
    for png in sorted(dst.glob("*.png")):
        for name in ("contours.3.zip", "lines.3.zip"):
            shutil.copy(FIXTURE / (png.stem + ".out") / name,
                        dst / (png.stem + ".out"))
    return dst


def compose_corpus(dst, stems=None):
    """The compose stage's JAX inputs: order_corpus with the JAX
    order.json and the JAX single-model ocr.zip."""
    order_corpus(dst, stems)
    for png in sorted(dst.glob("*.png")):
        out = dst / (png.stem + ".out")
        shutil.copy(COMPOSE_REF / (png.stem + ".out") / "order.json", out)
        shutil.copy(FIXTURE / "ref" / (png.stem + ".single.ocr.zip"),
                    out / "ocr.zip")
    return dst


def wkt_px(a, b, what):
    """Largest vertex difference in px between two WKT texts; raises
    PhaseError where their vertex counts differ."""
    import numpy as np
    from origami_tpu_torch import geometry as G
    if a == b:
        return 0.0
    x, y = _coords(G.wkt.loads(a)), _coords(G.wkt.loads(b))
    if [len(c) for c in x] != [len(c) for c in y]:
        raise PhaseError("%s: vertex counts %s, JAX %s" % (
            what, [len(c) for c in x], [len(c) for c in y]))
    return max([0.0] + [float(np.abs(c1 - c2).max())
                        for c1, c2 in zip(x, y) if len(c1)])


def compare_lines_outputs(out, ref):
    """Hold a page's contours.3.zip and lines.3.zip against the JAX
    stage's: raises PhaseError on another key set, vertex count,
    meta.json, line JSON keys or set of evidence classes; -> (largest
    vertex (and frame) difference in px of each zip, largest evidence
    difference, share of entries byte-equal)."""
    import numpy as np
    px = {"contours.3.zip": 0.0, "lines.3.zip": 0.0}
    conf = 0.0
    same = total = 0
    for name in px:
        a, b = _entries(out / name), _entries(ref / name)
        if a.keys() != b.keys():
            raise PhaseError("%s %s: keys differ (%s)" % (
                out.name, name, sorted(set(a) ^ set(b))[:4]))
        for k in b:
            total += 1
            same += a[k] == b[k]
            what = "%s %s %s" % (out.name, name, k)
            if a[k] == b[k]:
                continue
            if k.endswith(".wkt"):
                px[name] = max(px[name], wkt_px(
                    a[k].decode("utf8"), b[k].decode("utf8"), what))
                continue
            if k.endswith("meta.json"):
                raise PhaseError("%s differs" % what)
            x, y = json.loads(a[k]), json.loads(b[k])
            cx, cy = x["confidence"], y["confidence"]
            if list(x) != list(y) or type(cx) is not type(cy) or (
                    isinstance(cy, dict) and cx.keys() != cy.keys()):
                raise PhaseError("%s: JSON keys differ" % what)
            for f in ("p", "right", "up"):
                px[name] = max(px[name], float(
                    np.abs(np.subtract(x[f], y[f])).max()))
            px[name] = max(px[name], wkt_px(x["wkt"], y["wkt"], what))
            conf = max([conf] + ([abs(cx[c] - cy[c]) for c in cy]
                                 if isinstance(cy, dict)
                                 else [abs(cx - cy)]))
    return px, conf, same / max(total, 1)


def text_diff(got, ref):
    """(lines of `ref` identical in `got`, lines of `ref`, character
    errors, characters of `ref`): the two texts' lines aligned by
    difflib; a replaced run pairs its lines in order, a line without a
    partner counts all its characters."""
    import difflib
    a, b = ref.split("\n"), got.split("\n")
    same = errs = 0
    for op, i1, i2, j1, j2 in difflib.SequenceMatcher(
            None, a, b, autojunk=False).get_opcodes():
        if op == "equal":
            same += i2 - i1
            continue
        x, y = a[i1:i2], b[j1:j2]
        for k in range(max(len(x), len(y))):
            errs += levenshtein(x[k] if k < len(x) else "",
                                y[k] if k < len(y) else "")
    chars = sum(len(t) for t in a)
    return same, len(a), errs, max(chars, 1)


def page_text(path):
    with zipfile.ZipFile(path) as zf:
        return zf.read("page.txt").decode("utf8")


def compare_chain_text(corpus, name, failed, min_identical, max_cer):
    """Hold each page's composed text against the JAX chain's
    (tests/data/torch_compose); -> (share of lines identical, CER)."""
    same = n = errs = chars = 0
    for png in sorted(corpus.glob("*.png")):
        got = page_text(corpus / (png.stem + ".out") / "compose.zip")
        ref = page_text(COMPOSE_REF / (png.stem + ".out") / "compose.zip")
        s, k, e, c = text_diff(got, ref)
        same, n, errs, chars = same + s, n + k, errs + e, chars + c
    share, cer = same / max(n, 1), errs / max(chars, 1)
    ok = share >= min_identical and cer <= max_cer
    log("  %s: page.txt %d of %d lines identical to the JAX chain's "
        "(%.4f), CER %.5f  %s" % (name, same, n, share, cer,
                                  "ok" if ok else "FAIL"))
    if not ok:
        failed.append("%s: page.txt identical %.4f (bar %.2f), CER %.5f "
                      "(bar %.3f)" % (name, share, min_identical, cer,
                                      max_cer))
    return share, cer


def ocr_launch_errors(launches, n):
    """Phase 3's rule for a banded OCR run: strips_dewarped once a page,
    strips_through_grid at most once, dewarp_u8 at least once."""
    if launches["strips_dewarped"] == n and \
            launches["strips_through_grid"] <= n and \
            launches["dewarp_u8"] >= n:
        return None
    return {k: launches[k] for k in ("strips_dewarped",
                                     "strips_through_grid", "dewarp_u8")}


def strip_xml_times(data):
    import re
    return re.sub(rb"<(Created|LastChange)>[^<]*</\1>", b"", data)


def check_lines_order_compose(workdir, device="cuda"):
    """Phase 11. The lines CLI on the JAX inputs (contours.3.zip and
    lines.3.zip: the JAX keys, vertex counts and meta.json, frames and
    vertices within LINES_PX and CONTOUR_PX, evidence within LINE_CONF);
    the order CLI on the JAX inputs (order.json equal); the compose CLI
    on the JAX order.json and single-model ocr.zip (page.txt byte-equal;
    with --page-xml, page.xml equal apart from the Metadata timestamps);
    and the chain lines -> order -> ocr (single) -> compose from the JAX
    contours.2.zip (page.txt: MIN_IDENTICAL of the JAX chain's lines,
    CER <= MAX_CER). -> launch counts of each run."""
    runs, failed = {}, []
    pages = sorted(FIXTURE.glob("*.png"))

    corpus = lines_corpus(workdir / "lines_on_jax_inputs")
    run_chain("on the JAX inputs", corpus, ("lines",), device, runs, failed)
    worst = dict(contours_px=0.0, lines_px=0.0, conf=0.0, equal=1.0)
    for png in pages:
        px, conf, same = compare_lines_outputs(
            corpus / (png.stem + ".out"), FIXTURE / (png.stem + ".out"))
        worst = dict(
            contours_px=max(worst["contours_px"], px["contours.3.zip"]),
            lines_px=max(worst["lines_px"], px["lines.3.zip"]),
            conf=max(worst["conf"], conf), equal=min(worst["equal"], same))
    ok = worst["contours_px"] <= CONTOUR_PX and \
        worst["lines_px"] <= LINES_PX and worst["conf"] <= LINE_CONF
    log("  lines on the JAX inputs vs the JAX stage: entries byte-equal "
        "%.4f (worst page), contours.3.zip within %.3g px, lines.3.zip "
        "within %.3g px, evidence within %.3g  %s" % (
            worst["equal"], worst["contours_px"], worst["lines_px"],
            worst["conf"], "ok" if ok else "FAIL"))
    if not ok:
        failed.append("lines on the JAX inputs: %s (bars %g px, %g px, %g)"
                      % (worst, CONTOUR_PX, LINES_PX, LINE_CONF))

    corpus = order_corpus(workdir / "order_on_jax_inputs")
    run_chain("on the JAX inputs", corpus, ("order",), device, runs, failed)
    for png in pages:
        same = (corpus / (png.stem + ".out") / "order.json").read_bytes() \
            == (COMPOSE_REF / (png.stem + ".out") / "order.json").read_bytes()
        log("  order on the JAX inputs, %s: order.json %s" % (
            png.stem, "equal" if same else "DIFFERENT"))
        if not same:
            failed.append("order on the JAX inputs, %s: order.json differs"
                          % png.stem)

    corpus = compose_corpus(workdir / "compose_on_jax_inputs")
    for args, ref in (((), "compose.zip"),
                      (("--page-xml", "--overwrite"), "compose_xml.zip")):
        launches, wall, stage_s = run_stage_cli("compose", corpus, device,
                                                args)
        runs["compose %s(on the JAX inputs)" % (
            "--page-xml " if args else "")] = launches
        for png in pages:
            a = _entries(corpus / (png.stem + ".out") / "compose.zip")
            b = _entries(COMPOSE_REF / (png.stem + ".out") / ref)
            same = a.keys() == b.keys() and all(
                strip_xml_times(a[k]) == strip_xml_times(b[k]) for k in b)
            log("  compose %son the JAX inputs, %s: %s %s" % (
                "--page-xml " if args else "", png.stem,
                " and ".join(sorted(b)), "equal" if same else "DIFFERENT"))
            if not same:
                failed.append("compose %s, %s: %s differ" % (
                    " ".join(args), png.stem, sorted(b)))

    corpus = lines_corpus(workdir / "chain_from_jax_layout")
    run_chain("from the JAX contours.2.zip", corpus, ("lines", "order"),
              device, runs, failed)
    launches, wall, stage_s = run_stage_cli(
        "ocr", corpus, device, MODES["single"])
    runs["ocr (from the JAX contours.2.zip)"] = launches
    bad = ocr_launch_errors(launches, len(pages)) \
        if str(device) != "cpu" else None
    log("  ocr (from the JAX contours.2.zip) %d pages: launches %s  stage "
        "%.2f s  %s" % (len(pages), json.dumps(
            {k: v for k, v in launches.items() if v}), stage_s,
            "ok" if not bad else "FAIL"))
    if bad:
        failed.append("ocr (from the JAX contours.2.zip): launches %s"
                      % bad)
    run_chain("from the JAX contours.2.zip", corpus, ("compose",), device,
              runs, failed)
    compare_chain_text(corpus, "chain lines -> order -> ocr -> compose from "
                       "the JAX contours.2.zip", failed, MIN_IDENTICAL,
                       MAX_CER)
    if failed:
        raise PhaseError("; ".join(failed))
    return runs


# ---------------------------------------------------------------- phase 12

def reset_launches():
    from origami_tpu_torch.ops import binarize, gather, grid, remap
    for counts in (remap.launches, binarize.launches, gather.launches,
                   grid.launches):
        for k in counts:
            counts[k] = 0


def chain_stages(device, segmenter, extract_mode):
    """The nine detect stages of the port, in chain order, for
    PipelinedRunner."""
    from origami_tpu_torch.batch.detect.compose import ComposeProcessor
    from origami_tpu_torch.batch.detect.contours import ContoursProcessor
    from origami_tpu_torch.batch.detect.dewarp import DewarpProcessor
    from origami_tpu_torch.batch.detect.flow import FlowDetectionProcessor
    from origami_tpu_torch.batch.detect.layout import \
        LayoutDetectionProcessor
    from origami_tpu_torch.batch.detect.lines import LineDetectionProcessor
    from origami_tpu_torch.batch.detect.ocr import OCRProcessor
    from origami_tpu_torch.batch.detect.order import ReadingOrderProcessor
    from origami_tpu_torch.batch.detect.segment import SegmentationProcessor
    opts = dict(lock_strategy="NONE", plain=True, device=str(device))
    return [
        ("segment", SegmentationProcessor(segmenter, dict(opts))),
        ("contours", ContoursProcessor(dict(opts))),
        ("flow", FlowDetectionProcessor(dict(opts))),
        ("dewarp", DewarpProcessor(dict(opts))),
        ("layout", LayoutDetectionProcessor(dict(opts, layout="bbz"))),
        ("lines", LineDetectionProcessor(dict(opts))),
        ("order", ReadingOrderProcessor(dict(opts))),
        ("ocr", OCRProcessor(dict(
            opts, model=str(ROOT / "models_pretrained" / "recognizer"),
            extract_mode=extract_mode))),
        ("compose", ComposeProcessor(dict(opts))),
    ]


def unordered_regions(out):
    """The regions of a page's contours.3.zip that the order stage ranks
    (not ILLUSTRATION, at least its least area) and the "*" order of
    order.json leaves out."""
    from origami_tpu_torch import geometry as G
    from origami_tpu_torch.core.dewarp import Grid
    from origami_tpu_torch.core.math import Geometry
    grid = Grid.open(out / "dewarp.zip")
    h, w = grid._hv.shape[:2]
    min_area = Geometry(int(w * grid.resolution), int(
        h * grid.resolution)).rel_area(0.0025)
    star = json.loads((out / "order.json").read_text())["orders"]["*"]
    ranked = set("/".join(e.split("/")[:3]) for e in star)
    areas = {}
    for k, v in _entries(out / "contours.3.zip").items():
        parts = k[:-4].split("/")
        if not k.endswith(".wkt") or parts[0] != "regions" \
                or parts[1] == "ILLUSTRATION":
            continue
        base = "/".join(parts[:2] + [parts[2].split(".")[0]])
        areas.setdefault(base, []).append(G.wkt.loads(v.decode("utf8")))
    return sorted(b for b, gs in areas.items()
                  if b not in ranked and G.unary_union(gs).area >= min_area)


def whole_chain_launch_errors(mode, launches, n, device):
    """{kernel: (got, expected per page)} where a whole-chain run's
    launches differ from WHOLE_CHAIN_LAUNCHES; on the CPU nothing
    launches."""
    if str(device) == "cpu":
        want = {k: 0 for k in WHOLE_CHAIN_LAUNCHES[mode]}
    else:
        want = WHOLE_CHAIN_LAUNCHES[mode]
    bad = {}
    for k, per_page in want.items():
        ok = launches[k] <= per_page * n \
            if (mode, k) in WHOLE_CHAIN_AT_MOST and str(device) != "cpu" \
            else launches[k] == per_page * n
        if not ok:
            bad[k] = (launches[k], per_page)
    return bad


def check_whole_chain(workdir, device="cuda"):
    """Phase 12: the port alone from the page images through
    PipelinedRunner (waves of one page, so that segment, the host stages
    and ocr + compose of neighbouring pages overlap), twice, the launch
    counts set to 0 just before each run and read just after it: the
    main path (the students in bf16, banded strips), gated: every page
    COMPLETED in every stage, each kernel's launches per page as
    WHOLE_CHAIN_LAUNCHES says, the "*" order ranks every region of
    contours.3.zip that the stage ranks, page.txt within
    PORT_CHAIN_MAX_CER of the JAX chain's; then `-m heuristic` with
    gather strips, which must complete with its launches per page.
    Between them the two runs launch every kernel of phases 3, 5, 7 and
    9. Prints each stage's seconds and each kernel's launches.
    -> {"banded": launches, "gather": launches}."""
    import torch
    from origami_tpu_torch.batch.detect.flow import kernel_launches
    from origami_tpu_torch.batch.runner import PipelinedRunner
    runs, failed = {}, []
    for name, segmenter, mode in (
            ("students, banded", str(ROOT / STUDENTS), "banded"),
            ("heuristic, gather", "heuristic", "gather")):
        corpus = chain_corpus(workdir / ("whole_chain_" + mode), False)
        stages = chain_stages(device, segmenter, mode)
        reset_launches()
        t0 = time.perf_counter()
        PipelinedRunner(stages, wave_size=1).run(corpus)
        if str(device) != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_launches()
        runs[mode] = launches
        seconds = {}
        for png in sorted(corpus.glob("*.png")):
            rt = json.loads((corpus / (png.stem + ".out") / "runtime.json")
                            .read_text())
            for stage, _ in stages:
                entry = rt.get(STAGE_KEYS[stage], {})
                if entry.get("status") != "COMPLETED":
                    failed.append("whole chain (%s), %s on %s: %s" % (
                        name, stage, png.name,
                        entry.get("traceback", entry)))
                    continue
                seconds[stage] = seconds.get(stage, 0.0) + entry["elapsed"]
        n = len(list(corpus.glob("*.png")))
        bad = whole_chain_launch_errors(mode, launches, n, device)
        log("  whole chain (%s) %d pages: %.2f s wall; stage seconds %s; "
            "launches %s  %s" % (name, n, wall, json.dumps(seconds),
                                 json.dumps({k: v for k, v in
                                             launches.items() if v}),
                                 "ok" if not bad else "FAIL"))
        if bad:
            failed.append("whole chain (%s): launches (got, expected per "
                          "page) %s" % (name, bad))
        if failed:
            break
        if mode != "banded":
            continue
        for png in sorted(corpus.glob("*.png")):
            missing = unordered_regions(corpus / (png.stem + ".out"))
            if missing:
                failed.append("whole chain (%s), %s: the \"*\" order "
                              "leaves out %s" % (name, png.stem, missing))
        compare_chain_text(corpus, "whole chain (%s)" % name, failed, 0.0,
                           PORT_CHAIN_MAX_CER)
    if failed:
        raise PhaseError("; ".join(failed))
    return runs


# ---------------------------------------------------------------- main

def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "origami_tpu_torch").is_dir() or not FIXTURE.is_dir() \
            or not SEG_REF.is_dir() or not FLOW_REF.is_dir() \
            or not LAYOUT_REF.is_dir() or not COMPOSE_REF.is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(origami_tpu_torch/, tests/data/torch_ocr/, "
              "tests/data/torch_segment/, tests/data/torch_flow/, "
              "tests/data/torch_layout/ or tests/data/torch_compose/ "
              "missing)", file=sys.stderr)
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
    from concurrent.futures import ThreadPoolExecutor
    from origami_tpu_torch.geometry import native_bindings
    from origami_tpu_torch.ops import _build
    t0 = time.time()
    # g++ builds the host geometry library while nvcc builds the kernels
    with ThreadPoolExecutor(max_workers=1) as pool:
        host = pool.submit(native_bindings.build, True)
        nvcc_log = _build.build(force=True)
        host.result()
    _build.library()
    native_bindings.library()
    log("built %s from %s and %s from %s in %.1f s" % (
        _build.LIBRARY.relative_to(ROOT),
        ", ".join("origami_tpu_torch/csrc/" + s for s in _build.SOURCES),
        native_bindings.LIBRARY.relative_to(ROOT),
        ", ".join(str(s.relative_to(ROOT)) for s in native_bindings.SOURCES),
        time.time() - t0))
    for line in nvcc_log.splitlines():
        if "registers" in line or line.startswith("==") or "spill" in line:
            log("  " + line.strip())

    log("== phase 2: kernels vs plain versions (median of %d, CUDA "
        "events; %s)" % (REPS, smi))
    rows = check_kernels(device)
    rows.update(check_gather(device))
    rows.update(check_grid(device, rows["take_along_axis_lane"]))
    host_path_ab(device)
    device_groups_ab(device)

    log("== phase 3: OCR CLI on the card vs the JAX references (%s)"
        % smi)
    failed = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = Path(tmp)
        for mode in MODES:
            r = run_ocr_cli(mode, work)
            ok = r["identical"] >= MIN_IDENTICAL and r["cer"] <= MAX_CER
            # the dewarp kernel at least once per page in the banded runs;
            # a page's strips in exactly one launch of their mode: (a) in
            # the banded runs (and (b) at most once, for lines past the
            # banded profiles), (b) in the gather run, where (a) never runs
            n = r["pages"]
            got = r["launches"]
            starved = [k for k in ("dewarp_u8",)
                       if mode != "gather" and got[k] < n]
            if mode == "gather":
                strips_ok = got["strips_through_grid"] == n \
                    and got["strips_dewarped"] == 0
            else:
                strips_ok = got["strips_dewarped"] == n \
                    and got["strips_through_grid"] <= n
            if not strips_ok:
                starved.append("strip launches %s, expected one per page "
                               "(%d pages) of the mode's kernel" % (
                                   {k: got[k] for k in ("strips_dewarped",
                                                        "strips_through_grid")},
                                   n))
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
                failed.append("%s: launch counts: %s" % (mode, starved))
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

        log("== phase 5: segment CLI on the card vs the JAX references "
            "(%s; the float32 run with TF32 off)" % smi)
        for mode in SEG_MODES:
            r = run_segment_cli(mode, work)
            # the Sauvola kernel: the packed prefetch once per page in
            # every run, the u8 mask once per page in the heuristic run
            want = {"sauvola_packed": r["pages"],
                    "sauvola": r["pages"] if mode == "heuristic" else 0}
            low = {k: v for k, v in r["equal"].items()
                   if v < r["min_equal"]}
            ok = not low and r["launches"] == want
            log("  %-14s %d pages: equal pixels regions %.6f separators "
                "%.6f (gate %.3f)  launches %s  stage %.2f s, process "
                "%.2f s (cold)  %s" % (
                    mode, r["pages"], r["equal"]["regions"],
                    r["equal"]["separators"], r["min_equal"],
                    json.dumps(r["launches"]), r["stage_s"], r["wall_s"],
                    "ok" if ok else "FAIL"))
            if low:
                failed.append("segment %s: equal pixels %s below %.3f"
                              % (mode, low, r["min_equal"]))
            if r["launches"] != want:
                failed.append("segment %s: launches %s, expected %s"
                              % (mode, r["launches"], want))
        if failed:
            raise PhaseError("; ".join(failed))

        log("== phase 6: segment stage throughput, students in bf16, warm "
            "(%s)" % smi)
        stp = segment_throughput(work)
        log("  %d pages; median of %d warm passes %.4f s (min %.4f, max "
            "%.4f): %.3f pages/s; peak device memory %.0f MiB" % (
                stp["pages"], len(stp["times"]), stp["seconds"],
                min(stp["times"]), max(stp["times"]), stp["pages_per_s"],
                stp["peak_mb"]))
        log("  profiled pass: %.4f s wall, %.1f ms device (kernel) time, "
            "device busy %.1f %%" % (
                stp["prof_wall_s"], stp["device_ms"],
                100.0 * stp["device_ms"] / 1e3 / stp["prof_wall_s"]))
        log(stp["profile"])

        log("== phase 7: flow and dewarp CLIs on the card vs the JAX "
            "stages (%s)" % smi)
        check_flow_dewarp(work)

        log("== phase 8: flow and dewarp stage throughput, warm (%s)" % smi)
        ftp = flow_dewarp_throughput(work)
        for stage in ("flow", "dewarp"):
            log_throughput(stage, ftp[stage])
        g = ftp["grid"]
        log("  one grid build (88 x 64 nodes, 1312x1920 page): %.2f ms wall "
            "(median of 5), %d device launches (kernels and copies; %d of "
            "them the grid scan kernels), %.3f ms device time"
            % (g["wall_ms"], g["launches"], g["scans"], g["device_ms"]))

        log("== phase 9: the chain segment -> contours -> flow -> dewarp -> "
            "layout on the card, each stage's CLI, vs the JAX stages (%s)"
            % smi)
        check_layout_on_jax_inputs(work)
        check_chain_from_jax_segmentation(work)
        check_port_chain(work)

        log("== phase 10: contours and layout stage throughput, warm (%s)"
            % smi)
        from origami_tpu_torch.batch.detect.contours import \
            ContoursProcessor
        from origami_tpu_torch.batch.detect.layout import \
            LayoutDetectionProcessor
        log_throughput("contours", stage_throughput(
            work, "contours", ContoursProcessor,
            lambda dst: chain_corpus(dst, True)))
        log_throughput("layout", stage_throughput(
            work, "layout", LayoutDetectionProcessor, layout_corpus))

        log("== phase 11: lines, order and compose CLIs on the card vs the "
            "JAX stages, and their warm throughput (%s)" % smi)
        check_lines_order_compose(work)
        from origami_tpu_torch.batch.detect.compose import ComposeProcessor
        from origami_tpu_torch.batch.detect.lines import \
            LineDetectionProcessor
        from origami_tpu_torch.batch.detect.order import \
            ReadingOrderProcessor
        for stage, cls, make in (
                ("lines", LineDetectionProcessor, lines_corpus),
                ("order", ReadingOrderProcessor, order_corpus),
                ("compose", ComposeProcessor, compose_corpus)):
            log_throughput(stage, stage_throughput(work, stage, cls, make))

        log("== phase 12: the whole chain from the page images through "
            "PipelinedRunner on the card (%s)" % smi)
        whole = check_whole_chain(work)

    # each kernel's launches in the phase-12 run of its own path
    total = {k: whole["gather" if k in OTHER_PATH_KERNELS else "banded"][k]
             for k in whole["banded"]}
    table = {
        "dewarp_u8": ("remap.cu", "origami_tpu/ops/pallas/remap.py:392"),
        "strips_dewarped": ("strips.cu",
                            "origami_tpu/ops/pallas/remap.py:227"),
        "strips_through_grid": ("strips.cu",
                                "origami_tpu/ops/pallas/remap.py:227"),
        "sauvola": ("sauvola.cu", "origami_tpu/ops/pallas/sauvola.py:120"),
        "sauvola_packed": ("sauvola.cu",
                           "origami_tpu/ops/pallas/sauvola.py:120"),
        "grid_scan_h": ("grid.cu", "origami_tpu/core/dewarp.py:93"),
        "grid_scan_v": ("grid.cu", "scripts/pallas_gather_repro.py:73, "
                                   "origami_tpu/core/dewarp.py:131"),
        "remap": ("remap.cu", "origami_tpu/ops/pallas/remap.py:392"),
        "take_along_axis_lane": ("gather.cu",
                                 "scripts/pallas_gather_repro.py:73"),
        "take_along_axis_sublane": ("gather.cu",
                                    "scripts/pallas_gather_repro.py:73"),
    }
    kernels = {}
    for name, (source, replaces) in table.items():
        row = rows[name]
        kernels[name] = dict(
            name=name, route="cuda",
            source="origami_tpu_torch/csrc/" + source,
            replaces=replaces, launches=total[name],
            max_abs_err=row["err"], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"])
    off_path = ("take_along_axis_lane", "take_along_axis_sublane")
    starved = [n for n, k in kernels.items()
               if n not in off_path and k["launches"] < 1]
    if starved:
        raise PhaseError("kernels of the driven paths never launched: %s"
                         % starved)
    log("total %.1f s" % (time.time() - t_start))
    # the gather (lane and sublane) is an entry point that no stage
    # calls: held against its plain version above, launched by no path,
    # and so kept out of the table of the paths' kernels
    print(json.dumps({"off_path_kernels": [kernels.pop(n)
                                           for n in off_path]}),
          flush=True)
    log(smi)
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
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
