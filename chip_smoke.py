#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

  1. build the CUDA kernels from origami_tpu_torch/csrc with nvcc
     (sm_90a) and, beside them, the host library
     (origami_tpu_torch/geometry/native.cpp and contour_trace.cpp, the
     image codecs origami_tpu_torch/core/png.cpp, jpeg.cpp, jpeg_enc.cpp,
     jp2.cpp and tiff.cpp; g++);
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
     dewarp_u8 and dewarp_f32 once a page), and the layout stage's Sauvola
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
  13. the rest of the inference surface: (a) the OCR CLI with
     `--binarize sauvola` (the host strip path: every strip binarized by
     one `sauvola` launch) against the JAX stage's ocr.zip
     (tests/data/torch_ocr/full/ref/*.binarize.ocr.zip; MIN_IDENTICAL,
     MAX_CER), then in process, warm, its pages/s and the share of the
     per-strip Sauvola round trips; (b) the segment CLI with
     `-m auto:models_pretrained/students` on the real 1872 scan (mode
     "trained", TABULAR <= 1 %, TEXT >= 50 %) and the fixture pages (the
     JAX auto mode's modes, label maps at the bf16 bar against
     tests/data/torch_segment/ref/*.auto.segment.zip), and the heuristic
     fallback forced by trained maps without text (one `sauvola`
     launch, the heuristic maps); (c) PagePipeline with the students and
     the recognizer over the page images, sequential and overlapped
     (every page composed, page.txt within PORT_CHAIN_MAX_CER of the JAX
     chain's, wall time); (d) export.lines (one PNG per OCR line, each
     the OCR path's strip, gray and binarized) and export.pagexml (one
     TextLine per line of lines.0.zip). Each run's launch counts are
     set to 0 just before it and printed after it.
  14. training (train_corpus: the fixture pages and the two real scans
     with the JAX f32 auto label maps): (a) remap_batch, the training
     warp's kernel, at both borders on 2 pages of 2432x1280 f32 under a
     field of amplitude 10 against its plain version (REMAP_F32_ERR),
     one launch a call, timed with its plain version, its bound and
     F.grid_sample; (b) the port's trainers in float32 (TF32 off)
     against the JAX trainers' numbers at full width
     (tests/data/torch_train, scripts/make_torch_train_fixture.py): the
     students' SegmentationTrainer (region; separator with the
     tolerance band), the Distiller and the shipped recognizer, 3 steps,
     each loss and every leaf norm (PARITY_FIRST, PARITY_LATER); (c) the
     main path: bootstrap.train_segmentation (2 members, 20 steps, bf16,
     warp on: one remap_batch launch a step and no other kernel),
     distill_students (10 steps) and train_recognizer_pool (20 steps on
     the OCR path's strips with the JAX texts), each loss finite and
     falling, ms a step and peak memory printed; each trained directory
     loads and serves a page through the segment or OCR stage; (d) the
     contours, flow, dewarp, layout and lines stages with --processes 2
     write the --processes 1 artifacts, their workers' launches summed
     in the parent as STAGE_LAUNCHES says, and a stalled pool is ended
     by the watchdog. The kernels line's remap_batch launches come from
     (c);
 15. the ground-truth path on the card against the JAX package's numbers
     in tests/data/torch_gt (scripts/make_torch_gt_fixture.py), on the
     train corpus of phase 14: (a) gen_binarized (one sauvola launch a
     page; each bin/ page equal to JAX's on GT_BIN_EQUAL of its pixels,
     JAX's float32 integral images missing the exact sums on the rest,
     and equal to the exact Sauvola off its ties); (b) deskew_pair of a
     fixture page at 0.02 rad and the 1872 scan at -0.015 (one
     remap_affine launch a call; labels equal, the image within 1 gray
     level); (c) the ground-truth chain on each page (gt_chain: cleaned
     segments within 1e-6, the skew within 1e-9, master, stops and
     regions equal); (d) Line.image on both routes, Line.ink and the
     Deskewer on the OCR fixture's lines (strips within 1 gray level,
     ink within 1e-6; remap_batch once a dewarped strip, remap_affine
     once a deskewed strip, an ink and the Deskewer image); (e)
     eval_segmentation and eval_separator_tolerant of the students in
     float32 (every score within GT_EVAL of JAX's) and in bf16 (reports,
     pages/s and, as a control, their distance from JAX's float32
     scores); then each new kernel site against its plain version with
     its times, bound and yardstick (gt_sites). The kernels line's
     remap_affine launches come from (b) and (d).
 16. the synthetic corpus and what it feeds, against the JAX package's
     numbers in tests/data/torch_synth (scripts/make_torch_synth_fixture
     .py): (a) write_corpus(2 pages, seed=7) equal to the OCR fixture's
     page images on every pixel, its label maps and gt.json, the other
     render_page cases, render_line over SYNTH_LINE_SEEDS and
     page_line_pool equal to JAX's by digest; (b) eval_recognizer's 300
     lines through the serving predictor, models_pretrained/recognizer
     and the 2-model sequence vote with recognizer2 (CER within EVAL_CER
     of JAX's, EVAL_MIN_EQUAL texts equal), and the pool's build time
     and the recognizer's steps/s; (c) the chain's baselines on the
     rendered pages, mapped back through dewarp.zip and scored by the
     port's evaluate against their gt.json (each count within
     CHAIN_SCORE_SLACK of the JAX chain's; phase 12's outputs where the
     pages equal its page images); (d) `python -m
     origami_tpu_torch.train.bootstrap` end to end at BOOT_ARGS' depth.
     It prints render_page's host seconds a page, the pool's build
     seconds, the recognizer's steps/s, eval_recognizer's lines/s and
     the chain's pages/s with the card's name and power limit.
 17. the corpus-inspection surface in this process on the fixture pages
     with the JAX artifacts it reads (inspect_corpus), against the JAX
     package's outputs in tests/data/torch_inspect
     (scripts/make_torch_inspect_fixture.py): the annotate renders
     (grid, flow, contours warped and reliable, lines, layout) and
     utils.dewarp, each with the page caches emptied (one dewarp_u8
     launch a page where the canvas is the dewarped page, none
     elsewhere) and, where it dewarps, again warm (none), each render's
     JPEG decoded equal to the JAX file's PIL decode by digest outside
     the label boxes grown to the 16-px MCU lattice and one MCU more
     (mcu_box), dewarped.jpg byte-equal to JAX's; thumbnail.jpg
     byte-equal to JAX's, signature.zip and rtext equal to JAX's;
     stats, cleanup and reset on planted files; patch_skew_samples on
     the JAX binarized page at patches 256 and 128 (the same points,
     SKEW_EQUAL of the angles equal, the rest within SKEW_STEP). The
     kernels line's dewarp_u8 row lists the renders' cold launches in
     launches_by_path, beside phase 12's count.
 18. scale-out for serving and the flagship graph: (a) build_flagship
     (batch=2) at full width with the students' weights in all 5
     members of each net, in float32 and bf16, on the fixture pages
     against JAX's label maps (tests/data/torch_flagship,
     scripts/make_torch_flagship_fixture.py) at FLAGSHIP_BARS; the bf16
     graph's warm ms a page (CUDA events, median of FLAGSHIP_REPS), peak
     memory and top device ops, and one page of the random-init graph;
     (b) SegmentationPredictor over make_mesh() (every visible card)
     against mesh=None on 3 pages: equal maps; (c) two processes of the
     segment CLI on the one card, joined through
     ORIGAMI_TPU_COORDINATOR, over MULTIHOST_PAGES copies of the fixture
     pages: each page once, by the process its hash names, every map at
     the students_bf16 bar against the fixture's JAX segment.zip, and
     sauvola_packed 1 a page over both (the kernels line's
     sauvola_packed row lists them in launches_by_path); (d)
     parallel.dryrun.dryrun_multichip over every visible card;
 19. mesh training (parallel/{mesh,sharding}.py, train/mesh.py): (a)
     the trainers on meshes of repeated card entries (MESH_PARITY: the
     U-Nets on a model axis of 2, the recognizer on data axes of 2 and
     4) against phase 14b's JAX numbers at its bars; (b) the region
     trainer on a 2 x 2 mesh, 2 pages a step, warp on, against the
     one-device trainer with the same seeds at the same bars,
     remap_batch exactly MESH_WARP_LAUNCHES a step (the kernels line's
     remap_batch row lists the mesh run in launches_by_path), ms a step
     and each card's peak memory of both; (c)
     parallel.dryrun.dryrun_multichip over every visible card with its
     training half. On several cards the meshes take the cards in turn.
 20. the operator tools (tool/) and the remote runner (batch/remote) on
     a copy of the OCR fixture pages against the JAX tools' outputs
     (tests/data/torch_tools, scripts/make_torch_tools_fixture.py): (a)
     tool.sample (seed 0, 2 lines a type), annotate set, harmonize
     default, export at 48 px and with --binarize sauvola, annotate
     export-image, each CLI's main on the card: the rows, texts and
     sets.json equal, the strips within TOOLS_GRAY gray levels, the
     binarized strips equal on TOOLS_BIN_EQUAL of their pixels, each
     strip equal to its plain version on the CPU, remap_batch 1 a line
     and sauvola 1 a line under --binarize; (b) the four web tools on
     port 0 through every route: the JSON bodies equal, the JPEG bodies
     byte-equal to JAX's, pick_web's /image dewarp_u8 1 a page cold and 0
     warm; xycut and cluster print what JAX prints; (c) remote -m
     heuristic through ssh/scp shims against a direct run of the two
     stages, its task DB DONE and a second run of no page. The kernels
     line's remap_batch, sauvola, sauvola_packed and dewarp_u8 rows list
     these launches in launches_by_path.
 21. page images in every format the JAX package reads (core/_image.py
     and the decoders under it; tests/data/torch_formats,
     scripts/make_torch_formats_fixture.py): (a) every fixture file
     (JPEG qualities, samplings, restarts, progressive and smoothed
     progressive files; TIFF none, PackBits, LZW, Deflate, CCITT RLE,
     G3 1-D and 2-D, G4, both fill orders, strips and tiles, both byte
     orders; BMP 1-32 bits and RLE; PNG 1-16 bits and Adam7; the two
     fixture pages as JPEG, one progressive, one G4 TIFF; CMYK and YCCK
     JPEG with and without an Adobe marker) decodes to PIL's
     convert("L") digest and PIL's size, and the kinds the port does not
     read (arithmetic, lossless and 12-bit JPEG) raise a ValueError
     naming them; (b) the two
     pages as baseline gray JPEGs through PipelinedRunner on the main
     path: every page COMPLETED, launches exactly phase 12's, page.txt
     within PORT_CHAIN_MAX_CER of the JAX chain's on the same JPEG
     pages (the kernels line lists these launches in
     launches_by_path); (c) host decode ms a page of each page file
     beside the PNG of the same pixels, with the card's name and power
     limit, and of the PNG page written as BMP and TIFF (uncompressed;
     Deflate with the predictor), which must decode to its pixels.
 22. JPEG 2000 and JPEG-in-TIFF pages (core/_jp2.py over core/jp2.cpp,
     core/_tiff.py's JPEG strips; tests/data/torch_formats,
     scripts/make_torch_formats_fixture.py): (a) every JP2, J2K and
     JPEG-in-TIFF file of the manifest (Pillow's writer options; the
     libopenjp2-made code-block styles, SOP/EPH, PPM/PPT, RGN, POC,
     tile-parts, sub-sampled components and sYCC; CMYK, palettes; the
     fixture's JP2 and JPEG-in-TIFF pages) decodes to PIL's convert("L")
     digest and PIL's size, and the kinds the port does not read raise a
     ValueError naming them; (b) the two pages as JP2 (the archive
     profile, 512 x 512 tiles) through PipelinedRunner on the main path:
     every page COMPLETED, launches exactly phase 12's, page.txt within
     PORT_CHAIN_MAX_CER of the JAX chain's on the same JP2 files (the
     kernels line lists these launches in launches_by_path); the JPEG
     pages' lines split (ROADMAP C16): the port's bf16 label maps
     against the JAX segment.zip at phase 5's bar, the port from the JAX
     segment.zip (contours .. compose) and from the JAX contours.2.zip
     (lines .. compose), each page.txt against the JAX chain's; (c) host
     decode ms a page of each JP2 and JPEG-in-TIFF page beside the PNG of
     the same pixels, with the card's name and power limit.
 23. the JPEG writers (core/_jpeg.encode over core/jpeg_enc.cpp;
     tests/data/torch_jpeg, scripts/make_torch_jpeg_fixture.py): (a)
     every seeded case of jpeg_cases() (gray and RGB 4:2:0, six sizes,
     flat, noise and text-like content, eleven qualities) and the
     fixture page gray and as RGB of partial MCUs encode to PIL's bytes
     (sha256 and length); (b) utils.thumbnail and utils.dewarp on the
     fixture pages, cold page caches (dewarp_u8 1 a page), their
     thumbnail.jpg and dewarped.jpg byte-equal to the JAX modules'
     (tests/data/torch_inspect); (c) pick_web's /image once, cold
     (dewarp_u8 1), its image/jpeg body byte-equal to JAX's
     (tests/data/torch_tools); (f) annotate export-image -o line.jpg
     (remap_batch 1), PIL's bytes of the strip at quality 75; (d) a CMYK
     and a YCCK page decode to PIL's convert("L") digest; (e) host encode
     ms a page, gray at 90 and RGB at 85, beside the PNG encode of the
     same array, with the card's name and power limit. The kernels
     line's dewarp_u8 and remap_batch rows list (b), (c) and (f) in
     launches_by_path.
 24. the page kinds PIL reads beyond those (tests/data/torch_formats,
     scripts/make_torch_formats_fixture.py): (a) every file of more/
     (lossless and arithmetic-coded JPEG written by libjpeg-turbo,
     BigTIFF, planar, CMYK, float, signed and associated-alpha TIFF,
     the BMP palettes PIL drops) and the two lossless pages at PIL's
     convert("L") digest and size, or raising with the word of the
     kinds PIL refuses (an arithmetic scan past PIL's 65536-byte read
     block among them); (b) each lossless page equal to its PNG page on
     every pixel, then the two through PipelinedRunner on the main path
     as phase 21 (b) runs the JPEG pages: every page COMPLETED,
     launches exactly phase 12's, page.txt within PORT_CHAIN_MAX_CER of
     the JAX chain on the PNG pages (the same pixels), and its lines
     beside phase 12's run (the kernels line lists these launches as
     "lossless jpeg chain"); (c) host decode ms a page of each lossless
     page and of the PNG fixture page written here as BigTIFF, planar
     RGB and CMYK, beside the PNG of the same pixels.
 25. the last TIFF kinds PIL reads (tests/data/torch_formats,
     scripts/make_torch_formats_fixture.py): (a) every file of tiff/
     (old-style JPEG of one and three components, from a
     JPEGInterchangeFormat stream and from the tables tags; YCbCr under
     none, LZW, Deflate and PackBits at each sub-sampling libtiff reads,
     strips, tiles and planes; old-style LZW; 12-bit gray) and the two
     old-style JPEG pages at PIL's convert("L") digest and size, the
     kinds both refuse (CIELab among them) and those PIL misreads
     raising with their names; (b) the two old-style JPEG pages (2 x 2,
     strips of 64 rows, one of each form) through PipelinedRunner on the
     main path as phase 21 (b) runs the JPEG pages: every page
     COMPLETED, launches exactly phase 12's, page.txt within
     PORT_CHAIN_MAX_CER of the JAX chain on the same files (the kernels
     line lists these launches as "old-style JPEG chain"); (c) host
     decode ms a page of each old-style JPEG page and of the PNG fixture
     page written here as YCbCr 2 x 2 under LZW (its pixels against the
     PNG page's), beside the PNG of the same pixels.

Each phase prints its seconds.

Phase 2 also holds the Sauvola kernel (both borders, u8 mask and
bit-packed, windows 15, 31, 33, 41, 63, 101, 259 and 513) against its
plain version at a fixture page, a dewarped page and a ragged crop: the two
must agree exactly (scripts/sauvola_ab.py runs this check alone); and
the gather kernel (lane and sublane) over the sweep of
scripts/pallas_gather_repro.py and at the grid build's own inputs, which
must agree exactly with numpy's take_along_axis and the plain version;
dewarp_f32 (f32, within 1e-4) on the separator mask the layout stage
dewarps, against its plain version (the grid upsampled, then remap's
sample), and remap, its parity entry through the dense map, on the same
mask and on the page at both borders; dewarp_u8 (bit-equal, both
borders) and dewarp_f32 on both of their tile routes: the pages' own
grids (every tile staged in shared memory), a scrambled grid (every
tile through __ldg), a sheared grid, a past-edge grid and a ragged crop;
remap_affine on rotations of +-0.02 rad, a 0.3x minification, a
translation mostly off the page, an output width of 4k + 3 and a source
whose rows are not 16-byte aligned, and the map form through a map of
ragged width, a map off a 16-byte boundary and remap_batch's planes
(check_remap_cases); and the grid scan
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
driven paths; the gather's entry points and remap, which no path runs,
are printed on a line of their own before it), the last line {"ok":
true, "device": {...}}. Imports nothing of JAX or origami_tpu.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import zipfile
from pathlib import Path

import numpy as np

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
# phase 13: the host strip path, each strip binarized on its own
BINARIZE_MODE = ["-m", "models_pretrained/recognizer",
                 "--binarize", "sauvola"]
# acceptance per OCR run against its JAX reference
MIN_IDENTICAL = 0.99
MAX_CER = 0.005
# phase 3: the least number of the 513 lines identical to the JAX
# reference, per mode: since the dewarp takes the JAX banded route's
# border (ROADMAP C3) only the bf16 lines of ROADMAP C2 may differ
MIN_IDENTICAL_LINES = {"single": 511, "ensemble": 511, "gather": 512}
# phase 11: the least number of the 606 page.txt lines of the chain from
# the JAX contours.2.zip identical to the JAX chain's (the two bf16
# lines of ROADMAP C2 may differ)
CHAIN_MIN_IDENTICAL_LINES = 604
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
              "compose": COMPOSE_STAGE,
              "export.lines": "origami_tpu.batch.export.lines",
              "export.pagexml": "origami_tpu.batch.export.pagexml"}
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
# its page and the f32 dewarp of its separator mask; the lines stage's
# dewarp of its page and Sauvola (window 15) on it; nothing else
STAGE_LAUNCHES = {
    "segment": {"sauvola_packed": 1},
    "contours": {},
    "flow": {"sauvola_packed": 1},
    "dewarp": {"sauvola_packed": 1, "dewarp_u8": 1, "grid_scan_h": 1,
               "grid_scan_v": 1},
    "layout": {"sauvola_packed": 1, "dewarp_u8": 1, "dewarp_f32": 1},
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
               "dewarp_f32": 1, "remap": 0, "grid_scan_h": 1, "grid_scan_v": 1,
               "strips_dewarped": 1, "strips_through_grid": 1},
    "gather": {"sauvola_packed": 3, "sauvola": 1, "dewarp_u8": 1,
               "dewarp_f32": 1, "remap": 0, "grid_scan_h": 1, "grid_scan_v": 1,
               "strips_dewarped": 0, "strips_through_grid": 1},
}
WHOLE_CHAIN_AT_MOST = {("banded", "strips_through_grid")}
# the kernels line takes each kernel's launches from the phase-12 run of
# its own path: the heuristic segmenter's mask and the gather strips
# from the second run, every other kernel from the main path's (phase
# 17's dewarp_u8 launches go into that row's launches_by_path)
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
    page clamps them, so the tiles take both routes) and "past_edge" (a
    separable stretch of the page that samples 0.7 to 1.5 px past each
    of its edges, where the fill_taps border blends the page with the
    fill)."""
    import numpy as np
    import torch
    gh, gw = hv.shape[:2]
    u, v = np.linspace(0, 1, gw), np.linspace(0, 1, gh)
    past_edge = np.stack(np.meshgrid(
        -0.7 + u * (w - 1 + 0.7 + 1.5) + 3.0 * np.sin(np.pi * u),
        -1.5 + v * (h - 1 + 1.5 + 1.1) + 2.0 * np.sin(np.pi * v)), -1)
    rng = np.random.default_rng(11)
    scrambled = np.stack([rng.uniform(0, w - 1, (gh, gw)),
                          rng.uniform(0, h - 1, (gh, gw))], -1)
    ii, jj = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    sheared = np.stack([
        -600.0 + res * jj + 1.0 * res * ii + 3.1 * np.sin(ii / 2.3),
        -400.0 + res * ii + 0.5 * res * jj + 2.7 * np.cos(jj / 3.1)], -1)
    return {k: torch.from_numpy(v.astype(np.float32)).to(hv.device)
            for k, v in (("scrambled", scrambled), ("sheared", sheared),
                         ("past_edge", past_edge))}


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


def check_remap_cases(device, px, map_xy):
    """The f32 sampler's forms off the main path, against their plain
    versions (F32_TOL) on the first fixture page: remap_affine on the
    page as f32 rotated by +-0.02 rad, minified 0.3x, moved mostly off
    the page and rotated into an output of width 4k + 3, and on a crop
    whose rows are not 16-byte aligned (941 px); the map form at both borders
    through a map of ragged width (1597: scalar loads and stores), through
    a map that starts 8 bytes off a 16-byte boundary, and as remap_batch's
    planes of ragged width. -> failures."""
    import torch
    from origami_tpu_torch.core.math import rotation_matrix
    from origami_tpu_torch.ops import remap as ops
    failures = []

    def held(name, label, got, want):
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        log("  %-20s %-30s max|diff| %.3g (tol %g) %s" % (
            name, label, err, F32_TOL, "ok" if err <= F32_TOL else "FAIL"))
        if err > F32_TOL:
            failures.append("%s %s" % (name, label))

    img = px.float().contiguous()
    crop = img[100:1100, 60:1001].contiguous()
    h, w = img.shape
    c = (w / 2, h / 2)
    for image, label, m, out_hw in (
            (img, "rotated +0.02", rotation_matrix(0.02, c), (h, w)),
            (img, "rotated -0.02", rotation_matrix(-0.02, c), (h, w)),
            (img, "0.3x minified", [[1 / 0.3, 0.0, 0.4], [0.0, 1 / 0.3, 0.7]],
             (int(h * 0.3), int(w * 0.3))),
            (img, "mostly off the page",
             [[1.0, 0.0, 0.9 * w], [0.0, 1.0, 0.8 * h]], (h, w)),
            (img, "out_w % 4 == 3", rotation_matrix(0.02, c), (h - 3, w - 3)),
            (crop, "unaligned rows, rotated 0.02",
             rotation_matrix(0.02, (470.0, 500.0)), crop.shape)):
        held("remap_affine", "%s %dx%d -> %dx%d" % (
            (label,) + tuple(image.shape) + tuple(out_hw)),
            ops.affine_warp(image, m, out_hw, 255.0),
            ops.affine_warp_plain(image, m, out_hw, 255.0))
    oh, ow = map_xy.shape[:2]
    ragged = map_xy[:, :1597].contiguous()
    flat = torch.empty(map_xy.numel() + 2, device=device)
    shifted = flat[2:].view(oh, ow, 2)
    shifted.copy_(map_xy)
    for border in ("fill_taps", "hard"):
        for label, m in (("map of width 1597", ragged),
                         ("map 8 bytes off 16", shifted)):
            held("remap", "%s %s" % (border, label),
                 ops.remap(img, m, 0.0, border),
                 ops.remap_plain(img, m, 0.0, border))
        planes = (ragged[None, ..., 0].contiguous(),
                  ragged[None, ..., 1].contiguous())
        held("remap_batch", "%s planes of width 1597" % border,
             ops.remap_batch(img[None], planes, 0.0, border),
             ops.remap_batch_plain(img[None], *planes, 0.0, border))
    return failures


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

    def dewarp_only(label, page, grid, res, want_route, border):
        """A grid form against its plain version on a grid off the main
        path, with the count of tiles that staged a window: dewarp_u8
        (bit-equal) at one border for a u8 page, dewarp_f32 (fill_taps,
        within F32_TOL; fill 0) for an f32 image."""
        if page.dtype == torch.uint8:
            name, tol, fill = "dewarp_u8", 0, 255.0
            kernel, plain = ops.dewarp_u8, ops.dewarp_u8_plain
            args = (fill, border)
        else:
            name, tol, fill = "dewarp_f32", F32_TOL, 0.0
            kernel, plain = ops.dewarp_f32, ops.dewarp_f32_plain
            args = (fill,)
        staged = torch.zeros(1, dtype=torch.int32, device=device)
        got = kernel(page, grid, res, *args, staged_tiles=staged)
        want = plain(page, grid, res, *args)
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        gh, gw = grid.shape[:2]
        cells = ops.TILE_CELLS[page.dtype]
        tiles = -(-gh // cells) * -(-gw // cells)
        n_staged = int(staged)
        route_ok = {"staged": n_staged == tiles, "direct": n_staged == 0,
                    "any": True}[want_route]
        log("  %-20s %-30s max|diff| %g (tol %g) %s  tiles %d: %d staged, "
            "%d read through __ldg  kernel %.4f ms  plain %.4f ms" % (
                name, "%s %s %dx%d" % ((label, border) + tuple(page.shape)),
                err, tol, "ok" if err <= tol and route_ok else "FAIL", tiles,
                n_staged, tiles - n_staged,
                time_cuda(lambda: kernel(page, grid, res, *args)),
                time_cuda(lambda: plain(page, grid, res, *args))))
        if err > tol or not route_ok:
            failures.append("%s %s %s" % (name, label, border))
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

        # dewarp_u8 (the dewarp kernel on the main path): bit-equal, at
        # the border the page's grid takes there (the JAX banded route's
        # "fill_taps" where the grid has a banded plan: the fixture
        # pages), and at the other border ("hard") beside it
        main_border = "fill_taps" if page.grid.has_banded_plan((h, w)) \
            else "hard"
        mx, my = ops._upsample_grid(hv, res)
        grid = _norm_grid(mx, my, w, h)[None]
        pxf = px.float()[None, None]
        for name, border in (
                ("dewarp_u8", main_border),
                ("dewarp_u8_" + ("hard" if main_border == "fill_taps"
                                 else "fill_taps"),
                 "hard" if main_border == "fill_taps" else "fill_taps")):
            got = ops.dewarp_u8(px, hv, res, 255.0, border)
            want = ops.dewarp_u8_plain(px, hv, res, 255.0, border)
            torch.cuda.synchronize()
            if border == "hard":
                inb = (mx >= 0) & (mx <= w - 1) & (my >= 0) & (my <= h - 1)
                tx, ty = mx, my
            else:
                inb = torch.ones_like(mx, dtype=torch.bool)
                tx, ty = mx.clamp(-2.0, w + 1.0), my.clamp(-2.0, h + 1.0)
            report(name, got, want, 0,
                   lambda: ops.dewarp_u8(px, hv, res, 255.0, border),
                   lambda: ops.dewarp_u8_plain(px, hv, res, 255.0, border),
                   tapped_pixels(tx, ty, inb, h, w) + hv.numel() * 4
                   + got.numel(),
                   lambda: F.grid_sample(pxf, grid, mode="bilinear",
                                         padding_mode="zeros",
                                         align_corners=True),
                   "%s %dx%d -> %dx%d" % (border, h, w, gh * res, gw * res))
            if name == "dewarp_u8":
                dew = got
        images.append((px, dew))
        # both tile routes at both borders (dewarp_f32: its fill_taps
        # border, on the page's pixels as f32): the page's own grid
        # stages every tile's window, the scrambled grid none; the
        # sheared grid mixes them; a ragged crop (rows not 16-byte
        # aligned) stages with element loads; a grid that samples 0.7-1.5
        # px past every edge stages the ring of fill
        for image, border in ((px, "fill_taps"), (px, "hard"),
                              (px.float(), "fill_taps")):
            dewarp_only("own grid", image, hv, res, "staged", border)
            if i == 0:
                extra = dewarp_grids(hv, h, w, res)
                dewarp_only("scrambled grid", image, extra["scrambled"], res,
                            "direct", border)
                dewarp_only("sheared grid", image, extra["sheared"], res,
                            "any", border)
                dewarp_only("past-edge grid", image, extra["past_edge"],
                            res, "staged", border)
                crop = image[100:297, 60:311].contiguous()
                shift = torch.tensor([60.0, 100.0], device=device)
                dewarp_only("ragged crop", crop, (hv - shift).contiguous(),
                            res, "any", border)

        # the layout stage's site: its separator mask, resized onto the
        # warped page as that stage resizes it, dewarped through the
        # page's grid (f32, fill 0): "dewarp_f32" there (one launch, the
        # grid upsampled in the kernel; the stage's kernel), and "remap"
        # (remap_pallas' function through the dense map, the stage's
        # kernel before dewarp_f32, now remap_pallas' parity entry) on
        # the same map; the page's own pixels through the map are a
        # second case of remap ("remap_page"), at both borders
        sep = separator_mask(png, device, h, w)
        taps = tapped_pixels(mx.clamp(-2.0, w + 1.0), my.clamp(-2.0, h + 1.0),
                             torch.ones_like(mx, dtype=torch.bool), h, w)
        got = ops.dewarp_f32(sep, hv, res, 0.0)
        want = ops.dewarp_f32_plain(sep, hv, res, 0.0)
        torch.cuda.synchronize()
        report("dewarp_f32", got, want, F32_TOL,
               lambda: ops.dewarp_f32(sep, hv, res, 0.0),
               lambda: ops.dewarp_f32_plain(sep, hv, res, 0.0),
               taps * 4 + hv.numel() * 4 + got.numel() * 4,
               lambda: F.grid_sample(sep[None, None], grid, mode="bilinear",
                                     padding_mode="zeros",
                                     align_corners=True),
               "fill_taps %dx%d -> %dx%d" % (h, w, *got.shape))
        map_xy = torch.stack([mx, my], dim=-1).contiguous()
        for name, img, border in (
                ("remap", sep, "fill_taps"),
                ("remap_page", px.float().contiguous(), "fill_taps"),
                ("remap_page_hard", px.float().contiguous(), "hard")):
            got = ops.remap(img, map_xy, 0.0, border)
            want = ops.remap_plain(img, map_xy, 0.0, border)
            torch.cuda.synchronize()
            report(name, got, want, F32_TOL,
                   lambda: ops.remap(img, map_xy, 0.0, border),
                   lambda: ops.remap_plain(img, map_xy, 0.0, border),
                   taps * 4 + map_xy.numel() * 4 + got.numel() * 4,
                   lambda: F.grid_sample(img[None, None], grid,
                                         mode="bilinear",
                                         padding_mode="zeros",
                                         align_corners=True),
                   "%s %dx%d -> %dx%d" % (border, h, w, *map_xy.shape[:2]))
        if i == 0:
            failures += check_remap_cases(device, px, map_xy)

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
            ops._launch(h_xy.device, ops.kernels.origami_grid_scan_h,
                        ops._ptr(h_xy), ops._ptr(h_phi), ops._ptr(h_mask),
                        n_h, n_gy, cols, 25.0, -50.0, ops._ptr(dst))

        def run_v(rows_=n_gy):
            ops._launch(grid_h.device, ops.kernels.origami_grid_scan_v,
                        ops._ptr(grid_h), ops._ptr(v_xy), ops._ptr(v_phi),
                        ops._ptr(v_mask), n_v, rows_, n_gx, 25.0,
                        ops._ptr(out), None)

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
    (ops/remap.py `_launch`, `_ptr`: the entry point bound once, the raw
    current stream, the pointer as an int) against the earliest one (the
    entry point looked up by name in the library, a torch.cuda.Stream
    object and a ctypes.c_void_p per pointer, re-created here), in turns
    earlier, current, current, earlier. The wrappers of the f32 sampler
    (remap, remap_batch, affine_warp, dewarp_f32) at phase 2's shapes
    beside dewarp_u8, sauvola_packed, the gather and the grid scans."""
    import ctypes
    import torch
    from origami_tpu_torch.core import _png, dewarp
    from origami_tpu_torch.core.math import rotation_matrix
    from origami_tpu_torch.ops import _build, binarize, gather, grid
    from origami_tpu_torch.ops import remap as ops
    mods = (ops, gather, grid, binarize)
    current = {m: (m._launch, m._ptr) for m in mods}

    def earlier_launch(dev, fn, *args):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(_build.library(), fn.__name__)(*args, stream)
        if rc != 0:
            raise RuntimeError("%s: CUDA error %d at launch"
                               % (fn.__name__, rc))

    class VoidP(ctypes.c_void_p):
        """A pointer argument that takes an offset in bytes (the y plane
        of an interleaved map)."""

        def __add__(self, k):
            return VoidP(self.value + k)

    def earlier_ptr(t):
        return VoidP(t.data_ptr())

    png = sorted(FIXTURE.glob("*.png"))[0]
    px = torch.from_numpy(_png.read_gray(png)).to(device)
    hv = torch.from_numpy(dewarp.Grid.open(
        FIXTURE / (png.stem + ".out") / "dewarp.zip").points(
            "sample")).to(device)
    src = torch.rand((64, 63), device=device)
    idx = torch.zeros((64, 1), dtype=torch.int32, device=device)
    padded, shape = page_grid_inputs(png, device)
    f = px.float()
    mx, my = ops._upsample_grid(hv, 25)
    map_xy = torch.stack([mx, my], -1).contiguous()
    planes = (mx[None].contiguous(), my[None].contiguous())
    h, w = px.shape
    rot = rotation_matrix(0.02, (w / 2, h / 2))
    calls = {
        "remap": (lambda: ops.remap(f, map_xy), 200),
        "remap_batch": (lambda: ops.remap_batch(f[None], planes), 200),
        "affine_warp": (lambda: ops.affine_warp(f, rot, (h, w), 255.0),
                        200),
        "dewarp_f32": (lambda: ops.dewarp_f32(f, hv, 25), 200),
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
    args = BINARIZE_MODE if mode == "binarize" else MODES[mode]
    cmd = [sys.executable, "-m", "origami_tpu_torch.batch.detect.ocr",
           *args, "--lock-strategy", "NONE", "--plain",
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
    module = "origami_tpu_torch.batch." + (
        stage if stage.startswith("export.") else "detect." + stage)
    cmd = [sys.executable, "-m", module,
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
                device_events=device_events(prof) / n_pages,
                profile=prof.key_averages().table(
                    sort_by="self_cuda_time_total", row_limit=12))


def device_events(prof):
    """How many kernels and copies ran on the card in a profiled run."""
    import torch
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


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
            "time, device busy %.2f %%, %.1f device events a page" % (
                stage, r["prof_wall_s"], r["device_ms"],
                100.0 * r["device_ms"] / 1e3 / r["prof_wall_s"],
                r["device_events"]))
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


def compare_chain_text(corpus, name, failed, min_identical, max_cer,
                       min_lines=0, ref_dir=COMPOSE_REF, pattern="*.png"):
    """Hold each page's composed text against the JAX chain's
    (tests/data/torch_compose, or `ref_dir`'s): at least `min_identical`
    of its lines and `min_lines` lines identical, CER <= `max_cer`;
    -> (share of lines identical, CER)."""
    same = n = errs = chars = 0
    for png in sorted(corpus.glob(pattern)):
        got = page_text(corpus / (png.stem + ".out") / "compose.zip")
        ref = page_text(ref_dir / (png.stem + ".out") / "compose.zip")
        s, k, e, c = text_diff(got, ref)
        same, n, errs, chars = same + s, n + k, errs + e, chars + c
    share, cer = same / max(n, 1), errs / max(chars, 1)
    ok = share >= min_identical and cer <= max_cer and same >= min_lines
    log("  %s: page.txt %d of %d lines identical to the JAX chain's "
        "(%.4f), CER %.5f  %s" % (name, same, n, share, cer,
                                  "ok" if ok else "FAIL"))
    if not ok:
        failed.append("%s: page.txt identical %d, %.4f (bars %d, %.2f), "
                      "CER %.5f (bar %.3f)" % (name, same, share, min_lines,
                                               min_identical, cer, max_cer))
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
                       MAX_CER, CHAIN_MIN_IDENTICAL_LINES)
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
        WHOLE_CHAIN_WALL[mode] = wall
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


# ---------------------------------------------------------------- phase 13

REAL_SCAN = ROOT / "tests" / "data" / "real_scan_1872.png"
# the real 1872 scan under -m auto: (tests/test_pretrained.py:104-127):
# the students keep the page, the sanitization clears the TABULAR that
# they hallucinate over its text columns
REAL_SCAN_MAX_TABULAR = 0.01
REAL_SCAN_MIN_TEXT = 0.5


def _sync(device):
    import torch
    if str(device) != "cpu":
        torch.cuda.synchronize()


def check_binarize_ocr(workdir, device, failed):
    """Phase 13 (a): the OCR CLI with --binarize sauvola on the fixture,
    single model, against the JAX stage's --binarize ocr.zip; every strip
    comes to the host and takes one Sauvola launch, a page's strips one
    strips_dewarped launch. Then the stage in process, warm: pages/s and
    the share of its time spent in the per-strip Sauvola round trips."""
    from origami_tpu_torch.batch.detect.ocr import OCRProcessor
    from origami_tpu_torch.core import binarize as core_binarize
    r = run_ocr_cli("binarize", workdir, device)
    got, n = r["launches"], r["pages"]
    # on the CPU the plain versions run: no launch to count
    want = {} if str(device) == "cpu" else {"sauvola": r["lines"],
                                            "strips_dewarped": n}
    bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    if got["strips_through_grid"] > n:
        bad["strips_through_grid"] = (got["strips_through_grid"], n)
    ok = r["identical"] >= MIN_IDENTICAL and r["cer"] <= MAX_CER
    log("  ocr --binarize sauvola %d pages %d lines: identical %.4f  CER "
        "%.5f  launches %s  %s" % (
            n, r["lines"], r["identical"], r["cer"],
            json.dumps({k: v for k, v in got.items() if v}),
            "ok" if ok and not bad else "FAIL"))
    if not ok:
        failed.append("ocr --binarize: identical %.4f or CER %.5f"
                      % (r["identical"], r["cer"]))
    if bad:
        failed.append("ocr --binarize: launches (got, expected) %s" % bad)
    if str(device) == "cpu":
        return
    # in process, warm: time the binarizer's calls (each a page-strip
    # upload, one Sauvola launch and the mask's copy back)
    real = core_binarize.from_string
    spent = [0.0, 0]

    def timed_from_string(spec, dev=None):
        fn = real(spec, dev)

        def run(strip):
            t0 = time.perf_counter()
            out = fn(strip)
            spent[0] += time.perf_counter() - t0
            spent[1] += 1
            return out
        return run

    opts = dict(model=str(ROOT / "models_pretrained" / "recognizer"),
                binarize="sauvola", lock_strategy="NONE", plain=True,
                device=str(device))
    proc = OCRProcessor(opts)
    times = []
    core_binarize.from_string = timed_from_string
    try:
        for rep in range(3):
            corpus = workdir / ("binarize_warm_%d" % rep)
            shutil.copytree(FIXTURE, corpus,
                            ignore=shutil.ignore_patterns("ref"))
            spent[:] = [0.0, 0]
            _sync(device)
            t0 = time.perf_counter()
            proc.traverse(str(corpus))
            _sync(device)
            times.append((time.perf_counter() - t0, spent[0], spent[1]))
    finally:
        core_binarize.from_string = real
    wall, sauv, calls = sorted(times[1:])[0]
    log("  ocr --binarize sauvola in process, warm (best of 2 after one "
        "warm-up): %.3f s for %d pages, %.3f pages/s; %d per-strip "
        "Sauvola round trips took %.3f s, %.1f %% of the pass (%s)" % (
            wall, n, n / wall, calls, sauv, 100.0 * sauv / wall,
            smi_line()))


def check_auto_segment(workdir, device, failed):
    """Phase 13 (b): the segment CLI with -m auto:<students> on the real
    1872 scan (mode "trained", TABULAR and TEXT within the bounds of
    tests/test_pretrained.py) and on the fixture pages (the JAX auto
    mode's modes, label maps at the bf16 bar against
    tests/data/torch_segment/ref/*.auto.segment.zip); then one fixture
    page whose trained maps are replaced by maps without text, which
    must fall back to the heuristic maps with one `sauvola` launch."""
    import numpy as np
    from origami_tpu_torch.core import _png
    from origami_tpu_torch.core.predict import (
        AutoSegmentationPredictor, HeuristicSegmentationPredictor)
    from origami_tpu_torch.core.segment import Prediction, Segmentation
    modes = json.loads((SEG_REF / "auto_modes.json").read_text())
    corpus = copy_pages(workdir / "seg_auto")
    shutil.copy(REAL_SCAN, corpus / REAL_SCAN.name)
    reset_launches()
    # one page a batch, as the references were made: a batch pads its
    # pages to one canvas, which a page of another size would change
    launches, wall, stage_s = run_stage_cli(
        "segment", corpus, device,
        ["-m", "auto:" + str(ROOT / STUDENTS), "-b", "1"])
    for png in sorted(corpus.glob("*.png")):
        out = corpus / (png.stem + ".out")
        entry = json.loads((out / "runtime.json").read_text()).get(
            SEG_STAGE, {})
        if entry.get("status") != "COMPLETED":
            failed.append("segment auto on %s: %s" % (
                png.name, entry.get("traceback", entry)))
            continue
        mode = entry.get("segmentation_mode")
        seg = Segmentation.open(out / "segment.zip")
        reg = seg.by_name("regions")
        if png.stem == REAL_SCAN.stem:
            frac = {k: float(reg.class_mask(k).mean())
                    for k in ("TEXT", "TABULAR")}
            ok = mode == "trained" \
                and frac["TABULAR"] <= REAL_SCAN_MAX_TABULAR \
                and frac["TEXT"] >= REAL_SCAN_MIN_TEXT
            log("  segment auto %s: mode %s, TEXT %.4f, TABULAR %.4f  %s"
                % (png.stem, mode, frac["TEXT"], frac["TABULAR"],
                   "ok" if ok else "FAIL"))
            if not ok:
                failed.append("segment auto %s: mode %s, %s" % (
                    png.stem, mode, frac))
            continue
        ref = Segmentation.open(SEG_REF / (png.stem + ".auto.segment.zip"))
        equal = {k: float((seg.by_name(k).labels == ref.by_name(k).labels)
                          .mean()) for k in ("regions", "separators")}
        want = modes[png.stem]["bf16"]
        ok = mode == want and min(equal.values()) >= \
            SEG_MODES["students_bf16"][2]
        log("  segment auto %s: mode %s (JAX %s), equal pixels %s  %s" % (
            png.stem, mode, want, json.dumps(equal),
            "ok" if ok else "FAIL"))
        if not ok:
            failed.append("segment auto %s: mode %s (JAX %s), equal %s"
                          % (png.stem, mode, want, equal))
    log("  segment auto: 3 pages, stage %.2f s, launches %s" % (
        stage_s, json.dumps({k: v for k, v in launches.items() if v})))

    class NoText:
        def predict_batch(self, pages):
            return [Segmentation([
                Prediction("REGION", "regions",
                           np.full((64, 48), 3, np.uint8), REGION_CLASSES),
                Prediction("SEPARATOR", "separators",
                           np.full((64, 48), 3, np.uint8), SEP_CLASSES)])
                for _ in pages]

    from origami_tpu_torch.ops.binarize import launches as sauvola_counts
    png = sorted(FIXTURE.glob("*.png"))[-1]
    auto = AutoSegmentationPredictor(
        trained=NoText(), heuristic=HeuristicSegmentationPredictor(
            device=device), device=device)
    reset_launches()
    seg = auto.predict_batch([_png.read_gray(png)])[0]
    _sync(device)
    n_sauvola = sauvola_counts["sauvola"]
    ref = Segmentation.open(SEG_REF / (png.stem + ".heuristic.segment.zip"))
    equal = {k: float((seg.by_name(k).labels == ref.by_name(k).labels)
                      .mean()) for k in ("regions", "separators")}
    # on the CPU the plain version runs: no launch
    ok = auto.last_modes == ["heuristic"] \
        and n_sauvola == (0 if str(device) == "cpu" else 1) \
        and min(equal.values()) >= SEG_MODES["heuristic"][2]
    log("  auto with a trained map without text, %s: mode %s, sauvola "
        "launches %d, equal pixels to the JAX heuristic maps %s  %s" % (
            png.stem, auto.last_modes, n_sauvola, json.dumps(equal),
            "ok" if ok else "FAIL"))
    if not ok:
        failed.append("auto fallback on %s: modes %s, sauvola %d, equal %s"
                      % (png.stem, auto.last_modes, n_sauvola, equal))


def check_page_pipeline(workdir, device, failed):
    """Phase 13 (c): PagePipeline with the students and the recognizer
    over the fixture's two page images, sequential and overlapped: every
    page composed, page.txt within PORT_CHAIN_MAX_CER of the JAX chain's;
    each run's wall time and launches."""
    from origami_tpu_torch.core import _png
    from origami_tpu_torch.pipeline import PagePipeline
    pages = sorted(FIXTURE.glob("*.png"))
    images = [_png.read_gray(p) for p in pages]
    names = [p.stem for p in pages]
    pipe = PagePipeline(
        segmentation_model=str(ROOT / STUDENTS),
        ocr_model=str(ROOT / "models_pretrained" / "recognizer"),
        page_xml=True, device=str(device))
    for overlap in (False, True):
        reset_launches()
        _sync(device)
        t0 = time.perf_counter()
        results = pipe.process_batch(images, names=names, overlap=overlap)
        _sync(device)
        wall = time.perf_counter() - t0
        from origami_tpu_torch.batch.detect.flow import kernel_launches
        same = n = errs = chars = 0
        for name, res in zip(names, results):
            if not res.text or not res.page_xml:
                failed.append("PagePipeline (overlap %s): %s not composed"
                              % (overlap, name))
                continue
            ref = page_text(COMPOSE_REF / (name + ".out") / "compose.zip")
            s, k, e, c = text_diff(res.text, ref)
            same, n, errs, chars = same + s, n + k, errs + e, chars + c
        cer = errs / max(chars, 1)
        ok = cer <= PORT_CHAIN_MAX_CER and n > 0
        log("  PagePipeline (students, recognizer, overlap %s) %d pages: "
            "%.2f s wall, page.txt %d of %d lines identical to the JAX "
            "chain's, CER %.5f  launches %s  %s" % (
                overlap, len(pages), wall, same, n, cer,
                json.dumps({k: v for k, v in kernel_launches().items()
                            if v}), "ok" if ok else "FAIL"))
        if not ok:
            failed.append("PagePipeline (overlap %s): CER %.5f" % (overlap,
                                                                   cer))


def check_exports(workdir, device, failed):
    """Phase 13 (d): export.lines on the fixture corpus (one PNG per OCR
    line, each equal to the OCR path's strip for that line; with
    --binarize sauvola to its binarized strip) and export.pagexml (the
    XML parses, one TextLine per line of lines.0.zip)."""
    import xml.etree.ElementTree as ET

    import numpy as np
    from origami_tpu_torch.batch.core.io import Artifact, Input, Stage
    from origami_tpu_torch.batch.core.lines import LineExtractor
    from origami_tpu_torch.core import _png
    for binarize in ("", "sauvola"):
        corpus = workdir / ("export_lines_%s" % (binarize or "gray"))
        shutil.copytree(FIXTURE, corpus, ignore=shutil.ignore_patterns("ref"))
        out = workdir / ("export_lines_out_%s" % (binarize or "gray"))
        reset_launches()
        run_stage_cli("export.lines", corpus, device,
                      ["-o", str(out)] + (["--binarize", binarize]
                                          if binarize else []))
        bad = []
        n_png = 0
        for png in sorted(corpus.glob("*.png")):
            reader = Input(Artifact.LINES, Artifact.TABLES,
                           stage=Stage.RELIABLE).instantiate(
                png, device=device)
            ext = LineExtractor(reader.tables, 48, dict(
                binarize=binarize, device=str(device)),
                min_confidence=reader.lines.min_confidence)
            strips = dict(ext(reader.lines.by_path))
            ocr = read_zip(FIXTURE / "ref" / (png.stem + ".single.ocr.zip"))
            files = sorted((out / png.stem / "dw1-ds1-h48").glob("*.png"))
            n_png += len(files)
            if len(files) != len(ocr):
                bad.append("%s: %d PNGs for %d OCR lines" % (
                    png.stem, len(files), len(ocr)))
            for path, strip in strips.items():
                f = out / png.stem / "dw1-ds1-h48" / (
                    "-".join(map(str, path)).replace("/", "-") + ".png")
                if not f.exists() or not np.array_equal(
                        _png.read_gray(f), strip):
                    bad.append("%s: %s" % (png.stem, f.name))
        log("  export.lines%s: %d PNGs, each the OCR path's strip  %s" % (
            " --binarize " + binarize if binarize else "", n_png,
            "ok" if not bad else "FAIL %s" % bad[:5]))
        if bad:
            failed.append("export.lines %s: %s" % (binarize, bad[:5]))
    corpus = flow_corpus(workdir / "export_pagexml")
    for png in sorted(corpus.glob("*.png")):
        shutil.copy(FLOW_REF / (png.stem + ".out") / "lines.0.zip",
                    corpus / (png.stem + ".out"))
    out = workdir / "export_pagexml_out"
    run_stage_cli("export.pagexml", corpus, device, ["-o", str(out)])
    for png in sorted(corpus.glob("*.png")):
        root = ET.parse(out / (png.stem + ".xml")).getroot()
        n_lines = sum(1 for e in root.iter() if e.tag.endswith("TextLine"))
        want = sum(1 for k in read_zip(corpus / (png.stem + ".out")
                                       / "lines.0.zip")
                   if k.endswith(".json") and k != "meta.json")
        ok = n_lines == want
        log("  export.pagexml %s: %d TextLine elements for %d lines  %s"
            % (png.stem, n_lines, want, "ok" if ok else "FAIL"))
        if not ok:
            failed.append("export.pagexml %s: %d TextLines, %d lines"
                          % (png.stem, n_lines, want))


def check_inference_surface(workdir, device="cuda"):
    """Phase 13: the rest of the inference surface, (a) to (d)."""
    failed = []
    for check in (check_binarize_ocr, check_auto_segment,
                  check_page_pipeline, check_exports):
        t0 = time.time()
        check(workdir, device, failed)
        log("  (%s: %.1f s)" % (check.__name__, time.time() - t0))
    if failed:
        raise PhaseError("; ".join(failed))


# ---------------------------------------------------------------- phase 14

TRAIN_REF = ROOT / "tests" / "data" / "torch_train"
# the training corpus: the fixture pages and the two real scans, each
# with the JAX f32 auto label maps of tests/data/torch_segment/ref as
# <page>.labels.{region,separator}.png (their class indices are
# bootstrap.KIND_CLASSES')
TRAIN_PAGES = (FIXTURE / "synth0000.png", FIXTURE / "synth0001.png",
               ROOT / "tests" / "data" / "real_scan_1872.png",
               ROOT / "tests" / "data" / "real_scan_bbz_1925.png")
TRAIN_FULL = (1280, 2432)            # the students' canvas (W, H)
TRAIN_CLASSES = {"region": ["TEXT", "TABULAR", "ILLUSTRATION",
                            "BACKGROUND"],
                 "separator": ["H", "V", "T", "BACKGROUND"]}
# phase 14b: the JAX trainers' numbers (scripts/make_torch_train_fixture
# .py) against the port's, float32, TF32 off, warp off. U-Nets take one
# page a step (the corpus' pages in name order: real_scan_1872,
# real_scan_bbz_1925, synth0000, synth0001); the recognizer 8 of its 16
# strips (the first 8 TEXT lines of each fixture page, as the OCR path
# extracts them, labelled with the JAX single-mode ocr.zip text)
PARITY_RUNS = {
    "segment_region": dict(trainer="segment", kind="region",
                           start="models_pretrained/students/region/00",
                           band=None, learning_rate=3e-4),
    "segment_separator": dict(trainer="segment", kind="separator",
                              start="models_pretrained/students/"
                                    "separator/00",
                              band=(3, 2, 0.15), learning_rate=3e-4),
    "distill_region": dict(trainer="distill", kind="region",
                           start="models_pretrained/students/region/00",
                           learning_rate=2e-4),
    "recognizer": dict(trainer="recognizer",
                       start="models_pretrained/recognizer",
                       learning_rate=1e-3),
}
PARITY_STEPS, PARITY_WARMUP = 20, 10         # the schedule's length
PARITY_PAGES = ([2], [0], [3])
PARITY_STRIPS = (list(range(8)), list(range(8, 16)), list(range(4, 12)))
# the distiller's student: the teacher's weights plus noise, leaf by leaf
# in sorted path order, N(0, 1) from numpy's default_rng(seed) times
# scale times the leaf's standard deviation
PARITY_NOISE = dict(seed=11, scale=0.05)
# the bars: the first loss (the same weights, one forward) within
# PARITY_FIRST; later losses and every leaf's L2 norm after every step
# within PARITY_LATER (cuDNN's and XLA's float32 convolutions sum in other
# orders, and Adam's first steps magnify a gradient's last bits)
PARITY_FIRST = 1e-5
PARITY_LATER = 1e-3
# the recognizer's first loss: JAX's float32 CTC of these strips is
# 1.9e-4 relative off the float64 loss of the same logits (the port's
# 5.9e-5, on the CPU; ROADMAP C12), so PARITY_FIRST cannot hold
# against it; it is held to PARITY_LATER
PARITY_FIRST_CTC = PARITY_LATER
# phase 14a/c: the warp's amplitude, the f32 remap bar
WARP_AMPLITUDE = 10.0
REMAP_F32_ERR = 1e-4
# phase 14c: the main path's sizes (bootstrap's defaults where not cut)
MAIN_SEG = dict(kind="region", members=2, steps=20, width=2.0, s2d=4,
                full_size=TRAIN_FULL, batch=2, warp_amplitude=WARP_AMPLITUDE)
MAIN_DISTILL_STEPS = 10
MAIN_OCR = dict(steps=20, batch=64, height=48,
                conv_features=(64, 128, 256), lstm_features=256)
# phase 14d: the host stages run with --processes 2
POOL_STAGES = ("contours", "flow", "dewarp", "layout", "lines")
# the stalled pool's --alive: the watchdog names a page stuck once it has
# run for half of it; a worker's spawn (10-14 s on the card) does not
# count, as --alive runs from each worker's first chunk
POOL_ALIVE = 24


def train_corpus(dst):
    """The training corpus in `dst`: TRAIN_PAGES and their label PNGs."""
    dst.mkdir(parents=True)
    for png in TRAIN_PAGES:
        shutil.copy(png, dst / png.name)
        with zipfile.ZipFile(SEG_REF / (png.stem + ".auto.f32.segment.zip")) \
                as zf:
            for kind, name in (("region", "regions"),
                               ("separator", "separators")):
                classes = json.loads(zf.read(name + ".json"))["classes"]
                want = {c: i for i, c in enumerate(TRAIN_CLASSES[kind])}
                if classes != want:
                    raise PhaseError("%s %s: classes %s, expected %s"
                                     % (png.name, name, classes, want))
                (dst / ("%s.labels.%s.png" % (png.stem, kind))).write_bytes(
                    zf.read(name + ".png"))
    return dst


def flat_leaves(tree, prefix=""):
    """[(path, leaf)] of a nested dict, keys sorted at every level."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = prefix + "/" + k if prefix else k
        out += flat_leaves(v, path) if isinstance(v, dict) else [(path, v)]
    return out


def leaf_norms(tree):
    """{path: L2 norm in float64} of a flax param tree."""
    import numpy as np
    return {p: float(np.linalg.norm(np.asarray(v, np.float64)))
            for p, v in flat_leaves(tree)}


def noisy_tree(tree, seed=PARITY_NOISE["seed"],
               scale=PARITY_NOISE["scale"]):
    """PARITY_NOISE's student: a copy of `tree` (numpy float32 leaves)
    with noise added leaf by leaf in sorted path order."""
    import numpy as np
    rng = np.random.default_rng(seed)
    noisy = {}
    for path, v in flat_leaves(tree):
        v = np.asarray(v, np.float32)
        n = rng.standard_normal(v.shape) * (scale * float(v.std()))
        node = noisy
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = (v + n).astype(np.float32)
    return noisy


def ocr_strips(device):
    """Every OCR line of the fixture pages as the OCR path extracts it:
    [(page stem, line key, strip u8 (48, w), the JAX single-mode text)]
    in page and key order."""
    from origami_tpu_torch.batch.core.io import Artifact, Input, Stage
    from origami_tpu_torch.batch.core.lines import LineExtractor
    out = []
    for png in sorted(FIXTURE.glob("*.png")):
        reader = Input(Artifact.LINES, Artifact.TABLES,
                       stage=Stage.RELIABLE).instantiate(png, _Proc(device))
        ext = LineExtractor(reader.tables, 48, {"device": str(device)},
                            min_confidence=reader.lines.min_confidence)
        text = read_zip(FIXTURE / "ref" / (png.stem + ".single.ocr.zip"))
        strips = {"/".join(map(str, p)): s
                  for p, s in ext(reader.lines.by_path)}
        for key in sorted(strips):
            out.append((png.stem, key, strips[key], text[key + ".txt"]))
    return out


def parity_pool(device, charset):
    """The recognizer parity run's 16 strips in one width bucket:
    (bucket, (strips u8 (16, 48, bucket), widths, labels, label_pad),
    [(page, key)])."""
    import numpy as np
    from origami_tpu_torch.models.recognizer import width_buckets
    from origami_tpu_torch.train.ocr.train import encode_labels
    rows = []
    for stem in ("synth0000", "synth0001"):
        rows += [r for r in ocr_strips(device)
                 if r[0] == stem and r[1].startswith("regions/TEXT/")][:8]
    bucket = width_buckets([max(r[2].shape[1] for r in rows)])[0]
    x = np.full((len(rows), 48, bucket), 255, np.uint8)
    widths = np.zeros((len(rows),), np.float32)
    for i, (_, _, s, _) in enumerate(rows):
        w = min(s.shape[1], bucket)
        x[i, :, :w] = s[:, :w]
        widths[i] = w
    labels, pad = encode_labels([r[3] for r in rows], charset,
                                max_len=max(len(r[3]) for r in rows) + 1)
    return bucket, (x, widths, labels, pad), [(r[0], r[1]) for r in rows]


def port_parity_run(name, corpus, device, mesh=None):
    """One PARITY_RUNS entry through the port's trainer, float32, on
    `mesh` (parallel.mesh.make_mesh; None: the one device): ->
    (losses, [leaf norms after each step])."""
    import numpy as np
    import torch
    from origami_tpu_torch.models import registry
    from origami_tpu_torch.parallel.mesh import make_mesh
    from origami_tpu_torch.train import bootstrap
    from origami_tpu_torch.train.segment.data import class_weights
    run = PARITY_RUNS[name]
    mesh = mesh or make_mesh([device])
    tree, meta = registry.load_params(ROOT / run["start"])
    losses, norms = [], []
    if run["trainer"] == "recognizer":
        from origami_tpu_torch.train.ocr.train import (OCRTrainConfig,
                                                       RecognizerTrainer)
        cfg = OCRTrainConfig(
            num_symbols=len(meta["charset"]), height=meta["height"],
            learning_rate=run["learning_rate"], steps=PARITY_STEPS,
            warmup=PARITY_STEPS, conv_features=tuple(meta["conv_features"]),
            lstm_features=meta["lstm_features"])
        tr = RecognizerTrainer(cfg, mesh=mesh, dtype=torch.float32)
        tr.load_state_dict(registry.params_from_flax(tree))
        bucket, pool, _ = parity_pool(device, meta["charset"])
        tr.attach_pool({bucket: pool})
        for idx in PARITY_STRIPS:
            losses.append(float(tr.train_on_bucket(bucket, idx)))
            norms.append(leaf_norms(registry.flax_params(
                tr.model, tr.state_dict())))
        return losses, norms
    images, labels, _ = bootstrap.load_corpus_arrays(corpus, run["kind"],
                                                     TRAIN_FULL)
    if run["trainer"] == "segment":
        from origami_tpu_torch.train.segment.train import (
            SegmentationTrainer, TrainConfig)
        cfg = TrainConfig(
            num_classes=4, width=meta["width"], s2d=meta["s2d"],
            tile_hw=(TRAIN_FULL[1], TRAIN_FULL[0]),
            learning_rate=run["learning_rate"], steps=PARITY_STEPS,
            warmup=PARITY_WARMUP,
            class_weights=class_weights(list(labels), 4),
            band_dontcare=run["band"])
        tr = SegmentationTrainer(cfg, mesh=mesh, dtype=torch.float32)
        tr.load_state_dict(registry.unet_params_from_flax(tree, meta))
        tr.attach_dataset(images, labels)
        model, step = tr.model, tr.train_on_indices
    else:
        from origami_tpu_torch.train.segment.distill import (DistillConfig,
                                                             Distiller)
        teacher = registry.build_unet(meta, dtype=torch.float32)
        teacher.load_state_dict(registry.unet_params_from_flax(tree, meta))
        cfg = DistillConfig(
            num_classes=4, width=meta["width"], s2d=meta["s2d"],
            tile_hw=(TRAIN_FULL[1], TRAIN_FULL[0]),
            learning_rate=run["learning_rate"], steps=PARITY_STEPS,
            warmup=PARITY_WARMUP)
        tr = Distiller(cfg, [teacher], mesh=mesh, dtype=torch.float32)
        tr.load_state_dict(registry.unet_params_from_flax(
            noisy_tree(tree), meta))
        tr.attach_dataset(images, labels)
        model, step = tr.student, tr.distill_on_indices
    for idx in PARITY_PAGES:
        losses.append(float(step(np.asarray(idx))))
        norms.append(leaf_norms(registry.flax_params(model,
                                                     tr.state_dict())))
    return losses, norms


def parity_verdict(name, losses, norms, t0, label="parity"):
    """Hold a PARITY_RUNS entry's port numbers against the JAX trainer's
    in TRAIN_REF: the first loss within PARITY_FIRST (the recognizer's
    PARITY_FIRST_CTC), the later losses and every leaf's norm after every
    step within PARITY_LATER, relative; log the line. -> the failure, or
    None."""
    ref = json.loads((TRAIN_REF / (name + ".json")).read_text())
    loss_err = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    norm_err = 0.0
    worst = None
    for got, want in zip(norms, ref["leaf_norms"]):
        if set(got) != set(want):
            return "%s: leaves %s" % (name, sorted(set(got)
                                                   ^ set(want))[:5])
        for k, w in want.items():
            e = abs(got[k] - w) / max(abs(w), 1e-30)
            if e > norm_err:
                norm_err, worst = e, k
    first = PARITY_FIRST_CTC \
        if PARITY_RUNS[name]["trainer"] == "recognizer" else PARITY_FIRST
    ok = loss_err[0] <= first and max(loss_err) <= PARITY_LATER \
        and norm_err <= PARITY_LATER
    log("  %s %-18s losses %s (JAX %s): relative %s; leaf norms "
        "worst %.2e (%s); %.1f s  %s" % (
            label, name, ["%.6f" % v for v in losses],
            ["%.6f" % v for v in ref["losses"]],
            ["%.1e" % e for e in loss_err], norm_err, worst,
            time.time() - t0, "ok" if ok else "FAIL"))
    if not ok:
        return "%s %s: loss errors %s (first <= %g, later <= %g), leaf " \
               "norm %.2e at %s" % (label, name, loss_err, first,
                                    PARITY_LATER, norm_err, worst)
    return None


def check_train_parity(workdir, device="cuda"):
    """Phase 14b: each PARITY_RUNS entry against the JAX trainer's numbers
    in TRAIN_REF (3 steps), at parity_verdict's bars."""
    corpus = train_corpus(workdir / "train_parity")
    failed = []
    for name in PARITY_RUNS:
        t0 = time.time()
        losses, norms = port_parity_run(name, corpus, device)
        err = parity_verdict(name, losses, norms, t0)
        if err:
            failed.append(err)
    if failed:
        raise PhaseError("; ".join(failed))


def warp_inputs(images_u8, device, seed=5):
    """Two pages as f32 on the card and one warp field each at
    WARP_AMPLITUDE, as the training step draws them: (images (2, H, W),
    map_x, map_y)."""
    import torch
    from origami_tpu_torch.train.segment.warp import (displacement_field,
                                                      random_coarse)
    imgs = torch.from_numpy(images_u8[:2]).to(device).float()
    gen = torch.Generator().manual_seed(seed)
    coarse = random_coarse(gen, 2, WARP_AMPLITUDE).to(device)
    fields = displacement_field(coarse, imgs.shape[1:])
    h, w = imgs.shape[1:]
    ys = torch.arange(h, dtype=torch.float32, device=device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, None, :]
    return imgs, (xs + fields[..., 0]).contiguous(), \
        (ys + fields[..., 1]).contiguous()


def check_train_warp(workdir, device="cuda"):
    """Phase 14a: remap_batch on B = 2 pages of 2432 x 1280 f32 under a
    field of amplitude WARP_AMPLITUDE, both borders, against its plain
    version (REMAP_F32_ERR), one launch a call; its time (events and
    device), the plain version's, the bound (every input and output byte
    once at HBM_BYTES_PER_S) and F.grid_sample on the same map. -> the
    kernels-line row."""
    import torch
    import torch.nn.functional as F
    from origami_tpu_torch.ops import remap
    from origami_tpu_torch.train import bootstrap
    images, _, _ = bootstrap.load_corpus_arrays(
        train_corpus(workdir / "train_warp"), "region", TRAIN_FULL)
    imgs, mx, my = warp_inputs(images, device)
    err = 0.0
    for border in ("hard", "fill_taps"):
        before = remap.launches["remap_batch"]
        got = remap.remap_batch(imgs, (mx, my), 255.0, border)
        torch.cuda.synchronize()
        n = remap.launches["remap_batch"] - before
        want = remap.remap_batch_plain(imgs, mx, my, 255.0, border)
        e = float((got - want).abs().max())
        err = max(err, e)
        ok = e <= REMAP_F32_ERR and n == 1
        log("  remap_batch %-9s 2 x 2432 x 1280 f32: max abs %.3g (bar "
            "%g), %d launch  %s" % (border, e, REMAP_F32_ERR, n,
                                    "ok" if ok else "FAIL"))
        if not ok:
            raise PhaseError("remap_batch %s: max abs %g, %d launches"
                             % (border, e, n))

    def kernel():
        return remap.remap_batch(imgs, (mx, my), 255.0, "hard")

    h, w = imgs.shape[1:]
    grid = torch.stack([mx * (2.0 / (w - 1)) - 1.0,
                        my * (2.0 / (h - 1)) - 1.0], -1)

    def library():
        return F.grid_sample(imgs[:, None], grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)

    ms, dev = time_cuda(kernel), device_ms(kernel)
    plain = time_cuda(lambda: remap.remap_batch_plain(imgs, mx, my, 255.0,
                                                      "hard"), reps=5)
    lib, lib_dev = time_cuda(library), device_ms(library)
    nbytes = 4 * (imgs.numel() + mx.numel() + my.numel() + imgs.numel())
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log("  remap_batch (hard) events %s, device %s; plain %s; bound %s "
        "(%d bytes); F.grid_sample events %s, device %s" % (
            fmt_ms(ms), fmt_ms(dev), fmt_ms(plain), fmt_ms(bound), nbytes,
            fmt_ms(lib), fmt_ms(lib_dev)))
    return {"remap_batch": dict(err=err, ms=ms, plain_ms=plain,
                                bound_ms=bound, bound_by="bytes",
                                library_ms=lib)}


def _trend_ok(losses):
    """Every loss finite, and (20-step runs) the mean of steps 15-19
    below the mean of steps 1-5 (step 0 runs at learning rate 0)."""
    import math
    if not all(math.isfinite(v) for v in losses):
        return False
    if len(losses) < 20:
        return True
    return statistics.mean(losses[15:20]) < statistics.mean(losses[1:6])


def check_train_main_path(workdir, device="cuda"):
    """Phase 14c: bootstrap.train_segmentation (MAIN_SEG, bf16, warp on),
    distill_students (MAIN_DISTILL_STEPS) and train_recognizer_pool
    (MAIN_OCR, the OCR path's strips of the fixture pages with the JAX
    texts), the launch counts set to 0 just before each and read just
    after: the warp takes exactly one remap_batch launch a step; every
    loss finite and falling (_trend_ok); each saved directory loads and
    serves a page (the segment stage with the shipped separator student
    beside it; the OCR stage). -> the launches of the segmentation run."""
    import torch
    from origami_tpu_torch.batch.detect import ocr, segment
    from origami_tpu_torch.batch.detect.flow import kernel_launches
    from origami_tpu_torch.models import registry
    from origami_tpu_torch.train import bootstrap
    corpus = train_corpus(workdir / "train_main")
    failed = []
    smi = smi_line()

    def run(name, fn, **kw):
        losses, stamps = {}, {}

        def on_step(kind, member, step, loss):
            losses.setdefault(member, []).append(loss)
            if step in (0, kw.get("steps", 0) - 1):
                torch.cuda.synchronize()
                stamps.setdefault(member, []).append(time.perf_counter())

        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        fn(on_step=on_step, **kw)
        torch.cuda.synchronize()
        launched = kernel_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        for m, vals in sorted(losses.items()):
            vals = [float(v) for v in vals]
            t = stamps.get(m, [])
            ms = (t[-1] - t[0]) / (len(vals) - 1) * 1e3 \
                if len(t) == 2 and len(vals) > 1 else None
            ok = _trend_ok(vals)
            log("  %s member %d: %d steps, loss %.4f -> %.4f (steps 1-5 "
                "mean %.4f, 15-19 mean %s); %s a step (after step 0); "
                "peak %.0f MiB; %s  %s" % (
                    name, m, len(vals), vals[0], vals[-1],
                    statistics.mean(vals[1:6]),
                    "%.4f" % statistics.mean(vals[15:20])
                    if len(vals) >= 20 else "-",
                    fmt_ms(ms), peak, smi, "ok" if ok else "FAIL"))
            if not ok:
                failed.append("%s member %d: losses %s" % (name, m, vals))
        return launched

    seg_kw = dict(MAIN_SEG)
    steps = seg_kw["steps"]
    launched = run("train_segmentation", lambda **kw: (
        bootstrap.train_segmentation(corpus, workdir / "train_ens",
                                     device=device, **kw)), **seg_kw)
    want = seg_kw["members"] * steps
    log("  train_segmentation launches %s (remap_batch %d for %d steps)"
        % (json.dumps({k: v for k, v in launched.items() if v}),
           launched["remap_batch"], want))
    if launched["remap_batch"] != want or any(
            v for k, v in launched.items() if k != "remap_batch"):
        failed.append("train_segmentation launches %s, expected "
                      "remap_batch %d and nothing else" % (launched, want))
    seg_launches = launched
    launched = run("distill_students", lambda **kw: (
        bootstrap.distill_students(workdir / "train_ens", corpus,
                                   workdir / "train_students",
                                   kinds=("region",), device=device, **kw)),
        steps=MAIN_DISTILL_STEPS)
    if any(launched.values()):
        failed.append("distill_students launched %s" % launched)
    tree, meta = registry.load_params(ROOT / "models_pretrained/recognizer")
    pool = [(s, t) for _, _, s, t in ocr_strips(device)]
    run("train_recognizer_pool", lambda **kw: (
        bootstrap.train_recognizer_pool(pool, workdir / "train_rec",
                                        meta["charset"], device=device,
                                        **kw)), **MAIN_OCR)
    # serve: each trained directory loads and runs its stage on a page
    sep = ROOT / STUDENTS / "separator" / "00"
    for name, region in (("ensemble", workdir / "train_ens" / "region"),
                         ("student", workdir / "train_students" / "region")):
        for d in sorted(region.iterdir()):
            registry.load_model(d, device)
        models = workdir / ("serve_" + name)
        shutil.copytree(region, models / "region")
        shutil.copytree(sep, models / "separator" / "00")
        page = workdir / ("serve_%s_page" % name)
        page.mkdir()
        shutil.copy(FIXTURE / "synth0000.png", page)
        segment.main(["-m", str(models), "--lock-strategy", "NONE",
                      "--plain", "--device", str(device), str(page)])
        entry = json.loads((page / "synth0000.out" / "runtime.json")
                           .read_text()).get(SEG_STAGE, {})
        ok = entry.get("status") == "COMPLETED"
        log("  the trained %s serves synth0000 through the segment stage  "
            "%s" % (name, "ok" if ok else "FAIL %s" % entry))
        if not ok:
            failed.append("serving the trained %s: %s" % (name, entry))
    registry.load_model(workdir / "train_rec", device)
    page = workdir / "serve_recognizer"
    page.mkdir()
    shutil.copy(FIXTURE / "synth0000.png", page)
    shutil.copytree(FIXTURE / "synth0000.out", page / "synth0000.out")
    ocr.main(["-m", str(workdir / "train_rec"), "--lock-strategy", "NONE",
              "--plain", "--device", str(device), str(page)])
    entry = json.loads((page / "synth0000.out" / "runtime.json")
                       .read_text()).get(OCR_STAGE, {})
    ok = entry.get("status") == "COMPLETED"
    log("  the trained recognizer serves synth0000 through the OCR stage  "
        "%s" % ("ok" if ok else "FAIL %s" % entry))
    if not ok:
        failed.append("serving the trained recognizer: %s" % entry)
    if failed:
        raise PhaseError("; ".join(failed))
    return seg_launches


def stalling_contours(options):
    """A contours stage whose pages never end (a hung worker), for the
    watchdog check of phase 14d; its workers build it again through
    this function."""
    from origami_tpu_torch.batch.detect.contours import ContoursProcessor

    class StallingContours(ContoursProcessor):
        def process(self, p, input, output):
            time.sleep(600)
            return {}

        def spawn_factory(self):
            return stalling_contours, (self._options,)

    return StallingContours(options)


def _out_files(corpus):
    """{page/file: contents} of every artifact but runtime.json (zips by
    their entries)."""
    out = {}
    for d in sorted(corpus.glob("*.out")):
        for f in sorted(d.iterdir()):
            if f.name == "runtime.json":
                continue
            out["%s/%s" % (d.name, f.name)] = _entries(f) \
                if f.suffix == ".zip" else f.read_bytes()
    return out


def check_processes(workdir, device="cuda"):
    """Phase 14d (ROADMAP C11): the contours, flow, dewarp, layout and
    lines stages from the JAX segment.zip of the fixture pages, in
    process, once with --processes 1 and once with --processes 2 (two
    spawned workers, each with its own CUDA context): the artifacts
    equal, and the launches per page that the workers report to the
    parent as STAGE_LAUNCHES says; then a stalled worker is ended by the
    watchdog after --alive seconds and its pages named."""
    import importlib
    from origami_tpu_torch.batch.detect.flow import kernel_launches
    one = chain_corpus(workdir / "pool_1", True)
    two = chain_corpus(workdir / "pool_2", True)
    n = len(list(one.glob("*.png")))
    failed = []
    common = ["--lock-strategy", "NONE", "--plain", "--device", str(device)]
    for stage in POOL_STAGES:
        mod = importlib.import_module("origami_tpu_torch.batch.detect."
                                      + stage)
        mod.main(common + ["--processes", "1", str(one)])
        reset_launches()
        t0 = time.time()
        mod.main(common + ["--processes", "2", str(two)])
        wall = time.time() - t0
        launches = kernel_launches()
        bad = launch_errors(stage, launches, n, device)
        same = _out_files(one) == _out_files(two)
        status = [json.loads((two / (p.stem + ".out") / "runtime.json")
                             .read_text()).get(STAGE_KEYS[stage], {})
                  .get("status") for p in sorted(two.glob("*.png"))]
        ok = same and not bad and status == ["COMPLETED"] * n
        log("  %-8s --processes 2: %.1f s; artifacts %s the single "
            "process's; launches from the workers %s  %s" % (
                stage, wall, "equal" if same else "DIFFER from",
                json.dumps({k: v for k, v in launches.items() if v}),
                "ok" if ok else "FAIL %s %s" % (bad, status)))
        if not ok:
            failed.append("--processes 2, %s: artifacts equal %s, launches "
                          "(got, expected) %s, status %s"
                          % (stage, same, bad, status))
            break
    stall = chain_corpus(workdir / "pool_stall", True)
    stage = stalling_contours(dict(device=str(device), lock_strategy="NONE",
                                   plain=True, processes=2,
                                   alive=POOL_ALIVE))
    t0 = time.time()
    code = None
    try:
        stage.traverse(str(stall))
    except SystemExit as e:
        code = e.code
    wall = time.time() - t0
    stuck = sorted(Path(p).name for p, _, _ in getattr(stage, "stuck", []))
    ok = code == 1 and stuck == sorted(p.name for p in stall.glob("*.png"))
    log("  a stalled pool (--alive %d): ended after %.1f s, exit %s, stuck "
        "pages %s  %s" % (POOL_ALIVE, wall, code, stuck,
                          "ok" if ok else "FAIL"))
    if not ok:
        failed.append("watchdog: exit %s after %.1f s, stuck %s"
                      % (code, wall, stuck))
    if failed:
        raise PhaseError("; ".join(failed))


# ---------------------------------------------------------------- phase 15

GT_REF = ROOT / "tests" / "data" / "torch_gt"
# the ground-truth chain's parameters; the fixture (GT_REF/params.json)
# records the ones the JAX run took and phase 15 reads them from there.
# `classes`: the separator classes with their orientations, in the order
# they are painted (a later class paints over an earlier one)
GT_PARAMS = dict(max_gap=20.0, min_length=25.0, segment_thickness=1.0,
                 segment_extend={"H": 40, "V": 60, "T": 40},
                 close=[24, 12], min_area=400, text_class="TEXT",
                 classes=[["H", "H"], ["V", "V"], ["T", "H"]])
# phase 15b: deskew_pair's cases (page, angle in radians); the fixture
# holds JAX's image and labels for each
DESKEW_CASES = (("synth0000", 0.02), ("real_scan_1872", -0.015))
# phase 15 bars: gen_binarized's pages equal to JAX's on this share of
# pixels (ROADMAP C10: the float32 integral images of JAX's Sauvola,
# which on a whole page miss the exact sums on up to 7.4e-5 of the
# pixels);
# deskew_pair's image within 1 gray level on every pixel and equal on
# this share; segments within GT_COORD; the skew within GT_SKEW; the
# strips of Line.image within 1 gray level, Line.ink within GT_INK;
# every score of the float32 evaluation within GT_EVAL of JAX's
GT_BIN_EQUAL = 0.9999
# phase 15a also holds each page to the exact Sauvola (integer window
# sums, the threshold in float64) on every pixel farther than this many
# gray levels from its threshold (the kernel's threshold is float32)
GT_BIN_TIE = 0.01
GT_DESKEW_EQUAL = 0.999
GT_COORD = 1e-6
GT_SKEW = 1e-9
GT_INK = 1e-6
GT_EVAL = 1e-4


def gt_modules():
    """The port's modules that gt_chain and line_results call, by name
    (the fixture script passes the JAX package's under the same names)."""
    from origami_tpu_torch.batch.core import deskew, io
    from origami_tpu_torch.core import math
    from origami_tpu_torch.train.segment import (annotations, labels,
                                                 regions, segments)
    return dict(annotations=annotations, segments=segments,
                regions=regions, labels=labels, math=math, io=io,
                deskew=deskew)


def gt_chain(mods, png, params):
    """The ground-truth chain on one corpus page: its annotations, the H,
    V and T separators cleaned with the region TEXT pixels as obstacles,
    the deskewed master and stops rasters, and the regions grown from
    the deskewed TEXT pixels with the separators' extended strokes as
    barriers (their strokes painted alone, so a stroke of index 0 over
    TEXT = 0 still bars). -> dict of numpy results."""
    ann = mods["annotations"].load_page_annotations(png)
    region = ann.labels("region")
    sep = ann.labels("separator")
    label_set = mods["labels"].LabelSet(mods["labels"].DEFAULT_BBZ_SPEC)
    orient = mods["math"].Orientation
    text_idx = label_set.label("region", params["text_class"]).index
    text = region == text_idx
    segs = {}
    for cls, o in params["classes"]:
        idx = label_set.label("separator", cls).index
        segs[cls] = mods["segments"].clean_separators(
            sep == idx, orient[o], max_gap=params["max_gap"],
            min_length=params["min_length"], obstacles=text)
    gen = mods["regions"].AnnotationsGenerator(
        label_set, region, segs, segment_thickness=params[
            "segment_thickness"], segment_extend=params["segment_extend"])
    strokes = mods["regions"].AnnotationsGenerator(
        label_set, np.full(region.shape, 255, np.uint8), segs,
        segment_thickness=params["segment_thickness"],
        segment_extend=params["segment_extend"]).stops != 255
    text_d = gen.deskewing.pixels(text.astype(np.uint8))
    out = dict(skew=np.float64(gen.skew), master=gen.master,
               stops=gen.stops,
               regions=mods["regions"].generate_regions(
                   text_d, strokes, close=tuple(params["close"]),
                   min_area=params["min_area"]).astype(np.int32))
    for cls, pls in segs.items():
        out["seg_%s" % cls] = np.array(
            [[len(p.np_coords), p.width, p.error] for p in pls],
            np.float64).reshape(-1, 3)
        out["seg_%s_coords" % cls] = (
            np.concatenate([p.np_coords for p in pls])
            if pls else np.zeros((0, 2)))
    return out


# the OCR fixture's lines of phase 15d: the first LINE_COUNT lines (in
# path order) of each page's lines.3.zip, at the stage's strip height
LINE_PAGES = ("synth0000", "synth0001")
LINE_COUNT = 4
LINE_HEIGHT = 48
# full-page images of the fixture (deskew_pair, Deskewer.image) keep
# every SAMPLE_ROWS-th row, which holds the fixture under its budget
SAMPLE_ROWS = 16


def line_results(mods, png, device=None):
    """Line.image on both routes, Line.ink and the Deskewer on the first
    LINE_COUNT lines of the OCR fixture page `png` (its lines.3.zip,
    contours.3.zip and dewarp.zip), through the modules `mods` of
    gt_modules (the port's with `device`; the JAX package's, which take
    no device, with None) -> dict of numpy results."""
    io, deskew = mods["io"], mods["deskew"]
    on = {} if device is None else dict(device=device)
    reader = io.Reader([io.Artifact.LINES], io.Stage.RELIABLE, png, **on)
    lines = reader.lines.by_path
    out = {}
    for i, key in enumerate(sorted(lines)[:LINE_COUNT]):
        line = lines[key]
        out["dewarped_%d" % i] = line.image(LINE_HEIGHT)
        out["deskewed_%d" % i] = line.image(LINE_HEIGHT, dewarped=False)
        out["ink_%d" % i] = np.asarray(line.ink)
    d = deskew.Deskewer(lines)
    warped = reader.page.warped
    h, w = warped.shape
    out["deskewer_angle"] = np.float64(d.angle)
    out["deskewer_image"] = d.image(warped, **on)[::SAMPLE_ROWS]
    block = reader.regions.by_path[sorted(reader.regions.by_path)[0]]
    out["deskewer_geometry"] = np.asarray(d.geometry(
        block.image_space_polygon, (w, h)).exterior.coords, np.float64)
    return out


def launch_counts():
    """Every kernel wrapper's launch count, by kernel name."""
    from origami_tpu_torch.ops import binarize, gather, grid, remap
    return {k: v for counts in (remap.launches, binarize.launches,
                                gather.launches, grid.launches)
            for k, v in counts.items()}


def gt_params():
    return json.loads((GT_REF / "params.json").read_text())


def sauvola_exact(px, window, k=0.2, r=128.0):
    """Sauvola of the u8 page `px` from exact integer window sums (the
    window clipped to the page) with the threshold in float64 ->
    (mask, |pixel - threshold|)."""
    v = px.astype(np.int64)
    h, w = v.shape
    rad = window // 2

    def integral(a):
        s = np.zeros((h + 1, w + 1), np.int64)
        s[1:, 1:] = a.cumsum(0).cumsum(1)
        return s
    ys, xs = np.arange(h), np.arange(w)
    y0, y1 = np.clip(ys - rad, 0, h)[:, None], np.clip(ys + rad + 1, 0, h)[
        :, None]
    x0, x1 = np.clip(xs - rad, 0, w)[None], np.clip(xs + rad + 1, 0, w)[None]

    def box(s):
        return (s[y1, x1] - s[y0, x1] - s[y1, x0] + s[y0, x0]).astype(
            np.float64)
    n = ((y1 - y0) * (x1 - x0)).astype(np.float64)
    mean = box(integral(v)) / n
    std = np.sqrt(np.maximum(box(integral(v * v)) / n - mean * mean, 0.0))
    t = mean * (1.0 + k * (std / r - 1.0))
    return v > t, np.abs(v - t)


def check_gen_binarized(corpus, device, params):
    """Phase 15a: gen_binarized over the train corpus; each bin/ page
    against the JAX page of the fixture (GT_BIN_EQUAL), one sauvola
    launch a page on the card. -> pages/s."""
    from origami_tpu_torch.core import _png
    from origami_tpu_torch.train.segment.binarize import gen_binarized
    reset_launches()
    t0 = time.time()
    n = gen_binarized(corpus, params["window_size"], device)
    dt = time.time() - t0
    launched = launch_counts()
    want = {"sauvola": n} if device == "cuda" else {}
    failed = []
    for png in sorted((corpus.parent / "bin").glob("*.png")):
        got, ref = _png.read(png), _png.read(GT_REF / "bin" / png.name)
        diff = int((got != ref).sum()) if got.shape == ref.shape else -1
        share = 1.0 - diff / got.size if diff >= 0 else 0.0
        exact, gap = sauvola_exact(_png.read_gray(corpus / png.name),
                                   params["window_size"] | 1)
        off = int(((got > 0) != exact)[gap > GT_BIN_TIE].sum())
        ok = share >= GT_BIN_EQUAL and off == 0
        log("  (a) bin/%s %dx%d: %d pixels differ from JAX's (equal %.7f, "
            "bar %g); %d from the exact Sauvola off its %d ties  %s" % (
                png.name, got.shape[1], got.shape[0], diff, share,
                GT_BIN_EQUAL, off, int((gap <= GT_BIN_TIE).sum()),
                "ok" if ok else "FAIL"))
        if not ok:
            failed.append(png.name)
    nz = {k: v for k, v in launched.items() if v}
    log("  (a) gen_binarized: %d pages in %.3f s (%.2f pages/s, cold "
        "process), launches %s (expected %s)" % (n, dt, n / dt,
                                                json.dumps(nz), want))
    if failed or n != len(TRAIN_PAGES) or nz != want:
        raise PhaseError("gen_binarized: pages %s off JAX's, %d pages, "
                         "launches %s" % (failed, n, nz))
    return n / dt


def check_deskew_pair(corpus, device, params):
    """Phase 15b: deskew_pair of each DESKEW_CASES page and its region
    map (resized to the page, nearest) against the fixture: labels
    equal, image within 1 gray level and equal on GT_DESKEW_EQUAL of
    the sampled rows; one remap_affine launch a call. -> launches."""
    from origami_tpu_torch.train.segment.annotations import \
        load_page_annotations
    from origami_tpu_torch.train.segment.data import resize_nearest_u8
    from origami_tpu_torch.train.segment.skew import deskew_pair
    rows = params["sample_rows"]
    n_launched = 0
    for page, angle in params["deskew"]:
        ann = load_page_annotations(corpus / (page + ".png"))
        h, w = ann.image.shape
        labels = resize_nearest_u8(ann.labels("region"), (w, h))
        reset_launches()
        t0 = time.time()
        img, lab = deskew_pair(ann.image, labels, angle, device=device)
        dt = time.time() - t0
        nz = {k: v for k, v in launch_counts().items() if v}
        want = {"remap_affine": 1} if device == "cuda" else {}
        n_launched += nz.get("remap_affine", 0)
        with np.load(GT_REF / ("deskew_%s.npz" % page)) as ref:
            lab_ok = np.array_equal(lab, ref["labels"])
            d = np.abs(img[::rows].astype(int) - ref["image"])
        share = float((d == 0).mean())
        ok = lab_ok and d.max() <= 1 and share >= GT_DESKEW_EQUAL \
            and nz == want
        log("  (b) deskew_pair %s %dx%d at %g rad: labels %s, image max "
            "%d gray level, equal %.6f (bar %g); %.3f s, launches %s  %s"
            % (page, w, h, angle, "equal" if lab_ok else "DIFFER",
               d.max(), share, GT_DESKEW_EQUAL, dt, json.dumps(nz),
               "ok" if ok else "FAIL"))
        if not ok:
            raise PhaseError("deskew_pair %s off JAX's or launches %s"
                             % (page, nz))
    return n_launched


def check_gt_chain(corpus, params):
    """Phase 15c: gt_chain on each corpus page against the fixture:
    segments within GT_COORD, the skew within GT_SKEW, the master,
    stops and region rasters equal. -> seconds."""
    mods = gt_modules()
    t0 = time.time()
    for png in sorted(p for p in corpus.glob("*.png")
                      if ".labels." not in p.name):
        t1 = time.time()
        got = gt_chain(mods, png, params["gt"])
        bad = []
        with np.load(GT_REF / ("gt_%s.npz" % png.stem)) as ref:
            for k in ref.files:
                a, b = ref[k], got[k]
                if a.shape != b.shape:
                    bad.append("%s shape %s != %s" % (k, b.shape, a.shape))
                    continue
                tol = GT_SKEW if k == "skew" else GT_COORD \
                    if k.startswith("seg_") else 0
                if a.size and np.abs(a.astype(np.float64)
                                     - b.astype(np.float64)).max() > tol:
                    bad.append(k)
        n_seg = sum(len(got["seg_%s" % c]) for c, _ in params["gt"]
                    ["classes"])
        log("  (c) %s: skew %.9g, %d segments, %d regions, master/stops/"
            "regions %s; %.2f s  %s" % (
                png.stem, float(got["skew"]), n_seg,
                int(got["regions"].max()),
                "equal" if not bad else "DIFFER " + ", ".join(bad),
                time.time() - t1, "ok" if not bad else "FAIL"))
        if bad:
            raise PhaseError("gt chain %s: %s" % (png.stem, bad))
    return time.time() - t0


def check_lines(device):
    """Phase 15d: line_results on the OCR fixture pages against the
    fixture: strips within 1 gray level, ink within GT_INK, the
    Deskewer's angle and geometry within 1e-9, its image within 1 gray
    level; remap_batch once a dewarped strip, remap_affine once a
    deskewed strip, a ink and the Deskewer image. -> remap_affine
    launches."""
    mods = gt_modules()
    n_launched = 0
    for page in LINE_PAGES:
        reset_launches()
        t0 = time.time()
        got = line_results(mods, FIXTURE / (page + ".png"), device)
        dt = time.time() - t0
        nz = {k: v for k, v in launch_counts().items() if v}
        bad = []
        worst = dict(strip=0, ink=0.0)
        with np.load(GT_REF / ("lines_%s.npz" % page)) as ref:
            for k in ref.files:
                a, b = ref[k], np.asarray(got[k])
                if a.shape != b.shape:
                    bad.append("%s shape" % k)
                    continue
                d = np.abs(a.astype(np.float64) - b) if a.size else \
                    np.zeros(1)
                if k.startswith("ink_"):
                    worst["ink"] = max(worst["ink"], float(d.max()))
                    tol = GT_INK
                elif k in ("deskewer_angle", "deskewer_geometry"):
                    tol = 1e-9
                else:
                    worst["strip"] = max(worst["strip"], int(d.max()))
                    tol = 1
                if d.max() > tol:
                    bad.append(k)
        n = LINE_COUNT
        # the page's load adds its dewarp_u8 and sauvola_packed launches
        want = {"remap_batch": n, "remap_affine": 2 * n + 1} \
            if device == "cuda" else {}
        got_remap = {k: nz[k] for k in ("remap_batch", "remap_affine")
                     if k in nz}
        if got_remap != want:
            bad.append("launches %s, expected %s" % (got_remap, want))
        n_launched += nz.get("remap_affine", 0)
        log("  (d) %s: %d lines, both Line.image routes max %d gray level, "
            "Line.ink max %.3g, Deskewer angle %.6g; %.2f s, launches %s"
            "  %s" % (page, n, worst["strip"], worst["ink"],
                      float(got["deskewer_angle"]), dt, json.dumps(nz),
                      "ok" if not bad else "FAIL " + ", ".join(bad)))
        if bad:
            raise PhaseError("lines %s: %s" % (page, bad))
    return n_launched


def _flat_report(report, prefix=""):
    for k, v in report.items():
        if isinstance(v, dict):
            yield from _flat_report(v, prefix + k + "/")
        else:
            yield prefix + k, v


def check_eval(corpus, device, params):
    """Phase 15e: eval_segmentation and eval_separator_tolerant of the
    students over the corpus in float32 against the fixture's JAX
    reports (GT_EVAL), then in bf16 with their pages/s."""
    import torch
    from origami_tpu_torch.train import bootstrap
    ev = params["eval"]
    models = ROOT / ev["models"]
    n_pages = len([p for p in corpus.glob("*.png")
                   if ".labels." not in p.name])
    for dtype in (torch.float32, torch.bfloat16):
        t0 = time.time()
        reports = dict(
            segmentation=bootstrap.eval_segmentation(
                models, corpus, target=ev["target"], batch=ev["batch"],
                device=device, dtype=dtype),
            separator_tolerant=bootstrap.eval_separator_tolerant(
                models, corpus, target=ev["target"], tol=ev["tol"],
                batch=ev["batch"], device=device, dtype=dtype))
        dt = time.time() - t0
        name = str(dtype).split(".")[-1]
        log("  (e) %s: %s" % (name, json.dumps(reports, sort_keys=True)))
        # each page passes the predictor twice: once for both kinds'
        # IoUs, once for the separator scores
        log("  (e) %s: %.2f s for %d page passes (%.2f pages/s)"
            % (name, dt, 2 * n_pages, 2 * n_pages / dt))
        want = dict(_flat_report(ev["reports"]))
        got = dict(_flat_report(reports))
        worst, bad = 0.0, []
        for k, v in want.items():
            if (v is None) != (got.get(k) is None):
                bad.append(k)
            elif v is not None:
                worst = max(worst, abs(got[k] - v))
                if abs(got[k] - v) > GT_EVAL:
                    bad.append(k)
        if dtype != torch.float32:
            # the control: bf16 scores lie outside the float32 bar, so
            # the bar would catch a predictor that lost float32
            log("  (e) bf16 vs JAX's float32: max |diff| %.3g over %d "
                "scores, %d outside the float32 bar %g (control, not "
                "gated)" % (worst, len(want), len(bad), GT_EVAL))
            continue
        log("  (e) float32 vs JAX: max |diff| %.3g over %d scores (bar %g)"
            "  %s" % (worst, len(want), GT_EVAL,
                      "ok" if not bad else "FAIL " + ", ".join(bad)))
        if bad:
            raise PhaseError("evaluation off JAX's: %s" % bad)


def gt_sites(corpus, device):
    """Phase 15's kernel sites on the card, each against its plain
    version: sauvola at gen_binarized's largest page (exactly) and
    remap_affine, affine_warp as deskew_pair calls it, at deskew_pair's
    largest page (within REMAP_F32_ERR), with the bound, the plain
    version's and the yardstick's times."""
    import torch
    import torch.nn.functional as F
    from origami_tpu_torch.core import _png
    from origami_tpu_torch.core.math import rotation_matrix
    from origami_tpu_torch.ops import binarize, remap
    page, angle = DESKEW_CASES[-1]          # the larger page
    px = _png.read_gray(corpus / (page + ".png"))
    h, w = px.shape
    img = torch.from_numpy(px).to(device)
    window = 15

    def sk():
        return binarize.sauvola(img, window)

    def sp():
        return binarize.sauvola_plain(img, window)
    same = bool(torch.equal(sk(), sp()))
    bound, by = sauvola_bound(img, sk())
    rows = {"sauvola": dict(
        site="gen_binarized", shape="%dx%d" % (w, h), equal=same,
        err=0.0 if same else 1.0, ms=time_cuda(sk), device_ms=device_ms(sk),
        plain_ms=time_cuda(sp), bound_ms=bound, bound_by=by,
        library_ms=time_cuda(lambda: sauvola_library(img, window)),
        library_device_ms=device_ms(lambda: sauvola_library(img, window)))}
    m = rotation_matrix(angle, center=(w / 2, h / 2))
    f = img.float()

    def rk():
        return remap.affine_warp(f, m, (h, w), 255.0)

    def rp():
        return remap.affine_warp_plain(f, m, (h, w), 255.0)
    err = float((rk() - rp()).abs().max())
    sx, sy = (torch.from_numpy(v).to(device)
              for v in remap.affine_planes(m, (h, w)))
    maps = (sx[None].contiguous(), sy[None].contiguous())

    def by_planes():
        # the same samples through remap_batch reading the planes
        return remap.remap_batch(f[None], maps, 255.0, "hard")
    grid = torch.stack([sx * (2.0 / (w - 1)) - 1.0,
                        sy * (2.0 / (h - 1)) - 1.0], -1)[None]

    def lib():
        return F.grid_sample(f[None, None], grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)
    # the f32 image read once and the f32 output written once
    nbytes = 4 * h * w + 4 * h * w
    rows["remap_affine"] = dict(
        site="affine_warp (deskew_pair)", shape="%dx%d" % (w, h),
        equal=err <= REMAP_F32_ERR, err=err, ms=time_cuda(rk),
        device_ms=device_ms(rk), plain_ms=time_cuda(rp, reps=5),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=time_cuda(lib), library_device_ms=device_ms(lib))
    log("  site remap_affine: remap_batch on prebuilt planes, the planes "
        "excluded: device %s" % fmt_ms(device_ms(by_planes)))
    for name, r in rows.items():
        log("  site %s at %s %s: max abs %.3g vs plain  %s; events %s, "
            "device %s; plain %s; bound %s (%s); yardstick events %s, "
            "device %s" % (
                name, r["site"], r["shape"], r["err"],
                "ok" if r["equal"] else "FAIL", fmt_ms(r["ms"]),
                fmt_ms(r["device_ms"]), fmt_ms(r["plain_ms"]),
                fmt_ms(r["bound_ms"]), r["bound_by"],
                fmt_ms(r["library_ms"]), fmt_ms(r["library_device_ms"])))
        if not r["equal"]:
            raise PhaseError("%s at %s off its plain version: %g"
                             % (name, r["site"], r["err"]))
    return rows


def check_ground_truth(workdir, device="cuda"):
    """Phase 15: the ground-truth path of the port on `device` against
    the JAX package's fixture (tests/data/torch_gt): (a)-(e) above, then
    (on the card) the kernel sites. -> (the site rows ({} on the CPU),
    remap_affine's launches in (b) and (d))."""
    params = gt_params()
    corpus = train_corpus(workdir / "gt" / "corpus")
    t = time.time()
    pps = check_gen_binarized(corpus, device, params)
    log("  (a) %.1f s" % (time.time() - t))
    t = time.time()
    n_affine = check_deskew_pair(corpus, device, params)
    log("  (b) %.1f s" % (time.time() - t))
    log("  (c) %.1f s" % check_gt_chain(corpus, params))
    t = time.time()
    n_affine += check_lines(device)
    log("  (d) %.1f s" % (time.time() - t))
    t = time.time()
    check_eval(corpus, device, params)
    log("  (e) %.1f s" % (time.time() - t))
    log("  gen_binarized %.2f pages/s" % pps)
    return (gt_sites(corpus, device) if device == "cuda" else {},
            n_affine)


# ---------------------------------------------------------------- phase 16

SYNTH_REF = ROOT / "tests" / "data" / "torch_synth"
# phase 16a: render_page's cases (seed, keyword arguments); the first two
# are write_corpus(seed=7)'s pages, the OCR fixture's page images
SYNTH_PAGES = ((70000, {}), (70001, {}), (55_000_000, {"n_columns": 2}),
               (123, {"degrade": False}))
SYNTH_LINE_SEEDS = tuple(range(32)) + tuple(123_456 + i for i in range(32))
SYNTH_POOL_PAGES = 2
# phase 16b: eval_recognizer's lines and models; the CER within EVAL_CER
# of the JAX value and at least EVAL_MIN_EQUAL of the texts equal
# (ROADMAP C2: bf16 convolutions round two lines of 513 otherwise)
EVAL_N = 300
EVAL_MODELS = {"single": ("recognizer",),
               "voted": ("recognizer", "recognizer2")}
EVAL_CER = 0.002
EVAL_MIN_EQUAL = 298
# phase 16c: each count within this many lines a page of the JAX chain's
CHAIN_SCORE_SLACK = 1
# phase 16d: the bootstrap CLI at a small depth (the widths and the page size
# are the defaults) and the report keys its phases write
BOOT_ARGS = ("--train-pages", "2", "--val-pages", "1", "--members", "1",
             "--seg-steps", "3", "--distill-steps", "3", "--ocr-steps",
             "3", "--ocr-pool", "64", "--batch", "1")
BOOT_KEYS = ("seg_train_seconds", "distill_seconds", "ocr_train_seconds",
             "iou_ensemble", "iou_ensemble_speed1", "iou_student",
             "sep_tolerant_ensemble", "sep_tolerant_student", "ocr",
             "eval_seconds")
# the recognizer's steps/s: a pool of this many strips, these many steps
# (the first two are warm-up)
TRAIN_POOL = 360
TRAIN_STEPS = 12
# phase 12's wall seconds a run, read by phase 16c
WHOLE_CHAIN_WALL = {}


def synth_modules():
    """The port's modules that phase 16 calls, by name (the fixture
    script passes the JAX package's under the same names)."""
    from origami_tpu_torch.batch.utils import evaluate
    from origami_tpu_torch.core.dewarp import Grid
    from origami_tpu_torch.train import synth
    return dict(synth=synth, evaluate=evaluate, Grid=Grid)


def digest(*parts):
    """sha256 over arrays (shape, dtype and bytes) and strings."""
    import hashlib
    h = hashlib.sha256()
    for p in parts:
        if isinstance(p, str):
            h.update(p.encode("utf8"))
        else:
            a = np.ascontiguousarray(p)
            h.update(("%s%s" % (a.shape, a.dtype)).encode())
            h.update(a.tobytes())
    return h.hexdigest()


def synth_page_digests(synth, seed, **kw):
    """Digests of render_page's image, label maps and gt.json document
    (write_corpus's, through the port's page_gt_json for either
    package's page)."""
    from origami_tpu_torch.train.synth import page_gt_json
    page = synth.render_page(seed, **kw)
    return dict(image=digest(page.image), region=digest(page.region_labels),
                separator=digest(page.separator_labels),
                gt=digest(json.dumps(page_gt_json(page))))


def synth_line_digests(synth, seeds=SYNTH_LINE_SEEDS):
    return [digest(*synth.render_line(s)) for s in seeds]


def synth_pool_digest(synth, n_pages=SYNTH_POOL_PAGES):
    pool = synth.page_line_pool(n_pages=n_pages)
    return digest(*[x for strip, text in pool for x in (strip, text)])


def synth_gt_lines(gt):
    """match_baselines' GT lines of a gt.json document: the baseline row,
    the ink's x extent and its height above the baseline."""
    return [dict(y=float(l["baseline"][0][1]), x0=float(l["bbox"][0]),
                 x1=float(l["bbox"][2]),
                 h=float(l["baseline"][0][1] - l["bbox"][1]))
            for l in gt["lines"]]


def chain_scores(mods, out, gt):
    """The detected baselines of a page's lines.3.zip, mapped back to the
    page through its dewarp.zip, scored against its gt.json document:
    per GT line (match_baselines, within max(0.5 h, 4) px) and per
    detection (match_detections)."""
    ev = mods["evaluate"]
    grid = mods["Grid"].open(out / "dewarp.zip")
    dets = []
    with zipfile.ZipFile(out / "lines.3.zip") as zf:
        for n in sorted(zf.namelist()):
            if not n.endswith(".json") or n == "meta.json":
                continue
            bl = (json.loads(zf.read(n)).get("tesseract_data")
                  or {}).get("baseline")
            if bl and len(bl) >= 2:
                dets.append(grid.inverse_points(np.asarray(bl, float)))
    lines = synth_gt_lines(gt)
    res = ev.match_baselines(lines, dets)
    matched = sum(1 for g, d in res
                  if d is not None and d <= max(0.5 * g["h"], 4.0))
    prec = ev.match_detections(lines, dets, zones=ev.gt_zones(lines))
    return dict(n_gt=len(res), n_matched=matched, n_detected=len(dets),
                n_considered=prec["n_considered"], n_true=prec["n_true"])


def synth_ref():
    return json.loads((SYNTH_REF / "synth.json").read_text())


def check_render(workdir, ref):
    """Phase 16a: write_corpus(2 pages, seed=7) against the OCR fixture's
    page images (every pixel) and the fixture's digests (images, label
    maps, gt.json), render_page's other cases, render_line's seeds and
    page_line_pool by digest. -> (the corpus, seconds a page, whether
    both pages equal the fixture's images)."""
    from origami_tpu_torch.core import _png
    from origami_tpu_torch.train import synth
    failed = []
    corpus = workdir / "synth_corpus"
    t = time.perf_counter()
    names = synth.write_corpus(corpus, 2, seed=7)
    per_page = (time.perf_counter() - t) / len(names)
    same_pages = True
    for name, (seed, kw) in zip(names, SYNTH_PAGES):
        want = ref["pages"][str(seed)]
        img = _png.read_gray(corpus / (name + ".png"))
        fixture = _png.read_gray(FIXTURE / (name + ".png"))
        diff = int((img != fixture).sum()) if img.shape == fixture.shape \
            else -1
        got = dict(image=digest(img),
                   region=digest(_png.read_gray(
                       corpus / (name + ".labels.region.png"))),
                   separator=digest(_png.read_gray(
                       corpus / (name + ".labels.separator.png"))),
                   gt=digest((corpus / (name + ".gt.json")).read_text()))
        bad = [k for k in want if got[k] != want[k]]
        log("  %s (seed %d): %d pixels differ from the OCR fixture's "
            "page; digests %s  %s" % (name, seed, diff,
                                      "equal" if not bad else bad,
                                      "ok" if diff == 0 and not bad
                                      else "FAIL"))
        same_pages &= diff == 0
        if diff or bad:
            failed.append("write_corpus %s: %d pixels, digests %s"
                          % (name, diff, bad))
    for seed, kw in SYNTH_PAGES[2:]:
        got = synth_page_digests(synth, seed, **kw)
        bad = [k for k, v in ref["pages"][str(seed)].items() if got[k] != v]
        log("  render_page(%d, %s): %s" % (seed, kw,
                                           "equal" if not bad else bad))
        if bad:
            failed.append("render_page(%d): %s" % (seed, bad))
    lines = synth_line_digests(synth)
    first = next((s for s, a, b in zip(SYNTH_LINE_SEEDS, lines,
                                       ref["lines"]) if a != b), None)
    log("  render_line over %d seeds: %s" % (
        len(lines), "equal" if first is None
        else "first differing seed %d" % first))
    if first is not None:
        failed.append("render_line: seed %d differs" % first)
    pool = synth_pool_digest(synth)
    log("  page_line_pool(n_pages=%d): %s" % (
        SYNTH_POOL_PAGES, "equal" if pool == ref["pool"] else "differs"))
    if pool != ref["pool"]:
        failed.append("page_line_pool differs")
    if failed:
        raise PhaseError("; ".join(failed))
    return corpus, per_page, same_pages


def check_eval_recognizer(ref, device):
    """Phase 16b: eval_recognizer's lines through the serving predictor
    on `device`, single and 2-model sequence vote, against the JAX
    package's texts and CER. -> {mode: lines/s}."""
    from origami_tpu_torch.batch.utils.evaluate import cer
    from origami_tpu_torch.train import bootstrap
    failed, rates = [], {}
    for mode, names in EVAL_MODELS.items():
        want = ref["eval"][mode]
        dirs = [ROOT / "models_pretrained" / n for n in names]
        t = time.perf_counter()
        truths, preds, _ = bootstrap.recognizer_predictions(
            dirs if len(dirs) > 1 else dirs[0], n=EVAL_N, device=device)
        rates[mode] = EVAL_N / (time.perf_counter() - t)
        c = float(np.mean([cer(a, b) for a, b in zip(truths, preds)]))
        same = sum(a == b for a, b in zip(preds, want["preds"]))
        ok = truths == want["truths"] and same >= EVAL_MIN_EQUAL \
            and abs(c - want["cer"]) <= EVAL_CER
        log("  %-6s %d lines: CER %.5f (JAX %.5f, bar %.3f), texts equal "
            "to JAX's %d (gate %d), %.1f lines/s  %s" % (
                mode, EVAL_N, c, want["cer"], EVAL_CER, same,
                EVAL_MIN_EQUAL, rates[mode], "ok" if ok else "FAIL"))
        if not ok:
            failed.append("eval_recognizer %s: CER %.5f vs %.5f, %d equal"
                          % (mode, c, want["cer"], same))
    if failed:
        raise PhaseError("; ".join(failed))
    return rates


def recognizer_rate(workdir, device):
    """(the pool's build seconds, the recognizer's training steps/s) of
    train_recognizer_synth's parts at their defaults."""
    import torch
    from origami_tpu_torch.train import bootstrap
    from origami_tpu_torch.train.synth import CHARSET
    t = time.perf_counter()
    pool = bootstrap.synth_pool(TRAIN_POOL)
    build = time.perf_counter() - t
    stamps = []

    def on_step(kind, member, step, loss):
        float(loss)
        stamps.append(time.perf_counter())

    bootstrap.train_recognizer_pool(pool, workdir / "synth_recognizer",
                                    CHARSET, steps=TRAIN_STEPS,
                                    device=device, on_step=on_step)
    if str(device) != "cpu":
        torch.cuda.synchronize()
    return build, (len(stamps) - 2) / (stamps[-1] - stamps[1])


def check_chain_scores(corpus, same_pages, ref, workdir, device):
    """Phase 16c: the nine stages on the 16a pages, scored by the port's
    evaluate against their gt.json documents, each count within
    CHAIN_SCORE_SLACK lines a page of the JAX chain's. Where both pages
    equal the OCR fixture's images, phase 12's main-path outputs of the
    same images are scored. -> pages/s of the chain run scored."""
    import torch
    from origami_tpu_torch.batch.runner import PipelinedRunner
    mods = synth_modules()
    if same_pages and "banded" in WHOLE_CHAIN_WALL:
        chain = workdir / "whole_chain_banded"
        wall = WHOLE_CHAIN_WALL["banded"]
        log("  scoring phase 12's main-path outputs (the same page images)")
    else:
        chain = workdir / "synth_chain"
        chain.mkdir()
        for png in sorted(corpus.glob("synth????.png")):
            shutil.copy(png, chain / png.name)
        reset_launches()
        t = time.perf_counter()
        PipelinedRunner(chain_stages(device, str(ROOT / STUDENTS), "banded"),
                        wave_size=1).run(chain)
        if str(device) != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
        log("  ran the chain on the rendered pages: %.2f s" % wall)
    failed = []
    n = 0
    for png in sorted(chain.glob("synth????.png")):
        gt = json.loads((corpus / (png.stem + ".gt.json")).read_text())
        got = chain_scores(mods, chain / (png.stem + ".out"), gt)
        want = ref["chain"][png.stem]
        bad = {k: (got[k], want[k]) for k in want
               if abs(got[k] - want[k]) > CHAIN_SCORE_SLACK}
        log("  %s: %s (JAX %s)  %s" % (png.stem, json.dumps(got),
                                       json.dumps(want),
                                       "ok" if not bad else "FAIL"))
        if bad:
            failed.append("%s scores (port, JAX): %s" % (png.stem, bad))
        n += 1
    if failed:
        raise PhaseError("; ".join(failed))
    return n / wall


def check_bootstrap_cli(workdir, device):
    """Phase 16d: `python -m origami_tpu_torch.train.bootstrap` end to end
    at BOOT_ARGS' depth: exit 0 and every BOOT_KEYS key in report.json.
    -> (seconds, the run's kernel launches)."""
    work = workdir / "bootstrap"
    cmd = [sys.executable, "-m", "origami_tpu_torch.train.bootstrap",
           "--work", str(work), "--device", str(device), *BOOT_ARGS]
    t = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT, text=True, timeout=900)
    secs = time.perf_counter() - t
    launches = {}
    for line in r.stdout.splitlines():
        if line.startswith('{"kernel_launches"'):
            launches = json.loads(line)["kernel_launches"]
    report = json.loads((work / "report.json").read_text()) \
        if (work / "report.json").exists() else {}
    missing = [k for k in BOOT_KEYS if k not in report]
    log("  bootstrap %s: exit %d, %.1f s; report keys missing %s; ocr %s; "
        "launches %s  %s" % (" ".join(BOOT_ARGS), r.returncode, secs,
                             missing, json.dumps(report.get("ocr")),
                             json.dumps({k: v for k, v in launches.items()
                                         if v}),
                             "ok" if r.returncode == 0 and not missing
                             else "FAIL"))
    if r.returncode or missing:
        raise PhaseError("bootstrap CLI: exit %d, missing %s; %s" % (
            r.returncode, missing, r.stdout[-3000:]))
    return secs, launches


def check_synth(workdir, device="cuda"):
    """Phase 16: (a)-(d) above, then the host and card rates."""
    ref = synth_ref()
    t = time.time()
    corpus, per_page, same_pages = check_render(workdir, ref)
    log("  (a) %.1f s" % (time.time() - t))
    t = time.time()
    rates = check_eval_recognizer(ref, device)
    build, steps = recognizer_rate(workdir, device)
    log("  (b) %.1f s" % (time.time() - t))
    t = time.time()
    pages_s = check_chain_scores(corpus, same_pages, ref, workdir, device)
    log("  (c) %.1f s" % (time.time() - t))
    t = time.time()
    check_bootstrap_cli(workdir, device)
    log("  (d) %.1f s" % (time.time() - t))
    smi = smi_line() if str(device) != "cpu" else "cpu"
    log("  render_page %.3f s a page (host); the pool of %d strips built "
        "in %.2f s (host); recognizer %.2f steps/s (batch 64); "
        "eval_recognizer %s lines/s; the chain %.3f pages/s  (%s)" % (
            per_page, TRAIN_POOL, build, steps,
            ", ".join("%s %.1f" % kv for kv in rates.items()), pages_s,
            smi))


# ------------------------------------------------------------ phase 17
# The corpus-inspection surface (origami_tpu_torch/batch/annotate,
# batch/utils): every render and utility CLI in this process on the
# fixture pages with the JAX artifacts they read, held against the JAX
# package's outputs in tests/data/torch_inspect/inspect.json
# (scripts/make_torch_inspect_fixture.py): the renders' canvases by
# digest outside the label boxes (ROADMAP C8: the labels are the glyph
# atlas's, not cv2's Hershey strokes), the dewarped pages, thumbnails
# and signature PNGs by the digest of their pixels, signature.json and
# the region texts equal; and patch_skew_samples on the JAX binarized
# page.
INSPECT_REF = ROOT / "tests" / "data" / "torch_inspect"
# (CLI under origami_tpu_torch.batch, its arguments, its file in the
# page's .out folder, whether it draws on the dewarped page: one
# dewarp_u8 launch a page when the page cache is cold, none when warm)
INSPECT_RENDERS = (
    ("annotate.grid", (), "annotation.dewarp.jpg", False),
    ("annotate.flow", (), "annotation.flow.jpg", False),
    ("annotate.contours", ("--stage", "warped"),
     "annotation.contours.0.jpg", False),
    ("annotate.contours", ("--stage", "reliable"),
     "annotation.contours.3.jpg", True),
    ("annotate.lines", (), "annotation.lines.jpg", True),
    ("annotate.layout", (), "annotation.layout.jpg", True),
    ("utils.dewarp", (), "dewarped.jpg", True),
)
# patch_skew_samples against the JAX function on the same mask: the same
# points, the angles equal on >= 99 % of the tiles and the rest within
# one step of the 33-angle sweep
SKEW_PATCHES = (256, 128)
SKEW_EQUAL = 0.99
SKEW_STEP = 0.24 / 32


def inspect_corpus(dst):
    """The fixture pages with the JAX artifacts the renders and utilities
    read: segment.zip, dewarp.zip, contours.3.zip, lines.3.zip,
    tables.json and runtime.json (tests/data/torch_ocr/full),
    contours.0.zip, contours.1.zip and flow.zip (torch_flow),
    contours.2.zip (torch_layout), order.json, and compose_xml.zip (the
    JAX compose stage's --page-xml output) as compose.zip
    (torch_compose)."""
    dst.mkdir(parents=True)
    for png in sorted(FIXTURE.glob("*.png")):
        shutil.copy(png, dst / png.name)
        out = dst / (png.stem + ".out")
        out.mkdir()
        for ref, names in (
                (FIXTURE, ("segment.zip", "dewarp.zip", "contours.3.zip",
                           "lines.3.zip", "tables.json", "runtime.json")),
                (FLOW_REF, ("contours.0.zip", "contours.1.zip",
                            "flow.zip")),
                (LAYOUT_REF, ("contours.2.zip",)),
                (COMPOSE_REF, ("order.json",))):
            for name in names:
                shutil.copy(ref / (png.stem + ".out") / name, out)
        shutil.copy(COMPOSE_REF / (png.stem + ".out") / "compose_xml.zip",
                    out / "compose.zip")
    return dst


def mcu_box(box, mcu=16):
    """A label box (x0, y0, x1, y1; x1 and y1 exclusive) grown out to the
    lattice of 16-px MCUs and one MCU further on each side: outside it a
    4:2:0 JPEG decodes the same whatever the box holds (fancy
    upsampling reads the chroma of the next MCU)."""
    x0, y0, x1, y1 = box
    return (x0 // mcu * mcu - mcu, y0 // mcu * mcu - mcu,
            -(-x1 // mcu) * mcu + mcu, -(-y1 // mcu) * mcu + mcu)


def masked_digest(pixels, boxes=()):
    """digest() of an image with its label boxes ((x0, y0, x1, y1), x1
    and y1 exclusive) set to 0."""
    px = np.array(pixels, copy=True)
    for x0, y0, x1, y1 in boxes:
        px[max(y0, 0):max(y1, 0), max(x0, 0):max(x1, 0)] = 0
    return digest(px)


def signature_digests(path):
    """{member: digest of the decoded PNG's pixels} and signature.json's
    text of a signature.zip."""
    from origami_tpu_torch.core import _png
    pngs, text = {}, None
    with zipfile.ZipFile(path) as zf:
        for name in sorted(zf.namelist()):
            if name.endswith(".png"):
                pngs[name] = digest(_png.decode(zf.read(name), name))
            else:
                text = zf.read(name).decode("utf8")
    return pngs, text


def text_digests(folder):
    """{relative path: digest of its text} of every file under folder."""
    return {str(p.relative_to(folder)): digest(p.read_text())
            for p in sorted(folder.rglob("*")) if p.is_file()}


def skew_rows(samples):
    return [[float(x), float(y), float(a)] for (x, y), a in samples]


def skew_errors(got, ref, label):
    """The bars of SKEW_*: -> (failures, tiles, tiles with equal angles)."""
    got, ref = np.asarray(got), np.asarray(ref)
    if got.shape != ref.shape or not np.array_equal(got[:, :2], ref[:, :2]):
        return ["%s: points differ (%s against %s)" % (
            label, got.shape, ref.shape)], len(ref), 0
    diff = np.abs(got[:, 2] - ref[:, 2])
    same = int((diff == 0).sum())
    bad = []
    if same < SKEW_EQUAL * len(ref) or diff.max() > SKEW_STEP + 1e-6:
        bad.append("%s: %d of %d angles equal, max diff %.3g rad" % (
            label, same, len(ref), diff.max()))
    return bad, len(ref), same


def run_inspect_cli(cli, args, corpus, device):
    """main() of origami_tpu_torch.batch.<cli> in this process over
    `corpus` (--overwrite), its printout captured; every page's
    runtime.json entry must be COMPLETED. -> (the kernel launches it
    made, seconds, printout)."""
    import contextlib
    import importlib
    import io
    from origami_tpu_torch.batch.detect.flow import kernel_launches
    mod = importlib.import_module("origami_tpu_torch.batch." + cli)
    reset_launches()
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        stage = mod.main([*args, "--lock-strategy", "NONE", "--plain",
                          "--overwrite", "--device", str(device),
                          str(corpus)])
    _sync(device)
    seconds = time.time() - t0
    for png in sorted(corpus.glob("*.png")):
        entry = json.loads((corpus / (png.stem + ".out") / "runtime.json")
                           .read_text()).get(stage.processor_name, {})
        if entry.get("status") != "COMPLETED":
            raise PhaseError("%s on %s: %s" % (
                cli, png.name, entry.get("traceback", entry)))
    return ({k: v for k, v in kernel_launches().items() if v}, seconds,
            out.getvalue())


def check_renders(corpus, ref, device, failed):
    """Each render CLI cold (page caches emptied: one dewarp_u8 launch a
    page where it draws on the dewarped page, none elsewhere) and, where
    it dewarps, warm (no launch); each render's JPEG decoded against the
    JAX file's PIL decode by digest outside the label boxes grown by
    mcu_box, the dewarped page's file byte-equal to JAX's. -> (dewarp_u8
    launches of the cold runs, {CLI: seconds a page, cold})."""
    import hashlib
    from origami_tpu_torch.core import _image
    from origami_tpu_torch.core import page as page_cache
    pages = ref["pages"]
    launched, rates = 0, {}
    for cli, args, name, dewarped in INSPECT_RENDERS:
        label = " ".join((cli,) + args)
        page_cache.clear_caches()
        got, secs, _ = run_inspect_cli(cli, args, corpus, device)
        # the wrappers count launches on the card only
        want = {"dewarp_u8": len(pages)} \
            if dewarped and str(device) != "cpu" else {}
        launched += got.get("dewarp_u8", 0)
        warm = None
        if dewarped:
            warm, warm_secs, _ = run_inspect_cli(cli, args, corpus, device)
        same = 0
        for stem in pages:
            path = corpus / (stem + ".out") / name
            r = ref["renders"][stem][name]
            if "decoded" in r:
                ok = masked_digest(_image.read(path), r["grown"]) \
                    == r["decoded"]
            else:
                ok = hashlib.sha256(path.read_bytes()).hexdigest() \
                    == r["sha256"]
            if ok:
                same += 1
            else:
                failed.append("%s: %s of %s differs from JAX's outside "
                              "its %d grown label boxes" % (
                                  label, name, stem, len(r["boxes"])))
        if got != want:
            failed.append("%s: launches %s, expected %s (cold cache)"
                          % (label, got, want))
        if warm:
            failed.append("%s: launches %s with a warm page cache, "
                          "expected none" % (label, warm))
        rates[label] = secs / len(pages)
        log("  %-34s %d/%d pages equal to JAX outside the label boxes; "
            "launches cold %s%s; %.3f s a page cold%s" % (
                label, same, len(pages), json.dumps(got),
                ", warm %s" % json.dumps(warm) if dewarped else "",
                secs / len(pages),
                ", %.3f warm" % (warm_secs / len(pages)) if dewarped
                else ""))
    return launched, rates


def check_utilities(corpus, ref, device, failed, workdir):
    """thumbnail (byte-equal), signature and rtext against the JAX
    outputs; stats, reset and cleanup on planted files. -> {CLI: seconds
    a page}."""
    import hashlib
    import os
    pages = ref["pages"]
    rates = {}

    def run(cli, *args):
        got, secs, printed = run_inspect_cli(cli, args, corpus, device)
        if got:
            failed.append("%s: launches %s, expected none" % (cli, got))
        rates[cli] = secs / len(pages)
        return printed

    run("utils.thumbnail")
    run("utils.signature")
    run("utils.rtext", "-o", str(workdir / "rtext"))
    for stem in pages:
        out = corpus / (stem + ".out")
        if hashlib.sha256((out / "thumbnail.jpg").read_bytes()) \
                .hexdigest() != ref["thumbnail"][stem]["sha256"]:
            failed.append("thumbnail.jpg of %s differs from JAX's" % stem)
        pngs, text = signature_digests(out / "signature.zip")
        if pngs != ref["signature"][stem]["png"] \
                or text != ref["signature"][stem]["json"]:
            failed.append("signature.zip of %s differs from JAX's" % stem)
        if text_digests(workdir / "rtext" / stem) != ref["rtext"][stem]:
            failed.append("rtext of %s differs from JAX's" % stem)
    # planted: a FAILED stage, a temporary file and a broken JSON a page
    for stem in pages:
        out = corpus / (stem + ".out")
        rt = json.loads((out / "runtime.json").read_text())
        rt["origami_tpu.batch.detect.ocr"] = dict(
            status="FAILED", traceback="Traceback\nValueError: planted")
        (out / "runtime.json").write_text(json.dumps(rt))
        (out / "tmp1234").write_text("x")
        (out / "broken.json").write_text("{")
    cwd = os.getcwd()
    os.chdir(workdir)                  # stats writes errors.csv here
    try:
        printed = run("utils.stats", "--list-names", "--list-errors")
    finally:
        os.chdir(cwd)
    errors = (workdir / "errors.csv").read_text()
    if "ValueError: planted" not in printed or "2: synth0000.png" \
            not in printed or errors.count("planted") != 1:
        failed.append("stats did not report the planted failures:\n%s"
                      % printed[-600:])
    printed = run("utils.cleanup")
    if "removed 4 files, cleared 2 failure records." not in printed:
        failed.append("cleanup: %r" % printed.strip()[-200:])
    printed = run("utils.reset", "-a", "annotation/layout, thumbnail")
    left = [p for stem in pages for p in (corpus / (stem + ".out"))
            .glob("*") if p.name in ("annotation.layout.jpg",
                                     "thumbnail.jpg")]
    if "removed 4 artifacts." not in printed or left:
        failed.append("reset: %r, left %s" % (printed.strip()[-200:],
                                              left))
    log("  thumbnail, signature, rtext equal to JAX's; stats, cleanup "
        "and reset on the planted files ok; s a page: %s" % ", ".join(
            "%s %.3f" % kv for kv in rates.items()))
    return rates


def check_skew(ref, device, failed):
    """patch_skew_samples on the JAX binarized page (the fixture's 1-bit
    PNG), on the card, against the JAX function's samples."""
    import torch
    from origami_tpu_torch.core import _png
    from origami_tpu_torch.core.flow import patch_skew_samples
    mask = torch.from_numpy(
        _png.read(INSPECT_REF / ref["skew"]["mask"]) > 0).to(device)
    counts = []
    for patch in SKEW_PATCHES:
        t0 = time.time()
        got = skew_rows(patch_skew_samples(mask, patch=patch))
        secs = time.time() - t0
        bad, n, same = skew_errors(got, ref["skew"][str(patch)],
                                   "patch %d" % patch)
        failed += bad
        counts.append("patch %d: %d/%d tiles equal (%.3f s)"
                      % (patch, same, n, secs))
    log("  patch_skew_samples on the JAX binarized %s: %s" % (
        ref["skew"]["page"], "; ".join(counts)))


def check_inspection(workdir, device="cuda"):
    """Phase 17: the renders, the utilities and patch_skew_samples.
    -> the dewarp_u8 launches of the renders' cold runs."""
    ref = json.loads((INSPECT_REF / "inspect.json").read_text())
    corpus = inspect_corpus(workdir / "inspect")
    failed = []
    launched, _ = check_renders(corpus, ref, device, failed)
    check_utilities(corpus, ref, device, failed, workdir)
    check_skew(ref, device, failed)
    if failed:
        raise PhaseError("; ".join(failed))
    return launched


# ------------------------------------------------------------ phase 18

FLAGSHIP_REF = ROOT / "tests" / "data" / "torch_flagship"
# phase 18a: the flagship's label maps against JAX's, with SEG_MODES'
# bars (float32 with TF32 off, bf16)
FLAGSHIP_BARS = {"float32": SEG_MODES["students_f32"][2],
                 "bfloat16": SEG_MODES["students_bf16"][2]}
FLAGSHIP_PAGES = ("synth0000", "synth0001")
FLAGSHIP_REPS = 5
# phase 18c: the pages of the two-process segment run's corpus (copies
# of the fixture pages)
MULTIHOST_PAGES = 4


def flagship_graph(dtype, device):
    """build_flagship(batch=2) at full width with the nets' convolutions
    in `dtype` (REGION_NET and SEP_NET given it in the module's
    namespace, as scripts/make_torch_flagship_fixture.py does for JAX):
    (segment, (stack_a, stack_b, images)) with the random members."""
    from origami_tpu_torch.models import flagship
    saved = flagship.REGION_NET, flagship.SEP_NET
    flagship.REGION_NET = dict(saved[0], dtype=dtype)
    flagship.SEP_NET = dict(saved[1], dtype=dtype)
    try:
        return flagship.build_flagship(batch=2, device=device)
    finally:
        flagship.REGION_NET, flagship.SEP_NET = saved


def load_students(stack_a, stack_b):
    """The students' weights into every member of each stack."""
    from origami_tpu_torch.models import registry
    for group, stack in (("region", stack_a), ("separator", stack_b)):
        state = registry.load_model(ROOT / STUDENTS / group / "00",
                                    "cpu")[0].state_dict()
        for member in stack:
            member.load_state_dict(state)


def check_flagship(device, failed):
    """Phase 18a: the flagship graph with the students in all 5 members,
    float32 and bf16, on the fixture pages against JAX's label maps; the
    bf16 graph's warm ms a page, peak memory and top device ops; one page
    of the random-init graph as bench.py runs it."""
    import torch
    from origami_tpu_torch.core import _png
    ref = np.load(FLAGSHIP_REF / "labels.npz")
    pages = torch.from_numpy(np.stack([
        _png.read_gray(FIXTURE / (stem + ".png"))
        for stem in FLAGSHIP_PAGES]).astype(np.float32)).to(device)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        segment, (stack_a, stack_b, images) = flagship_graph(dtype, device)
        if dtype == torch.bfloat16:
            # the random-init graph on one of its own pages (bench.py
            # times batches of 4 the same way, the first call apart)
            one = images[:1]
            segment(stack_a, stack_b, one)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reg, sep = segment(stack_a, stack_b, one)
            torch.cuda.synchronize()
            log("  random-init graph, one %dx%d page: %.1f ms wall, maps "
                "%s and %s, %d region classes present" % (
                    images.shape[1], images.shape[2],
                    (time.perf_counter() - t0) * 1e3, tuple(reg.shape),
                    tuple(sep.shape), int(reg.unique().numel())))
        load_students(stack_a, stack_b)
        got = segment(stack_a, stack_b, pages)
        shares = {}
        for net, labels in zip(("regions", "separators"), got):
            want = ref["%s_%s" % (net, name)]
            labels = labels.cpu().numpy()
            if labels.shape != want.shape or labels.dtype != np.uint8:
                failed.append("flagship %s %s: %s %s, expected %s u8" % (
                    name, net, labels.dtype, labels.shape, want.shape))
                continue
            shares[net] = float((labels == want).mean())
            if shares[net] < FLAGSHIP_BARS[name]:
                failed.append("flagship %s %s: %.6f of the pixels equal to "
                              "JAX's, below %.3f" % (
                                  name, net, shares[net],
                                  FLAGSHIP_BARS[name]))
        log("  flagship %s, students x 5: equal pixels %s (gate %.3f)" % (
            name, json.dumps(shares), FLAGSHIP_BARS[name]))
    # the bf16 graph (the flagship as it ships) with the students
    torch.cuda.reset_peak_memory_stats()
    ms = time_cuda(lambda: segment(stack_a, stack_b, pages),
                   reps=FLAGSHIP_REPS)
    peak = torch.cuda.max_memory_allocated() / 2**20
    prof = profiled(lambda: segment(stack_a, stack_b, pages))
    log("  flagship bf16 warm: %.2f ms a page (CUDA events, median of %d "
        "calls of %d pages); peak device memory %.0f MiB; device time of "
        "a profiled call %s" % (
            ms / len(FLAGSHIP_PAGES), FLAGSHIP_REPS, len(FLAGSHIP_PAGES),
            peak, fmt_ms(_device_ms(prof))))
    log(prof.key_averages().table(sort_by="self_cuda_time_total",
                                  row_limit=10))
    return ms / len(FLAGSHIP_PAGES), peak


def check_sharded_predictor(device, failed):
    """Phase 18b: SegmentationPredictor over a mesh of every visible card
    against the unsharded predictor on 3 pages: equal maps."""
    import torch
    from origami_tpu_torch.core import _png
    from origami_tpu_torch.core.predict import SegmentationPredictor
    from origami_tpu_torch.parallel.mesh import make_mesh
    pages = [_png.read_gray(FIXTURE / (stem + ".png"))
             for stem in FLAGSHIP_PAGES] + [_png.read_gray(REAL_SCAN)]
    # every visible card (one "cpu" entry in a rehearsal on the CPU)
    mesh = make_mesh() if torch.device(device).type == "cuda" \
        else make_mesh([device])
    sharded = SegmentationPredictor(ROOT / STUDENTS, mesh=mesh)
    plain = SegmentationPredictor(ROOT / STUDENTS, device=device)
    got, want = sharded.predict_batch(pages), plain.predict_batch(pages)
    same = [all(np.array_equal(g.by_name(n).labels, w.by_name(n).labels)
                for n in ("regions", "separators"))
            for g, w in zip(got, want)]
    if len(got) != len(pages) or not all(same):
        failed.append("sharded predictor over %d cards: %d pages, equal "
                      "to the unsharded maps %s" % (
                          len(mesh.devices), len(got), same))
    log("  SegmentationPredictor over a mesh of %d card(s), %d pages (pads "
        "to %d): maps equal to mesh=None: %s" % (
            len(mesh.devices), len(pages),
            -(-len(pages) // len(mesh.devices)) * len(mesh.devices), same))


def multihost_corpus(dst, n_processes=2):
    """MULTIHOST_PAGES copies of the fixture pages, named as
    tests/test_multihost.py:44-52 names them (page000.png, ...), keeping
    only names that leave every process's hash share a page -> {name:
    (source stem, the process its hash names)}."""
    from origami_tpu_torch.parallel.multihost import stable_shard
    dst.mkdir()
    pages, i = {}, 0
    while len(pages) < MULTIHOST_PAGES:
        name = "page%03d.png" % i
        shard = stable_shard(dst / name, n_processes)
        missing = set(range(n_processes)) - {p for _, p in pages.values()}
        i += 1
        if MULTIHOST_PAGES - len(pages) <= len(missing) \
                and shard not in missing:
            continue
        stem = FLAGSHIP_PAGES[len(pages) % len(FLAGSHIP_PAGES)]
        pages[name] = (stem, shard)
        shutil.copy(FIXTURE / (stem + ".png"), dst / name)
    return pages


def check_multihost_segment(workdir, device, failed):
    """Phase 18c: two processes of the segment CLI (the students, bf16),
    joined through ORIGAMI_TPU_COORDINATOR, each on the card its process
    id names modulo the cards (one card: both on it): each page
    once, by its hashed process, each segment.zip at the students_bf16
    bar against the fixture's JAX one, sauvola_packed 1 a page summed
    over both. -> (sauvola_packed launches, {process: pages})."""
    import os
    import socket
    from origami_tpu_torch.core.segment import Segmentation
    corpus = workdir / "multihost"
    pages = multihost_corpus(corpus)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    launch = ("ORIGAMI_TPU_COORDINATOR", "ORIGAMI_TPU_NUM_PROCESSES",
              "ORIGAMI_TPU_PROCESS_ID", "MASTER_ADDR", "WORLD_SIZE",
              "RANK", "LOCAL_RANK")
    base = {k: v for k, v in os.environ.items() if k not in launch}
    procs = []
    t0 = time.time()
    for pid in range(2):
        env = dict(base, ORIGAMI_TPU_COORDINATOR="127.0.0.1:%d" % port,
                   ORIGAMI_TPU_NUM_PROCESSES="2",
                   ORIGAMI_TPU_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "origami_tpu_torch.batch.detect.segment",
             "-m", STUDENTS, "--plain", "--device", str(device),
             str(corpus)], cwd=str(ROOT),
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    wall = time.time() - t0
    for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise PhaseError("segment CLI, process %d of 2, exited %d:\n%s"
                             % (pid, p.returncode, err[-4000:]))
    assigned, done, launched = {}, [], 0
    for pid, (out, _) in enumerate(outs):
        for line in out.splitlines():
            if "pages assigned" in line:
                assigned[pid] = int(line.split(": ")[1].split()[0])
            elif line.startswith("["):
                done.append((pid, Path(line.split()[-1]).name))
            elif line.startswith('{"kernel_launches"'):
                launched += json.loads(line)["kernel_launches"].get(
                    "sauvola_packed", 0)
    if sorted(assigned) != [0, 1] or min(assigned.values()) == 0 \
            or sum(assigned.values()) != len(pages):
        failed.append("multihost: pages assigned %s of %d" % (
            assigned, len(pages)))
    if sorted(n for _, n in done) != sorted(pages) or any(
            pages[n][1] != pid for pid, n in done):
        failed.append("multihost: pages done (process, page) %s, hashed %s"
                      % (done, {n: p for n, (_, p) in pages.items()}))
    bar = SEG_MODES["students_bf16"][2]
    low = {}
    for name, (stem, _) in pages.items():
        got = Segmentation.open(corpus / (Path(name).stem + ".out")
                                / "segment.zip")
        ref = Segmentation.open(FIXTURE / (stem + ".out") / "segment.zip")
        for net in ("regions", "separators"):
            a, b = got.by_name(net).labels, ref.by_name(net).labels
            share = float((a == b).mean()) if a.shape == b.shape else 0.0
            if share < bar:
                low["%s %s" % (name, net)] = share
    if low:
        failed.append("multihost: equal pixels below %.3f: %s" % (bar, low))
    if launched != len(pages):
        failed.append("multihost: sauvola_packed launches %d, expected %d"
                      % (launched, len(pages)))
    import torch
    cards = min(2, torch.cuda.device_count()) \
        if torch.device(device).type == "cuda" else 0
    log("  two segment processes on %d card(s): assigned %s, done %s, "
        "sauvola_packed %d for %d pages, every map at the students_bf16 "
        "bar: %s; %.1f s wall" % (
            cards, json.dumps(assigned), done, launched, len(pages),
            not low, wall))
    return launched, assigned


def check_scale_out(workdir, device="cuda"):
    """Phase 18: the flagship graph, the sharded predictor, two segment
    processes on the card and the dry run. -> (sauvola_packed launches
    of the two-process run, the flagship's warm ms a page, its peak
    MiB)."""
    import torch
    from origami_tpu_torch.parallel.dryrun import dryrun_multichip
    failed = []
    ms, peak = check_flagship(device, failed)
    check_sharded_predictor(device, failed)
    launched, _ = check_multihost_segment(workdir, device, failed)
    t0 = time.time()
    n = torch.cuda.device_count() if torch.device(device).type == "cuda" \
        else 1
    dryrun_multichip(n, device)
    log("  dryrun_multichip(%d): ok (%.1f s)" % (n, time.time() - t0))
    if failed:
        raise PhaseError("; ".join(failed))
    return launched, ms, peak


# ------------------------------------------------------------ phase 19

# phase 19a: the mesh trainers against phase 14b's JAX numbers, at its
# bars: (run, mesh entries, model_parallel). The U-Nets on a model axis
# of 2 (one page a step runs on its group's first device; every split
# leaf and its moments rest in two halves), the recognizer's 8 strips a
# step over data axes of 2 and 4
MESH_PARITY = (("segment_region", 2, 2), ("segment_separator", 2, 2),
               ("distill_region", 2, 2), ("recognizer", 2, 1),
               ("recognizer", 4, 1))
# phase 19b: the region trainer from the shipped student's weights,
# float32, warp on (WARP_AMPLITUDE, seed 5), 2 pages a step on a 2 x 2
# mesh against the one-device trainer, at phase 14b's bars: each page is
# its group's block, so remap_batch launches exactly MESH_WARP_LAUNCHES a
# step on the mesh
MESH_WARP_PAGES = ([0, 1], [2, 3], [1, 2])
MESH_WARP_LAUNCHES = 2


def mesh_devices(n, device="cuda"):
    """n mesh entries over the visible cards in turn: every entry
    "cuda:0" on one card (the code paths, not the speed of a mesh);
    "cpu" entries in a rehearsal on the CPU."""
    import torch
    if torch.device(device).type == "cpu":
        return ["cpu"] * n
    cards = torch.cuda.device_count()
    return ["cuda:%d" % (i % cards) for i in range(n)]


def check_mesh_parity(workdir, device="cuda"):
    """Phase 19a: each MESH_PARITY run against the JAX trainer's numbers
    at parity_verdict's bars."""
    from origami_tpu_torch.parallel.mesh import make_mesh
    corpus = train_corpus(workdir / "mesh_parity")
    failed = []
    for name, n, m in MESH_PARITY:
        t0 = time.time()
        mesh = make_mesh(mesh_devices(n, device), model_parallel=m)
        losses, norms = port_parity_run(name, corpus, device, mesh)
        err = parity_verdict(name, losses, norms, t0,
                             label="mesh %d x %d" % (n // m, m))
        if err:
            failed.append(err)
    if failed:
        raise PhaseError("; ".join(failed))


def mesh_warp_run(images, labels, cfg, state, mesh):
    """MESH_WARP_PAGES through SegmentationTrainer on `mesh` from `state`,
    float32, warp on: -> dict(losses, norms (leaf norms after each
    step), launches (remap_batch a step), ms (the mean host ms of steps
    1-2, each ending in a synchronize of every card), peak_mib ({card:
    peak allocated MiB}))."""
    import torch
    from origami_tpu_torch.models import registry
    from origami_tpu_torch.ops import remap
    from origami_tpu_torch.train.segment.train import SegmentationTrainer
    tr = SegmentationTrainer(cfg, mesh=mesh, dtype=torch.float32)
    tr.load_state_dict(state)
    tr.attach_dataset(images, labels, warp_amplitude=WARP_AMPLITUDE, seed=5)
    cards = sorted({d for d in mesh.devices if d.type == "cuda"}, key=str)

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)

    sync()
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    out = dict(losses=[], norms=[], launches=[], times=[])
    for idx in MESH_WARP_PAGES:
        before = remap.launches["remap_batch"]
        t0 = time.time()
        loss = tr.train_on_indices(idx)
        sync()
        out["times"].append((time.time() - t0) * 1e3)
        out["launches"].append(remap.launches["remap_batch"] - before)
        out["losses"].append(float(loss))
        out["norms"].append(leaf_norms(registry.flax_params(
            tr.model, tr.state_dict())))
    out["ms"] = statistics.mean(out["times"][1:])
    out["peak_mib"] = {str(d): torch.cuda.max_memory_allocated(d) / 2 ** 20
                       for d in cards}
    return out


def check_mesh_warp(workdir, device="cuda"):
    """Phase 19b: the region trainer on a 2 x 2 mesh against the
    one-device trainer (MESH_WARP_PAGES); the launch counts set to 0
    just before the mesh run and read just after. -> remap_batch's
    launches in the mesh run."""
    from origami_tpu_torch.models import registry
    from origami_tpu_torch.parallel.mesh import make_mesh
    from origami_tpu_torch.train import bootstrap
    from origami_tpu_torch.train.segment.data import class_weights
    from origami_tpu_torch.train.segment.train import TrainConfig
    run = PARITY_RUNS["segment_region"]
    tree, meta = registry.load_params(ROOT / run["start"])
    images, labels, _ = bootstrap.load_corpus_arrays(
        train_corpus(workdir / "mesh_warp"), "region", TRAIN_FULL)
    cfg = TrainConfig(
        num_classes=4, width=meta["width"], s2d=meta["s2d"],
        tile_hw=(TRAIN_FULL[1], TRAIN_FULL[0]),
        learning_rate=run["learning_rate"], steps=PARITY_STEPS,
        warmup=PARITY_WARMUP, class_weights=class_weights(list(labels), 4))
    state = registry.unet_params_from_flax(tree, meta)
    one = mesh_warp_run(images, labels, cfg, state,
                        make_mesh(mesh_devices(1, device)))
    reset_launches()
    mesh = mesh_warp_run(images, labels, cfg, state, make_mesh(
        mesh_devices(4, device), model_parallel=2))
    launched = sum(mesh["launches"])
    loss_err = [abs(a - b) / abs(b)
                for a, b in zip(mesh["losses"], one["losses"])]
    norm_err, worst = 0.0, None
    for got, want in zip(mesh["norms"], one["norms"]):
        for k, w in want.items():
            e = abs(got[k] - w) / max(abs(w), 1e-30)
            if e > norm_err:
                norm_err, worst = e, k
    steps = len(MESH_WARP_PAGES)
    ok = loss_err[0] <= PARITY_FIRST and max(loss_err) <= PARITY_LATER \
        and norm_err <= PARITY_LATER \
        and mesh["launches"] == [MESH_WARP_LAUNCHES] * steps \
        and one["launches"] == [1] * steps
    for name, r in (("1 x 1", one), ("2 x 2", mesh)):
        log("  region trainer, warp on, %s mesh: losses %s; remap_batch "
            "launches a step %s; %.1f ms a step (steps 1-2), peak %s MiB"
            % (name, ["%.6f" % v for v in r["losses"]], r["launches"],
               r["ms"], ", ".join("%s %.0f" % kv
                                  for kv in r["peak_mib"].items())))
    log("  2 x 2 against 1 x 1: losses relative %s (first <= %g, later <= "
        "%g); leaf norms worst %.2e (%s); %d remap_batch launches in the "
        "mesh run  %s" % (["%.1e" % e for e in loss_err], PARITY_FIRST,
                          PARITY_LATER, norm_err, worst, launched,
                          "ok" if ok else "FAIL"))
    if not ok:
        raise PhaseError("mesh warp run: loss errors %s, leaf norm %.2e at "
                         "%s, remap_batch launches a step %s (1 x 1: %s)"
                         % (loss_err, norm_err, worst, mesh["launches"],
                            one["launches"]))
    return launched


def check_mesh_training(workdir, device="cuda"):
    """Phase 19: 19a, 19b, and (19c) dryrun_multichip over the visible
    cards with its training half. -> remap_batch's launches in 19b's
    mesh run."""
    import torch
    from origami_tpu_torch.parallel.dryrun import dryrun_multichip
    check_mesh_parity(workdir, device)
    launched = check_mesh_warp(workdir, device)
    t0 = time.time()
    n = torch.cuda.device_count() if torch.device(device).type == "cuda" \
        else 1
    dryrun_multichip(n, device)
    log("  dryrun_multichip(%d) with its training half: ok (%.1f s)"
        % (n, time.time() - t0))
    return launched


# ------------------------------------------------------------ phase 20
# The operator tools (origami_tpu_torch/tool) and the remote runner
# (batch/remote) on a copy of the OCR fixture pages (their reliable
# artifacts and grids), held against the JAX tools' outputs in
# tests/data/torch_tools (scripts/make_torch_tools_fixture.py): the
# sampled rows, the harmonized texts, the exported names, texts and
# sets.json equal; the strips within TOOLS_GRAY gray levels, the
# binarized strips equal on TOOLS_BIN_EQUAL of their pixels (ROADMAP
# C10); the web tools' JSON bodies equal, their JPEG bodies byte-equal
# and annotate_web's strip the array the JAX tool hands its encoder.
TOOLS_REF = ROOT / "tests" / "data" / "torch_tools"
TOOLS_PER_TYPE = 2
TOOLS_SEED = 0
TOOLS_HEIGHT = 48
TOOLS_BINARIZE = "sauvola"
TOOLS_GRAY = 1
TOOLS_BIN_EQUAL = 0.999
WEB_JSON_INLINE = 2000
# the page the remote runner pulls through the ssh/scp shims
REMOTE_PAGE = "synth0000"
# shell shims for the remote runner: `ssh HOST CMD` runs CMD here, `scp`
# copies with cp and drops the HOST: prefixes
SSH_SHIM = '#!/bin/sh\nshift\nexec sh -c "$*"\n'
SCP_SHIM = ('#!/bin/sh\nargs=""\nfor a in "$@"; do case "$a" in\n'
            '  -q) ;;\n  -r) ;;\n  *:*) args="$args ${a#*:}" ;;\n'
            '  *) args="$args $a" ;;\nesac; done\nexec cp -r $args\n')


def tools_corpus(dst):
    """The OCR fixture pages with their artifacts (tests/data/torch_ocr/
    full: segment.zip, dewarp.zip, contours.3.zip, lines.3.zip,
    tables.json, runtime.json)."""
    dst.mkdir(parents=True)
    for png in sorted(FIXTURE.glob("*.png")):
        shutil.copy(png, dst / png.name)
        shutil.copytree(FIXTURE / (png.stem + ".out"),
                        dst / (png.stem + ".out"))
    return dst


def tools_pages(corpus):
    return sorted(corpus.glob("*.png"))


def db_rows(db_path, corpus):
    """The annotation DB's rows in their order, page paths relative to
    the corpus."""
    import sqlite3
    conn = sqlite3.connect(str(db_path))
    try:
        rows = conn.execute(
            "SELECT page_path, line_path, annotation, author, training, "
            "validation FROM lines ORDER BY rowid").fetchall()
    finally:
        conn.close()
    return [[str(Path(r[0]).relative_to(corpus))] + list(r[1:])
            for r in rows]


def db_schema(db_path):
    """PRAGMA table_info of the lines table."""
    import sqlite3
    conn = sqlite3.connect(str(db_path))
    try:
        return [list(r) for r in conn.execute("PRAGMA table_info(lines)")]
    finally:
        conn.close()


def exported(out):
    """-> (names of the PNGs, {text file: text}, sets.json's object)."""
    names = sorted(p.stem for p in out.glob("*.png"))
    texts = {p.name: p.read_text() for p in sorted(out.glob("*.gt.txt"))}
    return names, texts, json.loads((out / "sets.json").read_text())


def placeholder(text, corpus):
    """`text` with the corpus's path written as {corpus}."""
    return text.replace(str(corpus), "{corpus}")


def web_routes(tool, corpus, line):
    """[(method, route, JSON body or None)] that drive every route of
    `tool`, in order; `line` is (page path, line path) of a sampled
    row."""
    from urllib.parse import quote
    pages = [str(p) for p in tools_pages(corpus)]
    q = ["page=" + quote(p) for p in pages]
    page, path = line
    if tool == "annotate_web":
        strip = "/strip?page=%s&line=%s" % (quote(page), quote(path))
        return [("GET", "/", None), ("GET", "/lines", None),
                ("GET", "/lines?only_blank=1", None), ("GET", strip, None),
                ("GET", "/strip?page=%s&line=x/y" % quote(page), None),
                ("POST", "/save", dict(page=page, line=path,
                                       text="edited line")),
                ("POST", "/save", dict(page=page, line="regions/NEW/0",
                                       text="")),
                ("GET", "/lines?only_blank=1", None),
                ("GET", "/nowhere", None)]
    if tool == "pick_web":
        return [("GET", "/", None), ("GET", "/pages", None)] + [
            ("GET", "/lines?" + x, None) for x in q] + [
            ("GET", "/image?" + x, None) for x in q] + [
            ("GET", "/image?" + q[0], None),
            ("POST", "/toggle", dict(page=page, line=path, picked=False)),
            ("POST", "/toggle", dict(page=pages[1], line=path,
                                     picked=True)),
            ("GET", "/lines?" + q[0], None), ("POST", "/nowhere", {})]
    if tool == "cluster_web":
        return [("GET", "/", None), ("GET", "/clusters", None),
                ("GET", "/thumb?" + q[0], None),
                ("GET", "/image?" + q[1], None),
                ("GET", "/thumb?page=elsewhere.png", None)]
    if tool == "xycut_web":
        return [("GET", "/", None), ("GET", "/pages", None)] + [
            ("GET", "/tree?" + x, None) for x in q] + [
            ("GET", "/image?" + q[1], None), ("GET", "/nowhere", None)]
    raise ValueError(tool)


def drive_web(handler, routes, on_response=None):
    """Serve `handler` on 127.0.0.1, port 0, in a thread and request
    `routes` in order -> [(status, content type, body bytes)].
    on_response(i) runs after the i-th response."""
    import threading
    import urllib.error
    import urllib.request
    from http.server import HTTPServer
    server = HTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://127.0.0.1:%d" % server.server_address[1]
    out = []
    try:
        for i, (method, route, body) in enumerate(routes):
            data = None if body is None else json.dumps(body).encode()
            req = urllib.request.Request(base + route, data=data,
                                         method=method)
            if data is not None:
                req.add_header("Content-Type", "application/json")
            try:
                with urllib.request.urlopen(req, timeout=300) as r:
                    out.append((r.status, r.headers["Content-Type"],
                                r.read()))
            except urllib.error.HTTPError as e:
                out.append((e.code, e.headers["Content-Type"], e.read()))
            if on_response is not None:
                on_response(i)
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    return out


def web_record(responses, corpus):
    """JSON-comparable records of drive_web's responses: JSON and text
    bodies with the corpus path as {corpus} (a JSON body longer than
    WEB_JSON_INLINE characters by the digest of its sorted dump), HTML
    by digest, images by status and content type (web_tool_errors holds
    their bodies)."""
    rec = []
    for status, ctype, body in responses:
        if ctype.startswith("application/json"):
            value = json.loads(placeholder(body.decode("utf8"), corpus))
            text = json.dumps(value, sort_keys=True)
            if len(text) > WEB_JSON_INLINE:
                value = {"digest": digest(text)}
        elif ctype.startswith("text/html"):
            value = digest(body.decode("utf8"))
        elif ctype.startswith("text/plain"):
            value = placeholder(body.decode("utf8"), corpus)
        else:
            value = None
        rec.append([status, ctype.split(";")[0], value])
    return rec


@contextlib.contextmanager
def with_path(cmd_dir):
    """Put cmd_dir at the front of PATH for the block."""
    import os
    old = os.environ["PATH"]
    os.environ["PATH"] = str(cmd_dir) + os.pathsep + old
    try:
        yield
    finally:
        os.environ["PATH"] = old


def write_shims(bin_dir):
    bin_dir.mkdir(parents=True, exist_ok=True)
    for name, text in (("ssh", SSH_SHIM), ("scp", SCP_SHIM)):
        (bin_dir / name).write_text(text)
        (bin_dir / name).chmod(0o755)
    return bin_dir


def label_maps(segment_zip):
    """{member: decoded label map} of a segment.zip's PNGs, and its
    other members' bytes."""
    from origami_tpu_torch.core import _png
    out = {}
    with zipfile.ZipFile(segment_zip) as zf:
        for name in sorted(zf.namelist()):
            data = zf.read(name)
            out[name] = _png.decode_paletted(data)[0] \
                if name.endswith(".png") else data
    return out


def same_artifacts(a_out, b_out):
    """Differences between two .out folders' segment.zip label maps and
    contours.*.zip members."""
    bad = []
    a, b = label_maps(a_out / "segment.zip"), label_maps(
        b_out / "segment.zip")
    if a.keys() != b.keys() or any(
            not np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
            for k in a):
        bad.append("segment.zip")
    names = sorted(p.name for p in a_out.glob("contours.*.zip"))
    if not names or names != sorted(p.name for p in
                                    b_out.glob("contours.*.zip")):
        bad.append("contours files %s" % names)
    for name in names:
        if read_zip(a_out / name) != read_zip(b_out / name):
            bad.append(name)
    return bad


def check_remote(workdir, device="cuda"):
    """Phase 20c: `batch.remote -m heuristic` over one fixture page
    through ssh/scp shims at the front of PATH, against a direct run of
    the port's segment and contours stages on the same page; the task DB
    DONE and a second run that processes nothing. -> (launches of the
    remote run, seconds)."""
    import io
    import sqlite3
    from origami_tpu_torch.batch.remote import runner
    remote = workdir / "remote_host"
    remote.mkdir(parents=True)
    shutil.copy(FIXTURE / (REMOTE_PAGE + ".png"), remote)
    direct = workdir / "remote_direct"
    direct.mkdir()
    shutil.copy(FIXTURE / (REMOTE_PAGE + ".png"), direct)
    local = workdir / "remote_local"
    args = ["--host", "archive", "--remote-dir", str(remote),
            "--work-dir", str(local), "-m", "heuristic",
            "--device", str(device)]
    quiet = contextlib.redirect_stdout(io.StringIO())
    with with_path(write_shims(workdir / "shims")), quiet:
        reset_launches()
        t0 = time.time()
        n = runner.main(args)
        _sync(device)
        seconds = time.time() - t0
        launched = {k: v for k, v in launch_counts().items() if v}
        again = runner.main(args)
        for stage in runner.remote_stages("heuristic", device):
            stage.traverse(direct)
    conn = sqlite3.connect(str(local / "remote.tasks.db"))
    tasks = conn.execute("SELECT remote_path, status FROM tasks").fetchall()
    conn.close()
    bad = same_artifacts(remote / (REMOTE_PAGE + ".out"),
                         direct / (REMOTE_PAGE + ".out"))
    if n != 1 or again != 0 or tasks != [(REMOTE_PAGE + ".png", "DONE")]:
        bad.append("processed %d then %d pages, tasks %s" % (n, again,
                                                             tasks))
    want = {"sauvola": 1, "sauvola_packed": 1} \
        if str(device) != "cpu" else {}
    if launched != want:
        bad.append("launches %s, expected %s" % (launched, want))
    log("  (c) remote -m heuristic through the ssh/scp shims: %d page "
        "pushed back, segment.zip label maps and contours.*.zip equal to "
        "the direct run; tasks %s; second run %d pages; launches %s; "
        "%.2f s  %s" % (n, tasks, again, json.dumps(launched), seconds,
                        "ok" if not bad else "FAIL " + "; ".join(bad)))
    if bad:
        raise PhaseError("remote runner: %s" % "; ".join(bad))
    return launched, seconds


def tools_chain(corpus, work, ref, device):
    """Phase 20a: sample -> annotate set (the fixture's raw texts, two
    rows' split flags) -> harmonize default -> export at TOOLS_HEIGHT,
    plain and --binarize -> annotate export-image, each through its
    CLI's main() on `device`; the launch counts set to 0 just before
    each export and read just after. -> dict of what they wrote."""
    import io
    from origami_tpu_torch.core import _png
    from origami_tpu_torch.core import page as page_cache
    from origami_tpu_torch.tool import annotate, export, harmonize, sample
    from origami_tpu_torch.tool.lineload import AnnotationDB
    db = work / "annotations.db"
    dev = ["--device", str(device)]
    quiet = contextlib.redirect_stdout(io.StringIO())
    out = {}
    with quiet:
        sample.main([str(corpus), "--db-path", str(db), "--per-type",
                     str(TOOLS_PER_TYPE), "--seed", str(TOOLS_SEED),
                     "--plain"] + dev)
    out["rows"] = db_rows(db, corpus)
    out["schema"] = db_schema(db)
    with quiet:
        for page, line, *_ in out["rows"]:
            key = page + ":" + line
            annotate.main(["set", "--db-path", str(db), "--page",
                           str(corpus / page), "--line", line, "--text",
                           ref["raw_texts"][key]] + dev)
    for key, (training, validation) in ref["splits"].items():
        page, line = key.split(":")
        AnnotationDB(db).set_split(corpus / page, line, training,
                                   validation)
    with quiet:
        harmonize.main(["default", "--db-path", str(db)] + dev)
    out["harmonized"] = db_rows(db, corpus)
    page_cache.clear_caches()
    for name, extra in (("export", []),
                        ("export_bin", ["--binarize", TOOLS_BINARIZE])):
        reset_launches()
        t0 = time.time()
        with quiet:
            export.main(["--db-path", str(db), "-o", str(work / name),
                         "--line-height", str(TOOLS_HEIGHT)] + extra + dev)
        _sync(device)
        out[name + "_s"] = time.time() - t0
        out[name + "_launches"] = {k: v for k, v in launch_counts().items()
                                   if v}
        names, texts, sets = exported(work / name)
        out[name] = dict(names=names, texts=texts, sets=sets)
        out[name + "_strips"] = {
            n: _png.read(work / name / (n + ".png")) for n in names}
    page, line = out["rows"][0][:2]
    with quiet:
        annotate.main(["export-image", "--db-path", str(db), "--page",
                       str(corpus / page), "--line", line, "-o",
                       str(work / "line.png"), "--line-height",
                       str(TOOLS_HEIGHT)] + dev)
    out["export_image"] = _png.read(work / "line.png")
    out["db"] = db
    return out


def tools_strips():
    """The JAX strips of tests/data/torch_tools/strips.npz, by name
    (strip/<name>, bin/<name>): the file holds each strip's row
    differences modulo 256, which deflate better."""
    with np.load(TOOLS_REF / "strips.npz") as z:
        return {k: np.cumsum(z[k], axis=0, dtype=np.uint8)
                for k in z.files}


def strip_errors(got, ref_npz, prefix, bar_gray=None, bar_equal=None):
    """Strips against the JAX ones: shapes equal, then within bar_gray
    gray levels or equal on bar_equal of their pixels -> (failures,
    worst gray difference or least equal share)."""
    bad, worst = [], (0 if bar_gray is not None else 1.0)
    for name, px in got.items():
        want = ref_npz[prefix + name]
        if want.shape != px.shape:
            bad.append("%s shape %s against %s" % (name, px.shape,
                                                   want.shape))
            continue
        if bar_gray is not None:
            d = int(np.abs(want.astype(int) - px).max()) if px.size else 0
            worst = max(worst, d)
            if d > bar_gray:
                bad.append("%s: %d gray levels" % (name, d))
        else:
            same = float((want == px).mean()) if px.size else 1.0
            worst = min(worst, same)
            if same < bar_equal:
                bad.append("%s: %.5f of the pixels equal" % (name, same))
    return bad, worst


def plain_strip_errors(corpus, out):
    """Phase 20a on the card: each exported strip against the same line
    through the plain versions on the CPU (dewarp, remap_batch, Sauvola):
    equal."""
    from origami_tpu_torch.core.binarize import from_string
    from origami_tpu_torch.tool.lineload import load_line_image
    binarize = from_string(TOOLS_BINARIZE, device="cpu")
    bad = []
    for page, line, *_ in out["harmonized"]:
        name = Path(page).stem + "-" + line.replace("/", "-")
        plain = load_line_image(corpus / page, line, TOOLS_HEIGHT,
                                device="cpu")
        if not np.array_equal(plain, out["export_strips"][name]):
            bad.append("strip %s differs from its plain version" % name)
        if not np.array_equal(binarize(plain),
                              out["export_bin_strips"][name]):
            bad.append("binarized strip %s differs from its plain "
                       "version" % name)
    return bad


def check_tool_chain(corpus, work, ref, device):
    """Phase 20a's gates. -> the launch counts of the two exports."""
    out = tools_chain(corpus, work, ref, device)
    n = len(out["rows"])
    bad = []
    for key in ("rows", "harmonized", "schema"):
        if out[key] != ref[key]:
            bad.append("%s differ from JAX's" % key)
    for key in ("export", "export_bin"):
        if out[key] != ref[key]:
            bad.append("%s names, texts or sets.json differ from JAX's"
                       % key)
    strips = tools_strips()
    b, gray = strip_errors(out["export_strips"], strips, "strip/",
                           bar_gray=TOOLS_GRAY)
    bad += b
    b, equal = strip_errors(out["export_bin_strips"], strips, "bin/",
                            bar_equal=TOOLS_BIN_EQUAL)
    bad += b
    b, _ = strip_errors({ref["export_image"]: out["export_image"]}, strips,
                        "strip/", bar_gray=TOOLS_GRAY)
    bad += b
    on_card = str(device) != "cpu"
    if on_card:
        bad += plain_strip_errors(corpus, out)
    want = {"export": {"remap_batch": n}, "export_bin": {
        "remap_batch": n, "sauvola": n}} if on_card else {}
    for key in ("export", "export_bin"):
        got = {k: v for k, v in out[key + "_launches"].items()
               if k in ("remap_batch", "sauvola")}
        if on_card and got != want[key]:
            bad.append("%s launches %s, expected %s" % (key, got,
                                                        want[key]))
    log("  (a) sample (%d rows), annotate set, harmonize, export and "
        "export --binarize %s (%d lines each), annotate export-image: "
        "rows, texts and sets.json equal to JAX's; strips max %d gray "
        "level (bar %d), binarized strips >= %.5f equal (bar %.3f)%s; "
        "launches %s (cold page cache) and %s; %.2f s and %.2f s  %s" % (
            n, TOOLS_BINARIZE, len(out["export"]["names"]), gray,
            TOOLS_GRAY, equal, TOOLS_BIN_EQUAL,
            "; each equal to its plain version" if on_card else "",
            json.dumps(out["export_launches"]),
            json.dumps(out["export_bin_launches"]), out["export_s"],
            out["export_bin_s"],
            "ok" if not bad else "FAIL " + "; ".join(bad)))
    if bad:
        raise PhaseError("tools: %s" % "; ".join(bad))
    return out


def write_signatures(corpus, device):
    """utils.signature over the corpus (cluster_web reads it)."""
    import io
    from origami_tpu_torch.batch.utils.signature import main as signature
    with contextlib.redirect_stdout(io.StringIO()):
        signature([str(corpus), "--lock-strategy", "NONE", "--plain",
                   "--device", str(device)])


def tool_db(work, db, tool):
    """A copy of the chain's DB for one web tool: each tool starts from
    the DB phase 20a left."""
    copy = work / ("%s.db" % tool)
    shutil.copy(db, copy)
    return copy


def port_web_handler(tool, corpus, db, device):
    from origami_tpu_torch.tool import (annotate_web, cluster_web, pick_web,
                                        xycut_web)
    pages = tools_pages(corpus)
    if tool == "annotate_web":
        return annotate_web.make_handler(str(db), TOOLS_HEIGHT, device)
    if tool == "pick_web":
        return pick_web.make_handler(str(db), pages, "reliable", device)
    if tool == "cluster_web":
        return cluster_web.make_handler(
            cluster_web.compute_clusters(corpus, 8))
    return xycut_web.make_handler(pages, "reliable", 0.005, device)


WEB_TOOLS = ("annotate_web", "pick_web", "cluster_web", "xycut_web")


def web_tool_errors(tool, corpus, work, ref, rows, device):
    """Phase 20b for one web tool: served on port 0 over a copy of the
    chain's DB and driven through every route (web_routes); JSON and text
    bodies equal to JAX's, JPEG bodies byte-equal to JAX's (by sha256),
    annotate_web's PNG strip within TOOLS_GRAY gray levels of the array
    JAX encodes; pick_web's /image one dewarp_u8 launch a page cold and
    none warm. -> (failures, a note, dewarp_u8 launches of the cold
    /image requests)."""
    import hashlib
    from origami_tpu_torch.core import _png
    from origami_tpu_torch.core import page as page_cache
    pages = tools_pages(corpus)
    line = (str(corpus / rows[0][0]), rows[0][1])
    routes = web_routes(tool, corpus, line)
    counts, bad, launched = [], [], 0

    def count_dewarps(i):
        counts.append(launch_counts().get("dewarp_u8", 0))
        reset_launches()

    page_cache.clear_caches()
    handler = port_web_handler(tool, corpus,
                               tool_db(work, work / "annotations.db", tool),
                               device)
    t0 = time.time()
    reset_launches()
    got = drive_web(handler, routes, count_dewarps)
    note = "%s %d routes %.2f s" % (tool, len(routes), time.time() - t0)
    want = ref["web"][tool]
    rec = web_record(got, corpus)
    for i, ((method, route, _), r, w) in enumerate(zip(
            routes, rec, want["records"])):
        if r != w:
            bad.append("%s %s %s: %s against JAX's %s" % (
                tool, method, placeholder(route, corpus), str(r)[:200],
                str(w)[:200]))
        key = str(i)
        if key in want["bodies"]:
            if hashlib.sha256(got[i][2]).hexdigest() != want["bodies"][key]:
                bad.append("%s %s: the JPEG body differs from JAX's" % (
                    tool, placeholder(route, corpus)))
        elif key in want["images"]:
            b, _ = strip_errors({want["images"][key]: _png.decode(
                got[i][2])}, tools_strips(), "strip/", bar_gray=TOOLS_GRAY)
            bad += ["%s %s" % (tool, e) for e in b]
    if len(rec) != len(want["records"]):
        bad.append("%s: %d responses, JAX %d" % (tool, len(rec),
                                                 len(want["records"])))
    if tool == "pick_web" and str(device) != "cpu":
        image = [counts[i] for i, (_, r, _) in enumerate(routes)
                 if r.startswith("/image")]
        launched = sum(image[:len(pages)])
        if image != [1] * len(pages) + [0]:
            bad.append("pick_web /image dewarp_u8 launches %s, expected 1 "
                       "a page cold, 0 warm" % image)
        note += ", /image dewarp_u8 %s" % image
    return bad, note, launched


def check_web_tools(corpus, work, ref, out, device):
    """Phase 20b: web_tool_errors for each web tool. -> dewarp_u8
    launches of pick_web's cold /image requests."""
    write_signatures(corpus, device)
    bad, notes, launched = [], [], 0
    for tool in WEB_TOOLS:
        b, note, n = web_tool_errors(tool, corpus, work, ref, out["rows"],
                                     device)
        bad += b
        notes.append(note)
        launched += n
    log("  (b) the web tools on port 0, every route: JSON bodies equal to "
        "JAX's, JPEG bodies byte-equal to JAX's; %s  %s" % (
            "; ".join(notes), "ok" if not bad else "FAIL " + "; ".join(
                bad)))
    if bad:
        raise PhaseError("web tools: %s" % "; ".join(bad))
    return launched


def check_cli_printouts(corpus, ref, device):
    """xycut and cluster print what the JAX CLIs print."""
    import io
    from origami_tpu_torch.tool import cluster, xycut
    bad = []
    for page in tools_pages(corpus):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            xycut.main([str(page), "--device", str(device)])
        if buf.getvalue() != ref["xycut"][page.stem]:
            bad.append("xycut of %s" % page.stem)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cluster.main([str(corpus), "-k", "2", "--device", str(device)])
    if placeholder(buf.getvalue(), corpus) != ref["cluster"]:
        bad.append("cluster")
    return bad


def check_tools(workdir, device="cuda"):
    """Phase 20: (a) the sample -> harmonize -> export chain and annotate
    export-image, (b) the web tools, xycut and cluster, (c) the remote
    runner. -> ({kernel: {path: launches}}, seconds)."""
    t0 = time.time()
    ref = json.loads((TOOLS_REF / "tools.json").read_text())
    work = workdir / "tools"
    corpus = tools_corpus(work / "corpus")
    out = check_tool_chain(corpus, work, ref, device)
    web = check_web_tools(corpus, work, ref, out, device)
    bad = check_cli_printouts(corpus, ref, device)
    log("  xycut and cluster printouts equal to JAX's  %s" % (
        "ok" if not bad else "FAIL " + "; ".join(bad)))
    if bad:
        raise PhaseError("tool printouts: %s" % "; ".join(bad))
    remote, _ = check_remote(work, device)
    by_path = {
        "remap_batch": {"tools export": out["export_launches"].get(
            "remap_batch", 0)},
        "sauvola": {"tools export --binarize": out[
            "export_bin_launches"].get("sauvola", 0),
            "remote": remote.get("sauvola", 0)},
        "sauvola_packed": {"remote": remote.get("sauvola_packed", 0)},
        "dewarp_u8": {"pick_web": web},
    }
    return by_path, time.time() - t0


# ---------------------------------------------------------------- phase 21

FORMATS_REF = ROOT / "tests" / "data" / "torch_formats"
FORMATS_PAGES = ("synth0000", "synth0001")
# page files timed in phase 21c, each beside the PNG of its pixels
FORMATS_TIMED = ("synth0000.jpg", "synth0001.jpg",
                 "synth0000.progressive.jpg", "synth0001.g4.tif")
DECODE_REPS = 5


def parity_phase(rel):
    """The phase whose decode parity checks a manifest entry: 25 the
    old-style JPEG, YCbCr, old-style LZW and 12-bit TIFF files of tiff/
    and the old-style JPEG pages, 24 the lossless and arithmetic JPEG,
    BigTIFF, planar, CMYK, float, signed and associated-alpha TIFF and BMP
    files of more/ and the lossless pages, 22 JPEG 2000 files and TIFFs of
    JPEG strips, 21 the rest."""
    name = rel.rsplit("/", 1)[-1]
    if rel.startswith("tiff/") or name.endswith(OJPEG):
        return 25
    if rel.startswith("more/") or name.endswith(".lossless.jpg"):
        return 24
    if name.endswith((".jp2", ".j2k", ".jpeg.tif")) or \
            name.startswith(("tiff-jpeg", "tiff-old-jpeg", "old-style-JPEG")):
        return 22
    return 21


def check_decode_parity(phase=21):
    """Phase 21 (a), 22 (a) for the JPEG 2000 and JPEG-in-TIFF files, or
    24 (a) for the kinds of more/ and the lossless pages: each file of
    tests/data/torch_formats through core/_image.py: PIL's pixels (by
    digest) and size, or the ValueError that names a kind PIL or the
    port does not read. -> files checked."""
    import hashlib
    from origami_tpu_torch.core import _image
    manifest = {k: v for k, v in json.loads(
        (FORMATS_REF / "manifest.json").read_text()).items()
        if parity_phase(k) == phase}
    bad, kinds = [], {}
    for rel, want in sorted(manifest.items()):
        path = FORMATS_REF / rel
        kind = path.suffix
        kinds[kind] = kinds.get(kind, 0) + 1
        if "raises" in want:
            try:
                _image.read_gray(path)
            except ValueError as e:
                if want["raises"] not in str(e):
                    bad.append("%s: %s" % (rel, e))
            else:
                bad.append("%s: read, expected a ValueError naming %s"
                           % (rel, want["raises"]))
            continue
        px = _image.read_gray(path)
        got = hashlib.sha256(np.ascontiguousarray(px).tobytes()).hexdigest()
        size = list(_image.read_size(path))
        if got != want["sha256"] or size != want["size"] \
                or [px.shape[1], px.shape[0]] != want["size"]:
            bad.append("%s: size %s, pixels %s" % (
                rel, size, "equal" if got == want["sha256"] else "DIFFER"))
    log("  decode parity: %d files (%s) against PIL's digests and sizes: "
        "%d differ  %s" % (len(manifest), ", ".join(
            "%d %s" % (v, k) for k, v in sorted(kinds.items())), len(bad),
            "ok" if not bad else "FAIL " + "; ".join(bad[:10])))
    if bad:
        raise PhaseError("decode parity: %s" % "; ".join(bad[:10]))
    return len(manifest)


def check_jpeg_chain(workdir, device="cuda", suffix=".jpg", kind="JPEG",
                     ref_dir=FORMATS_REF / "chain", as_suffix=None,
                     ref_pages=None):
    """Phase 21 (b), 22 (b) with `suffix` ".jp2", or 24 (b) with
    ".lossless.jpg": the two fixture pages in that format (copied as
    `as_suffix`, where given) through PipelinedRunner on the main path
    (the students in bf16, banded strips), the launch counts set to 0
    just before the run and read just after it: every page COMPLETED in
    every stage, each kernel's launches per page as WHOLE_CHAIN_LAUNCHES
    says (phase 12's), page.txt within PORT_CHAIN_MAX_CER of the JAX
    chain's on the same pixels (`ref_dir`, run on `ref_pages`: the same
    page files where not given). -> launches."""
    import torch
    from origami_tpu_torch.batch.detect.flow import kernel_launches
    from origami_tpu_torch.batch.runner import PipelinedRunner
    corpus = workdir / (kind.lower().replace(" ", "_") + "_chain")
    corpus.mkdir(parents=True)
    copied = as_suffix or suffix
    for stem in FORMATS_PAGES:
        shutil.copy(FORMATS_REF / "pages" / (stem + suffix),
                    corpus / (stem + copied))
    stages = chain_stages(device, str(ROOT / STUDENTS), "banded")
    reset_launches()
    t0 = time.perf_counter()
    PipelinedRunner(stages, wave_size=1).run(corpus)
    if str(device) != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    failed, seconds = [], {}
    pages = sorted(corpus.glob("*" + copied))
    for page in pages:
        seconds_of(corpus, page, stages, seconds, failed, kind + " chain")
    bad = whole_chain_launch_errors("banded", launches, len(pages), device)
    log("  %s chain (students, banded) %d pages: %.2f s wall; stage "
        "seconds %s; launches %s  %s" % (
            kind, len(pages), wall, json.dumps(seconds), json.dumps(
                {k: v for k, v in launches.items() if v}),
            "ok" if not bad and not failed else "FAIL"))
    if bad:
        failed.append("%s chain: launches (got, expected per page) %s"
                      % (kind, bad))
    if not failed:
        compare_chain_text(corpus, "%s chain vs the JAX chain on %s" % (
                           kind, ref_pages or "the same %s pages" % kind),
                           failed, 0.0,
                           PORT_CHAIN_MAX_CER, ref_dir=ref_dir,
                           pattern="*" + copied)
    if failed:
        raise PhaseError("; ".join(failed))
    return launches


def seconds_of(corpus, page, stages, seconds, failed, what):
    """Add each stage's seconds on `page` to `seconds`; a stage not
    COMPLETED goes into `failed`."""
    rt = json.loads((corpus / (page.stem + ".out") / "runtime.json")
                    .read_text())
    for stage, _ in stages:
        entry = rt.get(STAGE_KEYS[stage], {})
        if entry.get("status") != "COMPLETED":
            failed.append("%s, %s on %s: %s" % (
                what, stage, page.name, entry.get("traceback", entry)))
            continue
        seconds[stage] = seconds.get(stage, 0.0) + entry["elapsed"]


def split_jpeg_chain(workdir, device="cuda"):
    """Phase 22, the JPEG pages' lines (ROADMAP C16): the port's stages in
    this process from the JAX chain's artifacts on the same JPEG pages
    (tests/data/torch_formats/chain): from the JAX segment.zip (contours
    .. compose, the host geometry and the recognizer) and from the JAX
    contours.2.zip with its segment.zip, contours.1.zip, dewarp.zip and
    tables.json (lines .. compose, the recognizer's rounding), each
    page.txt against the JAX chain's: every page COMPLETED, CER within
    PORT_CHAIN_MAX_CER; and the port's label maps (the students in bf16,
    as the chain runs them) against the JAX segment.zip, at phase 5's
    students_bf16 bar. -> {run: (lines identical, lines, CER)}."""
    failed, rows = [], {}
    ref = FORMATS_REF / "chain"
    corpus = workdir / "split_segment"
    corpus.mkdir(parents=True)
    for stem in FORMATS_PAGES:
        shutil.copy(FORMATS_REF / "pages" / (stem + ".jpg"), corpus)
    chain_stages(device, str(ROOT / STUDENTS), "banded")[0][1].traverse(
        sorted(corpus.glob("*.jpg")))
    equal = total = 0
    for stem in FORMATS_PAGES:
        got = label_maps(corpus / (stem + ".out") / "segment.zip")
        want = label_maps(ref / (stem + ".out") / "segment.zip")
        for name, m in want.items():
            if name.endswith(".png"):
                equal += int((got[name] == m).sum())
                total += m.size
    bar = SEG_MODES["students_bf16"][2]
    log("  JPEG pages, the port's label maps (students, bf16) vs the JAX "
        "segment.zip: equal on %d of %d pixels (%.6f; bar %.2f)  %s" % (
            equal, total, equal / total, bar,
            "ok" if equal >= bar * total else "FAIL"))
    rows["label maps equal"] = (equal, total, 0.0)
    if equal < bar * total:
        failed.append("JPEG pages' label maps: %d of %d pixels equal to "
                      "JAX's" % (equal, total))
    for name, first, keep in (
            ("from the JAX segment.zip", "contours", ("segment.zip",)),
            ("from the JAX contours.2.zip", "lines",
             ("segment.zip", "contours.1.zip", "contours.2.zip",
              "dewarp.zip", "tables.json"))):
        corpus = workdir / ("split_" + first)
        corpus.mkdir(parents=True)
        for stem in FORMATS_PAGES:
            shutil.copy(FORMATS_REF / "pages" / (stem + ".jpg"), corpus)
            (corpus / (stem + ".out")).mkdir()
            for artifact in keep:
                shutil.copy(ref / (stem + ".out") / artifact,
                            corpus / (stem + ".out"))
        stages = chain_stages(device, str(ROOT / STUDENTS), "banded")
        stages = stages[[n for n, _ in stages].index(first):]
        pages = sorted(corpus.glob("*.jpg"))
        t0 = time.perf_counter()
        for _, proc in stages:
            proc.traverse(pages)
        wall = time.perf_counter() - t0
        seconds, bad = {}, []
        for page in pages:
            seconds_of(corpus, page, stages, seconds, bad, name)
        failed += bad
        log("  JPEG pages, the port %s (%s): %.2f s wall  %s" % (
            name, " .. ".join((stages[0][0], stages[-1][0])), wall,
            "ok" if not bad else "FAIL"))
        if not bad:
            _, cer = compare_chain_text(
                corpus, "JPEG pages, the port %s vs the JAX chain" % name,
                failed, 0.0, PORT_CHAIN_MAX_CER, ref_dir=ref,
                pattern="*.jpg")
            same = n = 0
            for png in pages:
                s, k, _, _ = text_diff(
                    page_text(corpus / (png.stem + ".out") / "compose.zip"),
                    page_text(ref / (png.stem + ".out") / "compose.zip"))
                same, n = same + s, n + k
            rows[name] = (same, n, cer)
    if failed:
        raise PhaseError("; ".join(failed))
    return rows


def tiff_page_bytes(px, kind):
    """uint8 (H, W) gray page -> a TIFF in strips of 64 rows that decodes
    to it, by plain byte packing: "tif" (uncompressed), "deflate" (Deflate
    with the horizontal predictor), "bigtiff" (little-endian BigTIFF,
    LONG8 offsets), "planar" (RGB, R = G = B = the page, one plane a
    sample), "cmyk" (C = M = Y = 0, K = 255 - the page) or "ycbcr"
    (YCbCr sub-sampled 2 x 2, Y = the page, Cb = Cr = 128, in libtiff's
    blocks of 4 Y samples, Cb and Cr, under LZW: lzw_literals)."""
    import struct
    import zlib
    h, w = px.shape
    big = kind == "bigtiff"
    if kind == "ycbcr":
        spp, photometric, planes = 3, 6, []
    elif kind == "planar":
        spp, photometric, planes = 3, 2, [px] * 3
    elif kind == "cmyk":
        cmyk = np.zeros((h, w, 4), np.uint8)
        cmyk[..., 3] = 255 - px
        spp, photometric, planes = 4, 5, [cmyk]
    else:
        spp, photometric, planes = 1, 1, [px]
    rps = 64
    chunks = [np.ascontiguousarray(p[y: y + rps]).tobytes()
              for p in planes for y in range(0, h, rps)]
    if kind == "deflate":
        chunks = [zlib.compress(np.diff(px[y: y + rps], axis=1,
                                        prepend=np.uint8(0)).tobytes())
                  for y in range(0, h, rps)]
    if kind == "ycbcr":
        chunks = []
        for y in range(0, h, rps):
            strip = px[y: y + rps]
            rows = strip.shape[0]
            blocks = np.full((rows // 2, w // 2, 6), 128, np.uint8)
            blocks[..., :4] = strip.reshape(rows // 2, 2, w // 2, 2).transpose(
                0, 2, 1, 3).reshape(rows // 2, w // 2, 4)
            chunks.append(lzw_literals(blocks.tobytes()))
    data = bytearray(16 if big else 8)
    offsets = []
    for c in chunks:
        offsets.append(len(data))
        data += c
    long_t, field = (16, 8) if big else (4, 4)
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8] * spp),
               (259, 3, [{"deflate": 8, "ycbcr": 5}.get(kind, 1)]),
               (262, 3, [photometric]), (273, long_t, offsets),
               (277, 3, [spp]), (278, 4, [rps]),
               (279, long_t, [len(c) for c in chunks]),
               (284, 3, [2 if kind == "planar" else 1]),
               (317, 3, [2 if kind == "deflate" else 1])]
    if kind == "ycbcr":
        entries.append((530, 3, [2, 2]))
    code = {3: "H", 4: "I", 16: "Q"}
    blobs = {}
    for tag, typ, vals in entries:
        if len(vals) * struct.calcsize(code[typ]) > field:
            blobs[tag] = len(data)
            data += struct.pack("<%d%s" % (len(vals), code[typ]), *vals)
    ifd = len(data)
    if big:
        data[:16] = b"II+\x00" + struct.pack("<HHQ", 8, 0, ifd)
        data += struct.pack("<Q", len(entries))
    else:
        data[:8] = b"II*\x00" + struct.pack("<I", ifd)
        data += struct.pack("<H", len(entries))
    for tag, typ, vals in entries:
        data += struct.pack("<HH" + code[long_t], tag, typ, len(vals))
        data += struct.pack("<" + code[long_t], blobs[tag]) if tag in blobs \
            else struct.pack("<%d%s" % (len(vals), code[typ]),
                             *vals).ljust(field, b"\x00")
    return bytes(data + b"\x00" * field)


def lzw_literals(raw):
    """Bytes -> a TIFF LZW stream (9-bit codes, most significant bit
    first) that holds each byte as its literal code: CLEAR before every
    250 bytes, so that the table never reaches the first 10-bit code, and
    EOI at the end. Valid LZW that any decoder reads, at 9/8 of the
    bytes."""
    raw = np.frombuffer(raw, np.uint8)
    n = raw.size
    codes = np.full(n + -(-n // 250) + 1, 256, np.uint16)
    codes[np.arange(n) + np.arange(n) // 250 + 1] = raw
    codes[-1] = 257
    bits = (codes[:, None] >> np.arange(8, -1, -1, dtype=np.uint16)) & 1
    return np.packbits(bits.astype(np.uint8).ravel()).tobytes()


def decode_timings(workdir, timed=FORMATS_TIMED,
                   write=("bmp", "tif", "deflate.tif")):
    """Phase 21 (c), 22 (c) with `timed` the JP2 and JPEG-in-TIFF pages
    and nothing to `write`, or 24 (c) with the lossless pages and the
    TIFF kinds: host ms to decode each timed page file
    (core/_image.read_gray, the file read included; median of
    DECODE_REPS after one warm-up), beside the PNG of the same pixels;
    then the PNG fixture page written here as each file of `write`
    (BMP, or TIFF by tiff_page_bytes: "<kind>.tif"), each decoded to its
    pixels exactly. -> {file: (ms, png ms)}."""
    from origami_tpu_torch.core import _bmp, _image, _png
    page = _png.read_gray(FIXTURE / (FORMATS_PAGES[0] + ".png"))
    written = []
    for name in write:
        path = workdir / ("%s.%s" % (FORMATS_PAGES[0], name))
        path.write_bytes(_bmp.encode_gray(page) if name == "bmp" else
                         tiff_page_bytes(page, name.split(".")[0]))
        differ = int((_image.read_gray(path) != page).sum())
        log("  %s: %d pixels differ from the PNG page's  %s" % (
            path.name, differ, "ok" if not differ else "FAIL"))
        if differ:
            raise PhaseError("%s does not decode to its pixels" % path.name)
        written.append(path)
    rows = {}
    for path in [FORMATS_REF / "pages" / n for n in timed] + written:
        name = path.name
        px = _image.read_gray(path)
        png = workdir / (name + ".png")
        _png.write_gray(png, px)
        times = {}
        for key, p in (("file", path), ("png", png)):
            _image.read_gray(p)
            ts = []
            for _ in range(DECODE_REPS):
                t0 = time.perf_counter()
                _image.read_gray(p)
                ts.append(1e3 * (time.perf_counter() - t0))
            times[key] = statistics.median(ts)
        rows[name] = (times["file"], times["png"])
        log("  decode %-26s %dx%d %7d bytes: %.2f ms a page; the PNG of "
            "its pixels (%d bytes) %.2f ms" % (
                name, px.shape[1], px.shape[0], path.stat().st_size,
                times["file"], png.stat().st_size, times["png"]))
    return rows


def check_image_formats(workdir, device="cuda"):
    """Phase 21: (a) decode parity, (b) the chain on the JPEG pages, (c)
    decode timings. -> (launches of (b), seconds)."""
    t0 = time.time()
    check_decode_parity()
    launches = check_jpeg_chain(workdir, device)
    decode_timings(workdir)
    return launches, time.time() - t0


# ---------------------------------------------------------------- phase 22

# the page files timed in phase 22c, each beside the PNG of its pixels
JP2_TIMED = ("synth0000.jp2", "synth0001.jp2", "synth0001.jpeg.tif")


def check_jpeg2000(workdir, device="cuda"):
    """Phase 22: (a) decode parity of the JPEG 2000 and JPEG-in-TIFF
    files, (b) the chain on the JP2 pages and the JPEG pages' split, (c)
    decode timings. -> (launches of (b)'s chain, split rows, seconds)."""
    t0 = time.time()
    check_decode_parity(22)
    launches = check_jpeg_chain(workdir, device, ".jp2", "JP2",
                                FORMATS_REF / "chain_jp2")
    split = split_jpeg_chain(workdir, device)
    decode_timings(workdir, JP2_TIMED, write=())
    return launches, split, time.time() - t0


# ---------------------------------------------------------------- phase 24

LOSSLESS = ".lossless.jpg"
# phase 24c: the lossless pages, each beside the PNG of its pixels
LOSSLESS_TIMED = tuple(stem + LOSSLESS for stem in FORMATS_PAGES)


def check_lossless_chain(workdir, device="cuda"):
    """Phase 24 (b): each lossless page decodes to its PNG page on every
    pixel; then the two through PipelinedRunner (check_jpeg_chain, named
    as the PNG pages so that page.txt is held against the JAX chain on
    those same pixels, tests/data/torch_compose); page.txt beside phase
    12's run of the port where this process made one. -> launches."""
    from origami_tpu_torch.core import _image, _png
    bad = []
    for stem in FORMATS_PAGES:
        got = _image.read_gray(FORMATS_REF / "pages" / (stem + LOSSLESS))
        want = _png.read_gray(FIXTURE / (stem + ".png"))
        differ = int((got != want).sum()) if got.shape == want.shape \
            else got.size
        log("  %s%s: %dx%d, %d pixels differ from %s.png  %s" % (
            stem, LOSSLESS, got.shape[1], got.shape[0], differ, stem,
            "ok" if not differ else "FAIL"))
        if differ:
            bad.append("%s%s differs from its PNG page on %d pixels"
                       % (stem, LOSSLESS, differ))
    if bad:
        raise PhaseError("; ".join(bad))
    launches = check_jpeg_chain(workdir, device, LOSSLESS, "lossless JPEG",
                                COMPOSE_REF, as_suffix=".jpg",
                                ref_pages="the PNG pages (the same pixels)")
    phase12 = workdir / "whole_chain_banded"
    for stem in FORMATS_PAGES:
        ref = phase12 / (stem + ".out") / "compose.zip"
        got = page_text(workdir / "lossless_jpeg_chain" / (stem + ".out")
                        / "compose.zip")
        if not ref.is_file():
            log("  %s: page.txt beside phase 12's: phase 12 did not run in "
                "this process" % stem)
            continue
        same, n, _, _ = text_diff(got, page_text(ref))
        log("  %s: page.txt %d of %d lines equal to phase 12's run on the "
            "PNG page; byte-equal: %s" % (stem, same, n,
                                          got == page_text(ref)))
    return launches


def check_more_formats(workdir, device="cuda"):
    """Phase 24: (a) decode parity of more/ and the lossless pages, (b)
    the chain on the lossless pages, (c) host decode times of the
    lossless pages and of the TIFF kinds. -> (launches of (b),
    seconds)."""
    t0 = time.time()
    check_decode_parity(24)
    launches = check_lossless_chain(workdir, device)
    decode_timings(workdir, LOSSLESS_TIMED,
                   ("bigtiff.tif", "planar.tif", "cmyk.tif"))
    return launches, time.time() - t0


# ---------------------------------------------------------------- phase 25

OJPEG = ".ojpeg.tif"
# phase 25c: the old-style JPEG pages, each beside the PNG of its pixels
OJPEG_TIMED = tuple(stem + OJPEG for stem in FORMATS_PAGES)


def check_tiff_kinds(workdir, device="cuda"):
    """Phase 25: (a) decode parity of tiff/ (old-style JPEG, YCbCr outside
    JPEG, old-style LZW, 12-bit gray; the kinds both refuse, CIELab among
    them, and those PIL misreads, raising with their names) and of the
    old-style JPEG pages; (b) the two old-style JPEG pages through
    PipelinedRunner (check_jpeg_chain) against the JAX chain on the same
    files (tests/data/torch_formats/chain_ojpeg); (c) host decode times of
    those pages and of the PNG page written as YCbCr 2 x 2 under LZW. ->
    (launches of (b), seconds)."""
    t0 = time.time()
    check_decode_parity(25)
    launches = check_jpeg_chain(workdir, device, OJPEG, "old-style JPEG",
                                FORMATS_REF / "chain_ojpeg")
    decode_timings(workdir, OJPEG_TIMED, ("ycbcr.tif",))
    return launches, time.time() - t0


# ---------------------------------------------------------------- phase 23

JPEG_REF = ROOT / "tests" / "data" / "torch_jpeg"
# the encoder's seeded cases (tests/test_torch_jpeg_encode.py, phase
# 23a): every mode, size, content and quality; the fixture page gray and,
# cut to a size of partial MCUs, as RGB at JPEG_PAGE_QUALITIES
JPEG_MODES = ("L", "RGB")
JPEG_SIZES = ((1, 1), (7, 9), (8, 8), (15, 17), (16, 16), (33, 65))
JPEG_CONTENTS = ("flat", "noise", "text")
JPEG_QUALITIES = (1, 10, 24, 25, 50, 75, 80, 85, 90, 95, 100)
JPEG_PAGE_QUALITIES = (1, 24, 75, 85, 90, 100)
JPEG_PAGE_RGB = (1911, 1301)
# phase 23e: host encode ms a page, median of ENCODE_REPS after a warm-up
ENCODE_REPS = 5


def jpeg_case_pixels(mode, shape, content, seed):
    """A seeded encoder case: uint8 (H, W) for "L", (H, W, 3) for "RGB";
    flat, noise, or text-like (dark strokes on a light ground, a little
    noise)."""
    rng = np.random.default_rng(seed)
    h, w = shape
    c = 3 if mode == "RGB" else 1
    if content == "flat":
        px = np.broadcast_to(rng.integers(0, 256, c, dtype=np.uint8),
                             (h, w, c)).copy()
    elif content == "noise":
        px = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    else:
        x = np.broadcast_to(rng.integers(200, 250, c), (h, w, c)).astype(
            np.int64) + rng.integers(-6, 7, (h, w, c))
        for _ in range(max(1, h * w // 30)):
            y0, x0 = int(rng.integers(0, h)), int(rng.integers(0, w))
            tall = bool(rng.integers(0, 2))
            n = int(rng.integers(2, 12))
            x[y0: y0 + (n if tall else 2), x0: x0 + (2 if tall else n)] = \
                rng.integers(0, 60, c)
        px = np.clip(x, 0, 255).astype(np.uint8)
    return px[..., 0] if c == 1 else px


def jpeg_cases():
    """{name: (mode, (h, w), content, seed, quality)} of the seeded
    cases; one seed a mode, size and content."""
    out = {}
    for i, mode in enumerate(JPEG_MODES):
        for j, shape in enumerate(JPEG_SIZES):
            for k, content in enumerate(JPEG_CONTENTS):
                seed = 100 * i + 10 * j + k
                for q in JPEG_QUALITIES:
                    out["%s-%dx%d-%s-q%d" % (mode, shape[0], shape[1],
                                             content, q)] = (
                        mode, shape, content, seed, q)
    return out


def jpeg_page_pixels(mode):
    """The fixture page synth0000: gray, or as RGB (the page, the page
    shifted 5 px, its negative) cut to JPEG_PAGE_RGB."""
    from origami_tpu_torch.core import _png
    page = _png.read_gray(FIXTURE / "synth0000.png")
    if mode == "L":
        return page
    h, w = JPEG_PAGE_RGB
    rgb = np.stack([page, np.roll(page, 5, axis=1), 255 - page], axis=-1)
    return np.ascontiguousarray(rgb[:h, :w])


def jpeg_page_cases():
    """{name: (mode, quality)} of the fixture page's cases."""
    return {"page-%s-q%d" % (mode, q): (mode, q) for mode in JPEG_MODES
            for q in JPEG_PAGE_QUALITIES}


def check_encoder(ref):
    """Phase 23 (a): every seeded case and page case through
    core/_jpeg.encode, its sha256 and length against PIL's
    (tests/data/torch_jpeg/encode.json). -> cases checked."""
    import hashlib
    from origami_tpu_torch.core import _jpeg
    bad, n = [], 0
    pages = {m: jpeg_page_pixels(m) for m in JPEG_MODES}
    items = [(name, jpeg_case_pixels(*case[:4]), case[4], ref["cases"])
             for name, case in jpeg_cases().items()]
    items += [(name, pages[mode], q, ref["pages"])
              for name, (mode, q) in jpeg_page_cases().items()]
    t0 = time.time()
    for name, px, q, want in items:
        data = _jpeg.encode(px, q)
        n += 1
        if hashlib.sha256(data).hexdigest() != want[name]["sha256"] \
                or len(data) != want[name]["length"]:
            bad.append("%s: %d bytes, PIL %d" % (name, len(data),
                                                  want[name]["length"]))
    missing = set(ref["cases"]) - set(jpeg_cases()) | \
        set(ref["pages"]) - set(jpeg_page_cases())
    if missing:
        bad.append("cases of the fixture not encoded: %s" % sorted(missing))
    log("  (a) encoder: %d seeded cases (L and RGB 4:2:0, %d sizes, %s, "
        "qualities %s) and %d fixture-page cases against PIL's bytes: %d "
        "differ (%.2f s)  %s" % (
            n - len(jpeg_page_cases()), len(JPEG_SIZES),
            "/".join(JPEG_CONTENTS), ",".join(map(str, JPEG_QUALITIES)),
            len(jpeg_page_cases()), len(bad), time.time() - t0,
            "ok" if not bad else "FAIL " + "; ".join(bad[:5])))
    if bad:
        raise PhaseError("JPEG encoder: %s" % "; ".join(bad[:5]))
    return n


def check_jpeg_sites(workdir, device):
    """Phase 23 (b), (c), (f): utils.thumbnail and utils.dewarp on the
    fixture pages with cold page caches (dewarp_u8 1 a page), their files
    byte-equal to the JAX modules' (tests/data/torch_inspect); pick_web's
    /image of the first page, cold, its JPEG body byte-equal to JAX's
    (tests/data/torch_tools), dewarp_u8 1; annotate export-image of the
    first sampled line to .jpg, remap_batch 1, PIL's bytes of its strip
    at quality 75. -> {"dewarp_u8": launches, "remap_batch": launches}."""
    import hashlib
    import io
    from origami_tpu_torch.core import _jpeg
    from origami_tpu_torch.core import page as page_cache
    from origami_tpu_torch.tool import annotate, pick_web

    def sha(data):
        return hashlib.sha256(data).hexdigest()

    inspect = json.loads((INSPECT_REF / "inspect.json").read_text())
    tools = json.loads((TOOLS_REF / "tools.json").read_text())
    corpus = inspect_corpus(workdir / "jpeg_sites")
    pages = inspect["pages"]
    bad, launched = [], {"dewarp_u8": 0, "remap_batch": 0}
    cold = str(device) != "cpu"
    for cli, name, want_launch in (
            ("utils.thumbnail", "thumbnail.jpg", {}),
            ("utils.dewarp", "dewarped.jpg",
             {"dewarp_u8": len(pages)} if cold else {})):
        page_cache.clear_caches()
        got, secs, _ = run_inspect_cli(cli, (), corpus, device)
        launched["dewarp_u8"] += got.get("dewarp_u8", 0)
        if got != want_launch:
            bad.append("%s: launches %s, expected %s" % (cli, got,
                                                          want_launch))
        for stem in pages:
            ref = inspect["thumbnail"][stem] if name == "thumbnail.jpg" \
                else inspect["renders"][stem][name]
            if sha((corpus / (stem + ".out") / name).read_bytes()) \
                    != ref["sha256"]:
                bad.append("%s of %s differs from JAX's" % (name, stem))
        log("  (b) %s on %d pages: %s byte-equal to JAX's; launches %s "
            "(cold caches); %.2f s" % (cli, len(pages), name,
                                       json.dumps(got), secs))
    # pick_web /image, once, on a cold cache
    tcorpus = tools_corpus(workdir / "jpeg_pick")
    tpages = tools_pages(tcorpus)
    row = tools["rows"][0]
    routes = web_routes("pick_web", tcorpus, (str(tcorpus / row[0]),
                                              row[1]))
    i = next(k for k, r in enumerate(routes) if r[1].startswith("/image"))
    page_cache.clear_caches()
    reset_launches()
    handler = pick_web.make_handler(str(workdir / "pick.db"), tpages,
                                    "reliable", device)
    t0 = time.time()
    (status, ctype, body), = drive_web(handler, [routes[i]])
    secs = time.time() - t0
    n = launch_counts().get("dewarp_u8", 0)
    launched["dewarp_u8"] += n
    ok = status == 200 and ctype == "image/jpeg" and \
        sha(body) == tools["web"]["pick_web"]["bodies"][str(i)]
    if not ok or n != (1 if cold else 0):
        bad.append("pick_web /image: %s %s, body %s, dewarp_u8 %d" % (
            status, ctype, "equal" if ok else "DIFFERS", n))
    log("  (c) pick_web /image of %s: %d %s, %d bytes byte-equal to JAX's: "
        "%s; dewarp_u8 %d (cold); %.2f s" % (
            tpages[0].name, status, ctype, len(body), ok, n, secs))
    # annotate export-image to .jpg
    reset_launches()
    out = workdir / "jpeg_line.jpg"
    with contextlib.redirect_stdout(io.StringIO()):
        strip = annotate.export_image(tcorpus / row[0], row[1], out,
                                      TOOLS_HEIGHT, device=device)
    _sync(device)
    n = launch_counts().get("remap_batch", 0)
    launched["remap_batch"] += n
    same = out.read_bytes() == _jpeg.encode(strip, 75)
    if not same or n != (1 if cold else 0):
        bad.append("export-image .jpg: PIL's bytes %s, remap_batch %d"
                   % (same, n))
    log("  (f) annotate export-image -o line.jpg (%dx%d strip): PIL's "
        "bytes at quality 75 %s; remap_batch %d" % (
            strip.shape[1], strip.shape[0], same, n))
    if bad:
        raise PhaseError("JPEG sites: %s" % "; ".join(bad))
    return launched


def check_cmyk_pages(ref):
    """Phase 23 (d): the CMYK and YCCK pages of tests/data/torch_jpeg
    decode to PIL's convert("L") (sha256 of the pixels) and size."""
    import hashlib
    from origami_tpu_torch.core import _image
    bad = []
    for name, want in sorted(ref["four_components"].items()):
        path = JPEG_REF / name
        t0 = time.perf_counter()
        px = _image.read_gray(path)
        ms = 1e3 * (time.perf_counter() - t0)
        got = hashlib.sha256(np.ascontiguousarray(px).tobytes()).hexdigest()
        ok = got == want["sha256"] and [px.shape[1], px.shape[0]] \
            == want["size"]
        if not ok:
            bad.append(name)
        log("  (d) %s %dx%d, %d bytes: PIL's convert(\"L\") %s; %.1f ms"
            % (name, px.shape[1], px.shape[0], path.stat().st_size,
               "equal" if ok else "DIFFERS", ms))
    if bad:
        raise PhaseError("four-component JPEG pages differ from PIL's: %s"
                         % bad)


def encode_timings():
    """Phase 23 (e): host ms to encode a page as the writers do: the gray
    fixture page at quality 90 (utils.dewarp's) and the RGB page at 85
    (the annotate renders'), beside core/_png's encode of the same array
    (what the port wrote before). -> {case: (jpeg ms, png ms, bytes,
    png bytes)}."""
    from origami_tpu_torch.core import _jpeg, _png
    rows = {}
    for mode, q, png in (("L", 90, _png.encode_gray),
                         ("RGB", 85, _png.encode_rgb)):
        px = jpeg_page_pixels(mode)
        times = {}
        for key, fn in (("jpeg", lambda: _jpeg.encode(px, q)),
                        ("png", lambda: png(px))):
            data = fn()
            ts = []
            for _ in range(ENCODE_REPS):
                t0 = time.perf_counter()
                fn()
                ts.append(1e3 * (time.perf_counter() - t0))
            times[key] = (statistics.median(ts), len(data))
        name = "%s q%d %dx%d" % (mode, q, px.shape[1], px.shape[0])
        rows[name] = (times["jpeg"][0], times["png"][0], times["jpeg"][1],
                      times["png"][1])
        log("  (e) encode %s: JPEG %.2f ms a page (%d bytes); PNG %.2f ms "
            "(%d bytes)" % (name, times["jpeg"][0], times["jpeg"][1],
                            times["png"][0], times["png"][1]))
    return rows


def check_jpeg_writers(workdir, device="cuda"):
    """Phase 23: (a) the encoder against PIL's bytes, (b, c, f) the
    writers' sites, (d) the CMYK and YCCK pages, (e) encode timings.
    -> (launches of the sites, seconds)."""
    t0 = time.time()
    ref = json.loads((JPEG_REF / "encode.json").read_text())
    check_encoder(ref)
    launched = check_jpeg_sites(workdir, device)
    check_cmyk_pages(ref)
    encode_timings()
    return launched, time.time() - t0


# ---------------------------------------------------------------- main

def phase_seconds(n, t0):
    """Log phase n's seconds since t0 -> the time now (the next phase's
    start)."""
    now = time.time()
    log("  (phase %d: %.1f s)" % (n, now - t0))
    return now


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "origami_tpu_torch").is_dir() or not FIXTURE.is_dir() \
            or not SEG_REF.is_dir() or not FLOW_REF.is_dir() \
            or not LAYOUT_REF.is_dir() or not COMPOSE_REF.is_dir() \
            or not TRAIN_REF.is_dir() or not GT_REF.is_dir() \
            or not INSPECT_REF.is_dir() or not FLAGSHIP_REF.is_dir() \
            or not TOOLS_REF.is_dir() or not FORMATS_REF.is_dir() \
            or not JPEG_REF.is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(origami_tpu_torch/, tests/data/torch_ocr/, "
              "tests/data/torch_segment/, tests/data/torch_flow/, "
              "tests/data/torch_layout/, tests/data/torch_compose/, "
              "tests/data/torch_train/, tests/data/torch_gt/, "
              "tests/data/torch_inspect/, tests/data/torch_flagship/, "
              "tests/data/torch_tools/, tests/data/torch_formats/ or "
              "tests/data/torch_jpeg/ missing)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    t_start = time.time()

    log("== phase 1: build")
    t_phase = time.time()
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
    t_phase = phase_seconds(1, t_phase)

    log("== phase 2: kernels vs plain versions (median of %d, CUDA "
        "events; %s)" % (REPS, smi))
    rows = check_kernels(device)
    rows.update(check_gather(device))
    rows.update(check_grid(device, rows["take_along_axis_lane"]))
    host_path_ab(device)
    device_groups_ab(device)
    t_phase = phase_seconds(2, t_phase)

    log("== phase 3: OCR CLI on the card vs the JAX references (%s)"
        % smi)
    failed = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = Path(tmp)
        for mode in MODES:
            r = run_ocr_cli(mode, work)
            same = round(r["identical"] * r["lines"])
            ok = r["identical"] >= MIN_IDENTICAL and r["cer"] <= MAX_CER \
                and same >= MIN_IDENTICAL_LINES[mode]
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
            log("  %-8s %d pages %d lines: identical %d (%.4f; gate %d)  "
                "CER %.5f  launches %s  stage %.2f s (%.2f pages/s, %.1f "
                "lines/s, cold process)  %s" % (
                    mode, r["pages"], r["lines"], same, r["identical"],
                    MIN_IDENTICAL_LINES[mode], r["cer"],
                    json.dumps(r["launches"]), r["stage_s"],
                    r["pages"] / r["stage_s"], r["lines"] / r["stage_s"],
                    "ok" if ok and not starved else "FAIL"))
            if not ok:
                failed.append("%s: identical %d (%.4f; gates %d, %.2f) or "
                              "CER %.5f > %.3f" % (
                                  mode, same, r["identical"],
                                  MIN_IDENTICAL_LINES[mode], MIN_IDENTICAL,
                                  r["cer"], MAX_CER))
            if starved:
                failed.append("%s: launch counts: %s" % (mode, starved))
        if failed:
            raise PhaseError("; ".join(failed))
        t_phase = phase_seconds(3, t_phase)

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
        t_phase = phase_seconds(4, t_phase)

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
        t_phase = phase_seconds(5, t_phase)

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
        t_phase = phase_seconds(6, t_phase)

        log("== phase 7: flow and dewarp CLIs on the card vs the JAX "
            "stages (%s)" % smi)
        check_flow_dewarp(work)
        t_phase = phase_seconds(7, t_phase)

        log("== phase 8: flow and dewarp stage throughput, warm (%s)" % smi)
        ftp = flow_dewarp_throughput(work)
        for stage in ("flow", "dewarp"):
            log_throughput(stage, ftp[stage])
        g = ftp["grid"]
        log("  one grid build (88 x 64 nodes, 1312x1920 page): %.2f ms wall "
            "(median of 5), %d device launches (kernels and copies; %d of "
            "them the grid scan kernels), %.3f ms device time"
            % (g["wall_ms"], g["launches"], g["scans"], g["device_ms"]))
        t_phase = phase_seconds(8, t_phase)

        log("== phase 9: the chain segment -> contours -> flow -> dewarp -> "
            "layout on the card, each stage's CLI, vs the JAX stages (%s)"
            % smi)
        check_layout_on_jax_inputs(work)
        check_chain_from_jax_segmentation(work)
        check_port_chain(work)
        t_phase = phase_seconds(9, t_phase)

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
        t_phase = phase_seconds(10, t_phase)

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
        t_phase = phase_seconds(11, t_phase)

        log("== phase 12: the whole chain from the page images through "
            "PipelinedRunner on the card (%s)" % smi)
        whole = check_whole_chain(work)
        t_phase = phase_seconds(12, t_phase)

        log("== phase 13: OCR --binarize, -m auto:, PagePipeline and the "
            "export CLIs on the card (%s)" % smi)
        check_inference_surface(work)
        t_phase = phase_seconds(13, t_phase)

        log("== phase 14: training on the card: the warp kernel, the JAX "
            "trainers' numbers, the main path, --processes (%s)" % smi)
        rows.update(check_train_warp(work))
        check_train_parity(work)
        train_launches = check_train_main_path(work)
        check_processes(work)
        t_phase = phase_seconds(14, t_phase)

        log("== phase 15: ground-truth generation, segmentation evaluation "
            "and the affine-warp helpers on the card vs the JAX package "
            "(%s)" % smi)
        gt_rows, affine_launches = check_ground_truth(work)
        rows["remap_affine"] = gt_rows["remap_affine"]
        t_phase = phase_seconds(15, t_phase)

        log("== phase 16: the synthetic corpus, recognizer evaluation and "
            "training, the chain's scores and the bootstrap CLI on the "
            "card vs the JAX package (%s)" % smi)
        check_synth(work)
        t_phase = phase_seconds(16, t_phase)

        log("== phase 17: the annotate renders, the corpus utilities and "
            "patch_skew_samples on the card vs the JAX package (%s)" % smi)
        inspect_launches = check_inspection(work)
        t_phase = phase_seconds(17, t_phase)

        log("== phase 18: the flagship ensemble graph, the sharded "
            "predictor, two segment processes on the card and the dry "
            "run (%s)" % smi)
        multihost_launches, _, _ = check_scale_out(work)
        t_phase = phase_seconds(18, t_phase)

        log("== phase 19: mesh training: the trainers on meshes against "
            "the JAX numbers, the region trainer on a 2 x 2 mesh with the "
            "warp against one device, the dry run's training half (%s)"
            % smi)
        mesh_launches = check_mesh_training(work)
        t_phase = phase_seconds(19, t_phase)

        log("== phase 20: the operator tools and the remote runner: "
            "sample, harmonize, export, annotate export-image, the web "
            "tools and remote -m heuristic on the card vs the JAX tools "
            "(%s)" % smi)
        tools_by_path, _ = check_tools(work)
        t_phase = phase_seconds(20, t_phase)

        log("== phase 21: page images in every format the JAX package "
            "reads: decode parity against PIL, the chain on the JPEG "
            "pages, host decode times (%s)" % smi)
        jpeg_launches, _ = check_image_formats(work)
        # exactly phase 12's, but where a count is bounded (a banded run's
        # strips_through_grid: lines past the banded profiles)
        differ = {k: (v, whole["banded"][k]) for k, v in
                  jpeg_launches.items() if v != whole["banded"][k]
                  and ("banded", k) not in WHOLE_CHAIN_AT_MOST}
        if differ:
            raise PhaseError("JPEG chain launches (got, phase 12's) %s"
                             % differ)
        t_phase = phase_seconds(21, t_phase)

        log("== phase 22: JPEG 2000 and JPEG-in-TIFF pages: decode parity "
            "against PIL, the chain on the JP2 pages, the JPEG pages' "
            "lines split, host decode times (%s)" % smi)
        jp2_launches, _, _ = check_jpeg2000(work)
        differ = {k: (v, whole["banded"][k]) for k, v in
                  jp2_launches.items() if v != whole["banded"][k]
                  and ("banded", k) not in WHOLE_CHAIN_AT_MOST}
        if differ:
            raise PhaseError("JP2 chain launches (got, phase 12's) %s"
                             % differ)
        t_phase = phase_seconds(22, t_phase)

        log("== phase 23: JPEG writers: the encoder against PIL's bytes, "
            "the thumbnail, dewarped page, pick_web and export-image "
            "against the JAX files, CMYK and YCCK pages, host encode "
            "times (%s)" % smi)
        writer_launches, _ = check_jpeg_writers(work)
        t_phase = phase_seconds(23, t_phase)

        log("== phase 24: lossless and arithmetic JPEG, BigTIFF, planar, "
            "CMYK, float, signed and associated-alpha TIFF: decode parity "
            "against PIL, the chain on the lossless pages, host decode "
            "times (%s)" % smi)
        lossless_launches, _ = check_more_formats(work)
        differ = {k: (v, whole["banded"][k]) for k, v in
                  lossless_launches.items() if v != whole["banded"][k]
                  and ("banded", k) not in WHOLE_CHAIN_AT_MOST}
        if differ:
            raise PhaseError("lossless JPEG chain launches (got, phase "
                             "12's) %s" % differ)
        t_phase = phase_seconds(24, t_phase)

        log("== phase 25: old-style JPEG, YCbCr, old-style LZW and 12-bit "
            "TIFF: decode parity against PIL, the chain on the old-style "
            "JPEG pages, host decode times (%s)" % smi)
        ojpeg_launches, _ = check_tiff_kinds(work)
        differ = {k: (v, whole["banded"][k]) for k, v in
                  ojpeg_launches.items() if v != whole["banded"][k]
                  and ("banded", k) not in WHOLE_CHAIN_AT_MOST}
        if differ:
            raise PhaseError("old-style JPEG chain launches (got, phase "
                             "12's) %s" % differ)
        phase_seconds(25, t_phase)

    # each kernel's launches in the phase-12 run of its own path
    total = {k: whole["gather" if k in OTHER_PATH_KERNELS else "banded"][k]
             for k in whole["banded"]}
    # the training warp's kernel: its launches in phase 14c's run; phase
    # 19b's mesh run stands beside it
    total["remap_batch"] = train_launches["remap_batch"]
    # the affine warp's: its launches in phase 15's deskew_pair and lines
    total["remap_affine"] = affine_launches
    # phase 17's renders dewarp pages too (cold page caches): their
    # launches stand beside the chain's, not in its count
    # phase 18's two segment processes binarize their pages too
    by_path = {"dewarp_u8": {"chain": total["dewarp_u8"],
                             "inspection": inspect_launches},
               "sauvola_packed": {"chain": total["sauvola_packed"],
                                  "multihost": multihost_launches},
               "remap_batch": {"training": total["remap_batch"],
                               "mesh training": mesh_launches}}
    # phase 20's tools: the line export, its Sauvola, pick_web's pages
    # and the remote runner's segment stage
    for name, paths in tools_by_path.items():
        by_path.setdefault(name, {}).update(paths)
    # phases 21, 22, 24 and 25's JPEG, JP2, lossless JPEG and old-style
    # JPEG pages on the main path: phase 12's launches again
    for path, counts in (("jpeg chain", jpeg_launches),
                         ("jp2 chain", jp2_launches),
                         ("lossless jpeg chain", lossless_launches),
                         ("old-style JPEG chain", ojpeg_launches)):
        for name, n in counts.items():
            if n:
                by_path.setdefault(name, {})[path] = n
    # phase 23's JPEG writers: utils.dewarp and pick_web's /image dewarp
    # their pages, export-image warps its line
    for name, n in writer_launches.items():
        by_path.setdefault(name, {})["jpeg writers"] = n
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
        "dewarp_f32": ("remap.cu", "origami_tpu/ops/pallas/remap.py:392"),
        "remap": ("remap.cu", "origami_tpu/ops/pallas/remap.py:392"),
        "remap_batch": ("remap.cu", "origami_tpu/ops/pallas/remap.py:392"),
        "remap_affine": ("remap.cu",
                         "origami_tpu/ops/pallas/remap.py:392"),
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
        if name in by_path:
            kernels[name]["launches_by_path"] = by_path[name]
    # remap (the dense map) is remap_pallas' parity entry: the layout
    # stage took it until dewarp_f32 upsampled the grid in the kernel
    off_path = ("take_along_axis_lane", "take_along_axis_sublane", "remap")
    starved = [n for n, k in kernels.items()
               if n not in off_path and k["launches"] < 1]
    if starved:
        raise PhaseError("kernels of the driven paths never launched: %s"
                         % starved)
    log("total %.1f s" % (time.time() - t_start))
    # the gather (lane and sublane) and remap are entry points that no
    # stage calls: held against their plain versions above, launched by
    # no path, and so kept out of the table of the paths' kernels
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
