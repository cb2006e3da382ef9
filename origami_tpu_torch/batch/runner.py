"""Wave-pipelined runner of the detect chain.

Port of origami_tpu/batch/runner.py (`corpus_pages`, `PipelinedRunner`,
:34-110). The corpus goes through the chain in waves of a few pages,
and three waves overlap:

    wave i+1 segment        (device, side thread)
    wave i   host stages    (contours, flow, dewarp, layout, lines,
                             order; main thread)
    wave i-1 ocr + compose  (device, side thread)

PyTorch releases the GIL while the card works, so the side threads free
the host for the geometry. The stage processors are shared across
waves (weights, built kernels and page caches stay warm). Artifacts and
runtime.json records are those of a stage-by-stage traversal: the
runner reorders page traversals and changes none.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path

from origami_tpu_torch.core.page import is_image


def corpus_pages(path):
    """The page images under `path`, folders and files sorted, `.out`
    folders skipped."""
    pages = []
    for folder, dirs, files in os.walk(str(path)):
        folder = Path(folder)
        if folder.name.endswith(".out"):
            dirs.clear()
            continue
        dirs.sort()
        for fn in sorted(files):
            if is_image(folder / fn):
                pages.append(folder / fn)
    return pages


class PipelinedRunner:
    """stages: [(name, Processor)] in chain order; the segment stage and
    the ocr/compose tail run in side threads, a wave each."""

    def __init__(self, stages, wave_size=3):
        names = [n for n, _ in stages]
        self._seg = [p for n, p in stages if n == "segment"]
        self._tail = [p for n, p in stages if n in ("ocr", "compose")]
        self._host = [p for n, p in stages
                      if n not in ("segment", "ocr", "compose")]
        if "segment" not in names or "ocr" not in names:
            raise ValueError("runner needs segment and ocr stages")
        self._wave = wave_size
        # three waves are alive at once: size the page caches so that no
        # page is decoded, uploaded or binarized twice
        from origami_tpu_torch.core import page
        page.set_cache_budget(3 * wave_size)

    def _run(self, procs, pages, errors):
        try:
            for proc in procs:
                proc.traverse(pages)
        except BaseException as e:       # raised again by run()
            errors.append(e)

    def run(self, corpus):
        pages = corpus_pages(corpus)
        waves = [pages[i: i + self._wave]
                 for i in range(0, len(pages), self._wave)]
        if not waves:
            return
        # the host geometry library is built here, before threads share it
        from origami_tpu_torch.geometry.native_bindings import library
        library()
        errors = []

        def spawn(procs, wave):
            t = threading.Thread(target=self._run,
                                 args=(procs, wave, errors), daemon=True)
            t.start()
            return t

        # prologue: segment wave 0 here (it also builds the kernels)
        self._run(self._seg, waves[0], errors)
        tail_t = None
        seg_t = None
        for i, wave in enumerate(waves):
            if errors:
                break
            # side threads: segment the next wave, ocr + compose the
            # previous one, both beside this wave's host stages
            if i + 1 < len(waves):
                seg_t = spawn(self._seg, waves[i + 1])
            for proc in self._host:
                proc.traverse(wave)
            if tail_t is not None:
                tail_t.join()
            tail_t = spawn(self._tail, wave)
            if seg_t is not None:
                seg_t.join()
                seg_t = None
        if tail_t is not None:
            tail_t.join()
        if errors:
            raise errors[0]
