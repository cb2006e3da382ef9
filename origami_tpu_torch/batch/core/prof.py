"""Lightweight span profiler for the batch stages (port of
origami_tpu/batch/core/prof.py `span`).

Enabled by setting ``ORIGAMI_PROF=1``; disabled it costs one check per
span. Spans measure host wall time: device work inside a span is only
counted where the span's code waits for it.
"""

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager

enabled = os.environ.get("ORIGAMI_PROF") == "1"
_acc: dict[str, list[float]] = {}


@contextmanager
def span(key):
    if not enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        slot = _acc.setdefault(key, [0.0, 0])
        slot[0] += time.perf_counter() - t0
        slot[1] += 1


def snapshot():
    return {k: (round(v[0], 3), v[1]) for k, v in sorted(_acc.items())}


def report(out=None):
    out = out or sys.stderr
    for k, (s, n) in snapshot().items():
        print("%-40s %8.3f s  x%d" % (k, s, n), file=out)
