"""ctypes bindings for the C++ geometry kernels of native.cpp.

Port of origami_tpu/geometry/native_bindings.py (the bindings the flow and
dewarp stages reach: the polygon overlay, the segment distance and the
Douglas-Peucker keep-mask). native.cpp is host C++, the JAX package's
file copied whole; it is compiled at first use with g++ (the JAX package's
Makefile flags) into

    build/origami_tpu_torch/liborigami_native.so

and rebuilt when the source is newer. The JAX artifacts the port is held
against were made with this library, whose overlay need not give the
same polygons as the Python reference in booleans.py, so a failed build
or load raises: nothing drops to the Python paths.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "origami_tpu_torch"
LIBRARY = BUILD_DIR / "liborigami_native.so"
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]

_DP = ctypes.POINTER(ctypes.c_double)
_IP = ctypes.POINTER(ctypes.c_int)


def build(force=False):
    """Compile native.cpp if the library is missing or older than it."""
    if not force and LIBRARY.exists() \
            and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
        return
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the geometry library cannot be "
                           "built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / ("liborigami_native.%d.so" % os.getpid())
    out = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if out.returncode != 0:
        raise RuntimeError("g++ failed for %s:\n%s" % (SOURCE, out.stdout))
    os.replace(tmp, LIBRARY)


@functools.lru_cache(maxsize=1)
def library():
    """The loaded library (built first where needed); raises on failure."""
    build()
    lib = ctypes.CDLL(str(LIBRARY))
    lib.polygon_overlay.restype = ctypes.c_int
    lib.polygon_overlay.argtypes = [
        _DP, _IP, _IP, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _DP, ctypes.c_int, _IP, _IP, ctypes.c_int]
    lib.min_seg_dist.restype = ctypes.c_double
    lib.min_seg_dist.argtypes = [_DP, ctypes.c_int, _DP, ctypes.c_int,
                                 ctypes.c_double]
    lib.douglas_peucker.restype = None
    lib.douglas_peucker.argtypes = [
        _DP, ctypes.c_int, ctypes.c_double, ctypes.POINTER(ctypes.c_uint8)]
    return lib


_OP_CODES = {"and": 0, "or": 1, "diff": 2, "xor": 3, "any": 4}


def polygon_overlay_native(ring_groups, op):
    """ring_groups: list of ring-lists ((N,2) float arrays); op in
    {"and","or","diff","xor","any"}. Returns [(shell, holes), ...] as
    float64 arrays, or None when the result outgrows every output buffer
    the call tries (the caller then runs the Python overlay)."""
    lib = library()
    rings = []
    groups = []
    for gi, rg in enumerate(ring_groups):
        for r in rg:
            c = np.asarray(r, np.float64)
            if len(c) >= 2:
                # drop an explicit closing point
                d0 = c[0, 0] - c[-1, 0]
                d1 = c[0, 1] - c[-1, 1]
                if -1e-8 < d0 < 1e-8 and -1e-8 < d1 < 1e-8:
                    c = c[:-1]
            if len(c) >= 3:
                rings.append(c)
                groups.append(gi)
    if not rings:
        return []
    coords = np.ascontiguousarray(np.concatenate(rings, axis=0).reshape(-1))
    sizes = np.asarray([len(r) for r in rings], np.int32)
    garr = np.asarray(groups, np.int32)
    n_pts = int(sizes.sum())

    cap_c = max(8 * 2 * n_pts, 4096)
    cap_r = max(8 * len(rings) + 64, 256)
    for _ in range(4):
        out_c = np.empty(cap_c, np.float64)
        out_s = np.empty(cap_r, np.int32)
        out_p = np.empty(cap_r, np.int32)
        m = lib.polygon_overlay(
            coords.ctypes.data_as(_DP), sizes.ctypes.data_as(_IP),
            garr.ctypes.data_as(_IP), len(rings), len(ring_groups),
            _OP_CODES[op], out_c.ctypes.data_as(_DP), cap_c,
            out_s.ctypes.data_as(_IP), out_p.ctypes.data_as(_IP), cap_r)
        if m >= 0:
            break
        cap_c *= 4
        cap_r *= 4
    else:
        return None
    polys = {}
    off = 0
    for i in range(m):
        n = int(out_s[i])
        ring = out_c[2 * off: 2 * (off + n)].reshape(n, 2).copy()
        off += n
        pid = int(out_p[i])
        if pid not in polys:
            polys[pid] = (ring, [])
        else:
            polys[pid][1].append(ring)
    return [polys[k] for k in sorted(polys)]


def min_seg_dist_native(segs_a, segs_b, cutoff=0.0):
    """Minimum distance between two (N,4) segment sets; `cutoff` allows
    an early exit as soon as any pair is at most that close."""
    lib = library()
    sa = np.ascontiguousarray(segs_a, np.float64)
    sb = np.ascontiguousarray(segs_b, np.float64)
    return float(lib.min_seg_dist(sa.ctypes.data_as(_DP), len(sa),
                                  sb.ctypes.data_as(_DP), len(sb),
                                  float(cutoff)))


def douglas_peucker_native(coords, tol):
    """Keep-mask of Douglas-Peucker simplification over an open chain
    (N, 2)."""
    lib = library()
    c = np.ascontiguousarray(coords, np.float64)
    n = len(c)
    keep = np.empty(n, np.uint8)
    lib.douglas_peucker(c.ctypes.data_as(_DP), n, float(tol),
                        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return keep > 0
