"""ctypes bindings for the host C++ geometry kernels.

Port of origami_tpu/geometry/native_bindings.py: the polygon overlay, the
segment distance, the Douglas-Peucker keep-mask, Zhang-Suen thinning, the
city-block EDT, the skeleton tracer and the concave hull of native.cpp
(the JAX package's file copied whole), and the port's own raster
vectorization of contour_trace.cpp (cv2's findContours, connected
components, chamfer distance transform, fillPoly and line;
geometry/contour_trace.py and raster.py wrap them). Both sources are compiled at first use with g++ (the JAX
package's Makefile flags) into

    build/origami_tpu_torch/liborigami_native.so

and rebuilt when a source is newer. The JAX artifacts the port is held
against were made with this library, whose overlay need not give the
same polygons as the Python reference in booleans.py, so a failed build
or load raises: nothing drops to the Python paths (nor to the JAX
package's device thinning).
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCES = [Path(__file__).resolve().parent / name
           for name in ("native.cpp", "contour_trace.cpp")]
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "origami_tpu_torch"
LIBRARY = BUILD_DIR / "liborigami_native.so"
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]

_DP = ctypes.POINTER(ctypes.c_double)
_IP = ctypes.POINTER(ctypes.c_int)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_FP = ctypes.POINTER(ctypes.c_float)


def build(force=False):
    """Compile the sources if the library is missing or older than one."""
    if not force and LIBRARY.exists() and all(
            LIBRARY.stat().st_mtime >= s.stat().st_mtime for s in SOURCES):
        return
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the geometry library cannot be "
                           "built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / ("liborigami_native.%d.so" % os.getpid())
    out = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp),
                          *map(str, SOURCES)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if out.returncode != 0:
        raise RuntimeError("g++ failed for %s:\n%s"
                           % (", ".join(map(str, SOURCES)), out.stdout))
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
        _DP, ctypes.c_int, ctypes.c_double, _U8P]
    lib.concave_hull.restype = ctypes.c_int
    lib.concave_hull.argtypes = [
        _DP, ctypes.c_int, _IP, ctypes.c_int, ctypes.c_double,
        ctypes.c_double, _IP, ctypes.c_int]
    lib.trace_skeleton.restype = ctypes.c_int
    lib.trace_skeleton.argtypes = [
        _U8P, ctypes.c_int, ctypes.c_int, _I32P, ctypes.c_int, _I32P,
        ctypes.c_int]
    lib.thin_mask.restype = ctypes.c_int
    lib.thin_mask.argtypes = [_U8P, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int]
    lib.chamfer_edt.restype = None
    lib.chamfer_edt.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, _FP]
    lib.find_contours_run.restype = ctypes.c_void_p
    lib.find_contours_run.argtypes = [
        _U8P, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_long)]
    lib.find_contours_copy.restype = None
    lib.find_contours_copy.argtypes = [ctypes.c_void_p, _I32P, _I32P,
                                       _I32P]
    lib.find_contours_free.restype = None
    lib.find_contours_free.argtypes = [ctypes.c_void_p]
    lib.components8.restype = ctypes.c_int
    lib.components8.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, _I32P]
    lib.component_stats.restype = None
    lib.component_stats.argtypes = [_I32P, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, _I32P]
    lib.chamfer5.restype = None
    lib.chamfer5.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, _FP, _I32P,
                             ctypes.c_int]
    lib.fill_poly.restype = None
    lib.fill_poly.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, _I32P,
                              ctypes.c_int, ctypes.c_int]
    lib.draw_line.restype = None
    lib.draw_line.argtypes = [_U8P] + [ctypes.c_int] * 7
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
                        keep.ctypes.data_as(_U8P))
    return keep > 0


def concave_hull_native(points, concavity, length_threshold):
    """(N, 2) float64 points -> (M, 2) hull ring, or None when the C++
    dig returns fewer than 3 points. The convex hull it starts from is
    scipy's, as in the JAX binding."""
    import scipy.spatial
    lib = library()
    pts = np.ascontiguousarray(points, dtype=np.float64)
    hull = scipy.spatial.ConvexHull(pts)
    hidx = np.ascontiguousarray(hull.vertices, dtype=np.int32)
    max_out = len(pts) + 8
    out = np.zeros(max_out, dtype=np.int32)
    m = lib.concave_hull(
        pts.ctypes.data_as(_DP), len(pts), hidx.ctypes.data_as(_IP),
        len(hidx), float(concavity), float(length_threshold),
        out.ctypes.data_as(_IP), max_out)
    if m < 3:
        return None
    return pts[out[:m]]


def trace_skeleton_native(skel):
    """(H, W) bool mask -> list of (N_i,) pixel-index paths, or None when
    the paths outgrow their buffers."""
    lib = library()
    sk = np.ascontiguousarray(skel, dtype=np.uint8)
    h, w = sk.shape
    n_px = int(sk.sum())
    path_cap = max(16, n_px * 8 + 64)
    off_cap = max(16, n_px + 8)
    data = np.zeros(path_cap, dtype=np.int32)
    offs = np.zeros(off_cap, dtype=np.int32)
    n = lib.trace_skeleton(sk.ctypes.data_as(_U8P), h, w,
                           data.ctypes.data_as(_I32P), path_cap,
                           offs.ctypes.data_as(_I32P), off_cap)
    if n < 0:
        return None
    return [data[offs[i]: offs[i + 1]] for i in range(n)]


def thin_mask_native(mask, max_iter=128):
    """Zhang-Suen thinning of a bool mask."""
    lib = library()
    img = (np.ascontiguousarray(mask, np.uint8) > 0).astype(np.uint8)
    h, w = img.shape
    lib.thin_mask(img.ctypes.data_as(_U8P), h, w, int(max_iter))
    return img > 0


def chamfer_edt_native(mask):
    """City-block distance to the nearest set pixel of `mask`."""
    lib = library()
    src = (np.ascontiguousarray(mask, np.uint8) > 0).astype(np.uint8)
    h, w = src.shape
    out = np.empty((h, w), np.float32)
    lib.chamfer_edt(src.ctypes.data_as(_U8P), h, w, out.ctypes.data_as(_FP))
    return out
