"""cv2's raster vectorization without cv2.

The JAX package vectorizes label masks with OpenCV (core/contours.py,
core/geometry_ops.py). These functions give the same results from the
C++ of contour_trace.cpp (built into the port's geometry library):

    find_contours         cv2.findContours(m, RETR_CCOMP, CHAIN_APPROX_SIMPLE)
    contour_area          cv2.contourArea (the shoelace, unsigned)
    connected_components_with_stats
                          cv2.connectedComponentsWithStats(m, connectivity=8)
    distance_transform    cv2.distanceTransform(m, DIST_L2, 5)
    distance_transform_with_labels
                          cv2.distanceTransformWithLabels(m, DIST_L2, 5,
                              labelType=DIST_LABEL_PIXEL)

Shapes and dtypes follow cv2's: contours are (n, 1, 2) int32 arrays, the
hierarchy a (1, n, 4) int32 array of [next, prev, first_child, parent].
"""

from __future__ import annotations

import ctypes

import numpy as np

from origami_tpu_torch.geometry.native_bindings import library

# cv2.CC_STAT_* columns
CC_STAT_LEFT, CC_STAT_TOP, CC_STAT_WIDTH, CC_STAT_HEIGHT, CC_STAT_AREA = \
    range(5)

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_FP = ctypes.POINTER(ctypes.c_float)


def _mask_u8(mask):
    m = np.asarray(mask)
    if m.ndim != 2:
        raise ValueError("a 2-D mask is needed, got shape %s" % (m.shape,))
    return np.ascontiguousarray(m != 0, dtype=np.uint8)


def find_contours(mask):
    """Borders of the set pixels of `mask`: (contours, hierarchy), or
    ((), None) when nothing is set, as cv2 returns them."""
    lib = library()
    m = _mask_u8(mask)
    h, w = m.shape
    n = ctypes.c_int()
    n_pts = ctypes.c_long()
    handle = lib.find_contours_run(m.ctypes.data_as(_U8P), h, w,
                                   ctypes.byref(n), ctypes.byref(n_pts))
    try:
        pts = np.empty((n_pts.value, 2), np.int32)
        sizes = np.empty(n.value, np.int32)
        hier = np.empty((n.value, 4), np.int32)
        lib.find_contours_copy(handle, pts.ctypes.data_as(_I32P),
                               sizes.ctypes.data_as(_I32P),
                               hier.ctypes.data_as(_I32P))
    finally:
        lib.find_contours_free(handle)
    if not n.value:
        return (), None
    ends = np.cumsum(sizes)
    contours = tuple(c.reshape(-1, 1, 2)
                     for c in np.split(pts, ends[:-1]))
    return contours, hier[None]


def contour_area(contour):
    """Unsigned shoelace area of a contour, as cv2.contourArea."""
    c = np.asarray(contour, dtype=np.float64).reshape(-1, 2)
    if len(c) == 0:
        return 0.0
    x, y = c[:, 0], c[:, 1]
    # integer vertices: every term and partial sum is an exact integer in
    # float64, so the order of the sum does not matter
    a = float(np.sum(np.roll(x, 1) * y - np.roll(y, 1) * x))
    return abs(a * 0.5)


def connected_components_with_stats(mask):
    """(n_labels, labels int32 (h, w), stats int32 (n_labels, 5)) of the
    8-connected components; label 0 is the background."""
    lib = library()
    m = _mask_u8(mask)
    h, w = m.shape
    labels = np.empty((h, w), np.int32)
    n = lib.components8(m.ctypes.data_as(_U8P), h, w,
                        labels.ctypes.data_as(_I32P))
    stats = np.empty((n, 5), np.int32)
    lib.component_stats(labels.ctypes.data_as(_I32P), h, w, n,
                        stats.ctypes.data_as(_I32P))
    return n, labels, stats


def _chamfer(mask, with_labels):
    lib = library()
    m = _mask_u8(mask)
    h, w = m.shape
    dist = np.empty((h, w), np.float32)
    labels = np.empty((h, w), np.int32) if with_labels else None
    lib.chamfer5(m.ctypes.data_as(_U8P), h, w, dist.ctypes.data_as(_FP),
                 labels.ctypes.data_as(_I32P) if with_labels else None,
                 1 if with_labels else 0)
    return dist, labels


def distance_transform(mask):
    """float32 distance of each set pixel to the nearest unset one (0 on
    unset pixels), by the 5x5 chamfer of DIST_L2."""
    return _chamfer(mask, False)[0]


def distance_transform_with_labels(mask):
    """(dist, labels): labels number the unset pixels 1, 2, ... in raster
    order and give every set pixel the number of the unset pixel its
    distance came from."""
    return _chamfer(mask, True)
