"""Page: lazy image decode, geometry, device-resident pixels.

Port of origami_tpu/core/page.py (the part the segment and OCR stages
need): pixels decode lazily through the port's PNG reader (grayscale, as
PIL's convert("L")), upload to the page's device once as u8, dewarp
there through the dewarp kernel and binarize there through the Sauvola
kernel. Process-wide LRUs keyed by (path, mtime) keep every stage of a
process from decoding, uploading, dewarping or binarizing a page twice
(page.py:39-117); `set_cache_budget` sizes them for a pipelined runner.
"""

from __future__ import annotations

import collections
from pathlib import Path

import numpy as np
import torch

from origami_tpu_torch import device as _device
from origami_tpu_torch.core import _png
from origami_tpu_torch.core.math import Geometry

_IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png", ".tif", ".tiff", ".jp2", ".bmp")

_PIXELS_LRU = collections.OrderedDict()        # decoded host pixels
_DEVICE_PIXELS_LRU = collections.OrderedDict()  # u8 page on its device
_DEWARPED_LRU = collections.OrderedDict()      # u8 dewarped page
_BINARIZED_LRU = collections.OrderedDict()     # bool host masks
# pages each cache holds; the binarized cache holds two spaces (warped
# and dewarped) a page. A runner that keeps several waves of pages alive
# raises it (set_cache_budget), so that no page is derived twice.
_PAGES = 24


def set_cache_budget(pages_in_flight):
    """Hold pages_in_flight + 4 pages in each cache (page.py:75-87); the
    caches never shrink below their defaults."""
    global _PAGES
    _PAGES = max(_PAGES, int(pages_in_flight) + 4)


def find_image_path(path):
    """Resolve a page path tolerating a different image extension."""
    path = Path(path)
    if path.exists():
        return path
    candidates = [c for c in path.parent.glob(path.stem + ".*")
                  if c.suffix.lower() in _IMAGE_SUFFIXES]
    if len(candidates) != 1:
        raise FileNotFoundError(path)
    return candidates[0]


def is_image(path):
    return Path(path).suffix.lower() in _IMAGE_SUFFIXES


def _lru_get(lru, key):
    if key is not None and key in lru:
        lru.move_to_end(key)
        return lru[key]
    return None


def _lru_put(lru, key, value):
    if key is None:
        return
    lru[key] = value
    while len(lru) > (2 * _PAGES if lru is _BINARIZED_LRU else _PAGES):
        lru.popitem(last=False)


class Page:
    def __init__(self, path, dewarping_grid=None, device=None):
        """`device` None means the card (raises without one); pass "cpu"
        to keep the page on the CPU."""
        self._path = find_image_path(path)
        self._grid = dewarping_grid
        self._device = _device.resolve(device)
        self._pixels = None
        self._lazy_size = None

    def _file_key(self, *extra):
        try:
            return (str(self._path), self._path.stat().st_mtime) + extra
        except OSError:
            return None

    @property
    def path(self):
        return self._path

    @property
    def grid(self):
        return self._grid

    @property
    def device(self):
        return self._device

    @property
    def warped(self):
        """Grayscale u8 (H, W) numpy pixels."""
        if self._pixels is None:
            key = self._file_key()
            px = _lru_get(_PIXELS_LRU, key)
            if px is None:
                px = _png.read_gray(self._path)
                _lru_put(_PIXELS_LRU, key, px)
            self._pixels = px
        return self._pixels

    @property
    def device_pixels(self):
        """The warped page as a u8 tensor on the page's device."""
        key = self._file_key(str(self._device))
        dev = _lru_get(_DEVICE_PIXELS_LRU, key)
        if dev is None:
            dev = torch.from_numpy(np.ascontiguousarray(self.warped)) \
                .to(self._device)
            _lru_put(_DEVICE_PIXELS_LRU, key, dev)
        return dev

    def _grid_fp(self):
        g = self._grid
        return (g.resolution, g._hv.shape, float(g._hv.sum()),
                float(g._hv[-1, -1].sum()))

    @property
    def dewarped_dev(self):
        """The dewarped page, u8 on the page's device (None: no grid)."""
        if self._grid is None:
            return None
        key = self._file_key(str(self._device), self._grid_fp())
        dev = _lru_get(_DEWARPED_LRU, key)
        if dev is None:
            from origami_tpu_torch.core.dewarp import Dewarper
            dev = Dewarper(self.device_pixels, self._grid).dewarped_dev
            _lru_put(_DEWARPED_LRU, key, dev)
        return dev

    def _binarize(self, key, pixels_dev):
        """Sauvola mask (True = paper) of a u8 page on the device, as a
        numpy bool array. The kernel packs it to a bit per pixel, so the
        device writes and the host receives an eighth of the mask."""
        out = _lru_get(_BINARIZED_LRU, key)
        if out is None:
            from origami_tpu_torch.ops.binarize import sauvola_packed
            packed = sauvola_packed(pixels_dev, 15).cpu().numpy()
            out = np.unpackbits(packed, axis=1)[
                :, : pixels_dev.shape[1]].astype(bool)
            _lru_put(_BINARIZED_LRU, key, out)
        return out

    @property
    def binarized(self):
        """Sauvola-binarized warped page (True = paper) as numpy; flow,
        layout and lines all consume it."""
        return self._binarize(self._file_key("warped-bin"),
                              self.device_pixels)

    @property
    def dewarped_binarized(self):
        return self._binarize(
            self._file_key("dewarped-bin", self._grid_fp()),
            self.dewarped_dev)

    def size(self, dewarped=False):
        """(width, height); dewarped: the upsampled grid extent
        (page.py:216-224), without running the dewarp."""
        if dewarped and self._grid is not None:
            hv = self._grid._hv
            res = self._grid.resolution
            return (int(hv.shape[1] * res), int(hv.shape[0] * res))
        if self._pixels is None:
            if self._lazy_size is None:
                self._lazy_size = tuple(_png.read_size(self._path))
            return self._lazy_size
        h, w = self._pixels.shape[:2]
        return (w, h)

    def geometry(self, dewarped=False):
        return Geometry(*self.size(dewarped))
