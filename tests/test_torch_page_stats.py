"""The page caches' counters (origami_tpu_torch/core/page.py CACHE_STATS,
cache_stats; the JAX package's page.py:91-116): a seeded sequence of
page accesses against an LRU model of the caches, and lookups without a
file key, which count nothing (the JAX package counts them as misses,
ADVICE.md; ROADMAP C8).

Tolerance: none; the counts are exact.
"""

import collections

import numpy as np
import PIL.Image
import pytest

from origami_tpu_torch.core import page

N_PAGES, CAPACITY, ACCESSES = 7, 3, 60


@pytest.fixture
def caches(monkeypatch):
    monkeypatch.setattr(page, "_PAGES", CAPACITY)
    page.clear_caches()
    page.CACHE_STATS.clear()
    yield
    page.clear_caches()
    page.CACHE_STATS.clear()


def _pages(root):
    rng = np.random.default_rng(5)
    paths = []
    for i in range(N_PAGES):
        path = root / ("p%d.png" % i)
        PIL.Image.fromarray(rng.integers(0, 256, (12, 10), dtype=np.uint8)
                            ).save(path)
        paths.append(path)
    return paths


def _lru_model(keys, capacity):
    """([hits, misses, evictions], the keys missed) of an LRU of
    `capacity` over `keys`."""
    lru, counts, missed = collections.OrderedDict(), [0, 0, 0], []
    for k in keys:
        if k in lru:
            counts[0] += 1
            lru.move_to_end(k)
            continue
        counts[1] += 1
        missed.append(k)
        lru[k] = True
        if len(lru) > capacity:
            lru.popitem(last=False)
            counts[2] += 1
    return counts, missed


def test_counts_follow_an_lru_of_the_access_sequence(caches, tmp_path):
    paths = _pages(tmp_path)
    seq = np.random.default_rng(11).integers(0, N_PAGES, ACCESSES).tolist()
    for i in seq:
        # the device copy first (a miss decodes through the pixels
        # cache), then the mask
        page.Page(paths[i], device="cpu").binarized
    device, missed = _lru_model(seq, CAPACITY)
    want = {"device_pixels": device,
            "pixels": _lru_model(missed, CAPACITY)[0],
            "binarized": _lru_model(seq, 2 * CAPACITY)[0]}
    assert page.cache_stats() == {
        name: dict(hits=h, misses=m, evictions=e)
        for name, (h, m, e) in want.items()}
    assert device[2] > 0 and want["binarized"][2] > 0


def test_unkeyed_lookups_count_nothing(caches, tmp_path, monkeypatch):
    [path] = _pages(tmp_path)[:1]
    lru = collections.OrderedDict()
    assert page._lru_get(lru, None, "pixels") is None
    page._lru_put(lru, None, 1, "pixels")
    assert not lru
    monkeypatch.setattr(page.Page, "_file_key", lambda self, *extra: None)
    for _ in range(3):
        page.Page(path, device="cpu").binarized
    assert page.cache_stats() == {}
