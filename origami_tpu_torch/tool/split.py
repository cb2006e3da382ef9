"""Optimized train/validation splitting of GT lines.

Port of origami_tpu/tool/split.py (optimal_split via line-form
clustering so visually similar lines don't leak between sets), numpy on
the host as there. Lines are clustered by a cheap signature (downsampled
ink profile) with k-means; whole clusters are assigned to one side.
"""

from __future__ import annotations

import random

import numpy as np


def line_signature(strip, n=32):
    """Downsampled column ink profile as the clustering feature."""
    strip = np.asarray(strip, dtype=np.float32)
    ink = 1.0 - strip / max(strip.max(), 1.0)
    prof = ink.mean(axis=0)
    idx = np.linspace(0, len(prof) - 1, n).astype(int)
    sig = prof[idx]
    denom = np.linalg.norm(sig) + 1e-9
    return sig / denom


def kmeans(points, k, iters=25, seed=0):
    rng = np.random.default_rng(seed)
    points = np.asarray(points, dtype=np.float64)
    k = min(k, len(points))
    centers = points[rng.choice(len(points), k, replace=False)]
    assign = np.zeros(len(points), dtype=int)
    for _ in range(iters):
        d = np.linalg.norm(points[:, None, :] - centers[None], axis=-1)
        new_assign = np.argmin(d, axis=1)
        if (new_assign == assign).all():
            break
        assign = new_assign
        for j in range(k):
            sel = points[assign == j]
            if len(sel):
                centers[j] = sel.mean(axis=0)
    return assign, centers


def optimal_split(names, signatures, valid_ratio=0.2, n_clusters=None,
                  seed=0):
    """Cluster lines and assign whole clusters to train/valid so similar
    line forms stay on one side. Returns (train_names, valid_names)."""
    if len(names) < 5:
        cut = max(1, int(len(names) * valid_ratio))
        return list(names[cut:]), list(names[:cut])
    if n_clusters is None:
        n_clusters = max(2, len(names) // 8)
    assign, _ = kmeans(np.asarray(signatures), n_clusters, seed=seed)
    clusters = {}
    for name, a in zip(names, assign):
        clusters.setdefault(int(a), []).append(name)
    order = list(clusters.values())
    random.Random(seed).shuffle(order)
    target = int(len(names) * valid_ratio)
    valid, train = [], []
    for group in order:
        if len(valid) < target:
            valid.extend(group)
        else:
            train.extend(group)
    return train, valid
