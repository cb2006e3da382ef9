"""take_along_axis of a float32 matrix by int32 indices.

`take_along_axis` wraps the hand-written CUDA kernel of csrc/gather.cu,
which replaces the Pallas gather probe (scripts/pallas_gather_repro.py:
`run_case.kernel` over `_lane_gather` / `_sublane_gather` of
origami_tpu/ops/pallas/remap.py). No stage launches it: the dewarp grid
build's `jnp.take_along_axis` (core/dewarp.py:131) runs inside the V
scan kernel of csrc/grid.cu, and the grid build's plain version
(ops/grid.py) takes `take_along_axis_plain` there.

    axis 1 (lane):    src (r, w), idx (r, c) -> out (r, c)
    axis 0 (sublane): src (h, c), idx (r, c) -> out (r, c)

Indices are clamped into the gathered axis, as the Pallas helpers clamp
them. `take_along_axis_plain` is the plain PyTorch version (`torch.gather`
on the clamped indices). The wrapper given CPU tensors computes the plain
version (the CPU tests run it); given CUDA tensors it launches the kernel
on the current stream or raises, never falling back. `launches[name]`
counts kernel launches.
"""

from __future__ import annotations

import torch

from origami_tpu_torch.ops.remap import (LaunchCounts, _check, _device_of,
                                         _launch, _ptr)

launches = LaunchCounts(take_along_axis_lane=0, take_along_axis_sublane=0)


def _check_args(src, idx, axis):
    dev = _device_of(src)
    _check(src, "src", torch.float32, 2, dev)
    _check(idx, "idx", torch.int32, 2, dev)
    if axis not in (0, 1):
        raise ValueError("axis must be 0 or 1, got %r" % (axis,))
    other = 1 - axis
    if idx.shape[other] != src.shape[other]:
        raise ValueError("idx %s and src %s differ off axis %d"
                         % (tuple(idx.shape), tuple(src.shape), axis))
    if src.shape[axis] == 0 and idx.numel():
        raise ValueError("cannot gather from an empty axis")
    return dev


def take_along_axis_plain(src, idx, axis):
    """out = take_along_axis(src, clip(idx, 0, n - 1), axis)."""
    _check_args(src, idx, axis)
    n = src.shape[axis]
    return torch.gather(src, axis, idx.long().clamp(0, n - 1))


def take_along_axis(src, idx, axis):
    """f32 src (2-D), i32 idx (2-D) -> f32 (idx's shape); axis 1 or 0."""
    dev = _check_args(src, idx, axis)
    if dev.type == "cpu":
        return take_along_axis_plain(src, idx, axis)
    r, c = idx.shape
    out = torch.empty((r, c), dtype=torch.float32, device=dev)
    if out.numel():
        _launch("origami_take_along_axis_f32", _ptr(src), src.shape[axis],
                _ptr(idx), r, c, axis, _ptr(out))
        launches.add("take_along_axis_lane" if axis == 1
                     else "take_along_axis_sublane")
    return out
