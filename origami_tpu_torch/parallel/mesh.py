"""A (data x model) grid of devices.

Port of origami_tpu/parallel/mesh.py. The JAX mesh has a "data" axis
(page, tile and line batches) and a "model" axis (channel-split
parameters); XLA places the blocks and inserts the collectives. Here the
mesh is a grid of torch devices in one process: a batch is cut into
contiguous blocks of its leading axis, one a data group, and each device
holds its own replica of the modules that run on its block. Training
splits parameters over the model axis (parallel/sharding.py, train/mesh.py).
"""

from __future__ import annotations

import copy

import torch

from origami_tpu_torch.device import resolve


class Mesh:
    """`devices` in row-major order: data group i holds devices[i * m:
    (i + 1) * m], m = model_parallel, and device j of a group is its
    place on the model axis."""

    def __init__(self, devices, model_parallel=1):
        self.devices = tuple(devices)
        self.model_parallel = int(model_parallel)
        if self.model_parallel < 1 \
                or len(self.devices) % self.model_parallel:
            raise ValueError("%d devices not divisible by model_parallel=%d"
                             % (len(self.devices), self.model_parallel))

    @property
    def shape(self):
        m = self.model_parallel
        return {"data": len(self.devices) // m, "model": m}


def make_mesh(devices=None, model_parallel=1):
    """A (data x model) mesh over the given devices, or over every
    visible card, in the JAX order (devices reshaped to (n // m, m)).

    Entries are anything torch.device takes and may repeat: several
    "cpu" entries make a mesh on the CPU, several "cuda:0" entries one
    on a single card (it checks the code paths, not the speed)."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device is available; pass devices "
                               "(e.g. ['cpu', 'cpu']) to build a mesh on "
                               "the CPU")
        devices = ["cuda:%d" % i for i in range(n)]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh((resolve(d) for d in devices), model_parallel)


def shard_batch(mesh, batch):
    """Place an array with a leading batch axis on the mesh -> one tensor
    a device. Contiguous blocks of the leading axis, one a data group and
    the same block on every device of the group, where the axis divides
    by the data axis; otherwise every device gets the whole array
    (replicated: right, just not sharded), as the JAX function does."""
    x = torch.as_tensor(batch)
    n, m = mesh.shape["data"], mesh.model_parallel
    if x.dim() >= 1 and x.shape[0] % n == 0:
        k = x.shape[0] // n
        parts = [x[(i // m) * k: (i // m + 1) * k]
                 for i in range(len(mesh.devices))]
    else:
        parts = [x] * len(mesh.devices)
    return [p.to(d) for p, d in zip(parts, mesh.devices)]


def replicate(mesh, modules):
    """One copy of `modules` (a list of nn.Modules) on each device of the
    mesh -> a list of such lists, in the mesh's order."""
    return [[copy.deepcopy(m).to(d) for m in modules] for d in mesh.devices]
