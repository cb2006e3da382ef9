"""A data axis over devices.

Port of origami_tpu/parallel/mesh.py for serving. The JAX mesh has a
"data" axis (page, tile and line batches) and a "model" axis; XLA places
the blocks and inserts the collectives. Here the mesh is the data axis
alone: a batch is cut into contiguous blocks of its leading axis, one a
device, and each device holds its own replica of the modules that run on
its block.
"""

from __future__ import annotations

import copy

import torch

from origami_tpu_torch.device import resolve


class Mesh:
    """The devices of the data axis, in block order."""

    def __init__(self, devices):
        self.devices = tuple(devices)

    @property
    def shape(self):
        return {"data": len(self.devices)}


def make_mesh(devices=None):
    """A data axis over the given devices, or over every visible card.

    Entries are anything torch.device takes; several "cpu" entries make
    a mesh on the CPU."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device is available; pass devices "
                               "(e.g. ['cpu', 'cpu']) to build a mesh on "
                               "the CPU")
        devices = ["cuda:%d" % i for i in range(n)]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(resolve(d) for d in devices)


def shard_batch(mesh, batch):
    """Place an array with a leading batch axis on the mesh -> one tensor
    a device. Contiguous blocks where the leading axis divides by the
    data axis; otherwise every device gets the whole array (replicated:
    right, just not sharded), as the JAX function does."""
    x = torch.as_tensor(batch)
    n = len(mesh.devices)
    if x.dim() >= 1 and x.shape[0] % n == 0:
        k = x.shape[0] // n
        parts = [x[i * k: (i + 1) * k] for i in range(n)]
    else:
        parts = [x] * n
    return [p.to(d) for p, d in zip(parts, mesh.devices)]


def replicate(mesh, modules):
    """One copy of `modules` (a list of nn.Modules) on each device of the
    mesh -> a list of such lists, in the mesh's order."""
    return [[copy.deepcopy(m).to(d) for m in modules] for d in mesh.devices]
