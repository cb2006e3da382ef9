"""Training on a (data x model) mesh in one process.

The JAX trainers place their parameters with parallel/sharding.py's
rules and their batches over the mesh's "data" axis; XLA's GSPMD then
inserts the gathers and the gradient reductions. `MeshModel` does that
work for the port's trainers, on the devices of one process:

  * at rest each device holds a slice of every split leaf (its place on
    the model axis) and the whole of every other leaf, each with its
    AdamW moments; the replicated leaves are the device's replica's own
    parameters;
  * for a step the computing devices gather their group's slices into
    whole leaves, and the global batch is cut into blocks (`blocks`):
    over the data axis as JAX's shard_batch cuts it (a batch that does
    not divide runs whole, in the first group), then each group's block
    over its model devices (one that does not divide runs on the group's
    first device), so no device repeats another's work;
  * each block back-propagates its share of the global loss, the blocks'
    gradients are summed in block order on the first device, and every
    device updates its slices (or whole leaves) with the sum: replicated
    leaves stay bit-identical across replicas;
  * after the update the gathered leaves are freed.

The trainers compute each block's share so that the shares add up to the
loss of the whole batch (a global weighted mean, not the mean of the
blocks' means).
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from origami_tpu_torch.device import resolve
from origami_tpu_torch.parallel.mesh import Mesh
from origami_tpu_torch.parallel.sharding import param_shardings, shard_of


def mesh_or_device(mesh, device):
    """`mesh`, or a one-device mesh on `device` (None -> cuda)."""
    if mesh is not None and device is not None:
        raise ValueError("pass a mesh or a device, not both")
    return mesh if mesh is not None else Mesh([resolve(device)])


def upload(mesh, arrays):
    """The arrays on each distinct device of the mesh, once a device:
    {device: [tensors]}."""
    tensors = [torch.as_tensor(a) for a in arrays]
    return {d: [t.to(d) for t in tensors]
            for d in dict.fromkeys(mesh.devices)}


def _freed(p):
    return torch.empty(0, dtype=p.dtype, device=p.device)


class MeshModel:
    """`module` and its optimizer on `mesh`. `make_optimizer(params)`
    builds one device's optimizer over its slices and whole leaves;
    `split=False` keeps every leaf whole (data parallelism only, as the
    JAX recognizer trainer places its parameters)."""

    def __init__(self, mesh, module, make_optimizer, split=True):
        self.mesh = mesh
        m = self.m = mesh.shape["model"]
        copies = [copy.deepcopy(module) for _ in mesh.devices[1:]]
        self.replicas = [r.to(d) for r, d in zip([module] + copies,
                                                 mesh.devices)]
        axes = param_shardings(mesh, module) if split and m > 1 else {}
        self.split = {n: a for n, a in axes.items() if a is not None}
        self.shards = []
        for k, rep in enumerate(self.replicas):
            part = {}
            for name, p in rep.named_parameters():
                if name in self.split:
                    piece = shard_of(p.detach(), self.split[name], m, k % m)
                    part[name] = nn.Parameter(piece.clone(),
                                              requires_grad=p.requires_grad)
                    p.data = _freed(p)
                else:
                    part[name] = p
            self.shards.append(part)
        self.optimizers = [make_optimizer(list(part.values()))
                           for part in self.shards]

    def blocks(self, b):
        """[(device index, slice of the batch)] for a global batch of b
        rows, in block order."""
        n, m = self.mesh.shape["data"], self.m
        groups = [(i, slice(i * (b // n), (i + 1) * (b // n)))
                  for i in range(n)] if b % n == 0 else [(0, slice(0, b))]
        out = []
        for i, s in groups:
            size = s.stop - s.start
            if size % m == 0:
                t = size // m
                out += [(i * m + j, slice(s.start + j * t, s.start
                                          + (j + 1) * t)) for j in range(m)]
            else:
                out.append((i * m, s))
        return out

    def scatter(self, parts, arrays):
        """{device index: (each array's rows of its block, on its
        device)} for the blocks `parts`."""
        return {k: tuple(a[rows].to(self.mesh.devices[k]) for a in arrays)
                for k, rows in parts}

    def gather(self, ks):
        """Whole split leaves on the devices `ks`, each from its data
        group's slices."""
        m = self.m
        for k in ks:
            dev = self.mesh.devices[k]
            first = k - k % m
            params = dict(self.replicas[k].named_parameters())
            for name, axis in self.split.items():
                params[name].data = torch.cat(
                    [self.shards[first + j][name].detach().to(dev)
                     for j in range(m)], axis)

    def update(self, ks):
        """Sum the gradients of the devices `ks` (in that order, on the
        first of them), give every device its slice of the sum, step
        every optimizer and free the gathered leaves."""
        params = [dict(self.replicas[k].named_parameters()) for k in ks]
        for name, p in params[0].items():
            if not p.requires_grad:
                continue
            grads = [ps[name].grad for ps in params]
            total = grads[0]
            for g in grads[1:]:
                total += g.to(total.device)
            axis = self.split.get(name)
            for k, part in enumerate(self.shards):
                piece = total if axis is None \
                    else shard_of(total, axis, self.m, k % self.m)
                part[name].grad = piece.to(self.mesh.devices[k])
        for opt in self.optimizers:
            opt.step()
        for ps in params:
            for name in self.split:
                ps[name].data = _freed(ps[name])
                ps[name].grad = None

    def zero_grad(self):
        for opt in self.optimizers:
            opt.zero_grad()

    def step(self, parts, run_block):
        """One update over the blocks `parts` ([(device index, rows)] of
        `blocks`): `run_block(k, replica, rows)` computes device k's
        block on its replica, back-propagates the block's share of the
        loss and returns a detached tensor (its part of the loss's sum)
        -> those parts summed in block order on the first device."""
        ks = [k for k, _ in parts]
        self.zero_grad()
        self.gather(ks)
        shares = [run_block(k, self.replicas[k], rows) for k, rows in parts]
        self.update(ks)
        total = shares[0]
        for s in shares[1:]:
            total = total + s.to(total.device)
        return total

    def state_dict(self):
        """The module's state_dict with every split leaf whole, on the
        first device."""
        sd = self.replicas[0].state_dict()
        dev = self.mesh.devices[0]
        for name, axis in self.split.items():
            sd[name] = torch.cat([self.shards[j][name].detach().to(dev)
                                  for j in range(self.m)], axis)
        return sd

    @torch.no_grad()
    def load_state_dict(self, sd):
        """Set every device's slices and whole leaves from a whole
        state_dict (as the module names its parameters)."""
        for k, part in enumerate(self.shards):
            for name, p in part.items():
                src = torch.as_tensor(sd[name])
                if name in self.split:
                    src = shard_of(src, self.split[name], self.m,
                                   k % self.m)
                p.copy_(src)
