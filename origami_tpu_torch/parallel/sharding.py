"""Parameter sharding rules (tensor parallelism over the "model" axis).

Port of origami_tpu/parallel/sharding.py. The JAX rule splits the output
channel axis of every kernel of two or more dimensions over the mesh's
"model" axis when that axis divides by the axis size m and holds at
least 2m channels; everything else is replicated. JAX's kernels keep
their output channels last (a conv kernel is HWIO); PyTorch keeps them
first (a Conv2d weight is (Cout, Cin, kh, kw), a Linear weight (out,
in)), so here the split is on axis 0. Biases and GroupNorm scales are
1-D and stay whole.

XLA inserts the gathers and reductions around the JAX rules; the port's
trainers do that in train/mesh.py.
"""

from __future__ import annotations

# the axis a split leaf is cut along (PyTorch's output channels)
SPLIT_AXIS = 0


def param_spec(name, tensor, model_axis_size):
    """The axis of `tensor` split over the model axis, or None where the
    leaf stays whole on every device. `name` is the leaf's path (the
    rule, like JAX's, reads only the shape)."""
    shape = tuple(tensor.shape)
    m = max(int(model_axis_size), 1)
    if len(shape) >= 2 and shape[SPLIT_AXIS] % m == 0 \
            and shape[SPLIT_AXIS] >= 2 * m:
        return SPLIT_AXIS
    return None


def param_shardings(mesh, module):
    """{leaf name: split axis or None} over `module`'s parameters."""
    m = mesh.shape["model"]
    return {name: param_spec(name, p, m)
            for name, p in module.named_parameters()}


def shard_of(tensor, axis, model_axis_size, index):
    """The slice of a split leaf that place `index` of the model axis
    owns."""
    return tensor.chunk(model_axis_size, axis)[index]


def shard_params(mesh, module):
    """Each device's part of `module`'s parameters, in the mesh's order:
    [{leaf name: tensor on that device}], the slice of a split leaf that
    the device's place on the model axis owns and the whole of every
    other leaf."""
    m = mesh.shape["model"]
    axes = param_shardings(mesh, module)
    out = []
    for k, dev in enumerate(mesh.devices):
        part = {}
        for name, p in module.named_parameters():
            t = p.detach()
            if axes[name] is not None:
                t = shard_of(t, axes[name], m, k % m)
            part[name] = t.to(dev, copy=True)
        out.append(part)
    return out
