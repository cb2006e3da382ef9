"""The flagship segmentation graph: full-quality ensemble page
segmentation at full width.

Port of origami_tpu/models/flagship.py, the graph the JAX package's
bench.py and __graft_entry__ measure: 5 region and 5 separator U-Nets
(the reference's origami/core/segment.py:97-135, softmax-sum voting) as
space-to-depth nets (region s2d 4 width 2, separator s2d 2 width 1),
single-shot at the 1280x2432 canvas; pages run one after the other and
each net's members in sequence, as lax.map and lax.scan run them. The
convolutions are cuDNN's, as they are XLA's in the JAX package: it has
no hand kernel here.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

FULL_W, FULL_H = 1280, 2432
N_CLASSES = 4
N_MODELS_PER_NET = 5

REGION_NET = dict(width=2.0, s2d=4)
SEP_NET = dict(width=1.0, s2d=2)


def build_flagship(n_models_per_net=N_MODELS_PER_NET, batch=4,
                   src_hw=(2400, 1600), device=None):
    """Build the production segmentation graph on `device` (None: the
    card).

    Returns (segment, (stack_a, stack_b, images)): `segment` maps the
    region and separator members (lists of UNets) and a float32 page
    batch (B, H, W) to the (region_labels, separator_labels) u8 maps
    (B, FULL_H, FULL_W). Each net is initialised once, from a generator
    seeded 0 as the JAX graph's PRNGKey(0), and copied into every
    member; `images` are the JAX graph's numpy pages."""
    from origami_tpu_torch import device as _device
    from origami_tpu_torch.models import unet as unet_lib
    dev = _device.resolve(device)

    def stack(net):
        model = unet_lib.init_unet(
            unet_lib.create_unet(N_CLASSES, **net),
            torch.Generator().manual_seed(0))
        return [copy.deepcopy(model).to(dev).eval()
                for _ in range(n_models_per_net)]

    stack_a, stack_b = stack(REGION_NET), stack(SEP_NET)
    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (batch,) + tuple(src_hw)).astype(np.float32)).to(dev)
    return segment, (stack_a, stack_b, images)


@torch.no_grad()
def segment(stack_a, stack_b, images):
    """Per page in turn: the area resize to the canvas and /255, each
    net's members in sequence, the vote's argmax to u8."""
    from origami_tpu_torch.models.unet import ensemble_apply
    from origami_tpu_torch.ops.resize import resize
    regions, separators = [], []
    for img in images:
        x = (resize(img, (FULL_H, FULL_W), "area") / 255.0)[None, ..., None]
        for stack, out in ((stack_a, regions), (stack_b, separators)):
            probs = ensemble_apply(stack, x)
            out.append(torch.argmax(probs[0], dim=-1).to(torch.uint8))
    return torch.stack(regions), torch.stack(separators)
