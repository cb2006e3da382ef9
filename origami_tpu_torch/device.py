"""Device choice for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: there is
no quiet fallback, so a run that was meant for the card and found none
fails instead of measuring the CPU.
"""

from __future__ import annotations

import torch


def resolve(device=None):
    """`torch.device` for `device` (None -> "cuda").

    Raises RuntimeError when CUDA is asked for (explicitly or by default)
    and no card is present. Pass "cpu" to run on the CPU. Under a
    multi-process launch a bare "cuda" is the card of this process's
    local index (parallel.multihost.local_index) modulo the cards
    visible, and that card becomes the process's current device; an
    explicit "cuda:N" stays."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %r" % (device,))
    if dev.type == "cuda" and dev.index is None:
        from origami_tpu_torch.parallel.multihost import local_index
        index = local_index()
        if index is not None:
            dev = torch.device("cuda", index % torch.cuda.device_count())
            torch.cuda.set_device(dev)
    return dev
