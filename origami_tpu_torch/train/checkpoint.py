"""Training checkpoints: trainer state in step directories.

Port of origami_tpu/train/checkpoint.py, where Orbax keeps params and
optimizer state per step. Here each step is a directory `<ckpt_dir>/<step>/`
holding `state.pt`, the model's and the optimizer's state dicts written
with torch.save; a step is written to a temporary directory and renamed,
so a crash never leaves half a step, and only the newest `max_to_keep`
steps are kept. `restore_state` loads tensors only (weights_only), on
the CPU; `load_state_dict` moves them where the model lives.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path

import torch


def _steps(ckpt_dir):
    d = Path(ckpt_dir)
    if not d.is_dir():
        return []
    return sorted(int(p.name) for p in d.iterdir()
                  if p.name.isdigit() and (p / "state.pt").exists())


def save_state(ckpt_dir, step, params, opt_state, max_to_keep=3):
    """Write step `step`: `params` and `opt_state` are state dicts (a
    module's or optimizer's, or anything torch.save takes). Returns the
    step."""
    d = Path(ckpt_dir).absolute()
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / (".%d.tmp.%d" % (int(step), os.getpid()))
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    torch.save({"step": int(step), "params": params,
                "opt_state": opt_state}, tmp / "state.pt")
    final = d / str(int(step))
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    for old in _steps(d)[:-max_to_keep] if max_to_keep else []:
        shutil.rmtree(d / str(old), ignore_errors=True)
    return int(step)


def latest_step(ckpt_dir):
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_state(ckpt_dir):
    """Restore the latest checkpoint: (step, params, opt_state), or None
    if there is none. The JAX function's templates have no counterpart:
    state dicts carry their own structure."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    state = torch.load(Path(ckpt_dir) / str(step) / "state.pt",
                       map_location="cpu", weights_only=True)
    return step, state["params"], state["opt_state"]
