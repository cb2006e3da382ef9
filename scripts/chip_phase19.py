"""chip_smoke.py's phase 19 alone (mesh training: the trainers on meshes
against phase 14b's JAX numbers, the region trainer on a 2 x 2 mesh
with the warp against one device, the dry run's training half) after
the build:

    python3 scripts/chip_phase19.py

On one card, as chip_smoke.py runs it, every mesh entry is card 0; on
several, the meshes take the cards in turn and each card's peak memory
is printed.

A failure prints its traceback; the script does not print chip_smoke's
result lines.
"""
import sys
import tempfile
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    import torch
    from origami_tpu_torch.ops import _build
    t0 = time.time()
    _build.build(force=True)
    print("built in %.1f s" % (time.time() - t0))
    print(cs.smi_line())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    code = 0
    with tempfile.TemporaryDirectory() as t:
        t1 = time.time()
        try:
            launched = cs.check_mesh_training(Path(t))
            print("== phase 19 ok (%.1f s; %d remap_batch launches in the "
                  "2 x 2 mesh run)" % (time.time() - t1, launched))
        except Exception:
            traceback.print_exc()
            print("== phase 19 FAILED (%.1f s)" % (time.time() - t1))
            code = 1
    print("total %.1f s" % (time.time() - t0))
    sys.exit(code)
