"""chip_smoke.py's phase 18 alone (the flagship ensemble graph against
the JAX label maps of tests/data/torch_flagship, the sharded predictor,
two segment processes and the dry run over the visible cards) after the
build:

    python3 scripts/chip_phase18.py

On one card, as chip_smoke.py runs it, both segment processes share the
card; on several, process 1 runs on card 1 and the mesh and the dry run
span every card.

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
    from origami_tpu_torch.geometry import native_bindings
    from origami_tpu_torch.ops import _build
    t0 = time.time()
    _build.build(force=True)
    native_bindings.build(True)
    print("built in %.1f s" % (time.time() - t0))
    print(cs.smi_line())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    code = 0
    with tempfile.TemporaryDirectory() as t:
        t1 = time.time()
        try:
            launches, ms, peak = cs.check_scale_out(Path(t))
            print("== phase 18 ok (%.1f s; %d sauvola_packed launches in "
                  "the two-process run; flagship %.2f ms a page, peak %.0f "
                  "MiB)" % (time.time() - t1, launches, ms, peak))
        except Exception:
            traceback.print_exc()
            print("== phase 18 FAILED (%.1f s)" % (time.time() - t1))
            code = 1
    print("total %.1f s" % (time.time() - t0))
    sys.exit(code)
