"""chip_smoke.py's phase 14 alone (training: the warp kernel, the JAX
trainers' numbers, the main path, --processes) after the build and
phase 2's kernel checks, on one card:

    python3 scripts/chip_phase14.py [kernels,warp,parity,main,processes]

Each part's failure is printed with its traceback and the next part
runs; the script does not print chip_smoke's result lines.
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
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from origami_tpu_torch.geometry import native_bindings
    from origami_tpu_torch.ops import _build
    t0 = time.time()
    out = _build.build(force=True)
    native_bindings.build(True)
    print("built in %.1f s" % (time.time() - t0))
    for line in out.splitlines():
        if "registers" in line or line.startswith("=="):
            print(" ", line.strip())
    print(cs.smi_line())
    dev = torch.device("cuda")
    steps = [("kernels", lambda w: cs.check_kernels(dev)),
             ("warp", cs.check_train_warp),
             ("parity", cs.check_train_parity),
             ("main", cs.check_train_main_path),
             ("processes", cs.check_processes)]
    only = sys.argv[1].split(",") if len(sys.argv) > 1 else None
    with tempfile.TemporaryDirectory() as t:
        for name, fn in steps:
            if only and name not in only:
                continue
            t1 = time.time()
            try:
                r = fn(Path(t))
                print("== %s ok (%.1f s): %s" % (name, time.time() - t1,
                                                 r if name != "kernels"
                                                 else r.get("remap")))
            except Exception:
                traceback.print_exc()
                print("== %s FAILED (%.1f s)" % (name, time.time() - t1))
    print("total %.1f s" % (time.time() - t0))
