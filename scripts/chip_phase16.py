"""chip_smoke.py's phase 16 alone (the synthetic corpus, recognizer
evaluation and training, the chain's scores on the rendered pages and
the bootstrap CLI, against the JAX package's numbers in
tests/data/torch_synth) after the build, on one card:

    python3 scripts/chip_phase16.py

Without phase 12 before it, phase 16c runs the chain on the rendered
pages itself. A failure prints its traceback; the script does not print
chip_smoke's result lines.
"""
import sys
import tempfile
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    from origami_tpu_torch.geometry import native_bindings
    from origami_tpu_torch.ops import _build
    t0 = time.time()
    _build.build(force=True)
    native_bindings.build(True)
    print("built in %.1f s" % (time.time() - t0))
    print(cs.smi_line())
    code = 0
    with tempfile.TemporaryDirectory() as t:
        t1 = time.time()
        try:
            cs.check_synth(Path(t))
            print("== phase 16 ok (%.1f s)" % (time.time() - t1))
        except Exception:
            traceback.print_exc()
            print("== phase 16 FAILED (%.1f s)" % (time.time() - t1))
            code = 1
    print("total %.1f s" % (time.time() - t0))
    sys.exit(code)
