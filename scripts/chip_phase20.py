"""chip_smoke.py's phase 20 alone (the operator tools and the remote
runner, against the JAX tools' outputs in tests/data/torch_tools) after
the build, on one card:

    python3 scripts/chip_phase20.py

A failure prints its traceback; the script does not print chip_smoke's
result lines.
"""
import json
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
            by_path, seconds = cs.check_tools(Path(t))
            print("== phase 20 ok (%.1f s; launches by path %s)"
                  % (seconds, json.dumps(by_path)))
        except Exception:
            traceback.print_exc()
            print("== phase 20 FAILED (%.1f s)" % (time.time() - t1))
            code = 1
    print("total %.1f s" % (time.time() - t0))
    sys.exit(code)
