"""chip_smoke.py's phase 25 alone (old-style JPEG, YCbCr outside JPEG,
old-style LZW and 12-bit TIFF: decode parity against PIL's digests in
tests/data/torch_formats, the nine-stage chain on the old-style JPEG
pages, host decode times) after the build, on one card:

    python3 scripts/chip_phase25.py

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
    import torch
    from origami_tpu_torch.geometry import native_bindings
    from origami_tpu_torch.ops import _build
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    _build.build(force=True)
    native_bindings.build(True)
    print("built in %.1f s" % (time.time() - t0))
    print(cs.smi_line())
    code = 0
    with tempfile.TemporaryDirectory() as t:
        t1 = time.time()
        try:
            launches, seconds = cs.check_tiff_kinds(Path(t))
            print("== phase 25 ok (%.1f s; launches %s)" % (
                seconds, json.dumps({k: v for k, v in launches.items()
                                     if v})))
        except Exception:
            traceback.print_exc()
            print("== phase 25 FAILED (%.1f s)" % (time.time() - t1))
            code = 1
    print("total %.1f s" % (time.time() - t0))
    sys.exit(code)
