"""Build and load the port's CUDA kernels.

The sources in origami_tpu_torch/csrc/ are compiled at first use with
nvcc for sm_90a (Hopper), one nvcc process per source started together,
then linked into one shared library with a plain C interface:

    build/origami_tpu_torch/libkernels.so

which is loaded with ctypes. A source newer than the library triggers a
rebuild. Each C entry point launches on the stream it is given and
returns cudaGetLastError().

`-fmad=false` keeps each multiply and add rounded on its own, as
PyTorch's elementwise ops round them, so a kernel and its plain version
agree bit for bit (the kernels are bound by memory or by dependent
steps, not FLOPs); only sums reduced in another order than PyTorch's
(the grid scans' IDW sums) differ, by float32 rounding. No fast math:
cosf, sinf, sqrtf and division stay the accurate ones PyTorch uses.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "origami_tpu_torch"
SOURCES = ("remap.cu", "strips.cu", "sauvola.cu", "gather.cu", "grid.cu")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
LIBRARY = BUILD_DIR / "libkernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_long
SIGNATURES = {
    "origami_remap_f32": [_P, _I, _I, _I, _P, _P, _I, _I, _I, _F, _I, _P,
                          _P],
    "origami_remap_affine_f32": [_P, _I, _I, _F, _F, _F, _F, _F, _F, _I, _I,
                                 _F, _P, _P],
    "origami_dewarp_u8": [_P, _I, _I, _P, _I, _I, _I, _F, _I, _P, _P, _P],
    "origami_dewarp_f32": [_P, _I, _I, _P, _I, _I, _I, _F, _P, _P, _P],
    "origami_strips_dewarped": [_P, _I, _I, _P, _P, _P, _I, _I, _I, _F, _P,
                                _L, _P],
    "origami_strips_through_grid": [_P, _I, _I, _P, _I, _I, _F, _P, _P, _P,
                                    _I, _I, _I, _F, _P, _L, _P],
    "origami_sauvola_u8": [_P, _I, _I, _I, _F, _F, _I, _I, _P, _P],
    "origami_take_along_axis_f32": [_P, _I, _P, _I, _I, _I, _P, _P],
    "origami_grid_scan_h": [_P, _P, _P, _I, _I, _I, _F, _F, _P, _P],
    "origami_grid_scan_v": [_P, _P, _P, _P, _I, _I, _I, _F, _P, _P, _P],
}


def nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(path).exists():
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built")
    return path


def build(force=False):
    """Compile the sources if the library is missing or older than one
    of them. Returns nvcc's output (ptxas register/spill report), or ""
    when the library was up to date. Processes that start at once (the
    host stages' --processes workers) take a file lock in turn: the first
    builds, the others find the library up to date."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return _build(force)


def _build(force):
    sources = [CSRC / s for s in SOURCES]
    newest = max(s.stat().st_mtime for s in sources)
    if not force and LIBRARY.exists() and LIBRARY.stat().st_mtime >= newest:
        return ""
    tag = "%d" % os.getpid()
    cc = nvcc()
    objs, procs = [], []
    for src in sources:
        obj = BUILD_DIR / ("%s.%s.o" % (src.stem, tag))
        objs.append(obj)
        procs.append(subprocess.Popen(
            [cc, *ARCH, "-std=c++17", "-O3", "-fmad=false",
             "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    log = []
    failed = []
    for src, p in zip(sources, procs):
        out, _ = p.communicate()
        log.append("== %s\n%s" % (src.name, out))
        if p.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError("nvcc failed for %s:\n%s"
                           % (", ".join(failed), "\n".join(log)))
    tmp = BUILD_DIR / ("libkernels.%s.so" % tag)
    link = subprocess.run(
        [cc, *ARCH, "-shared", "-o", str(tmp)] + [str(o) for o in objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for o in objs:
        o.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n%s" % link.stdout)
    os.replace(tmp, LIBRARY)
    return "\n".join(log)


@functools.lru_cache(maxsize=1)
def library():
    """The loaded kernel library (built first where needed)."""
    build()
    lib = ctypes.CDLL(str(LIBRARY))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


class _Entries:
    """The C entry points of SIGNATURES as attributes
    (`entries.origami_remap_f32`), bound once: the first attribute read
    loads the library and sets every entry point on this object, so
    later reads are plain attribute lookups."""

    def __getattr__(self, name):
        if name not in SIGNATURES:
            raise AttributeError(name)
        lib = library()
        for fn in SIGNATURES:
            setattr(self, fn, getattr(lib, fn))
        return getattr(lib, name)


entries = _Entries()
