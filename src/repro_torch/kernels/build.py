"""Build the port's CUDA kernels at first use and load them with ctypes.

Route (b) of the Hopper kernel guide: each ``csrc/*.cu`` file has a plain
C interface and compiles with ``nvcc`` for ``sm_90a`` into its own shared
library (seconds, not the minutes a PyTorch-header extension takes).  The
builds run in parallel, one ``nvcc`` per source, into ``build/`` at the
repository root (listed in ``.gitignore``).  A library's file name carries
a hash of its source and flags, so an edited source is rebuilt and a
stale library is never loaded.

Nothing here runs at import: :func:`library` builds on its first call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("gram", "grouped_combine")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# C signatures of every exported entry point (restype is int: the
# cudaGetLastError() code)
SIGNATURES = {
    "gram": {
        "zolo_gram_f32": (_P, _P, _I, _I, _LL, _P, _P),
        "zolo_gram_bf16": (_P, _P, _I, _I, _LL, _P, _P),
    },
    "grouped_combine": {
        "zolo_grouped_combine": (_I, _I, _P, _P, _P, _LL, _I, _P, _P, _P),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
PTXAS_LOG: Dict[str, str] = {}  # per source: nvcc's -Xptxas -v report


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
                       "the CUDA kernels are built from source at first use")


def _target(name: str) -> pathlib.Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> Dict[str, pathlib.Path]:
    """Compile every listed source that has no current library, all
    ``nvcc`` processes at once.  Returns {name: library path}; raises
    ``RuntimeError`` with the compiler's output if any build fails.  The
    ``-Xptxas -v`` report (registers, shared memory, spills) of each
    fresh build is kept in :data:`PTXAS_LOG`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if todo:
        nvcc = nvcc_path()
        procs = {}
        for n, t in todo.items():
            tmp = t.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT,
                                         text=True), tmp)
        failed = []
        for n, (p, tmp) in procs.items():
            out, _ = p.communicate()
            PTXAS_LOG[n] = out
            if p.returncode != 0:
                failed.append(f"--- {n}.cu (nvcc exit {p.returncode})\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, todo[n])  # atomic: readers never see halves
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" +
                               "\n".join(failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed,
    with ``argtypes``/``restype`` declared for every entry point."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build((name,))[name]
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{code}")
