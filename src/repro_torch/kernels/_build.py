"""Build and load the hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface. On first use they are
compiled with ``nvcc`` for ``sm_90a`` into one shared library in
``build/repro_torch_kernels/`` at the repository root, named by a hash of
the sources so an edited kernel is rebuilt, and loaded with :mod:`ctypes`.
Nothing is compiled or loaded when this module is imported: a machine
without a CUDA toolkit imports the package and runs the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "screen_select.cu",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIB = None
# what ptxas said about the last build (registers, shared memory, spills)
BUILD_LOG = ""
# filled from the library's coconut_layout when it is loaded
LAYOUT: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "coconut_layout": ([_P], None),
    "coconut_screen_select": (
        [_I, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P], _I),
    "coconut_screen_select_quant": (
        [_P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P], _I),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return str(path)


def library() -> ctypes.CDLL:
    """The loaded kernel library, compiled on first use."""
    global _LIB, BUILD_LOG
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        digest = hashlib.sha256()
        for src in SOURCES:
            digest.update(src.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        so = BUILD_DIR / f"libcoconut_kernels-{digest.hexdigest()[:16]}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            BUILD_LOG = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{BUILD_LOG}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        out = (ctypes.c_int * 3)()
        lib.coconut_layout(out)
        LAYOUT.update(max_slate=out[0], query_block=out[1], tile=out[2])
        _LIB = lib
        return lib


def layout() -> dict:
    """The kernels' launch layout as the built library defines it:
    ``max_slate``, ``query_block`` (queries per block) and ``tile``
    (candidates per tile)."""
    library()
    return LAYOUT
