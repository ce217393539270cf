"""Build and load the hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface. On first use each is
compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc`` per source, all started
together), and the objects are linked into one shared library in
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
SOURCES = (CSRC / "screen_fused.cu", CSRC / "summarize.cu", CSRC / "lower_bound.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIB = None
# what ptxas said about the last build (registers, shared memory, spills)
BUILD_LOG = ""
# filled from the library's layout functions when it is loaded
LAYOUT: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "coconut_screen_layout": ([_P], None),
    "coconut_screen_select": (
        [_I, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P], _I),
    "coconut_screen_select_quant": (
        [_P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P], _I),
    "coconut_topk_ed": (
        [_P, _I, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P], _I),
    "coconut_min_ed": ([_P, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P], _I),
    "coconut_summarize_layout": ([_P], None),
    "coconut_paa": ([_P, _I, _I, _I, _P, _P], _I),
    "coconut_sax_pack": ([_P, _I, _I, _P, _I, _I, _I, _P, _P, _P], _I),
    "coconut_mindist": ([_P, _P, _P, _I, _I, _F, _I, _P, _P], _I),
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


def compile_objects(stem: str) -> tuple[list, str]:
    """Compile every source at once into objects in BUILD_DIR named after
    ``stem``; returns the objects and what nvcc and ptxas said. The caller
    removes the objects."""
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    objs = [BUILD_DIR / f"{src.stem}-{stem}.{tag}.o" for src in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(SOURCES, objs)]
    log = "".join(proc.communicate()[0] for proc in procs)
    for src, proc in zip(SOURCES, procs):
        if proc.returncode != 0:
            for obj in objs:
                obj.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{log}")
    return objs, log


def link(objs, so: Path) -> str:
    """Link ``objs`` into the shared library ``so`` with a static copy of the
    CUDA runtime (nvcc's default); returns what the linker said."""
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-shared", "-cudart", "static", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"linking failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return proc.stdout + proc.stderr


def load(so: Path) -> ctypes.CDLL:
    """Load a built library, set its functions' signatures and read its
    layout; it becomes the library the wrappers launch from."""
    global _LIB
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    out = (ctypes.c_int * 4)()
    lib.coconut_screen_layout(out)
    LAYOUT["screen"] = dict(pass_slate=out[0], query_block=out[1], tile=out[2])
    lib.coconut_summarize_layout(out)
    LAYOUT.update(max_key_words=out[0], max_breakpoints=out[1])
    _LIB = lib
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, compiled on first use."""
    global BUILD_LOG
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
            objs, BUILD_LOG = compile_objects(so.stem)
            try:
                BUILD_LOG += link(objs, so)
            finally:
                for obj in objs:
                    obj.unlink(missing_ok=True)
        return load(so)


def layout() -> dict:
    """The kernels' launch layout as the built library defines it:
    ``screen``, the layout of the three screens, ``topk_ed`` and
    ``min_ed`` (``query_block``, queries per block; ``tile``, candidates
    per tile; ``pass_slate``, the most slate entries one pass holds, longer
    slates taking several passes); ``max_key_words`` and
    ``max_breakpoints`` of SAX-pack."""
    library()
    return LAYOUT
