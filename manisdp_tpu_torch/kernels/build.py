"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources in ``manisdp_tpu_torch/csrc/`` have a plain C interface (no
PyTorch headers), so each compiles in seconds: one ``nvcc -c`` per source,
all started together, then one ``nvcc -shared`` links the objects.
The library lands in ``build/manisdp_tpu_torch/`` at the repository root,
named by a hash of the sources and flags, so an edited source is never
served from a stale build.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "manisdp_tpu_torch"
SOURCES = ("symcoo_spmm.cu", "oblique_cols.cu", "pattern_dots.cu",
           "csr_gather.cu", "masked_sym.cu", "oa_refine.cu",
           "symdual_apply.cu", "symdual_adjoint.cu", "symmom_apply.cu",
           "symmom_adjoint.cu", "tcg_step.cu")
# headers the sources include (their bytes are part of the library name)
HEADERS = ("nmajor.cuh", "oblique_tile.cuh")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _I64, _D, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, \
    ctypes.c_double, ctypes.c_uint64
_SIGNATURES = {
    "symcoo_spmm": (_P, _I64, _I64, _I64, _P, _P, _P, _P, _I, _I, _I, _I,
                    _P, _P, _I64, _I64, _I64, _P, _P, _D, _D, _P, _P, _P,
                    _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "oblique_cols": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P),
    "pattern_dots": (_P, _I64, _I64, _P, _I64, _I64, _P, _P, _I, _I, _I,
                     _I, _P, _P, _P, _I, _I, _I, _I, _P),
    "csr_gather": (_P, _P, _P, _P, _P, _D, _P, _I, _I, _I, _P, _I, _P,
                   _P),
    "masked_sym": (_P, _P, _P, _P, _D, _I, _I, _P, _P),
    "oa_refine": (_P, _P, _P, _P, _I, _P, _P, _P, _P, _P),
    "symdual_apply": (_P, _I, _P, _P, _P, _P, _P),
    "symdual_adjoint": (_P, _P, _P, _P, _P, _I, _P, _P, _D, _P, _D, _P,
                        _P),
    "symdual_apply_rows": (_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    "symdual_adjoint_rows": (_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P),
    "symdual_sym_factor": (_P, _I, _I, _I, _P, _P),
    "symdual_sym_mat": (_P, _I, _P, _P),
    "symmom_apply": (_P, _I, _P, _P, _P),
    "symmom_adjoint": (_P, _I, _P, _D, _P, _P, _P),
    "tcg_step": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _I,
                 _I, _P, _P, _P, _P, _P, _I, _P, _I, _I, _U64, _P),
}
# functions of one name, no dtype: (argtypes, restype); K11's peer-mode
# receive buffers (tcg_step.cu)
_UNTYPED = {
    "tcg_peer_layout": ((_I, _I, _I, _I, _P), None),
    "tcg_peer_alloc": ((_I64, _P, _P), ctypes.c_int),
    "tcg_peer_open": ((_P, _P), ctypes.c_int),
    "tcg_peer_close": ((_P,), ctypes.c_int),
    "tcg_peer_free": ((_P,), ctypes.c_int),
    "tcg_peer_read": ((_P, _P, _I64), ctypes.c_int),
}
# the dtypes each kernel is built for (default: both)
_SUFFIXES = {"oa_refine": ("f64",)}

_lib = None
# filled by build(): the nvcc command, its seconds and ptxas's report
# (registers, spills and shared memory of every kernel)
build_info: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
            "CUDA kernels are built from source on first use")
    return found


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libmanisdp_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; cached per
    process."""
    global _lib
    if _lib is not None:
        return _lib
    path = _lib_path()
    t0 = time.perf_counter()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        tag = f"{path.stem}.{os.getpid()}"
        objs = [BUILD_DIR / f"{Path(src).stem}.{tag}.o" for src in SOURCES]
        cmds = [[nvcc, *FLAGS, "-c", "-o", str(obj), str(SRC_DIR / src)]
                for src, obj in zip(SOURCES, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for cmd in cmds]
        outs = [proc.communicate() for proc in procs]
        for cmd, proc, (out, err) in zip(cmds, procs, outs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                    f"{out}\n{err}")
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        link = [nvcc, *FLAGS[:2], "-shared", "-o", str(tmp),
                *(str(o) for o in objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        for obj in objs:
            obj.unlink()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)
        build_info.update(cmd=[" ".join(c) for c in cmds + [link]],
                          ptxas="".join(err for _, err in outs))
    lib = ctypes.CDLL(str(path))
    for base, argtypes in _SIGNATURES.items():
        for suffix in _SUFFIXES.get(base, ("f64", "f32")):
            fn = getattr(lib, f"{base}_{suffix}")
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    for name, (argtypes, restype) in _UNTYPED.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    build_info.update(path=str(path), seconds=time.perf_counter() - t0)
    _lib = lib
    return lib
