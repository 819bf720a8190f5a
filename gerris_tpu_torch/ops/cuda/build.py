"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

The sources in ``gerris_tpu_torch/csrc`` are compiled at first use into
``build/gerris_tpu_torch/`` at the repository root, with a plain C
interface (no PyTorch headers, so a build takes seconds).  The library
name carries a hash of the sources, so an edited source is rebuilt.
Importing this module never runs nvcc.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
SOURCES = (_PKG / "csrc" / "rbgs.cu",)
BUILD_DIR = _PKG.parent / "build" / "gerris_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (on PATH or under /usr/local/cuda)")


def library_path() -> Path:
    digest = hashlib.sha1()
    for src in SOURCES:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libgerris_rbgs-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)   # atomic: a concurrent build never sees half
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    "gtt_residual_restrict": [_P, _P, _P, _D, _D, _I, _I, _D, _D, _D, _D,
                              _D, _D, _D, _D, _I, _P, _P, _P, _P],
    "gtt_restrict2": [_P, _I, _I, _P, _P],
    "gtt_prolong_relax": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _D, _D, _D,
                          _D, _D, _D, _D, _I, _P],
}


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib
