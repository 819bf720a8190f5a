"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

The sources in ``gerris_tpu_torch/csrc`` are compiled at first use into
``build/gerris_tpu_torch/`` at the repository root, with a plain C
interface (no PyTorch headers, so a build takes seconds): one nvcc per
source, all started together, then one link.  The library name carries
a hash of the sources and headers, so an edited source is rebuilt.
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
_CSRC = _PKG / "csrc"
SOURCES = tuple(_CSRC / f for f in ("rbgs.cu", "projops.cu", "predict.cu",
                                        "bcg.cu", "rbgs3d.cu"))
HEADERS = (_CSRC / "stencil.cuh",)
BUILD_DIR = _PKG.parent / "build" / "gerris_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")


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
    for src in SOURCES + HEADERS:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libgerris_kernels-{digest.hexdigest()[:12]}.so"


def _run_all(cmds):
    """Run the commands in parallel; raise with every failure's output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in SOURCES]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                  for src, obj in zip(SOURCES, objs)])
        lib = str(Path(tmp) / out.name)
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)   # atomic: a concurrent build never sees half
    return out


_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_DP = ctypes.POINTER(ctypes.c_double)   # a host array of BC values
_PP = ctypes.POINTER(ctypes.c_void_p)   # a host table of device pointers
_IP = ctypes.POINTER(ctypes.c_int)       # a host array of ints
_SIGNATURES = {
    "gtt_residual_restrict": [_I, _PP, _DP, _DP, _D, _I, _I, _DP, _I, _P],
    "gtt_restrict2": [_I, _PP, _I, _I, _P],
    "gtt_prolong_relax": [_I, _PP, _DP, _I, _I, _I, _I, _I, _D, _D, _DP, _I,
                          _P],
    "gtt_residual": [_P, _P, _P, _I, _I, _D, _D, _DP, _DP, _I, _I, _P],
    "gtt_rbgs_relax": [_P, _P, _P, _I, _I, _I, _I, _I, _D, _D, _D, _DP, _I,
                       _I, _P],
    "gtt_coarse_block": [_P, _P, _I, _I, _I, _I, _D, _D, _DP, _I, _P],
    "gtt_rbgs_relax_alpha": [_PP, _I, _I, _I, _I, _I, _D, _D, _D, _DP, _I,
                             _I, _P],
    "gtt_residual_restrict_div": [_PP, _D, _DP, _D, _D, _I, _I, _DP, _I, _P],
    "gtt_prolong_relax_correct": [_PP, _D, _I, _I, _I, _I, _I, _D, _D, _D,
                                  _D, _DP, _DP, _I, _P],
    "gtt_rbgs_relax_3d": [_P, _P, _P, _I, _I, _I, _I, _D, _D, _D, _DP, _P],
    "gtt_divergence_mac": [_P, _P, _I, _I, _D, _I, _I, _P, _P, _P, _P],
    "gtt_correct_project": [_P, _P, _P, _P, _P, _I, _I, _D, _D, _DP, _DP,
                            _I, _P, _P, _P, _P, _P, _P, _P],
    "gtt_interp_faces": [_P, _P, _P, _P, _D, _I, _I, _I, _DP, _D, _P, _P,
                         _P, _P, _P, _P, _P, _P],
    "gtt_predict_xy": [_P, _P, _I, _I, _D, _DP, _DP, _DP, _DP, _I, _DP, _D,
                       _P, _P, _P, _P, _P, _P],
    "gtt_advect2d": [_P, _P, _P, _P, _P, _I, _I, _D, _D, _DP, _DP, _I, _I,
                     _DP, _I, _D, _P, _P],
    "gtt_advect2d_pair": [_PP, _P, _P, _I, _I, _D, _D, _DP, _DP, _IP, _DP, _I,
                          _D, _I, _D, _D, _P],
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
