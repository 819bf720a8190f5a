#!/usr/bin/env python3
"""The JAX package's runs that the port's tests hold the port to, pinned
to files so that the tests do not rerun them.

    python3 tools/jax_pins.py [NAME ...]

Each test module of MODULES names its pinned runs in a dict ``JAX_PINS``
{name: function}; a function runs the JAX package, gerris_tpu, on the CPU
in float64 as the test ran it live (eagerly, jax.disable_jit, unless it
says otherwise) and returns {key: array}.  This tool runs them (all, or
the NAMEs given) and writes each to tests/data/jax_pins/NAME.npz; the
tests read them with load(NAME), and hold the port to them with the
tolerances they held it to the live run.  A few minutes on the CPU.  The
tool imports jax and gerris_tpu (through the test modules); the port and
chip_smoke.py import neither.
"""
import contextlib
import importlib
import os
import sys
import time

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DATA = os.path.join(ROOT, "tests", "data", "jax_pins")
MODULES = ("test_torch_3d", "test_torch_adaptive", "test_torch_axi",
           "test_torch_bubble", "test_torch_bubble3d", "test_torch_capwave",
           "test_torch_couette", "test_torch_css", "test_torch_cylinder",
           "test_torch_droplet3d", "test_torch_gfs_build",
           "test_torch_moving", "test_torch_ns",
           "test_torch_pair", "test_torch_periodic", "test_torch_schemes",
           "test_torch_timebc", "test_torch_tracers", "test_torch_twophase")


def load(name: str) -> dict:
    """The pinned arrays of run ``name``."""
    path = os.path.join(DATA, name + ".npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path}: run python3 tools/jax_pins.py "
                                f"{name}")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@contextlib.contextmanager
def recording(module):
    """Every ``module.solve`` call's niter, in call order, into the list
    yielded (a JAX or a port poisson module)."""
    rec = []
    real = module.solve

    def spy(*args, **kw):
        out = real(*args, **kw)
        rec.append(int(out[1].niter))
        return out

    module.solve = spy
    try:
        yield rec
    finally:
        module.solve = real


def main():
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    want = set(sys.argv[1:])
    os.makedirs(DATA, exist_ok=True)
    done = set()
    for m in MODULES:
        mod = importlib.import_module(m)
        for name, fn in mod.JAX_PINS.items():
            if want and name not in want:
                continue
            t0 = time.perf_counter()
            arrays = {k: np.asarray(v) for k, v in fn().items()}
            np.savez_compressed(os.path.join(DATA, name + ".npz"), **arrays)
            done.add(name)
            print(f"{name}: {sorted(arrays)} in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    if want - done:
        raise SystemExit(f"no pinned run named {sorted(want - done)}")


if __name__ == "__main__":
    main()
