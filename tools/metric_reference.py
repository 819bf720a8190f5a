#!/usr/bin/env python3
"""The lid cavity under a general metric on the JAX package, gerris_tpu,
on the CPU in float64: the reference values that
tests/test_torch_metric.py holds the port's metric step to.

    python3 tools/metric_reference.py [OUT.json]

For MetricStretch(1, 0.1) (test/lake's factor) and MetricLonLat() at
level 4 (16^2): the cavity of tests/test_metric.py (u = 1 on the lid,
nu 1e-3, NSConfig's default schedules) from the seeded velocity of
``initial_state``, dt = 0.2 h, the initial projection and one ns_step,
each run eagerly (jax.disable_jit).  The JAX step's merged-cell update
merges cells that no solid cuts under these metrics (ROADMAP Queue 3:
its a / s test takes the metric's factors for fractions), which the
reference's C does not; this tool replaces that update, for these runs
only, by the update of a cell that merges with none, (a v + fv) / a,
and prints what the step then gives.  For U, V, Gx, Gy and the
mean-free P and Pmac after each it prints ``projections``: the sums of
the field times NPROJ fixed fields of normal deviates
(numpy.random.default_rng(seed k)), as one JSON line, also written to
OUT.json when given.  About a minute on the CPU.  It imports jax and
gerris_tpu; the port and chip_smoke.py import neither.
"""
import json
import math
import os
import sys
import time

import numpy as np

LEVEL = 4
NPROJ = 2
FIELDS = ("U", "V", "Gx", "Gy", "P", "Pmac")


def initial_state(x, y):
    """The seeded velocity: U and V as functions of the cell centres
    (numpy or torch arrays)."""
    lib = np if isinstance(x, np.ndarray) else __import__("torch")
    u = 0.1 * lib.sin(2 * math.pi * x) * lib.cos(math.pi * y) + 0.05
    v = 0.1 * lib.cos(3 * math.pi * x) * lib.sin(math.pi * (y + 0.5))
    return u, v


def weights(k, shape):
    """The k-th projection's field of normal deviates."""
    return np.random.default_rng(k).standard_normal(shape)


def projections(state, shape):
    """{field: [sum(w_k f) for k < NPROJ]} of a state of numpy arrays, P
    and Pmac mean-free."""
    out = {}
    for name in FIELDS:
        f = np.asarray(state[name], dtype=np.float64)
        if name in ("P", "Pmac"):
            f = f - f.mean()
        out[name] = [float(np.sum(weights(k, shape) * f))
                     for k in range(NPROJ)]
    return out


def mismatches(state, ref, shape, rtol):
    """The (field, k) of ``ref`` (projections) whose projection of
    ``state`` (numpy or CPU torch arrays) lies further from it than rtol
    times its scale, the sum of the absolute products."""
    out = []
    for name in FIELDS:
        f = np.asarray(state[name], dtype=np.float64)
        if name in ("P", "Pmac"):
            f = f - f.mean()
        for k in range(NPROJ):
            wf = weights(k, shape) * f
            if abs(np.sum(wf) - ref[name][k]) > rtol * max(
                    np.sum(np.abs(wf)), 1e-300):
                out.append((name, k))
    return out


def main():
    os.environ["JAX_PLATFORMS"] = "cpu"
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    sys.path.insert(0, root)
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from gerris_tpu.core import bc
    from gerris_tpu.core import metric
    from gerris_tpu.core.grid import Grid
    from gerris_tpu.models import ns
    import gerris_tpu.physics.solid as jsolid

    jsolid.merged_cell_update = lambda v, fv, a, s: jnp.where(
        a > 0.0, (a * v + fv) / jnp.maximum(a, 1e-30), v)
    grid = Grid(LEVEL)
    x, y = (np.asarray(c) for c in grid.centers)
    u, v = initial_state(x, y)
    z = np.zeros(grid.shape)
    st = {"U": u, "V": v, "P": z, "Pmac": z, "Gx": z, "Gy": z}
    dt = 0.2 * grid.h
    res = {"level": LEVEL, "dt": dt}
    t0 = time.perf_counter()
    for name, m in (("stretch", metric.MetricStretch(1.0, 0.1)),
                    ("lonlat", metric.MetricLonLat())):
        cfg = ns.NSConfig(
            grid=grid, nu=1e-3, metric=m,
            u_bcs=(bc.FieldBC.make(2, default=bc.Dirichlet(0.0),
                                   top=bc.Dirichlet(1.0)),
                   bc.FieldBC.uniform(bc.Dirichlet(0.0), 2)))
        js = {k: jnp.asarray(a) for k, a in st.items()}
        with jax.disable_jit():
            j0 = ns.initial_projection(js, dt, 0.0, cfg)
            j1 = ns.ns_step(j0, dt, 0.0, cfg, first_step=True)
        res[name] = {"init": projections(j0, grid.shape),
                     "step": projections(j1, grid.shape)}
    res["seconds"] = time.perf_counter() - t0
    print(json.dumps(res))
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
