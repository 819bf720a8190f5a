#!/usr/bin/env python3
"""Where the stretched cavity's float32 pressure floor comes from: the
port's and the JAX package's float32 steps against their float64 steps,
on the CPU.

    python3 tools/stretch_f32_floor.py LEVEL [LEVEL ...]

At each LEVEL (6 to 9 take seconds; the JAX side compiles for about a
minute): chip_smoke.stretch_cfg (the bench's lid cavity, one multigrid
cycle a solve, under MetricStretch(1, 0.1): face weights 0.1 across x
and 10 across y) from rest, the initial projection and two ns_steps at
dt = 0.5 h, run
* on the port in float32 and float64;
* on the port in float64 with every Poisson right-hand side multiplied
  by (1 + 6e-8 n), n a normal deviate per cell (float32's rounding of
  the data, not of the arithmetic);
* on the JAX package, gerris_tpu, in float32 and float64 (each in a
  child process of this script, ``--jax LEVEL BITS OUT``), its
  merged-cell update swapped for the plain one as
  tools/metric_reference.py swaps it (the reference's merges cells that
  this metric's weights make small: ROADMAP Queue 3).
It prints one JSON line per level: max|a - b| / max|b| against the
float64 run of the same package for U, V, the mean-free P, ``P_y`` (P
less its mean over y in each column, chip_smoke.column_free) and
``P_col`` (the column means, mean-free), and the port's float64 run
against the JAX package's.  It imports jax and gerris_tpu in the child
processes only; the port and chip_smoke.py import neither.
"""
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
NAMES = ("U", "V", "P", "Pmac", "Gx", "Gy")
STEPS = 2


def jax_run(level, bits, out):
    """The JAX package's run in ``bits`` (32 or 64), saved to ``out``."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, ROOT)
    import jax
    if bits == 64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from gerris_tpu.core import bc, metric
    from gerris_tpu.core.grid import Grid
    from gerris_tpu.models import ns
    from gerris_tpu.solvers import poisson
    import gerris_tpu.physics.solid as jsolid

    jsolid.merged_cell_update = lambda v, fv, a, s: jnp.where(
        a > 0.0, (a * v + fv) / jnp.maximum(a, 1e-30), v)
    grid = Grid(level)
    proj = poisson.MultilevelParams(nrelax=5, omega=1.5, coarsest_relax=40,
                                    ncycles=1)
    diff = poisson.MultilevelParams(nrelax=1, omega=1.0, coarsest_relax=40,
                                    ncycles=1)
    cfg = ns.NSConfig(
        grid=grid, nu=1e-3, beta=1.0, metric=metric.MetricStretch(1.0, 0.1),
        projection=proj, approx_projection=proj, diffusion_params=diff,
        u_bcs=(bc.FieldBC.make(2, default=bc.Dirichlet(0.0),
                               top=bc.Dirichlet(1.0)),
               bc.FieldBC.uniform(bc.Dirichlet(0.0), 2)))
    dt = 0.5 * grid.h
    z = jnp.zeros(grid.shape, jnp.float64 if bits == 64 else jnp.float32)
    st = ns.initial_projection({k: z for k in NAMES}, dt, 0.0, cfg)
    for i in range(STEPS):
        st = ns.ns_step(st, dt, i * dt, cfg, first_step=(i == 0))
    np.savez(out, **{k: np.asarray(v, dtype=np.float64)
                     for k, v in st.items()})


def port_run(level, dtype, rhs_noise=0.0):
    """The port's run, as numpy float64 arrays."""
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke
    from gerris_tpu_torch.models import ns
    from gerris_tpu_torch.solvers import poisson
    cfg = chip_smoke.stretch_cfg(level)
    solve = poisson.solve
    gen = torch.Generator().manual_seed(3)

    def noisy(u, rhs, *args, **kw):
        rhs = rhs * (1.0 + rhs_noise * torch.randn(
            rhs.shape, generator=gen, dtype=rhs.dtype))
        return solve(u, rhs, *args, **kw)

    poisson.solve = noisy if rhs_noise else solve
    try:
        dt = 0.5 * cfg.grid.h
        z = torch.zeros(cfg.grid.shape, dtype=dtype)
        st = ns.initial_projection({k: z for k in NAMES}, dt, 0.0, cfg)
        for i in range(STEPS):
            st = ns.ns_step(st, dt, i * dt, cfg, first_step=(i == 0))
    finally:
        poisson.solve = solve
    return {k: v.double().numpy() for k, v in st.items()}


def distances(a, b):
    """{field: max|a - b| / max|b|} over U, V, P, P_y and P_col."""
    def views(s):
        p = s["P"] - s["P"].mean()
        col = p.mean(axis=1, keepdims=True)
        return {"U": s["U"], "V": s["V"], "P": p, "P_y": p - col,
                "P_col": col - col.mean()}
    va, vb = views(a), views(b)
    return {k: float(np.abs(va[k] - vb[k]).max() / np.abs(vb[k]).max())
            for k in va}


def main():
    if sys.argv[1] == "--jax":
        jax_run(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return
    import torch
    torch.set_num_threads(4)
    for level in (int(x) for x in sys.argv[1:]):
        with tempfile.TemporaryDirectory() as tmp:
            jx = {}
            for bits in (32, 64):
                out = os.path.join(tmp, f"j{bits}.npz")
                subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--jax", str(level), str(bits), out],
                               check=True)
                jx[bits] = dict(np.load(out))
        p32 = port_run(level, torch.float32)
        p64 = port_run(level, torch.float64)
        noisy = port_run(level, torch.float64, rhs_noise=6e-8)
        print(json.dumps({
            "level": level,
            "port_f32_vs_f64": distances(p32, p64),
            "jax_f32_vs_f64": distances(jx[32], jx[64]),
            "port_f64_rhs_noise_vs_f64": distances(noisy, p64),
            "port_f32_vs_jax_f32": distances(p32, jx[32]),
            "port_f64_vs_jax_f64": distances(p64, jx[64])}), flush=True)


if __name__ == "__main__":
    main()
