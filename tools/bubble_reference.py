#!/usr/bin/env python3
"""The rising bubble (Hysing et al., Int. J. Numer. Meth. Fluids 60
(2009) 1259-1288, test case 1) on the JAX package, gerris_tpu, on the CPU
in float64: the reference values that chip_smoke.py's bubble gate holds
the port to.

    python3 tools/bubble_reference.py LEVEL T_END OUT.json

Runs gerris_tpu's Simulation on the box [0, 1] x [0, 2] at 2^LEVEL cells
per unit to T_END with chip_smoke.bubble_cfg's configuration (density
1000 / 100, mu(T1) = 10 T1 + (1 - T1), gravity -0.98, tension 24.5,
no-slip bottom and top, free-slip sides; the projections and the
diffusion on the schedule utils/convert gives the port: tolerance 1e-3,
nrelax 8, 16 coarsest sweeps), records after every step the mean rise
velocity sum((1 - T) V) / sum(1 - T) and the centroid sum((1 - T) y) /
sum(1 - T), prints the maximum rise velocity, its time and the final
centroid, and writes them with every sample to OUT.json.  At LEVEL 6,
T_END 3 it takes ~90 s on one CPU core (575 steps).  It imports jax and
gerris_tpu; the port and chip_smoke.py import neither.
"""
import json
import os
import sys
import time


def main():
    level, tend, out = int(sys.argv[1]), float(sys.argv[2]), sys.argv[3]
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    from gerris_tpu.core import bc
    from gerris_tpu.core.grid import Grid
    from gerris_tpu.events.events import Event
    from gerris_tpu.models import ns
    from gerris_tpu.models.simulation import Simulation, Time
    from gerris_tpu.physics import vof
    from gerris_tpu.solvers import poisson

    grid = Grid(level=level, dim=2, origin=(0.0, 0.0), extents=(1, 2))
    d0 = bc.Dirichlet(0.0)
    u_bc = bc.FieldBC.make(2, left=d0, right=d0, bottom=d0, top=d0)
    v_bc = bc.FieldBC.make(2, left=bc.Neumann(), right=bc.Neumann(),
                           bottom=d0, top=d0)
    floor = dict(nrelax=8, coarsest_relax=16)
    proj = poisson.MultilevelParams(tolerance=1e-3, nitermax=100, **floor)

    def mu(x, y, t=0.0, T1=None):
        return 10.0 * T1 + 1.0 * (1.0 - T1)

    cfg = ns.NSConfig(
        grid=grid, u_bcs=(u_bc, v_bc), nu=0.0, beta=1.0,
        projection=proj, approx_projection=proj,
        diffusion_params=poisson.MultilevelParams(tolerance=1e-3,
                                                  nitermax=10, **floor),
        vof_tracers=(("T", bc.default_scalar_bc(2)),),
        tension=(("T", 24.5),), density=("T", 1000.0, 100.0, 1),
        body_force=(None, -0.98), nu_var=mu,
        nu_var_fields=(("T1", "T", 1),))
    yc = jnp.asarray(grid.centers[1])
    rec = []

    def record(sim):
        g = 1.0 - sim.state["T"]
        m = jnp.sum(g)
        rec.append((sim.time.t, float(jnp.sum(g * sim.state["V"]) / m),
                    float(jnp.sum(g * yc) / m)))

    sim = Simulation(cfg, time=Time(end=tend),
                     events=[Event(action=record, istep=1)])
    sim.init(T=vof.fraction_from_levelset(
        grid, lambda x, y: jnp.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2)
        - 0.25))
    t0 = time.time()
    sim.run()
    k = int(np.argmax([r[1] for r in rec]))
    res = dict(level=level, tend=tend, steps=sim.time.i,
               t_final=sim.time.t, vmax=rec[k][1], t_vmax=rec[k][0],
               yc_final=rec[-1][2], seconds=time.time() - t0, samples=rec)
    with open(out, "w") as f:
        json.dump(res, f)
    print({k: v for k, v in res.items() if k != "samples"})


if __name__ == "__main__":
    main()
