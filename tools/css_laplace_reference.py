#!/usr/bin/env python3
"""The CSS tension's Laplace jump (tests/test_spurious.py::
test_css_tension_laplace) on the JAX package, gerris_tpu, on the CPU in
float64: the reference values that tests/test_torch_css_laplace.py holds
the port to.

    python3 tools/css_laplace_reference.py [OUT.json]

Runs the test's configuration (a droplet of radius 0.25 at the centre of
the unit box at level 6, sigma 1 by GfsSourceTensionCSS, nu 0.02,
velocity_bc walls, scheme "none", both projections to 1e-8 in at most
100 cycles, the default diffusion) to t = 30 * 0.4 * h * 0.1, with dtmax
= the capillary bound sqrt(h^3 / (pi sigma)), which the port's
Simulation applies to CSS as to the other tension (gerris_tpu's omits
it: ROADMAP Queue 3), so both packages take the same steps.  It prints
the steps, t, the pressure jump (the mean of P inside r < R - 3h less
the mean outside r > R + 3h) and max|U|, and writes them to OUT.json
when given.  It takes about a minute.  It imports jax and gerris_tpu;
the port imports neither.
"""
import json
import os
import sys
import time


def main():
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import jax
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    from gerris_tpu.core import bc
    from gerris_tpu.core.grid import Grid
    from gerris_tpu.models import ns
    from gerris_tpu.models.simulation import Simulation, Time
    from gerris_tpu.physics import tension, vof
    from gerris_tpu.solvers import poisson

    t0 = time.time()
    grid = Grid(level=6, dim=2)
    sigma, rd = 1.0, 0.25
    mp = poisson.MultilevelParams(tolerance=1e-8, nitermax=100)
    cfg = ns.NSConfig(
        grid=grid, u_bcs=(bc.velocity_bc(0, 2), bc.velocity_bc(1, 2)),
        nu=0.02, beta=1.0, advection=ns.adv.AdvectionParams(scheme="none"),
        vof_tracers=(("T", bc.default_scalar_bc(2)),),
        tension_css=(("T", sigma),), projection=mp, approx_projection=mp)
    sim = Simulation(cfg, time=Time(end=30 * 0.4 * grid.h * 0.1,
                                    dtmax=tension.stability_dt(grid, sigma)))
    sim.init(T=vof.fraction_from_levelset(
        grid, lambda x, y: rd * rd - (x ** 2 + y ** 2), refine=3))
    sim.run()
    x, y = [np.asarray(c) for c in grid.centers]
    r = np.sqrt(x ** 2 + y ** 2)
    P = np.asarray(sim.state["P"])
    res = dict(steps=sim.time.i, t=sim.time.t,
               jump=float(P[r < rd - 3 * grid.h].mean()
                          - P[r > rd + 3 * grid.h].mean()),
               umax=float(np.max(np.abs(np.asarray(sim.state["U"])))),
               seconds=time.time() - t0)
    print(json.dumps(res))
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump(res, f)


if __name__ == "__main__":
    main()
