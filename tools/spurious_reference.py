#!/usr/bin/env python3
"""The static droplet (Gerris test/spurious; Popinet, J. Comput. Phys.
228 (2009) 5838-5866, section 5.1) on the JAX package, gerris_tpu, on
the CPU in float64: the reference values that chip_smoke.py's spurious
gate holds the port to.

    python3 tools/spurious_reference.py LEVEL T_END OUT.json

Runs gerris_tpu's Simulation at 2^LEVEL cells per side to T_END with
chip_smoke.spurious_cfg's configuration (the droplet of radius 0.4 at
(-0.5, 0.5) in the unit box, velocity_bc walls, sigma 1, rho 1, nu =
sqrt(0.8 / 12000), AdvectionParams(scheme="none"), projections to 1e-6
in at most 100 cycles, diffusion to 1e-6 in at most 20), once with the
well-balanced tension and once with the CSS tension.  The CSS run is
given dtmax = the capillary bound sqrt(h^3 / (pi sigma)), which the
port's Simulation applies to CSS as to the other tension (gerris_tpu's
omits it: ROADMAP Queue 3), so both packages take the same steps.  It
prints, per tension, the steps, the shape error L2 and Linf of T - T0
and max|u| at T_END, and writes them to OUT.json.  At LEVEL 5, T_END 1
it takes a few minutes on the CPU.  It imports jax and gerris_tpu; the
port and chip_smoke.py import neither.
"""
import json
import math
import os
import sys
import time

LA = 12000.0
R = 0.4


def main():
    level, tend, out = int(sys.argv[1]), float(sys.argv[2]), sys.argv[3]
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from gerris_tpu.core import bc
    from gerris_tpu.core.grid import Grid
    from gerris_tpu.models import ns
    from gerris_tpu.models.simulation import Simulation, Time
    from gerris_tpu.physics import tension, vof
    from gerris_tpu.solvers import poisson
    from gerris_tpu.solvers.advection import AdvectionParams

    grid = Grid(level=level, dim=2)
    t0_ = vof.fraction_from_levelset(
        grid, lambda x, y: R * R - ((x + 0.5) ** 2 + (y - 0.5) ** 2))
    res = dict(level=level, tend=tend)
    for kind in ("tension", "tension_css"):
        cfg = ns.NSConfig(
            grid=grid, u_bcs=(bc.velocity_bc(0, 2), bc.velocity_bc(1, 2)),
            nu=math.sqrt(0.8 / LA), beta=1.0,
            advection=AdvectionParams(scheme="none"),
            vof_tracers=(("T", bc.default_scalar_bc(2)),),
            projection=poisson.MultilevelParams(tolerance=1e-6,
                                                nitermax=100),
            approx_projection=poisson.MultilevelParams(tolerance=1e-6,
                                                       nitermax=100),
            diffusion_params=poisson.MultilevelParams(tolerance=1e-6,
                                                      nitermax=20),
            **{kind: (("T", 1.0),)})
        dtmax = tension.stability_dt(grid, 1.0) \
            if kind == "tension_css" else math.inf
        sim = Simulation(cfg, time=Time(end=tend, dtmax=dtmax))
        sim.init(T=t0_)
        t0 = time.time()
        sim.run()
        e = sim.state["T"] - t0_
        res[kind] = dict(
            steps=sim.time.i, t_final=sim.time.t,
            shape_l2=float(jnp.sqrt(jnp.mean(e * e))),
            shape_linf=float(jnp.max(jnp.abs(e))),
            umax=float(jnp.max(jnp.sqrt(sim.state["U"] ** 2
                                        + sim.state["V"] ** 2))),
            seconds=time.time() - t0)
        print(kind, res[kind], flush=True)
    with open(out, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main()
