#!/usr/bin/env python3
"""The 3D static droplet (the 3D counterpart of Gerris test/spurious,
tests/test_vof3d.py::test_static_droplet_3d) on the JAX package,
gerris_tpu, on the CPU in float64: the reference values that
chip_smoke.py's droplet3d gate holds the port to.

    python3 tools/droplet3d_reference.py LEVEL STEPS OUT.json

Runs gerris_tpu's Simulation at 2^LEVEL cells per side for STEPS steps
with chip_smoke.droplet3d_cfg's configuration (a sphere of radius 0.3 at
the centre of the unit box, velocity_bc walls, sigma 1, rho 1, nu 0.1,
beta 1, AdvectionParams(scheme="none"), both projections to 1e-6 in at
most 50 cycles, the default diffusion), as the test runs it: end time 1,
one step per run call.  It prints the steps, the time reached, max|u|
after the last step and the shape error max|T - T0|, and writes them to
OUT.json.  At LEVEL 4, STEPS 20 it takes about ten minutes on the CPU.
It imports jax and gerris_tpu; the port and chip_smoke.py import
neither.
"""
import json
import os
import sys
import time

R = 0.3


def main():
    level, steps, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from gerris_tpu.core import bc
    from gerris_tpu.core.grid import Grid
    from gerris_tpu.models import ns
    from gerris_tpu.models.simulation import Simulation, Time
    from gerris_tpu.physics import vof
    from gerris_tpu.solvers import poisson
    from gerris_tpu.solvers.advection import AdvectionParams

    grid = Grid(level=level, dim=3, origin=(-0.5, -0.5, -0.5))
    proj = poisson.MultilevelParams(tolerance=1e-6, nitermax=50)
    cfg = ns.NSConfig(
        grid=grid, u_bcs=tuple(bc.velocity_bc(c, 3) for c in range(3)),
        nu=0.1, beta=1.0, advection=AdvectionParams(scheme="none"),
        vof_tracers=(("T", bc.default_scalar_bc(3)),),
        tension=(("T", 1.0),), projection=proj, approx_projection=proj)
    sim = Simulation(cfg, time=Time(end=1.0))
    sim.init(T=vof.fraction_from_levelset(
        grid, lambda x, y, z: R * R - (x * x + y * y + z * z)))
    T0 = sim.state["T"]
    t0 = time.time()
    for _ in range(steps):
        sim.run(max_steps=1)
    s = sim.state
    res = dict(level=level, steps=sim.time.i, t_final=sim.time.t,
               umax=float(jnp.sqrt(jnp.max(s["U"] ** 2 + s["V"] ** 2
                                           + s["W"] ** 2))),
               shape_err=float(jnp.max(jnp.abs(s["T"] - T0))),
               seconds=time.time() - t0)
    print(res, flush=True)
    with open(out, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main()
