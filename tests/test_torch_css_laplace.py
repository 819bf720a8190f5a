"""The CSS tension's Laplace jump (GfsSourceTensionCSS, src/tension.c:
181-305; tests/test_spurious.py::test_css_tension_laplace) on the port,
on the CPU in float64: a static droplet of radius 0.25 at level 6
develops the pressure jump sigma / R, its parasitic currents bounded.

The test's own bounds (the jump within 25% of sigma / R, max|U| below
half of sqrt(sigma / R)), and the JAX package's values on the same
configuration and steps, pinned from ``python3
tools/css_laplace_reference.py`` (gerris_tpu on the CPU in float64,
given the capillary dt bound that the port applies to CSS: 18 steps to t
= 0.01875, jump 3.9832130284737026, max|U| 0.1049971122731567), within
1e-6 relative.  Both packages solve each solve's coarsest 32^2 level
dense: the port is given the JAX package's CPU cap of 1024 unknowns
(dense_coarse_max), which the reference applies on the CPU, for the
projections and for the default diffusion schedule (tolerance 1e-3, at
most 10 cycles) alike."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu_torch.core import bc  # noqa: E402
from gerris_tpu_torch.core.grid import Grid  # noqa: E402
from gerris_tpu_torch.models import ns  # noqa: E402
from gerris_tpu_torch.models.simulation import Simulation, Time  # noqa
from gerris_tpu_torch.physics import vof  # noqa: E402
from gerris_tpu_torch.solvers.advection import AdvectionParams  # noqa
from gerris_tpu_torch.solvers.poisson import MultilevelParams  # noqa: E402

JAX = dict(steps=18, jump=3.9832130284737026, umax=0.1049971122731567)


def test_css_tension_laplace():
    grid = Grid(level=6)
    sigma, rd = 1.0, 0.25
    mp = MultilevelParams(tolerance=1e-8, nitermax=100,
                          dense_coarse_max=1024)
    cfg = ns.NSConfig(
        grid=grid, u_bcs=(bc.velocity_bc(0), bc.velocity_bc(1)), nu=0.02,
        beta=1.0, advection=AdvectionParams(scheme="none"),
        vof_tracers=(("T", bc.default_scalar_bc(2)),),
        tension_css=(("T", sigma),), projection=mp, approx_projection=mp,
        diffusion_params=MultilevelParams(tolerance=1e-3, nitermax=10,
                                          dense_coarse_max=1024))
    sim = Simulation(cfg, time=Time(end=30 * 0.4 * grid.h * 0.1),
                     device="cpu")
    sim.init(T=vof.fraction_from_levelset(
        grid, lambda x, y: rd * rd - (x ** 2 + y ** 2), refine=3,
        device="cpu"))
    sim.run()
    x, y = (np.asarray(c) for c in grid.centers)
    r = np.sqrt(x ** 2 + y ** 2)
    P = sim.state["P"].numpy()
    jump = P[r < rd - 3 * grid.h].mean() - P[r > rd + 3 * grid.h].mean()
    umax = float(sim.state["U"].abs().max())
    assert np.isfinite(P).all() and math.isfinite(umax)
    assert abs(jump - sigma / rd) / (sigma / rd) < 0.25, jump
    assert umax < 0.5 * math.sqrt(sigma / rd)
    assert sim.time.i == JAX["steps"]
    assert abs(jump - JAX["jump"]) / JAX["jump"] <= 1e-6, jump
    assert abs(umax - JAX["umax"]) / JAX["umax"] <= 1e-6, umax
