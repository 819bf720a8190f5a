"""The lid-driven cavity at Re = 1000 against Ghia, Ghia & Shin (1982) on
the port, on the CPU in float64: tests/test_lid.py::test_lid_cavity_ghia
(the reference's test/lid, test/lid/lid.sh:8-18) with its configuration,
measure and tolerances: 64^2, nu 1e-3, the lid U = 1, CFL 0.8, the
default adaptive solves, run to steady state (EventStop on U, 1e-4 every
10 steps, at most t = 300 with dt at most 1); the centreline profiles
interpolated at Ghia's points, Linf(U - Ghia) <= 2e-2 and Linf(V -
Ghia) <= 1.7e-2.  Marked ``slow``, as the JAX test is; chip_smoke.py
holds Ghia on the card on every run."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu_torch.core import bc  # noqa: E402
from gerris_tpu_torch.core.grid import Grid  # noqa: E402
from gerris_tpu_torch.events.events import EventStop  # noqa: E402
from gerris_tpu_torch.models import ns  # noqa: E402
from gerris_tpu_torch.models.simulation import Simulation, Time  # noqa
from gerris_tpu_torch.solvers.advection import AdvectionParams  # noqa

from test_lid import GHIA_U, GHIA_V  # noqa: E402


@pytest.mark.slow
def test_lid_cavity_ghia():
    d0 = bc.Dirichlet(0.0)
    u_bc = bc.FieldBC.make(2, default=d0, top=bc.Dirichlet(1.0))
    cfg = ns.NSConfig(grid=Grid(level=6),
                      u_bcs=(u_bc, bc.FieldBC.uniform(d0, 2)), nu=1e-3,
                      beta=1.0, advection=AdvectionParams(cfl=0.8))
    stop = EventStop("U", 1e-4, istep=10)
    sim = Simulation(cfg, time=Time(end=300.0, dtmax=1.0), events=[stop],
                     device="cpu").init()
    sim.run()
    assert sim.stop, f"no steady state by t = {sim.time.t}"
    u = sim.interpolate("U", [(0.0, y) for y in GHIA_U[:, 0]])
    v = sim.interpolate("V", [(x, 0.0) for x in GHIA_V[:, 0]])
    assert np.max(np.abs(u - GHIA_U[:, 1])) <= 2e-2
    assert np.max(np.abs(v - GHIA_V[:, 1])) <= 1.7e-2
