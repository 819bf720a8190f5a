"""VOF concentration co-advection (GfsVariableVOFConcentration,
src/vof.c:962-1010, 1476-1577) on the port: tests/test_vof.py::
test_concentration_coadvection with its own assertions (64^2, a slab
translated by 24 sweeps' steps on periodic BCs), and one advection step
with a concentration held to the JAX package's ``vof.advect`` (CPU,
float64, 1e-12 of max at every cell)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.physics import vof as jvof  # noqa: E402

from gerris_tpu_torch.core import bc as tbc  # noqa: E402
from gerris_tpu_torch.core.grid import Grid as TGrid  # noqa: E402
from gerris_tpu_torch.physics import vof as tvof  # noqa: E402


def _slab(grid):
    """The slab |x| < 0.15 and its concentration 1 + cos(2 pi y) in the
    phase."""
    x, y = (torch.as_tensor(c) for c in grid.centers)
    f = tvof.fraction_from_levelset(grid, lambda X, Y: 0.15 - X.abs(),
                                    device="cpu")
    c = torch.where(f > 0.5, 1.0 + torch.cos(2 * math.pi * y), 0.0)
    return x, f, c


def test_concentration_coadvection():
    """The concentration rides the geometric phase fluxes: its amount
    sum(c f) conserved to 1e-10, no new extrema, none outside the phase,
    and the slab's centre moved by 24 dt (wrap-aware, within 2h)."""
    grid = TGrid(level=6)
    fbc = tbc.FieldBC.uniform(tbc.Periodic(), 2)
    x, f, c = _slab(grid)
    ux = torch.ones(grid.shape[0] + 1, grid.shape[1], dtype=torch.float64)
    uy = torch.zeros(grid.shape[0], grid.shape[1] + 1, dtype=torch.float64)
    dt = 0.4 * grid.h
    mass0 = float((c * f).sum())
    f1, cs = f, [c]
    for i in range(24):
        f1, cs = tvof.advect(f1, [ux, uy], grid, fbc, dt, cstart=i % 2,
                             concentrations=cs)
    c1 = cs[0]
    mass1 = float((c1 * f1).sum())
    assert abs(mass1 - mass0) / mass0 < 1e-10, (mass0, mass1)
    assert float(c1.max()) <= float(c.max()) + 1e-9
    assert float(c1.min()) >= -1e-12
    assert float(torch.where(f1 < 1e-9, c1, 0.0).abs().max()) < 1e-9
    xc0 = float((x * f).sum() / f.sum())
    xc1 = float((x * f1).sum() / f1.sum())
    d = (xc1 - (xc0 + 24 * dt) + 0.5) % 1.0 - 0.5
    assert abs(d) < 2 * grid.h, (xc0, xc1)


@pytest.mark.parametrize("cstart", [0, 1])
def test_concentration_sweep_matches_jax(cstart):
    """One advection step (both sweeps) of a wavy interface with a
    concentration under a sheared seeded velocity: f and c within 1e-12
    of max of the JAX package's."""
    jgrid, grid = JGrid(level=5), TGrid(level=5)
    rng = np.random.default_rng(31 + cstart)
    f = np.asarray(jvof.fraction_from_levelset(
        jgrid, lambda X, Y: 0.1 * jnp.cos(2 * jnp.pi * X) - Y))
    c = np.where(f > 0.0, 1.0 + rng.uniform(0.0, 1.0, f.shape), 0.0)
    ux = 0.8 + 0.1 * rng.standard_normal(jgrid.face_shape(0))
    uy = 0.2 * rng.standard_normal(jgrid.face_shape(1))
    dt = 0.4 * jgrid.h
    jf, jc = jvof.advect(jnp.asarray(f), [jnp.asarray(ux), jnp.asarray(uy)],
                         jgrid, jbc.periodic_bc(2), dt, cstart=cstart,
                         concentrations=[jnp.asarray(c)])
    tf, tc = tvof.advect(torch.from_numpy(f), [torch.from_numpy(ux),
                                               torch.from_numpy(uy)],
                         grid, tbc.FieldBC.uniform(tbc.Periodic(), 2), dt, cstart=cstart,
                         concentrations=[torch.from_numpy(c)])
    for ref, got in ((jf, tf), (jc[0], tc[0])):
        ref = np.asarray(ref)
        assert np.max(np.abs(ref - got.numpy())) <= 1e-12 * np.max(
            np.abs(ref))
