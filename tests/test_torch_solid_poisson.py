"""The cut-cell Poisson solves of gerris_tpu_torch/physics/solid.py against
the JAX package's on the CPU in float64, and the reference's solid Poisson
gates on the port alone.

Against the JAX package, to 1e-10 of max: poisson_solid_solve on
test/circle's problem at level 5 (10 cycles, erelax 2), on the 3D sphere of
tests/test_ns3d.py at level 3 (adaptive to 1e-10), and
poisson_dirichlet_solve at level 5 (tests/test_couette.py's Dirichlet
circle, 10 cycles).  On the port alone: the Dirichlet solve's second
order at levels 5-7 (tests/test_couette.py:test_dirichlet_poisson_order),
test/circle's fractions and its multigrid reduction at level 7
(tests/test_circle.py), and the sphere's Richardson agreement
(tests/test_ns3d.py:test_poisson_solid_3d_sphere).  The circle's
convergence at levels 7-9 runs on the card (chip_smoke.circle_gate)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.physics import solid as jsolid  # noqa: E402
from gerris_tpu.solvers import poisson as jpoisson  # noqa: E402

import chip_smoke  # noqa: E402
from gerris_tpu_torch.core import bc  # noqa: E402
from gerris_tpu_torch.core.grid import Grid  # noqa: E402
from gerris_tpu_torch.physics import solid  # noqa: E402
from gerris_tpu_torch.solvers import poisson  # noqa: E402

RTOL = 1e-10
K_DIR = 2


def _rel(ref, got):
    ref = np.asarray(ref)
    return float(np.max(np.abs(ref - got.numpy())) / np.max(np.abs(ref)))


def _circle_rhs(grid):
    x, y = grid.centers
    return -(math.pi ** 2) * 18.0 * np.sin(3 * math.pi * x) * \
        np.sin(3 * math.pi * y)


def test_circle_solve_matches_jax():
    """test/circle at level 5: u, a, s and the residual after 10 cycles."""
    jg, tg = JGrid(5), Grid(5)
    rhs = _circle_rhs(jg)
    u, st, a, s = jsolid.poisson_solid_solve(
        jnp.asarray(rhs), jg, lambda x, y: x * x + y * y - 0.0625,
        jbc.default_scalar_bc(2),
        jpoisson.MultilevelParams(nitermin=10, nitermax=10, erelax=2))
    tu, tst, ta, ts = solid.poisson_solid_solve(
        torch.from_numpy(rhs), tg, chip_smoke.circle_phi,
        bc.default_scalar_bc(2),
        poisson.MultilevelParams(nitermin=10, nitermax=10, erelax=2))
    assert _rel(u, tu) <= RTOL and _rel(a, ta) <= RTOL
    assert tst.niter == st.niter == 10
    assert float(tst.residual_after["infty"]) == pytest.approx(
        float(st.residual_after["infty"]), rel=1e-6)


def test_sphere_solve_matches_jax():
    """The 3D sphere of radius 0.4 (fluid inside), rhs x, at level 3
    (8^3): the adaptive solve to 1e-10 in the same cycles, u to 1e-10."""
    R = 0.4
    jg, tg = JGrid(3, dim=3), Grid(3, dim=3)
    x = np.array(jg.centers[0])
    u, st, a, s = jsolid.poisson_solid_solve(
        jnp.asarray(x), jg, lambda x, y, z, t=0.0: R - jnp.sqrt(
            x ** 2 + y ** 2 + z ** 2), jbc.default_scalar_bc(3),
        jpoisson.MultilevelParams(tolerance=1e-10, nitermax=60))
    tu, tst, ta, ts = solid.poisson_solid_solve(
        torch.from_numpy(x), tg, lambda x, y, z: R - torch.sqrt(
            x ** 2 + y ** 2 + z ** 2), bc.default_scalar_bc(3),
        poisson.MultilevelParams(tolerance=1e-10, nitermax=60))
    assert tst.niter == st.niter
    assert _rel(u, tu) <= RTOL


def _dir_exact_j(x, y):
    return jnp.sin(math.pi * K_DIR * x) * jnp.sin(math.pi * K_DIR * y)


def _dir_exact(x, y):
    return torch.sin(math.pi * K_DIR * x) * torch.sin(math.pi * K_DIR * y)


def _dir_rhs(grid):
    x, y = grid.centers
    return -(math.pi ** 2) * 2 * K_DIR ** 2 * np.sin(math.pi * K_DIR * x) * \
        np.sin(math.pi * K_DIR * y)


def _dir_solve(level):
    g = Grid(level)
    return g, solid.poisson_dirichlet_solve(
        torch.from_numpy(_dir_rhs(g)), g, chip_smoke.circle_phi, _dir_exact,
        bc.FieldBC.uniform(bc.Dirichlet(_dir_exact), 2),
        poisson.MultilevelParams(nitermin=10, nitermax=10))


def test_dirichlet_solve_matches_jax():
    """The Dirichlet circle (u = sin(2 pi x) sin(2 pi y) on the circle of
    radius 0.25 and on the box) at level 5: u to 1e-10."""
    jg = JGrid(5)
    u, st, a, s = jsolid.poisson_dirichlet_solve(
        jnp.asarray(_dir_rhs(jg)), jg, lambda x, y: x * x + y * y - 0.0625,
        _dir_exact_j, jbc.FieldBC.uniform(jbc.Dirichlet(_dir_exact_j), 2),
        jpoisson.MultilevelParams(nitermin=10, nitermax=10))
    _, (tu, tst, ta, ts) = _dir_solve(5)
    assert _rel(u, tu) <= RTOL and _rel(a, ta) <= RTOL


def test_dirichlet_poisson_order():
    """tests/test_couette.py:test_dirichlet_poisson_order on the port: the
    max error on the cells with a > 1/2 at levels 5, 6, 7; below 2e-3 at
    level 7, order above 1.6 between 6 and 7."""
    errs = []
    for lvl in (5, 6, 7):
        g, (u, _, a, _) = _dir_solve(lvl)
        e = (u - _dir_exact(*(torch.from_numpy(c) for c in g.centers))).abs()
        errs.append(float(torch.where(a > 0.5, e, 0.0).max()))
    orders = [math.log2(errs[i] / errs[i + 1]) for i in range(2)]
    assert errs[-1] < 2e-3
    assert orders[-1] > 1.6


def test_circle_fractions_area():
    """tests/test_circle.py:test_solid_fractions_area on the port: the
    solid area at level 7 within 1e-3 of pi R^2, face fractions in [0,
    1]."""
    grid = Grid(7)
    a, (sx, sy) = solid.solid_fractions(grid, chip_smoke.circle_phi,
                                        device="cpu")
    area = float((1.0 - a).sum()) * grid.h ** 2
    assert abs(area - math.pi * 0.0625) < 1e-3 * math.pi * 0.0625
    assert float(sx.min()) >= 0.0 and float(sx.max()) <= 1.0
    assert float(sy.min()) >= 0.0 and float(sy.max()) <= 1.0


def test_circle_mg_reduction():
    """tests/test_circle.py:test_circle_mg_reduction on the port: cut cells
    keep the multigrid fast, at least 8x a cycle on average over 8 cycles
    at level 7 with erelax 2."""
    red, res = chip_smoke.circle_reduction(torch.device("cpu"))
    assert red >= 8.0, res


def test_sphere_richardson():
    """tests/test_ns3d.py:test_poisson_solid_3d_sphere on the port: the
    sphere's solves at levels 3 and 4 converge below 1e-8 of max|rhs|,
    and the restricted level-4 solution agrees with level 3 within 0.01
    on the full cells, their means removed."""
    R = 0.4

    def phi(x, y, z):
        return R - torch.sqrt(x ** 2 + y ** 2 + z ** 2)

    sols = []
    for level in (3, 4):
        grid = Grid(level, dim=3)
        rhs = torch.from_numpy(grid.centers[0])
        u, st, a, _ = solid.poisson_solid_solve(
            rhs, grid, phi, bc.default_scalar_bc(3),
            poisson.MultilevelParams(tolerance=1e-10, nitermax=60))
        assert float(st.residual_after["infty"]) < 1e-8 * float(
            rhs.abs().max())
        sols.append((u, a))
    fine = sols[1][0].reshape(8, 2, 8, 2, 8, 2).mean(dim=(1, 3, 5))
    m = sols[0][1] > 0.99
    d = fine - sols[0][0]
    d = d - d[m].mean()
    assert float(d[m].abs().max()) < 0.01
