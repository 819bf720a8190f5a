"""K11 ``residual`` and K10 ``rbgs_relax`` on the levels of a box of unit
boxes (the capillary wave's 1 x 3 box, and its transpose), plain
versions on the CPU in float64, against the JAX package's Pallas kernels
``residual_pallas`` and ``rbgs_relax`` at (128, 384) and (384, 128),
with periodic x and with walls; and the port's box solves with their
coarsest levels dense or relaxed down to (1, 3).

K11 runs in interpret mode, as tests/test_mgfuse.py runs it.  K10 takes
no ``interpret`` argument, so it runs under
``pltpu.force_tpu_interpret_mode()``, with the strip-plan helper that
gerris_tpu deleted set back on the module for the test's run
(tests/test_torch_coarse.py:_strip_plan).  Tolerance: 1e-12 of max|ref|
at every cell."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.ops.pallas import rbgs as jrbgs  # noqa: E402
from gerris_tpu.solvers import poisson as jpoisson  # noqa: E402

from gerris_tpu_torch.core import bc as tbc  # noqa: E402
from gerris_tpu_torch.core.grid import Grid as TGrid  # noqa: E402
from gerris_tpu_torch.ops.cuda import rbgs as trbgs  # noqa: E402
from gerris_tpu_torch.solvers import poisson as tpoisson  # noqa: E402
from gerris_tpu_torch.utils.convert import fieldbc_from_jax  # noqa: E402

from test_torch_coarse import _strip_plan  # noqa: E402

BOUND = 1e-12
# (extents, periodic axis or None): the 1 x 3 box (rows of 128 cells,
# 384 columns) and the 3 x 1 box
CASES = [((1, 3), 0), ((1, 3), None), ((3, 1), 0), ((3, 1), None)]


def _fbc(per_axis):
    """Periodic rows (x) with a Dirichlet and a Neumann side on y, or
    walls with inhomogeneous values."""
    per = (jbc.Periodic(), jbc.Periodic())
    if per_axis == 0:
        return jbc.FieldBC((per, (jbc.Dirichlet(0.0), jbc.Neumann())))
    return jbc.FieldBC(((jbc.Dirichlet(0.5), jbc.Neumann(0.25)),
                        (jbc.Dirichlet(-1.0), jbc.Dirichlet(0.0))))


def _rel(ref, got):
    ref = np.asarray(ref)
    return float(np.max(np.abs(ref - got.numpy())) / np.max(np.abs(ref)))


def _setup(extents, per_axis, seed):
    grid = JGrid(level=7, extents=extents)
    fbc = _fbc(per_axis)
    rng = np.random.default_rng(seed)
    u, rhs = rng.standard_normal(grid.shape), rng.standard_normal(grid.shape)
    return grid, fbc, u, rhs


@pytest.mark.parametrize("extents,per_axis", CASES)
def test_residual_box_matches_pallas(extents, per_axis):
    """K11's plain version on a box level against residual_pallas (32-row
    strips, the static ghosts' offsets), and the port's residual routes
    the box through K11."""
    grid, fbc, u, rhs = _setup(extents, per_axis, 21)
    assert grid.shape == (128 * extents[0], 128 * extents[1])
    signs, offs = jpoisson._signs_offs(grid, fbc, homogeneous=False)
    per = (fbc.is_periodic(0), fbc.is_periodic(1))
    ref = jrbgs.residual_pallas(jnp.asarray(u), jnp.asarray(rhs), 0.4,
                                h2=grid.h ** 2, signs=signs, offs=offs,
                                periodic=per, S=32, interpret=True)
    got = trbgs.residual(torch.from_numpy(u), torch.from_numpy(rhs), 0.4,
                         h2=grid.h ** 2, signs=signs, offs=offs,
                         periodic=per)
    assert _rel(ref, got) <= BOUND
    tgot = tpoisson.residual(torch.from_numpy(u), torch.from_numpy(rhs),
                             TGrid(level=7, extents=extents),
                             fieldbc_from_jax(fbc), dia=0.4)
    assert torch.equal(tgot, got)


@pytest.mark.parametrize("extents,per_axis", CASES)
def test_rbgs_relax_box_matches_pallas(extents, per_axis, monkeypatch):
    """K10's plain version on a box level against rbgs_relax (32-row
    strips, 3 sweeps, omega 1.2, homogeneous ghosts) and the reference's
    jnp relax; the port's relax routes the box through K10."""
    monkeypatch.setattr(jrbgs, "_strip_plan", _strip_plan, raising=False)
    grid, fbc, u, rhs = _setup(extents, per_axis, 22)
    signs, _ = jpoisson._signs_offs(grid, fbc, homogeneous=True)
    per = (fbc.is_periodic(0), fbc.is_periodic(1))
    kw = dict(nsweeps=3, h2=grid.h ** 2, signs=signs, periodic=per,
              omega=1.2)
    with pltpu.force_tpu_interpret_mode():
        ref = jrbgs.rbgs_relax(jnp.asarray(u), jnp.asarray(rhs), 0.3, S=32,
                               **kw)
    got = trbgs.rbgs_relax(torch.from_numpy(u), torch.from_numpy(rhs), 0.3,
                           **kw)
    assert _rel(ref, got) <= BOUND
    ref = jpoisson.relax(jnp.asarray(u), jnp.asarray(rhs), grid, fbc, 3,
                         dia=0.3, omega=1.2)
    assert _rel(ref, got) <= BOUND
    tgot = tpoisson.relax(torch.from_numpy(u), torch.from_numpy(rhs),
                          TGrid(level=7, extents=extents),
                          fieldbc_from_jax(fbc), 3, dia=0.3, omega=1.2)
    assert torch.equal(tgot, got)


@pytest.mark.parametrize("dense", [0, 3, 12, 768])
def test_box_solve_coarsest_levels(dense):
    """The capillary wave's pressure system on its (16, 48) box with the
    coarsest level relaxed from zero at (1, 3) (minlevel 0, no dense
    solve), dense at (1, 3) or (2, 6), or dense over the whole level:
    each converges to 1e-10 of max|rhs|, and the dense (1, 3) solve
    matches the JAX package's correction on the same residual."""
    grid = TGrid(level=4, extents=(1, 3))
    per = (tbc.Periodic(), tbc.Periodic())
    fbc = tbc.FieldBC((per, (tbc.Neumann(), tbc.Neumann())))
    rng = np.random.default_rng(23)
    rhs = torch.from_numpy(rng.standard_normal(grid.shape))
    rhs -= rhs.mean()
    p = tpoisson.MultilevelParams(tolerance=1e-10, nitermax=200,
                                  minlevel=0, dense_coarse_max=dense)
    u, st = tpoisson.solve(torch.zeros_like(rhs), rhs, grid, fbc, p)
    r = tpoisson.residual(u, rhs, grid, fbc)
    assert float(r.abs().max()) <= 1e-10 * float(rhs.abs().max())
    assert st.niter >= 1
    if dense == 3:
        jgrid = JGrid(level=4, extents=(1, 3))
        jper = (jbc.Periodic(), jbc.Periodic())
        jfbc = jbc.FieldBC((jper, (jbc.Neumann(), jbc.Neumann())))
        jp = jpoisson.MultilevelParams(minlevel=0, dense_coarse_max=3)
        ref = jpoisson.correction(jnp.asarray(rhs.numpy()), jgrid, jfbc, jp)
        got = tpoisson.correction(rhs, grid, fbc,
                                  dataclasses.replace(p, nitermax=1))
        assert _rel(ref, got) <= 1e-10
