"""The port's multigrid cycle kernels (plain versions, CPU, float64)
against the JAX package's Pallas kernels run in interpret mode, as
tests/test_mgfuse.py runs them (K2 with the bench's 40 coarsest sweeps
against the jnp ladder of its schedule, which tests/test_mgfuse.py holds
the Pallas kernel to), and the port's fused cycle against the jnp ladder
of the same schedule.  Tolerance: 1e-10 absolute, also for
the residual, whose values reach ~3e5 at 128^2 (scale 1/h^2)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.ops.pallas import rbgs as jrbgs  # noqa: E402
from gerris_tpu.solvers import poisson as jpoisson  # noqa: E402

from gerris_tpu_torch.core.grid import Grid as TGrid  # noqa: E402
from gerris_tpu_torch.ops.cuda import rbgs as trbgs  # noqa: E402
from gerris_tpu_torch.solvers import poisson as tpoisson  # noqa: E402
from gerris_tpu_torch.utils.convert import fieldbc_from_jax  # noqa: E402

from test_mgfuse import _ladder_cycle  # noqa: E402

KINDS = ["neumann", "dirichlet", "mixed"]


def _fbc(kind):
    """(JAX FieldBC, per_y) with inhomogeneous values where the kind
    allows them (only the residual reads the offsets)."""
    if kind == "neumann":
        return jbc.FieldBC(((jbc.Neumann(0.25), jbc.Neumann(-0.5)),
                            (jbc.Neumann(), jbc.Neumann(0.75)))), False
    if kind == "dirichlet":
        return jbc.FieldBC(((jbc.Dirichlet(0.3), jbc.Dirichlet(-0.2)),
                            (jbc.Dirichlet(0.0), jbc.Dirichlet(1.0)))), False
    return jbc.FieldBC(((jbc.Dirichlet(0.0), jbc.Neumann()),
                        (jbc.Periodic(), jbc.Periodic()))), True


def _fields(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) for s in shapes]


def _maxdiff(a, b):
    return float(np.max(np.abs(np.asarray(a) - b.numpy())))


def jnp_cascade(rs, grid, fbc, dia, nsweeps, coarsest, omega=1.0,
                min_n=16):
    """du at the level of rs[0] (``grid``) by the jnp ladder of K2's and
    K12's schedule (tests/test_mgfuse.py:_ladder_cycle's cascade): the
    given rhs levels rs (finest first), then rs[-1] restricted down to
    min_n, ``coarsest`` sweeps from zero there, prolong + ``nsweeps``
    sweeps at every level up to rs[0]'s, homogeneous ghosts."""
    import dataclasses as dc
    rs = list(rs)
    while rs[-1].shape[0] > min_n:
        rs.append(jpoisson.restrict(rs[-1], 2))
    grids = [dc.replace(grid, level=grid.level - k) for k in range(len(rs))]
    du = jpoisson.relax(jnp.zeros_like(rs[-1]), rs[-1], grids[-1], fbc,
                        coarsest, dia=dia, homogeneous=True, omega=omega)
    for k in range(len(rs) - 2, -1, -1):
        du = jpoisson.prolong(du, grids[k + 1], fbc, homogeneous=True)
        du = jpoisson.relax(du, rs[k], grids[k], fbc, nsweeps, dia=dia,
                            homogeneous=True, omega=omega)
    return du


@pytest.mark.parametrize("kind", KINDS)
def test_residual_restrict_matches_pallas(kind):
    fbc, per_y = _fbc(kind)
    grid = JGrid(level=7)
    signs, offs = jpoisson._signs_offs(grid, fbc, homogeneous=False)
    u, rhs = _fields(1, grid.shape, grid.shape)
    dia, sub = 0.4, 0.37
    ref = jrbgs.residual_restrict(
        jnp.asarray(u), jnp.asarray(rhs), dia, sub, h2=grid.h ** 2,
        signs=signs, offs=offs, periodic=(False, per_y), interpret=True)
    got = trbgs.residual_restrict(
        torch.from_numpy(u), torch.from_numpy(rhs), dia, sub,
        h2=grid.h ** 2, signs=signs, offs=offs, per_y=per_y)
    for a, b in zip(ref, got):
        assert a.shape == tuple(b.shape)
        assert _maxdiff(a, b) <= 1e-10


@pytest.mark.parametrize("omega", [1.0, 1.5])
@pytest.mark.parametrize("kind", KINDS)
def test_prolong_relax_matches_pallas(kind, omega):
    fbc, per_y = _fbc(kind)
    grid = JGrid(level=7)
    signs, _ = jpoisson._signs_offs(grid, fbc, homogeneous=True)
    n = grid.shape[0]
    du_c, r, u = _fields(2, (n // 2, n // 2), grid.shape, grid.shape)
    dia, nsweeps = 0.7, 3
    kw = dict(nsweeps=nsweeps, h2=grid.h ** 2, signs=signs)
    ref = jrbgs.prolong_relax(jnp.asarray(du_c), jnp.asarray(r), dia,
                              jnp.asarray(u), periodic_y=per_y, omega=omega,
                              add_u=True, interpret=True, **kw)
    got = trbgs.prolong_relax(torch.from_numpy(du_c), torch.from_numpy(r),
                              dia, torch.from_numpy(u), per_y=per_y,
                              omega=omega, **kw)
    assert _maxdiff(ref, got) <= 1e-10
    # without u: the correction alone
    ref0 = jrbgs.prolong_relax(jnp.asarray(du_c), jnp.asarray(r), dia,
                               periodic_y=per_y, omega=omega,
                               interpret=True, **kw)
    got0 = trbgs.prolong_relax(torch.from_numpy(du_c), torch.from_numpy(r),
                               dia, per_y=per_y, omega=omega, **kw)
    assert _maxdiff(ref0, got0) <= 1e-10


@pytest.mark.parametrize("kind,omega,coarsest", [
    ("neumann", 1.0, 40), ("dirichlet", 1.5, 12), ("mixed", 1.5, 12),
    ("mixed", 1.0, 12)])
def test_cascade_prolong_relax_matches_pallas(kind, omega, coarsest):
    """K2 at n/2 = 128 (restriction 64 -> 32 -> 16); the Pallas kernel's
    rep layout is un-repped as rep[8:8+n_half, ::2].  Interpret mode
    traces every sweep, so the Pallas kernel itself is held with 12
    coarsest sweeps; the bench's 40 are held against the jnp ladder of
    the same schedule, to which tests/test_mgfuse.py holds the Pallas
    kernel."""
    fbc, per_y = _fbc(kind)
    signs, _ = jpoisson._signs_offs(JGrid(level=8), fbc, homogeneous=True)
    n_half = 128
    h2_half = (1.0 / n_half) ** 2
    r1, r2 = _fields(3, (n_half, n_half), (n_half // 2, n_half // 2))
    kw = dict(nsweeps=5, coarsest=coarsest, h2_half=h2_half, signs=signs,
              per_y=per_y, min_n=16, omega=omega)
    if coarsest > 12:
        ref = jnp_cascade([jnp.asarray(r1), jnp.asarray(r2)], JGrid(level=7),
                          fbc, 0.25, 5, coarsest, omega)
    else:
        rep = jrbgs.cascade_prolong_relax(jnp.asarray(r1), jnp.asarray(r2),
                                          0.25, interpret=True, **kw)
        ref = np.asarray(rep)[8:8 + n_half, ::2]
    got = trbgs.cascade_prolong_relax(torch.from_numpy(r1),
                                      torch.from_numpy(r2), 0.25, **kw)
    assert _maxdiff(ref, got) <= 1e-10


@pytest.mark.parametrize("kind,per_y", [("neumann", False),
                                        ("dirichlet", False),
                                        ("dirichlet", True)])
def test_fused_cycle_matches_ladder(kind, per_y):
    """The port's K1 -> K2 -> K3 cycle == the jnp restrict/cascade/
    prolong ladder of tests/test_mgfuse.py with the same schedule."""
    grid = JGrid(level=7)
    if kind == "neumann":
        fbc = jbc.default_scalar_bc(2)
    else:
        fbc = jbc.FieldBC(((jbc.Dirichlet(0.0), jbc.Dirichlet(0.0)),
                           (jbc.Periodic(), jbc.Periodic()) if per_y else
                           (jbc.Dirichlet(0.0), jbc.Dirichlet(0.0))))
    u, rhs = _fields(4, grid.shape, grid.shape)
    dia, nsweeps, coarsest, omega = 0.25, 4, 40, 1.0
    ref_u, ref_r0 = _ladder_cycle(jnp.asarray(u), jnp.asarray(rhs), grid,
                                  fbc, dia, nsweeps, coarsest)
    params = tpoisson.MultilevelParams(nrelax=nsweeps, omega=omega,
                                       coarsest_relax=coarsest)
    got_u, got_r0 = tpoisson.fused_cycle(
        torch.from_numpy(u), torch.from_numpy(rhs), TGrid(level=7),
        fieldbc_from_jax(fbc), params, dia)
    assert _maxdiff(ref_r0, got_r0) <= 1e-10
    assert _maxdiff(ref_u, got_u) <= 1e-10


def test_wrappers_check_inputs():
    z = torch.zeros(64, 64, dtype=torch.float64)
    kw = dict(h2=1e-3, signs=(1.0,) * 4)
    with pytest.raises(ValueError):
        trbgs.residual_restrict(torch.zeros(48, 48, dtype=torch.float64),
                                torch.zeros(48, 48, dtype=torch.float64),
                                **kw)
    with pytest.raises(TypeError):
        trbgs.residual_restrict(z.half(), z.half(), **kw)
    with pytest.raises(ValueError):
        trbgs.residual_restrict(z.t(), z, **kw)     # not contiguous
    with pytest.raises(ValueError):
        trbgs.prolong_relax(torch.zeros(16, 16, dtype=torch.float64), z,
                            nsweeps=1, **kw)
    with pytest.raises(ValueError):
        trbgs.residual_restrict(z, z.float(), **kw)


def test_poisson_blocks_match_jnp():
    """The port's residual / relax / restrict / prolong against the JAX
    jnp building blocks (inhomogeneous residual, periodic-y relax)."""
    fbc, per_y = _fbc("mixed")
    jgrid = JGrid(level=6)
    tgrid = TGrid(level=6)
    tfbc = fieldbc_from_jax(fbc)
    u, rhs, c = _fields(5, jgrid.shape, jgrid.shape, (32, 32))
    gd, _ = _fbc("dirichlet")
    ref = jpoisson.residual(jnp.asarray(u), jnp.asarray(rhs), jgrid, gd,
                            dia=0.3)
    got = tpoisson.residual(torch.from_numpy(u), torch.from_numpy(rhs),
                            tgrid, fieldbc_from_jax(gd), dia=0.3)
    assert _maxdiff(ref, got) <= 1e-10
    ref = jpoisson.relax(jnp.asarray(u), jnp.asarray(rhs), jgrid, fbc, 3,
                         dia=0.3, omega=1.5)
    got = tpoisson.relax(torch.from_numpy(u), torch.from_numpy(rhs), tgrid,
                         tfbc, 3, dia=0.3, omega=1.5)
    assert _maxdiff(ref, got) <= 1e-10
    assert _maxdiff(jpoisson.restrict(jnp.asarray(u), 2),
                    tpoisson.restrict(torch.from_numpy(u))) <= 1e-12
    ref = jpoisson.prolong(jnp.asarray(c), JGrid(level=5), fbc)
    got = tpoisson.prolong(torch.from_numpy(c), tfbc, TGrid(level=5))
    assert _maxdiff(ref, got) <= 1e-12
