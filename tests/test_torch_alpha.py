"""The variable-coefficient multigrid: K15 ``rbgs_relax_alpha`` (plain
version, CPU, float64) against the JAX package's Pallas kernel and its
jnp ``relax``, and the port's residual, coefficient coarsening,
correction and adaptive solve with face coefficients and a cell dia
against ``gerris_tpu``; then the second-order gate of a
variable-coefficient Poisson problem on the port.

The Pallas ``rbgs_relax_alpha`` calls ``_strip_plan``, which commit
d408783 deleted (it raises NameError as committed); each test restores
the helper on the imported module for its own run with ``monkeypatch``,
as tests/test_torch_coarse.py does for K10, and runs the kernel under
``pltpu.force_tpu_interpret_mode()`` at 128^2 with 32-row strips.
Tolerance: 1e-12 of max|ref| at every cell for the kernel, 1e-10 of
max|u| for the solver pieces.  On a periodic axis the face arrays hold
face n equal to face 0, as the reference's two-phase coefficients do
(the TPU kernel reads face 0 for face n across its wrap)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.ops.pallas import rbgs as jrbgs  # noqa: E402
from gerris_tpu.solvers import poisson as jpoisson  # noqa: E402

from gerris_tpu_torch.core.grid import Grid as TGrid  # noqa: E402
from gerris_tpu_torch.ops.cuda import rbgs as trbgs  # noqa: E402
from gerris_tpu_torch.solvers import poisson as tpoisson  # noqa: E402
from gerris_tpu_torch.utils.convert import fieldbc_from_jax  # noqa: E402

from test_torch_coarse import _strip_plan  # noqa: E402

BOUND = 1e-12
SOLVE_BOUND = 1e-10


def _fbc(kind):
    d0 = jbc.Dirichlet(0.0)
    per = (jbc.Periodic(), jbc.Periodic())
    return {
        "dirichlet": jbc.FieldBC(((d0, d0), (d0, d0))),
        "per_x": jbc.FieldBC((per, (d0, jbc.Neumann()))),
        "per_xy": jbc.periodic_bc(2),
        "neumann": jbc.default_scalar_bc(2),
        "lid": jbc.FieldBC(((d0, jbc.Neumann(0.5)), (jbc.Dirichlet(0.3),
                                                     jbc.Dirichlet(1.0)))),
    }[kind]


def _system(seed, n, fbc, cell, dead=False):
    """u, rhs, positive random face coefficients (face n = face 0 on a
    periodic axis) and dia (scalar or positive per cell).  ``dead``: a
    few cells with all four faces and dia zero (K15's ``live`` mask)."""
    rng = np.random.default_rng(seed)
    u, rhs = rng.standard_normal((n, n)), rng.standard_normal((n, n))
    ax = 0.2 + rng.random((n + 1, n))
    ay = 0.2 + rng.random((n, n + 1))
    dia = 0.5 + rng.random((n, n)) if cell else 0.3
    if dead:
        for i, j in ((5, 7), (40, 90), (100, 3), (126, 64)):
            ax[i, j] = ax[i + 1, j] = ay[i, j] = ay[i, j + 1] = 0.0
            if cell:
                dia[i, j] = 0.0
        if not cell:
            dia = 0.0
    if fbc.is_periodic(0):
        ax[n] = ax[0]
    if fbc.is_periodic(1):
        ay[:, n] = ay[:, 0]
    return u, rhs, ax, ay, dia


def _rel(ref, got):
    ref = np.asarray(ref)
    return float(np.max(np.abs(ref - got.numpy())) / np.max(np.abs(ref)))


def _t(*arrays):
    return [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) if isinstance(a, np.ndarray) else a
            for a in arrays]


# --- K15 rbgs_relax_alpha ------------------------------------------------------

@pytest.mark.parametrize("dead", [False, True])
@pytest.mark.parametrize("cell", [False, True])
@pytest.mark.parametrize("kind", ["dirichlet", "per_x", "per_xy"])
def test_rbgs_relax_alpha_matches_pallas(kind, cell, dead, monkeypatch):
    """K15's plain version against the Pallas rbgs_relax_alpha (the
    deleted strip-plan helper restored) at 128^2 with 32-row strips, 3
    sweeps, omega 1.2: walls, periodic rows with mixed columns, doubly
    periodic; scalar and cell dia; with and without zero-diagonal cells.
    Then the reference's jnp relax with alpha on the same inputs, and
    the port's relax, which routes a 2D homogeneous alpha sweep to K15's
    wrapper, equal to it."""
    monkeypatch.setattr(jrbgs, "_strip_plan", _strip_plan, raising=False)
    fbc = _fbc(kind)
    grid = JGrid(level=7)
    u, rhs, ax, ay, dia = _system(20, 128, fbc, cell, dead)
    signs, _ = jpoisson._signs_offs(grid, fbc, homogeneous=True)
    per = (fbc.is_periodic(0), fbc.is_periodic(1))
    kw = dict(nsweeps=3, h2=grid.h ** 2, signs=signs, periodic=per,
              omega=1.2, dia_cell=cell)
    with pltpu.force_tpu_interpret_mode():
        ref = jrbgs.rbgs_relax_alpha(*_j(u, rhs, ax, ay, dia), S=32, **kw)
    got = trbgs.rbgs_relax_alpha(*_t(u, rhs, ax, ay, dia), **kw)
    assert _rel(ref, got) <= BOUND
    if dead:
        # zero-diagonal cells keep their value
        assert got[5, 7] == u[5, 7] and got[100, 3] == u[100, 3]
    ju, jrhs, jax_, jay, jdia = _j(u, rhs, ax, ay, dia)
    ref = jpoisson.relax(ju, jrhs, grid, fbc, 3, alpha=(jax_, jay),
                         dia=jdia, omega=1.2)
    assert _rel(ref, got) <= BOUND
    tu, trhs, tax, tay, tdia = _t(u, rhs, ax, ay, dia)
    tgot = tpoisson.relax(tu, trhs, TGrid(level=7), fieldbc_from_jax(fbc), 3,
                          dia=tdia, omega=1.2, alpha=(tax, tay))
    assert torch.equal(tgot, got)


def test_relax_alpha_dispatches_to_k15(monkeypatch):
    """A 2D homogeneous relax with face coefficients calls the K15 wrapper
    with the level's signs, periodicity and dia mode; an inhomogeneous
    one and a cell dia with unit coefficients take the torch route."""
    calls = []
    real = trbgs.rbgs_relax_alpha

    def spy(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(trbgs, "rbgs_relax_alpha", spy)
    fbc = _fbc("per_x")
    u, rhs, ax, ay, dia = _t(*_system(21, 16, fbc, True))
    grid, tfbc = TGrid(level=4), fieldbc_from_jax(fbc)
    tpoisson.relax(u, rhs, grid, tfbc, 2, dia=dia, alpha=(ax, ay))
    assert len(calls) == 1 and calls[0]["dia_cell"]
    assert calls[0]["periodic"] == (True, False)
    assert calls[0]["signs"] == (1.0, 1.0, -1.0, 1.0)
    tpoisson.relax(u, rhs, grid, tfbc, 2, dia=0.5, alpha=(ax, ay))
    assert len(calls) == 2 and not calls[1]["dia_cell"]
    tpoisson.relax(u, rhs, grid, tfbc, 2, dia=dia, alpha=(ax, ay),
                   homogeneous=False)
    tpoisson.relax(u, rhs, grid, tfbc, 2, dia=dia)
    assert len(calls) == 2


# --- the solver's pieces --------------------------------------------------------

def test_coarsen_face_coeff_matches_jax():
    rng = np.random.default_rng(22)
    ax, ay = rng.random((33, 32)), rng.random((32, 33))
    ref = jpoisson.coarsen_face_coeff((jnp.asarray(ax), jnp.asarray(ay)), 2)
    got = tpoisson.coarsen_face_coeff(_t(ax, ay), 2)
    for r, g in zip(ref, got):
        assert g.shape == r.shape
        assert _rel(r, g) <= BOUND


@pytest.mark.parametrize("homogeneous", [False, True])
@pytest.mark.parametrize("kind", ["lid", "per_xy", "neumann"])
def test_residual_alpha_matches_jax(kind, homogeneous):
    """residual with face coefficients and a cell dia: inhomogeneous
    Dirichlet and Neumann ghosts, periodic, pure Neumann."""
    fbc = _fbc(kind)
    u, rhs, ax, ay, dia = _system(23, 32, fbc, True)
    ref = jpoisson.residual(*_j(u, rhs), JGrid(level=5), fbc,
                            alpha=tuple(_j(ax, ay)), dia=jnp.asarray(dia),
                            homogeneous=homogeneous)
    got = tpoisson.residual(*_t(u, rhs), TGrid(level=5),
                            fieldbc_from_jax(fbc), dia=torch.from_numpy(dia),
                            homogeneous=homogeneous, alpha=tuple(_t(ax, ay)))
    assert _rel(ref, got) <= BOUND


# --- the generic torch route: what K15 does not take ----------------------------

def _jval(x, y, t):
    return jnp.cos(x + 2.0 * y) * (1.0 + t)


def _tval(x, y, t):
    return torch.cos(x + 2.0 * y) * (1.0 + t)


def _generic_bcs(kind):
    """(JAX FieldBC, port FieldBC) of the generic route's cases: 2D
    inhomogeneous walls, a callable Dirichlet side (the padded route),
    3D walls, 3D inhomogeneous mixed sides, 3D with a periodic axis."""
    d0, n0 = jbc.Dirichlet(0.0), jbc.Neumann()
    per = (jbc.Periodic(), jbc.Periodic())
    if kind == "callable":
        from gerris_tpu_torch.core import bc as tbc
        jf = jbc.FieldBC(((jbc.Dirichlet(_jval), jbc.Neumann(0.5)),
                          (jbc.Dirichlet(0.3), d0)))
        tf = tbc.FieldBC(((tbc.Dirichlet(_tval), tbc.Neumann(0.5)),
                          (tbc.Dirichlet(0.3), tbc.Dirichlet(0.0))))
        return jf, tf
    jf = {
        "lid": _fbc("lid"),
        "per_x": _fbc("per_x"),
        "walls3d": jbc.FieldBC(((d0, d0), (d0, d0), (d0, d0))),
        "mixed3d": jbc.FieldBC(((d0, jbc.Neumann(0.5)),
                                (jbc.Dirichlet(0.3), jbc.Dirichlet(1.0)),
                                (n0, n0))),
        "per3d": jbc.FieldBC((per, (d0, n0), per)),
    }[kind]
    return jf, fieldbc_from_jax(jf)


def _generic_system(seed, grid, fbc, unit, cell):
    """u, rhs, per-axis positive face coefficients (None for ``unit``;
    face n = face 0 on a periodic axis) and a scalar or cell dia."""
    rng = np.random.default_rng(seed)
    u, rhs = rng.standard_normal(grid.shape), rng.standard_normal(grid.shape)
    alpha = None
    if not unit:
        alpha = []
        for c in range(grid.dim):
            a = 0.2 + rng.random(grid.face_shape(c))
            if fbc.is_periodic(c):
                last = [slice(None)] * grid.dim
                first = list(last)
                last[c], first[c] = -1, 0
                a[tuple(last)] = a[tuple(first)]
            alpha.append(a)
    dia = 0.5 + rng.random(grid.shape) if cell else 0.3
    return u, rhs, alpha, dia


_GENERIC = [
    # (kind, dim, unit coefficients, cell dia, homogeneous)
    ("lid", 2, False, True, False),
    ("callable", 2, False, True, False),
    ("per_x", 2, True, True, True),
    ("lid", 2, True, True, False),
    ("walls3d", 3, False, True, True),
    ("mixed3d", 3, False, False, False),
    ("per3d", 3, False, True, True),
    ("mixed3d", 3, True, True, True),
]


def _generic_case(kind, dim, unit, cell):
    jf, tf = _generic_bcs(kind)
    level = 5 if dim == 2 else 3
    jg, tg = JGrid(level=level, dim=dim), TGrid(level=level, dim=dim)
    u, rhs, alpha, dia = _generic_system(26, jg, jf, unit, cell)
    jargs = dict(alpha=None if unit else tuple(_j(*alpha)),
                 dia=_j(dia)[0])
    targs = dict(alpha=None if unit else tuple(_t(*alpha)),
                 dia=_t(dia)[0])
    return jf, tf, jg, tg, u, rhs, jargs, targs


@pytest.mark.parametrize("kind,dim,unit,cell,homogeneous", _GENERIC)
def test_relax_generic_matches_jax(kind, dim, unit, cell, homogeneous,
                                   monkeypatch):
    """The port's torch red-black sweeps (the route of an inhomogeneous
    alpha relax, a cell dia with unit coefficients, and 3D with alpha)
    against the reference's jnp relax: 3 sweeps, omega 1.2, callable
    values at t = 0.4.  None of these reaches K15."""
    def refuse(*args, **kw):
        raise AssertionError("K15 on the generic route")

    monkeypatch.setattr(trbgs, "rbgs_relax_alpha", refuse)
    jf, tf, jg, tg, u, rhs, jargs, targs = _generic_case(kind, dim, unit,
                                                         cell)
    ref = jpoisson.relax(*_j(u, rhs), jg, jf, 3, homogeneous=homogeneous,
                         omega=1.2, t=0.4, **jargs)
    got = tpoisson.relax(*_t(u, rhs), tg, tf, 3, homogeneous=homogeneous,
                         omega=1.2, t=0.4, **targs)
    assert _rel(ref, got) <= BOUND


@pytest.mark.parametrize("homogeneous", [False, True])
@pytest.mark.parametrize("kind", ["walls3d", "mixed3d", "per3d"])
def test_residual_alpha_3d_matches_jax(kind, homogeneous):
    """residual with 3D face coefficients and a cell dia."""
    jf, tf, jg, tg, u, rhs, jargs, targs = _generic_case(kind, 3, False,
                                                         True)
    ref = jpoisson.residual(*_j(u, rhs), jg, jf, homogeneous=homogeneous,
                            **jargs)
    got = tpoisson.residual(*_t(u, rhs), tg, tf, homogeneous=homogeneous,
                            **targs)
    assert _rel(ref, got) <= BOUND


_PARAMS = dict(nrelax=8, coarsest_relax=16, tolerance=1e-8, nitermax=30)


@pytest.mark.parametrize("cell", [False, True])
@pytest.mark.parametrize("kind", ["dirichlet", "per_x", "neumann"])
def test_correction_alpha_matches_jax(kind, cell):
    """One correction at 64^2 with face coefficients (and a cell dia):
    the coefficient hierarchy, restrict, 8 * 1 + 16 sweeps from zero at
    4^2, prolong + 8 sweeps up each level (K15's plain version)."""
    fbc = _fbc(kind)
    u, rhs, ax, ay, dia = _system(24, 64, fbc, cell)
    jp = jpoisson.MultilevelParams(**_PARAMS)
    tp = tpoisson.MultilevelParams(**_PARAMS)
    ref = jpoisson.correction(jnp.asarray(rhs), JGrid(level=6), fbc, jp,
                              alpha=tuple(_j(ax, ay)), dia=_j(dia)[0],
                              u_fine=jnp.asarray(u))
    got = tpoisson.correction(torch.from_numpy(rhs), TGrid(level=6),
                              fieldbc_from_jax(fbc), tp,
                              dia=_t(dia)[0], u_fine=torch.from_numpy(u),
                              alpha=tuple(_t(ax, ay)))
    assert _rel(ref, got) <= SOLVE_BOUND


@pytest.mark.parametrize("level,kind,cell", [(6, "neumann", False),
                                             (7, "dirichlet", True),
                                             (6, "per_xy", False)])
def test_adaptive_solve_alpha_matches_jax(level, kind, cell):
    """The adaptive solve with face coefficients, both sides on the same
    floored schedule (nrelax 8, 16 coarsest sweeps): equal niter, the
    solution within 1e-10 of max|u| (mean-free for pure Neumann and
    periodic, whose rhs is made compatible)."""
    fbc = _fbc(kind)
    n = 1 << level
    _, rhs, ax, ay, dia = _system(25, n, fbc, cell)
    pure = kind != "dirichlet"
    if pure:
        rhs = rhs - rhs.mean()
        dia = 0.0
    u0 = np.zeros((n, n))
    jp = jpoisson.MultilevelParams(**_PARAMS)
    tp = tpoisson.MultilevelParams(**_PARAMS)
    ju, jst = jpoisson.solve(*_j(u0, rhs), JGrid(level=level), fbc, jp,
                             alpha=tuple(_j(ax, ay)), dia=_j(dia)[0])
    tu, tst = tpoisson.solve(*_t(u0, rhs), TGrid(level=level),
                             fieldbc_from_jax(fbc), tp, dia=_t(dia)[0],
                             alpha=tuple(_t(ax, ay)))
    assert int(jst.niter) == tst.niter
    ref, got = np.asarray(ju), tu.numpy()
    if pure:
        ref, got = ref - ref.mean(), got - got.mean()
    assert np.max(np.abs(ref - got)) / np.max(np.abs(ref)) <= SOLVE_BOUND


# --- the variable-coefficient Poisson problem on the port ---------------------------

A0, A1 = 0.55, 0.45     # alpha = A0 + A1 cos(pi x) cos(pi y): 0.1 .. 1.0


def _alpha(x, y):
    return A0 + A1 * np.cos(np.pi * x) * np.cos(np.pi * y)


def _vc_error(level):
    """max|u_h - u| of div(alpha grad u) = f on the unit box with u =
    cos(pi x) cos(pi y) (homogeneous Dirichlet), alpha sampled at the
    face centres, solved by the port to 1e-10."""
    grid = TGrid(level=level)
    xc, yc = grid.axis_centers(0), grid.axis_centers(1)
    xf, yf = grid.axis_faces(0), grid.axis_faces(1)
    ax = _alpha(xf[:, None], yc[None, :])
    ay = _alpha(xc[:, None], yf[None, :])
    X, Y = np.meshgrid(xc, yc, indexing="ij")
    cx, cy = np.cos(np.pi * X), np.cos(np.pi * Y)
    sx, sy = np.sin(np.pi * X), np.sin(np.pi * Y)
    u = cx * cy
    f = (-2.0 * np.pi ** 2 * _alpha(X, Y) * u
         + A1 * np.pi ** 2 * (sx * sx * cy * cy + cx * cx * sy * sy))
    fbc = fieldbc_from_jax(_fbc("dirichlet"))
    params = tpoisson.MultilevelParams(tolerance=1e-10, nitermax=60,
                                       nrelax=8, coarsest_relax=16)
    got, st = tpoisson.solve(torch.zeros(grid.shape, dtype=torch.float64),
                             torch.from_numpy(f), grid, fbc, params,
                             alpha=tuple(_t(ax, ay)))
    assert st.niter < 60
    return float(np.max(np.abs(got.numpy() - u)))


def test_variable_coefficient_poisson_second_order():
    """alpha varying by 10x: the error ratio between 64^2 and 128^2 is
    second order, in [3.5, 4.5]."""
    e6, e7 = _vc_error(6), _vc_error(7)
    assert 3.5 <= e6 / e7 <= 4.5, (e6, e7)


@pytest.mark.parametrize("beta", [1.0, 0.5])
def test_diffuse_cell_rho_matches_jax(beta):
    """The variable-density velocity diffusion (the reference's alpha_imp
    / dia = rho branch): face coefficients beta dt nu, cell dia rho, the
    Crank-Nicolson explicit term div(alpha grad u) when beta < 1; the
    lid's walls at 64^2, rho between 1 and 10."""
    from gerris_tpu.solvers import diffusion as jdiff
    from gerris_tpu_torch.solvers import diffusion as tdiff
    rng = np.random.default_rng(26)
    v, extra = rng.standard_normal((64, 64)), rng.standard_normal((64, 64))
    rho = 1.0 + 9.0 * rng.random((64, 64))
    fbc = _fbc("lid")
    dt, nu = 0.2 / 64, 1e-3
    jp = jpoisson.MultilevelParams(**_PARAMS)
    ju, jst = jdiff.diffuse(*_j(v), JGrid(level=6), fbc, dt, nu,
                            rho=jnp.asarray(rho), beta=beta, params=jp,
                            extra_rhs=jnp.asarray(extra))
    tu, tst = tdiff.diffuse(*_t(v), TGrid(level=6), fieldbc_from_jax(fbc),
                            dt, nu, rho=torch.from_numpy(rho), beta=beta,
                            params=tpoisson.MultilevelParams(**_PARAMS),
                            extra_rhs=torch.from_numpy(extra))
    assert int(jst.niter) == tst.niter
    assert _rel(ju, tu) <= SOLVE_BOUND
