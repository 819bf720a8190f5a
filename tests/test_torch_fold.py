"""The fold route (MultilevelParams.fold_div / fold_correct) on the CPU,
float64: the plain versions of K16 residual_restrict_div and K17
prolong_relax_correct against the JAX package's Pallas kernels run in
interpret mode with 32-row strips at 128^2 (as tests/test_mgfuse.py runs
them), the port's folded solves against the composition K16 -> K2 -> K3
-> K5 (K2 as the jnp ladder of its schedule), the folded ns_step against
the port's unfolded step, and the route's choice.

The JAX CPU step never takes this route (its _bcg.applicable asks for
the TPU), so the folded step is held to the port's unfolded step.  The
two differ by the compatibility mean that the fold drops (sub = 0); on
the lid cavity that mean is a rounding error, so the bound is 1e-9.
Kernel tolerances: 1e-12 of each output's max|ref|; K17's gradients amplify
p' by 1/h and are held relative to their own max.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.ops.pallas import projops as jprojops  # noqa: E402
from gerris_tpu.ops.pallas import rbgs as jrbgs  # noqa: E402
from gerris_tpu.solvers import poisson as jpoisson  # noqa: E402

from gerris_tpu_torch.core import bc as tbc  # noqa: E402
from gerris_tpu_torch.models import ns as tns  # noqa: E402
from gerris_tpu_torch.ops.cuda import projops as tprojops  # noqa: E402
from gerris_tpu_torch.ops.cuda import rbgs as trbgs  # noqa: E402
from gerris_tpu_torch.solvers import poisson as tpoisson  # noqa: E402
from gerris_tpu_torch.solvers import projection as tproj  # noqa: E402
from gerris_tpu_torch.utils.convert import (config_from_jax,  # noqa: E402
                                            fieldbc_from_jax,
                                            grid_from_jax, state_from_numpy)

from test_bench_schedule import cavity_cfg  # noqa: E402
from test_torch_rbgs import jnp_cascade  # noqa: E402

TOL = 1e-12
STEP_RTOL = 1e-9
STRIP = 32


def _fbc(per_y):
    """Pressure-like BCs without a Dirichlet side: inhomogeneous Neumann
    on every side, or Neumann x sides with periodic y."""
    if per_y:
        return jbc.FieldBC(((jbc.Neumann(0.25), jbc.Neumann()),
                            (jbc.Periodic(), jbc.Periodic())))
    return jbc.FieldBC(((jbc.Neumann(0.25), jbc.Neumann(-0.5)),
                        (jbc.Neumann(0.4), jbc.Neumann(0.75))))


def _fields(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) for s in shapes]


def _faces(seed, n):
    return _fields(seed, (n + 1, n), (n, n + 1))


def _rel(ref, got):
    ref = np.asarray(ref)
    return float(np.max(np.abs(ref - got.numpy())) / np.max(np.abs(ref)))


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("S", [STRIP, 256])
@pytest.mark.parametrize("sub", [0.0, 0.11])
@pytest.mark.parametrize("per_y", [False, True])
def test_residual_restrict_div_matches_pallas(per_y, sub, S):
    """K16 at 128^2, in 32-row strips and whole (S = 256 > n)."""
    grid = JGrid(level=7)
    signs, offs = jpoisson._signs_offs(grid, _fbc(per_y), homogeneous=False)
    n = grid.shape[0]
    (u,), (ufx, ufy) = _fields(1, grid.shape), _faces(2, n)
    dt, dia = 0.37 * grid.h, 0.4
    kw = dict(h2=grid.h ** 2, signs=signs, offs=offs)
    ref = jrbgs.residual_restrict_div(
        jnp.asarray(u), jnp.asarray(ufx), jnp.asarray(ufy), dt * grid.h, dia,
        sub, periodic=(False, per_y), S=S, interpret=True, **kw)
    got = trbgs.residual_restrict_div(*_t(u, ufx, ufy), dt * grid.h, dia, sub,
                                      per_y=per_y, **kw)
    for a, b in zip(ref, got):
        assert a.shape == tuple(b.shape)
        assert _rel(a, b) <= TOL


def _rep(du_c):
    """A coarse correction in the Pallas kernels' rep layout
    (tests/test_mgfuse.py:503-504)."""
    return jnp.pad(jnp.repeat(jnp.asarray(du_c), 2, axis=1),
                   ((jrbgs.GP, jrbgs.GP), (0, 0)))


@pytest.mark.parametrize("with_cells", [False, True])
@pytest.mark.parametrize("per_y,nsweeps", [(False, 5), (True, 8)])
def test_prolong_relax_correct_matches_pallas(per_y, nsweeps, with_cells):
    """K17 at 128^2 in 32-row strips (4 of them), omega 1.5, the real
    ghosts with inhomogeneous Neumann offsets."""
    grid = JGrid(level=7)
    fbc = _fbc(per_y)
    signs, offs = jpoisson._signs_offs(grid, fbc, homogeneous=False)
    n = grid.shape[0]
    du_c, rhs, u, U, V = _fields(3, (n // 2, n // 2), *[grid.shape] * 4)
    ufx, ufy = _faces(4, n)
    dt, dia, omega = 0.37 * grid.h, 0.0, 1.5
    cells = (U, V) if with_cells else None
    ref = jrbgs.prolong_relax_correct(
        _rep(du_c), jnp.asarray(rhs), dia, jnp.asarray(u), jnp.asarray(ufx),
        jnp.asarray(ufy), dt, grid.h,
        None if cells is None else tuple(map(jnp.asarray, cells)),
        nsweeps=nsweeps, h2=grid.h ** 2, sgn=signs, off=offs,
        periodic_y=per_y, omega=omega, S=STRIP, interpret=True)
    got = trbgs.prolong_relax_correct(
        *_t(du_c, rhs), dia, *_t(u, ufx, ufy), dt, grid.h,
        None if cells is None else _t(*cells), nsweeps=nsweeps,
        h2=grid.h ** 2, signs=signs, offs=offs, per_y=per_y, omega=omega)
    assert len(got) == 7 and (got[5] is None) == (cells is None)
    for a, b in zip(ref, got):
        assert a.shape == tuple(b.shape)
        assert _rel(a, b) <= TOL


@pytest.mark.parametrize("per_y", [False, True])
def test_correct_plain_is_k5_plain(per_y):
    """K17's epilogue in the kernels' encoding computes K5's plain
    version on the same BCs (inhomogeneous Neumann included)."""
    jgrid = JGrid(level=5)
    grid, fbc = grid_from_jax(jgrid), _fbc(per_y)
    signs, offs = jpoisson._signs_offs(jgrid, fbc, homogeneous=False)
    n = jgrid.shape[0]
    p, U, V = _t(*_fields(5, *[jgrid.shape] * 3))
    ufx, ufy = _t(*_faces(6, n))
    got = trbgs.correct_plain(p, ufx, ufy, 0.3, grid.h, signs, offs, per_y,
                              (U, V))
    ref = tprojops.correct_project_plain(p, ufx, ufy, 0.3, grid,
                                         fieldbc_from_jax(fbc), (U, V))
    for a, b in zip(ref, got):
        assert torch.allclose(a, b, rtol=0, atol=TOL * float(a.abs().max()))


def _pallas_fold(u, ufx, ufy, jgrid, fbc, params, dt, cells):
    """The Pallas composition K16 -> K2 -> K3 -> K5 of one folded
    projection, K16, K3 and K5 in interpret mode with 32-row strips, K2
    as the jnp ladder of its schedule (interpret mode traces each of its
    40 coarsest sweeps; tests/test_torch_rbgs.py holds the Pallas K2 to
    the port's and tests/test_mgfuse.py to the ladder), built as
    tests/test_mgfuse.py:_ladder_cycle: (p, ufx', ufy', gx, gy[, U',
    V'])."""
    signs, offs = jpoisson._signs_offs(jgrid, fbc, homogeneous=False)
    per_y = fbc.is_periodic(1)
    h, h2 = jgrid.h, jgrid.h ** 2
    u = jnp.asarray(u)
    r0, r1, r2 = jrbgs.residual_restrict_div(
        u, jnp.asarray(ufx), jnp.asarray(ufy), dt * h, 0.0, 0.0, h2=h2,
        signs=signs, offs=offs, periodic=(False, per_y), S=STRIP,
        interpret=True)
    du = jnp_cascade([r1, r2], dataclasses.replace(
        jgrid, level=jgrid.level - 1), fbc, 0.0, params.nrelax,
        max(params.coarsest_relax, 40), params.omega)
    p = jrbgs.prolong_relax(du, r0, 0.0, u, nsweeps=params.nrelax, h2=h2,
                            signs=signs, periodic_y=per_y, add_u=True,
                            omega=params.omega, S=STRIP, interpret=True)
    out = jprojops.correct_project(
        p, jnp.asarray(ufx), jnp.asarray(ufy), dt, h,
        None if cells is None else tuple(map(jnp.asarray, cells)),
        sgn=signs, off=offs, per_y=per_y, S=STRIP, interpret=True)
    return (p,) + tuple(out)


@pytest.mark.parametrize("per_y", [False, True])
def test_folded_solves_match_pallas_composition(per_y):
    """solve_fused_div's p and solve_fused_div_correct's outputs (with
    the cells) at 128^2 under the bench's projection schedule (5 sweeps,
    omega 1.5, 40 coarsest sweeps)."""
    jgrid = JGrid(level=7)
    fbc = _fbc(per_y)
    grid, tfbc = grid_from_jax(jgrid), fieldbc_from_jax(fbc)
    params = tpoisson.MultilevelParams(nrelax=5, omega=1.5,
                                       coarsest_relax=40, ncycles=1,
                                       fold_div=True, fold_correct=True)
    n = jgrid.shape[0]
    u, U, V = _fields(7, *[jgrid.shape] * 3)
    ufx, ufy = _faces(8, n)
    dt = 0.4 * jgrid.h
    assert tpoisson.fold_div_eligible(torch.from_numpy(u), grid, tfbc,
                                      params)
    ref = _pallas_fold(u, ufx, ufy, jgrid, fbc, params, dt, (U, V))
    p, stats = tpoisson.solve_fused_div(*_t(u, ufx, ufy), grid, tfbc, params,
                                        dt)
    assert _rel(ref[0], p) <= TOL and stats.niter == 1
    assert stats.r_before is stats.r_after
    got = tpoisson.solve_fused_div_correct(*_t(u, ufx, ufy), grid, tfbc,
                                           params, dt, _t(U, V))
    # (ufx', ufy', p, gx, gy, stats, U', V') against (p, ufx', ufy', gx,
    # gy, U', V')
    order = (2, 0, 1, 3, 4, 6, 7)
    for a, k in zip(ref, order):
        assert _rel(a, got[k]) <= TOL, k
    assert torch.equal(got[5].r_before, stats.r_before)


def _lid_cfgs(**fold):
    """The bench's lid cavity at 64^2 (config_from_jax), unfolded and with
    ``fold`` set on both projections' params."""
    tcfg = config_from_jax(cavity_cfg(6))
    folded = dataclasses.replace(
        tcfg, projection=dataclasses.replace(tcfg.projection, **fold),
        approx_projection=dataclasses.replace(tcfg.approx_projection,
                                              **fold))
    return tcfg, folded


def _run(cfg, st, steps):
    ts = state_from_numpy(st, device="cpu")
    dt = 0.8 * cfg.grid.h
    for i in range(steps):
        ts = tns.ns_step(ts, dt, 0.0, cfg, first_step=i == 0)
    return ts


def _step_err(a, b, name):
    x, y = a[name], b[name]
    if name == "P":
        x, y = x - x.mean(), y - y.mean()
    return float((x - y).abs().max() / y.abs().max())


@pytest.mark.parametrize("fold", [dict(fold_div=True),
                                  dict(fold_div=True, fold_correct=True)])
def test_folded_ns_step_matches_unfolded(fold):
    """10 lid-cavity steps at 64^2 from a small random state (seeded
    numpy), fixed dt = 0.8 h: the fold route against the port's unfolded
    route (K4 + K1 with the compatibility mean, and K5)."""
    tcfg, folded = _lid_cfgs(**fold)
    rng = np.random.default_rng(0)
    st = {n: 0.05 * rng.standard_normal(tcfg.grid.shape)
          for n in ("U", "V", "P", "Pmac", "Gx", "Gy")}
    ref, got = _run(tcfg, st, 10), _run(folded, st, 10)
    errs = {n: _step_err(got, ref, n) for n in ("U", "V", "P")}
    print(f"fold {fold}: rel errors (P mean-free) {errs}")
    assert all(e <= STEP_RTOL for e in errs.values()), errs


class _Spy:
    """Counts the calls of the fold route's and the unfolded route's
    dispatch sites."""
    SITES = ((tpoisson, "solve_fused_div"),
             (tpoisson, "solve_fused_div_correct"), (tpoisson, "solve"),
             (tprojops, "divergence_mac"), (tprojops, "correct_project"))

    def __init__(self, monkeypatch):
        self.calls = {name: 0 for _, name in self.SITES}
        for mod, name in self.SITES:
            monkeypatch.setattr(mod, name, self._wrap(name, getattr(mod,
                                                                    name)))

    def _wrap(self, name, fn):
        def spy(*args, **kw):
            self.calls[name] += 1
            return fn(*args, **kw)
        return spy


def _lid_state(cfg):
    rng = np.random.default_rng(1)
    return state_from_numpy({n: 0.05 * rng.standard_normal(cfg.grid.shape)
                             for n in ("U", "V", "P", "Pmac", "Gx", "Gy")},
                            device="cpu")


@pytest.mark.parametrize("fold,div_in_src,want", [
    (dict(fold_div=True), False,
     dict(solve_fused_div=2, divergence_mac=0, correct_project=2, solve=0)),
    (dict(fold_div=True, fold_correct=True), False,
     dict(solve_fused_div_correct=2, divergence_mac=0, correct_project=0,
          solve=0)),
    # a producer divergence wins (reference projection.py:127)
    (dict(fold_div=True, fold_correct=True), True,
     dict(solve_fused_div=0, solve_fused_div_correct=0, solve=2,
          correct_project=2)),
    (dict(), False, dict(solve_fused_div=0, solve_fused_div_correct=0,
                         divergence_mac=2, solve=2)),
])
def test_fold_route_choice_in_the_step(monkeypatch, fold, div_in_src, want):
    """One ns_step's two projections take the fold route with fold_div
    (K16 in place of K4 + K1) and fold_correct (K17 in place of K3 + K5),
    and not with div_in_src."""
    _, cfg = _lid_cfgs(**fold)
    cfg = dataclasses.replace(cfg, div_in_src=div_in_src)
    spy = _Spy(monkeypatch)
    tns.ns_step(_lid_state(cfg), 0.8 * cfg.grid.h, 0.0, cfg)
    for k, v in want.items():
        assert spy.calls[k] == v, (k, spy.calls)


@pytest.mark.parametrize("case", ["dirichlet_side", "ncycles", "per_x",
                                  "relax"])
def test_fold_route_refused(monkeypatch, case):
    """fold_div takes the unfolded route with a Dirichlet pressure side,
    more than one cycle, periodic rows or a registry solver."""
    jgrid = JGrid(level=6)
    grid = grid_from_jax(jgrid)
    params = tpoisson.MultilevelParams(nrelax=5, omega=1.5,
                                       coarsest_relax=40, ncycles=1,
                                       fold_div=True, fold_correct=True)
    p_bc = fieldbc_from_jax(_fbc(False))
    if case == "dirichlet_side":
        p_bc = tbc.FieldBC(((tbc.Dirichlet(0.0), tbc.Neumann()),
                            p_bc.sides[1]))
    elif case == "ncycles":
        params = dataclasses.replace(params, ncycles=2)
    elif case == "per_x":
        p_bc = tbc.FieldBC.uniform(tbc.Periodic(), 2)
        params = dataclasses.replace(params, dense_coarse_max=1024)
    else:
        params = dataclasses.replace(params, solver="relax")
    n = jgrid.shape[0]
    p = torch.zeros(jgrid.shape, dtype=torch.float64)
    uf = _t(*_faces(9, n))
    assert not tpoisson.fold_div_eligible(p, grid, p_bc, params)
    spy = _Spy(monkeypatch)
    tproj.mac_projection(uf, p, grid, p_bc, 0.01, params)
    assert spy.calls["solve_fused_div"] == 0
    assert spy.calls["solve_fused_div_correct"] == 0
    assert spy.calls["divergence_mac"] == 1 and spy.calls["solve"] == 1
