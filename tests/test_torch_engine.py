"""The sweep engine's K15 with the prolongation folded in, and the plans
of K10 and K15 (CPU, float64).

K15 ``rbgs_relax_alpha`` takes an optional coarse correction, placed as
its bilinear prolongation with homogeneous ghosts, and an optional field
added to its result, so that every upward level of a 2D alpha
correction is one launch.  On the CPU the wrapper runs its plain
version, which must be ``prolong_plain`` then ``rbgs_relax_alpha_plain``
(+ add) bit for bit; that composition is held to the reference's jnp
``prolong`` followed by the Pallas ``rbgs_relax_alpha`` in interpret mode
(the deleted ``_strip_plan`` restored with ``monkeypatch``, as
tests/test_torch_alpha.py does), at 32^2 with 2 sweeps, to 1e-12 of
max|ref|; and ``correction`` with face coefficients gives the tensor of
the unfolded ``prolong`` + ``relax`` ladder bit for bit.  The plans
(``_sweep_plan``) are checked for every level from 4^2 to 2048^2, float32
and float64, and the routes' sweep counts: shared memory within the
card's 232,448 bytes, a tile that divides the level, 256 or 512 threads.
"""
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

from gerris_tpu_torch.core.grid import Grid as TGrid  # noqa: E402
from gerris_tpu_torch.ops.cuda import rbgs as trbgs  # noqa: E402
from gerris_tpu_torch.solvers import poisson as tpoisson  # noqa: E402
from gerris_tpu_torch.utils.convert import fieldbc_from_jax  # noqa: E402

from test_torch_coarse import _strip_plan  # noqa: E402

BOUND = 1e-12
SMEM_MAX = 232448
KINDS = ("dirichlet", "per_x", "per_xy")


def _fbc(kind):
    d0 = jbc.Dirichlet(0.0)
    per = (jbc.Periodic(), jbc.Periodic())
    return {
        "dirichlet": jbc.FieldBC(((d0, d0), (d0, d0))),
        "per_x": jbc.FieldBC((per, (d0, jbc.Neumann()))),
        "per_xy": jbc.periodic_bc(2),
        "neumann": jbc.default_scalar_bc(2),
    }[kind]


def _system(seed, n, fbc, cell, dead=False):
    """rhs, positive face coefficients (face n = face 0 on a periodic
    axis), a scalar or positive cell dia, a coarse correction and a field
    to add; ``dead``: a few cells with all four faces and dia zero."""
    rng = np.random.default_rng(seed)
    rhs = rng.standard_normal((n, n))
    ax = 0.2 + rng.random((n + 1, n))
    ay = 0.2 + rng.random((n, n + 1))
    dia = 0.5 + rng.random((n, n)) if cell else 0.3
    if dead:
        for i, j in ((1, 2), (n // 2, n // 2 + 1), (n - 2, 3)):
            ax[i, j] = ax[i + 1, j] = ay[i, j] = ay[i, j + 1] = 0.0
            if cell:
                dia[i, j] = 0.0
        if not cell:
            dia = 0.0
    if fbc.is_periodic(0):
        ax[n] = ax[0]
    if fbc.is_periodic(1):
        ay[:, n] = ay[:, 0]
    coarse = rng.standard_normal((n // 2, n // 2))
    add = rng.standard_normal((n, n))
    return rhs, ax, ay, dia, coarse, add


def _t(*arrays):
    return [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for a in arrays]


def _kw(fbc, n, cell, nsweeps=3, omega=1.3):
    signs, _ = jpoisson._signs_offs(JGrid(level=5), fbc, homogeneous=True)
    return dict(nsweeps=nsweeps, h2=1.0 / n ** 2, signs=signs,
                periodic=(fbc.is_periodic(0), fbc.is_periodic(1)),
                omega=omega, dia_cell=cell)


# --- the fold's plain version -------------------------------------------------

@pytest.mark.parametrize("with_add", [False, True])
@pytest.mark.parametrize("dead", [False, True])
@pytest.mark.parametrize("cell", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_fold_plain_is_prolong_then_relax(kind, cell, dead, with_add):
    """K15 with a coarse correction (and an added field) on the CPU is
    prolong_plain then rbgs_relax_alpha_plain (+ add), bit for bit; with
    neither u nor coarse it starts from zero.  Walls, periodic rows,
    doubly periodic; scalar and cell dia; zero-diagonal cells."""
    fbc = _fbc(kind)
    rhs, ax, ay, dia, c, add = _t(*_system(50, 32, fbc, cell, dead))
    add = add if with_add else None
    kw = _kw(fbc, 32, cell)
    got = trbgs.rbgs_relax_alpha(None, rhs, ax, ay, dia, coarse=c, add=add,
                                 **kw)
    want = trbgs.rbgs_relax_alpha_plain(
        trbgs.prolong_plain(c, kw["signs"], kw["periodic"]), rhs, ax, ay,
        dia, **kw)
    assert torch.equal(got, want if add is None else want + add)
    zero = trbgs.rbgs_relax_alpha(None, rhs, ax, ay, dia, add=add, **kw)
    want = trbgs.rbgs_relax_alpha_plain(torch.zeros_like(rhs), rhs, ax, ay,
                                        dia, **kw)
    assert torch.equal(zero, want if add is None else want + add)
    if dead:
        # a zero-diagonal cell keeps its placed value (+ add)
        p = trbgs.prolong_plain(c, kw["signs"], kw["periodic"])
        base = p if add is None else p + add
        assert got[1, 2] == base[1, 2] and got[30, 3] == base[30, 3]


@pytest.mark.parametrize("cell", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_fold_matches_jax(kind, cell, monkeypatch):
    """The fold against the reference's composition: its jnp prolong of
    the coarse correction, then the Pallas rbgs_relax_alpha (interpret
    mode, the deleted strip-plan helper restored), + the added field;
    32^2, 2 sweeps, omega 1.3."""
    monkeypatch.setattr(jrbgs, "_strip_plan", _strip_plan, raising=False)
    fbc = _fbc(kind)
    rhs, ax, ay, dia, c, add = _system(51, 32, fbc, cell)
    kw = _kw(fbc, 32, cell, nsweeps=2)
    fine = jpoisson.prolong(jnp.asarray(c), JGrid(level=4), fbc)
    jd = jnp.asarray(dia) if cell else dia
    with pltpu.force_tpu_interpret_mode():
        ref = jrbgs.rbgs_relax_alpha(fine, jnp.asarray(rhs), jnp.asarray(ax),
                                     jnp.asarray(ay), jd, S=16, **kw)
    ref = np.asarray(ref) + add
    got = trbgs.rbgs_relax_alpha(None, *_t(rhs, ax, ay, dia), coarse=_t(c)[0],
                                 add=_t(add)[0], **kw)
    assert np.max(np.abs(got.numpy() - ref)) <= BOUND * np.max(np.abs(ref))


# --- the correction with the fold -----------------------------------------------

def _unfolded_correction(r, grid, fbc, params, alpha, dia, u_fine):
    """The alpha correction as it was before the fold: relax from zero at
    minlevel, then prolong + relax (K15's wrapper from a given u) up
    every level, + u_fine."""
    minlevel = min(params.minlevel, grid.level)
    grids = [dataclasses.replace(grid, level=lv)
             for lv in range(grid.level, minlevel - 1, -1)]
    alphas, dias = tpoisson._coeff_hierarchy(grid, minlevel, alpha, dia)
    rs = tpoisson._residual_levels(r, len(grids) - 1)
    nl = len(grids)
    du = tpoisson.relax(torch.zeros_like(rs[-1]), rs[-1], grids[-1], fbc,
                        params.nrelax * params.erelax ** (nl - 1)
                        + params.coarsest_relax, dias[-1],
                        omega=params.omega, alpha=alphas[-1])
    for k in range(nl - 2, -1, -1):
        du = tpoisson.relax(tpoisson.prolong(du, fbc, grids[k + 1]), rs[k],
                            grids[k], fbc,
                            params.nrelax * params.erelax ** k, dias[k],
                            omega=params.omega, alpha=alphas[k])
    return du if u_fine is None else u_fine + du


@pytest.mark.parametrize("with_u", [False, True])
@pytest.mark.parametrize("cell", [False, True])
@pytest.mark.parametrize("kind", KINDS + ("neumann",))
def test_correction_with_the_fold_is_unchanged(kind, cell, with_u):
    """correction with face coefficients, 64^2 down to 4^2 (five K15
    levels, omega 1.2), equals the unfolded ladder bit for bit on the
    CPU."""
    fbc = fieldbc_from_jax(_fbc(kind))
    grid = TGrid(level=6)
    rhs, ax, ay, dia, _, u = _t(*_system(52, 64, _fbc(kind), cell))
    params = tpoisson.MultilevelParams(nrelax=3, coarsest_relax=5,
                                       minlevel=2, omega=1.2)
    u = u if with_u else None
    got = tpoisson.correction(rhs, grid, fbc, params, dia, u_fine=u,
                              alpha=(ax, ay))
    want = _unfolded_correction(rhs, grid, fbc, params, (ax, ay), dia, u)
    assert torch.equal(got, want)


def test_correction_folds_every_upward_level(monkeypatch):
    """The 2D alpha correction calls K15's wrapper once per level: the
    coarsest from zero, each upward level with the coarser level's result
    as its coarse correction, u_fine added on the finest only."""
    calls = []
    real = trbgs.rbgs_relax_alpha

    def spy(u, rhs, *args, **kw):
        calls.append((u, rhs.shape[0], kw["coarse"], kw["add"]))
        return real(u, rhs, *args, **kw)

    monkeypatch.setattr(trbgs, "rbgs_relax_alpha", spy)
    fbc = fieldbc_from_jax(_fbc("per_x"))
    rhs, ax, ay, dia, _, u = _t(*_system(53, 64, _fbc("per_x"), True))
    params = tpoisson.MultilevelParams(nrelax=2, coarsest_relax=4,
                                       minlevel=2)
    tpoisson.correction(rhs, TGrid(level=6), fbc, params, dia, u_fine=u,
                        alpha=(ax, ay))
    assert [c[1] for c in calls] == [4, 8, 16, 32, 64]
    assert all(c[0] is None for c in calls)
    assert calls[0][2] is None
    assert all(c[2].shape[0] == c[1] // 2 for c in calls[1:])
    assert all(c[3] is None for c in calls[:-1]) and calls[-1][3] is u


# --- the wrapper's checks --------------------------------------------------------

@pytest.mark.parametrize("shape", [(17, 16), (16, 17), (32, 32), (8, 8)])
def test_fold_refuses_a_coarse_of_the_wrong_shape(shape):
    rhs, ax, ay, dia, _, _ = _t(*_system(54, 32, _fbc("dirichlet"), True))
    with pytest.raises(ValueError):
        trbgs.rbgs_relax_alpha(None, rhs, ax, ay, dia,
                               coarse=torch.zeros(shape, dtype=rhs.dtype),
                               **_kw(_fbc("dirichlet"), 32, True))


def test_fold_refuses_u_and_coarse_together():
    rhs, ax, ay, dia, c, _ = _t(*_system(55, 32, _fbc("dirichlet"), True))
    with pytest.raises(ValueError):
        trbgs.rbgs_relax_alpha(rhs, rhs, ax, ay, dia, coarse=c,
                               **_kw(_fbc("dirichlet"), 32, True))


# --- the plans ------------------------------------------------------------------

@pytest.mark.parametrize("nsweeps", [1, 2, 4, 5, 8, 24, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kernel", ["rbgs_relax", "rbgs_relax_alpha"])
def test_sweep_plans_fit_the_card(kernel, dtype, nsweeps):
    """For every level from 4^2 to 2048^2, on the H100's 132
    multiprocessors and on one, with the plan's tile and with each tile
    forced: the block's shared memory is at most 232,448 bytes, the tile
    divides the level, the threads are 256 or 512, and the launches
    cover the sweeps."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    buffers = trbgs.BUFFERS[kernel]
    for level in range(2, 12):
        n = 1 << level
        for sms in (132, 1):
            for tile in (None, 64, 32, 16):
                if tile is not None and (n <= 64 or n % tile):
                    continue
                got, per, threads = trbgs._sweep_plan(
                    n, nsweeps, buffers, itemsize, sms, tile)
                side = n + 2 if got == n else got + 4 * per + 2
                assert trbgs._engine_smem(side, itemsize, buffers) <= SMEM_MAX
                assert n % got == 0 and threads in (256, 512)
                assert 1 <= per <= nsweeps
                assert got == n if n <= 64 else got in (64, 32, 16)
                assert tile is None or got == tile
