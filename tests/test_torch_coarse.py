"""The adaptive solve's kernels, K10 ``rbgs_relax``, K11 ``residual`` and
K12 ``coarse_vcycle`` (plain versions, CPU, float64), against the JAX
package's Pallas kernels, and the K12 route of the port's ``correction``
against a JAX composition of public functions.

K11 and K12 run in interpret mode, as tests/test_mgfuse.py runs them.
K10 takes no ``interpret`` argument, so it runs under
``pltpu.force_tpu_interpret_mode()``.  Tolerance: 1e-12 of max|ref| at
every cell for the kernels; 1e-10 of max|u| per cycle for the
correction."""
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

from test_torch_rbgs import jnp_cascade  # noqa: E402

BOUND = 1e-12


def _strip_plan(n0, S, H, periodic_x):
    """The strip plan of gerris_tpu/ops/pallas/rbgs.py as defined before
    commit d408783, which deleted it while rbgs_relax (and
    rbgs_relax_alpha) still call it: as committed, both raise NameError
    at trace time on every backend.  The tests set it back on the
    imported module for their run only, so that the kernel's body can be
    held against the port; nothing in gerris_tpu changes."""
    if n0 % S or n0 <= S + 2 * H:
        return n0, 0
    return S, H


def _fields(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) for s in shapes]


def _rel(ref, got):
    ref = np.asarray(ref)
    return float(np.max(np.abs(ref - got.numpy())) / np.max(np.abs(ref)))


def _fbc(kind):
    """JAX FieldBCs of the kernels' cases."""
    d0, d1 = jbc.Dirichlet(0.0), jbc.Dirichlet(1.0)
    per = (jbc.Periodic(), jbc.Periodic())
    return {
        "dirichlet": jbc.FieldBC(((d0, d0), (d0, d0))),
        "lid": jbc.FieldBC(((d0, d0), (d0, d1))),
        "neumann": jbc.default_scalar_bc(2),
        "per_x": jbc.FieldBC((per, (d0, jbc.Neumann()))),
        "per_y": jbc.FieldBC(((jbc.Dirichlet(0.3), jbc.Neumann(0.5)), per)),
        "per_xy": jbc.periodic_bc(2),
    }[kind]


# --- K11 residual --------------------------------------------------------------

@pytest.mark.parametrize("kind", ["per_x", "per_y", "lid", "per_xy"])
def test_residual_matches_pallas(kind):
    """K11's plain version against residual_pallas at 128^2 with 32-row
    strips: periodic rows, periodic columns (with inhomogeneous Dirichlet
    and Neumann offsets), the lid's Dirichlet offsets, doubly periodic."""
    fbc = _fbc(kind)
    grid = JGrid(level=7)
    signs, offs = jpoisson._signs_offs(grid, fbc, homogeneous=False)
    per = (fbc.is_periodic(0), fbc.is_periodic(1))
    u, rhs = _fields(11, grid.shape, grid.shape)
    ref = jrbgs.residual_pallas(jnp.asarray(u), jnp.asarray(rhs), 0.4,
                                h2=grid.h ** 2, signs=signs, offs=offs,
                                periodic=per, S=32, interpret=True)
    got = trbgs.residual(torch.from_numpy(u), torch.from_numpy(rhs), 0.4,
                         h2=grid.h ** 2, signs=signs, offs=offs,
                         periodic=per)
    assert _rel(ref, got) <= BOUND
    # the port's residual routes a static-valued system through K11
    tgot = tpoisson.residual(torch.from_numpy(u), torch.from_numpy(rhs),
                             TGrid(level=7), fieldbc_from_jax(fbc), dia=0.4)
    assert torch.equal(tgot, got)


# --- K10 rbgs_relax --------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dirichlet", "per_x", "per_xy"])
def test_rbgs_relax_matches_pallas(kind, monkeypatch):
    """K10's plain version against rbgs_relax (the deleted strip-plan
    helper restored, see _strip_plan) at 128^2 with 32-row strips, 3
    sweeps, omega 1.2: all-Dirichlet, periodic rows with mixed columns,
    doubly periodic; and against the reference's jnp relax."""
    monkeypatch.setattr(jrbgs, "_strip_plan", _strip_plan, raising=False)
    fbc = _fbc(kind)
    grid = JGrid(level=7)
    signs, _ = jpoisson._signs_offs(grid, fbc, homogeneous=True)
    per = (fbc.is_periodic(0), fbc.is_periodic(1))
    u, rhs = _fields(12, grid.shape, grid.shape)
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
                          TGrid(level=7), fieldbc_from_jax(fbc), 3, dia=0.3,
                          omega=1.2)
    assert torch.equal(tgot, got)


# --- K12 coarse_vcycle -------------------------------------------------------------

@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("per_y", [False, True])
@pytest.mark.parametrize("dia", [0.0, 0.4])
def test_coarse_vcycle_matches_pallas(n, per_y, dia):
    """K12's plain version (the ladder of tests/test_mgfuse.py) against
    coarse_vcycle at 128^2 and 256^2, down to 16^2: 4 sweeps per level,
    12 coarsest sweeps."""
    fbc = _fbc("per_y" if per_y else "dirichlet")
    signs, _ = jpoisson._signs_offs(JGrid(level=7), fbc, homogeneous=True)
    (r,) = _fields(13, (n, n))
    kw = dict(nsweeps=4, coarsest=12, h2=1.0 / n ** 2, signs=signs,
              per_y=per_y, min_n=16)
    ref = jrbgs.coarse_vcycle(jnp.asarray(r), dia, interpret=True, **kw)
    got = trbgs.coarse_vcycle(torch.from_numpy(r), dia, **kw)
    assert _rel(ref, got) <= BOUND


@pytest.mark.parametrize("per_y", [False, True])
def test_coarse_block_matches_pallas(per_y):
    """The 64^2 block-level part of K12 alone (its block kernel's
    function: 64 -> 16 and back) against coarse_vcycle at 64^2, Neumann
    rows.  12 coarsest sweeps: interpret mode traces every sweep (the
    card checks the path's 40)."""
    fbc = _fbc("per_y" if per_y else "neumann")
    signs, _ = jpoisson._signs_offs(JGrid(level=6), fbc, homogeneous=True)
    (r,) = _fields(14, (64, 64))
    kw = dict(nsweeps=5, coarsest=12, h2=1.0 / 64 ** 2, signs=signs,
              per_y=per_y, min_n=16)
    ref = jrbgs.coarse_vcycle(jnp.asarray(r), 0.25, interpret=True, **kw)
    got = trbgs.coarse_block(torch.from_numpy(r), 0.25, **kw)
    assert _rel(ref, got) <= BOUND
    with pytest.raises(ValueError):
        trbgs.coarse_block(torch.zeros(128, 128, dtype=torch.float64),
                           **kw)


@pytest.mark.parametrize("kind,dia", [("lid", 2.5e4), ("per_y", None)])
def test_correction_k12_route_matches_jax(kind, dia):
    """The K12 route of the port's correction (256^2 above coarse_top =
    64: one restrict_pyramid to 64, K12 there with its 40 coarsest
    sweeps, K3 at 128 and 256 with u folded in) against restrict -> K12's
    schedule as the jnp ladder (64 -> 16, 40 sweeps from zero, prolong +
    relax up; the Pallas K12 itself is held to the port's in
    test_coarse_block_matches_pallas, interpret mode tracing every
    sweep) -> prolong + relax per level + u, composed of gerris_tpu's
    public functions, for two cycles, each from the JAX side's u: the
    lid's Helmholtz system, and periodic columns."""
    fbc = _fbc(kind)
    tfbc = fieldbc_from_jax(fbc)
    grid, tgrid = JGrid(level=8), TGrid(level=8)
    params = tpoisson.MultilevelParams(nrelax=3, omega=1.5, coarsest_relax=8,
                                       coarse_top=64)
    u, rhs = _fields(15, grid.shape, grid.shape)
    grids = [dataclasses.replace(grid, level=lv) for lv in (8, 7, 6)]
    for _ in range(2):
        r = jpoisson.residual(jnp.asarray(u), jnp.asarray(rhs), grid, fbc,
                              dia=dia)
        rs = [r]
        for _g in grids[1:]:
            rs.append(jpoisson.restrict(rs[-1], 2))
        du = jnp_cascade([rs[-1]], grids[-1], fbc, dia, 3, 40)
        for k in (1, 0):
            du = jpoisson.prolong(du, grids[k + 1], fbc)
            du = jpoisson.relax(du, rs[k], grids[k], fbc, 3, dia=dia,
                                omega=1.5)
        ref = np.asarray(jnp.asarray(u) + du)
        got = tpoisson.cycle(torch.from_numpy(u), torch.from_numpy(rhs),
                             tgrid, tfbc, params, dia)
        assert _rel(ref, got) <= 1e-10
        u = ref


def test_adaptive_wrappers_check_inputs():
    z = torch.zeros(64, 64, dtype=torch.float64)
    kw = dict(h2=1e-3, signs=(1.0,) * 4)
    with pytest.raises(ValueError):
        trbgs.residual(torch.zeros(48, 48, dtype=torch.float64),
                       torch.zeros(48, 48, dtype=torch.float64), **kw)
    with pytest.raises(ValueError):
        trbgs.rbgs_relax(z, z.float(), nsweeps=1, **kw)
    with pytest.raises(ValueError):
        trbgs.coarse_vcycle(torch.zeros(256, 256, dtype=torch.float64),
                            nsweeps=1, coarsest=4, min_n=128, **kw)
    with pytest.raises(TypeError):
        trbgs.residual(z.half(), z.half(), **kw)
