"""Geometric multigrid for (L - dia) u = rhs on uniform 2D grids
(port of gerris_tpu/solvers/poisson.py, the fixed-cycle half).

L is the unit-coefficient 5-point Laplacian and dia a scalar.  The solve
runs ``ncycles`` fixed sawtooth cycles, each the three-step fused cycle
of the TPU production path (``fused_cycle``), on every device alike:
``nrelax`` sweeps with ``omega`` at every level, a restriction cascade
down to min(16, n/4) and ``coarsest_relax`` sweeps from zero there.  The
reference derives that schedule from the TPU backend and its
``tpu_nrelax`` floors; the port takes it from the parameters only
(utils/convert.params_from_jax applies the floors).

Not in this slice, and raising NotImplementedError: the adaptive
tolerance loop (``ncycles == 0``), the non-multigrid solvers, per-face
coefficients, cell-valued dia and periodic rows.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.grid import Grid
from ..core import bc as bcs
from ..ops.stencils import norms
from ..ops.cuda import rbgs

# the restriction cascade stops at min(MIN_N, n/4) cells per side
MIN_N = 16


@dataclasses.dataclass(frozen=True)
class MultilevelParams:
    """The fixed-cycle schedule (reference: GfsMultilevelParams,
    src/poisson.c:40-126, and gerris_tpu MultilevelParams).

    nrelax: RBGS sweeps per level; omega: over-relaxation; coarsest_relax:
    sweeps from zero at the coarsest level; ncycles: sawtooth cycles per
    solve (0 = the adaptive loop, not ported); solver: "multigrid" only."""

    nrelax: int = 4
    omega: float = 1.0
    coarsest_relax: int = 40
    ncycles: int = 1
    solver: str = "multigrid"


@dataclasses.dataclass
class SolveStats:
    """Reference: src/poisson.h output fields.  The residual tensors are
    kept and their norms computed on demand, so an unread statistic costs
    no device work."""
    niter: int
    r_before: torch.Tensor
    r_after: torch.Tensor

    @property
    def residual_before(self) -> dict:
        return norms(self.r_before)

    @property
    def residual_after(self) -> dict:
        return norms(self.r_after)

    def reduction(self):
        # the reference guards with 1e-300, which is 0 in float32
        tiny = torch.finfo(self.r_after.dtype).tiny
        return (self.residual_before["infty"]
                / torch.clamp(self.residual_after["infty"], min=tiny))


def _signs_offs(grid: Grid, fbc: bcs.FieldBC, homogeneous: bool):
    """(signs, offs) ghost encodings for the kernels (ghost = sign *
    mirror + off per side; reference poisson.py:628-645)."""
    signs = tuple(-1.0 if fbc.sides[ax][sd].kind == bcs.DIRICHLET else 1.0
                  for ax in range(2) for sd in range(2))
    offs = []
    for ax in range(2):
        for sd in range(2):
            b = fbc.sides[ax][sd]
            if homogeneous or b.kind == bcs.PERIODIC:
                offs.append(0.0)
            elif b.kind == bcs.DIRICHLET:
                offs.append(2.0 * bcs.bc_value(b))
            else:
                offs.append((1.0 if sd else -1.0) * bcs.bc_value(b) * grid.h)
    return signs, tuple(offs)


def _periodic(fbc: bcs.FieldBC):
    return (fbc.is_periodic(0), fbc.is_periodic(1))


def _check_2d(grid: Grid):
    if grid.dim != 2:
        raise NotImplementedError("3D multigrid is slice 2 (ROADMAP Queue 1)")


def residual(u, rhs, grid: Grid, fbc: bcs.FieldBC, dia=None,
             homogeneous: bool = False):
    """r = rhs - (L - dia) u (reference: src/poisson.c:634-747)."""
    _check_2d(grid)
    signs, offs = _signs_offs(grid, fbc, homogeneous)
    up, dn, lf, rt = rbgs._neighbours(u, signs, offs, _periodic(fbc))
    d = 0.0 if dia is None else dia
    return rhs - (up + dn + lf + rt - 4.0 * u) / (grid.h * grid.h) + d * u


def relax(u, rhs, grid: Grid, fbc: bcs.FieldBC, nsweeps: int, dia=None,
          homogeneous: bool = True, omega: float = 1.0):
    """Red-black Gauss-Seidel sweeps (reference: src/poisson.c:507-586)."""
    _check_2d(grid)
    signs, offs = _signs_offs(grid, fbc, homogeneous)
    h2 = grid.h * grid.h
    d = 0.0 if dia is None else dia
    return rbgs.rbgs_plain(u, rhs, nsweeps, h2, 1.0 / (4.0 + d * h2), signs,
                           _periodic(fbc), omega, offs)


def restrict(r):
    """Mean of the 2x2 children (reference: get_from_below,
    src/poisson.c:1044-1068)."""
    return rbgs.pool_plain(r)


def prolong(c, fbc: bcs.FieldBC):
    """Bilinear prolongation coarse -> fine with homogeneous BCs
    (reference: get_from_above, src/poisson.c:1005-1042)."""
    signs, _ = _signs_offs(None, fbc, True)
    return rbgs.prolong_plain(c, signs, _periodic(fbc))


def fused_cycle(u, rhs, grid: Grid, fbc: bcs.FieldBC,
                params: MultilevelParams, dia=None, rhs_sub=0.0):
    """One sawtooth cycle as K1 -> K2 -> K3 (reference poisson.py:662-690):
      1. residual_restrict: r0 = (rhs - rhs_sub) - (L - dia) u, r1, r2;
      2. cascade_prolong_relax: the whole correction at and below n/2;
      3. prolong_relax: fine prolong + relax + u += du.
    Returns (u_new, r0)."""
    _check_2d(grid)
    n0, n1 = u.shape
    if fbc.is_periodic(0):
        raise NotImplementedError("periodic rows in the fused cycle "
                                  "(ROADMAP Queue 1, item 2)")
    if n0 != n1 or n0 < 4 * MIN_N or n0 & (n0 - 1):
        raise NotImplementedError(f"fused cycle on a {n0}x{n1} level: want "
                                  f"square powers of two >= {4 * MIN_N}")
    if dia is not None and not isinstance(dia, (int, float)):
        raise NotImplementedError("dia must be a scalar; cell-valued dia "
                                  "is ROADMAP Queue 1, slice 3")
    signs, offs = _signs_offs(grid, fbc, homogeneous=False)
    per_y = fbc.is_periodic(1)
    d = 0.0 if dia is None else float(dia)
    h2 = grid.h * grid.h
    r0, r1, r2 = rbgs.residual_restrict(u, rhs, d, rhs_sub, h2=h2,
                                        signs=signs, offs=offs, per_y=per_y)
    du = rbgs.cascade_prolong_relax(
        r1, r2, d, nsweeps=params.nrelax, coarsest=params.coarsest_relax,
        h2_half=4.0 * h2, signs=signs, per_y=per_y, omega=params.omega,
        min_n=MIN_N)
    u = rbgs.prolong_relax(du, r0, d, u, nsweeps=params.nrelax, h2=h2,
                           signs=signs, per_y=per_y, omega=params.omega)
    return u, r0


def solve(u, rhs, grid: Grid, fbc: bcs.FieldBC,
          params: MultilevelParams = MultilevelParams(), dia=None,
          rhs_sub=None):
    """``params.ncycles`` fixed sawtooth cycles on (L - dia) u = rhs -
    rhs_sub (reference poisson.py:1090-1127).  ``rhs_sub``: the
    pure-Neumann compatibility mean, a float or a one-element tensor,
    folded into the first kernel.  Stats report the residual entering the
    last cycle."""
    if params.solver != "multigrid":
        raise NotImplementedError(
            f"solver {params.solver!r}: the cg/mgcg/relax registry is not "
            "ported yet (ROADMAP Queue 1, slice 7)")
    if params.ncycles <= 0:
        raise NotImplementedError(
            "the adaptive tolerance loop (ncycles == 0) is not ported yet "
            "(ROADMAP Queue 1, item 2); give a fixed ncycles > 0")
    sub = 0.0 if rhs_sub is None else rhs_sub
    r0 = None
    for _ in range(params.ncycles):
        u, r0 = fused_cycle(u, rhs, grid, fbc, params, dia, sub)
    return u, SolveStats(niter=params.ncycles, r_before=r0, r_after=r0)
