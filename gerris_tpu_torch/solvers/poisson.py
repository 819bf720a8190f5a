"""Geometric multigrid for (L - dia) u = rhs on uniform 2D grids
(port of gerris_tpu/solvers/poisson.py, the fixed-cycle half, with the
batched U+V pair of the implicit diffusion).

L is the unit-coefficient 5-point Laplacian and dia a scalar.  The solve
runs ``ncycles`` fixed sawtooth cycles, each the three-step fused cycle
of the TPU production path (``fused_cycle``), on every device alike:
``nrelax`` sweeps with ``omega`` at every level, a restriction cascade
down to min(16, n/4) and ``coarsest_relax`` sweeps from zero there.  The
reference derives that schedule from the TPU backend and its
``tpu_nrelax`` floors; the port takes it from the parameters only
(utils/convert.params_from_jax applies the floors).

The U+V implicit-diffusion pair solves both systems together, every
launch of the cycle serving both (``solve_fixed_batched``, K8a-c;
``solve_relax_pair``, the "relax" solver's fine-relax-only correction,
K8a + K8c).

Not in this slice, and raising NotImplementedError: the adaptive
tolerance loop (``ncycles == 0``), the cg/mgcg solvers and "relax"
outside the pair, per-face coefficients, cell-valued dia and periodic
rows.
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
    solve (0 = the adaptive loop, not ported); solver: "multigrid", or
    "relax" for the diffusion pair (solve_relax_pair)."""

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


def _check_fused(u, grid: Grid, fbc: bcs.FieldBC):
    """The levels and BCs the fused cycle's kernels take."""
    _check_2d(grid)
    n0, n1 = u.shape
    if fbc.is_periodic(0):
        raise NotImplementedError("periodic rows in the fused cycle "
                                  "(ROADMAP Queue 1, item 1)")
    if n0 != n1 or n0 < 4 * MIN_N or n0 & (n0 - 1):
        raise NotImplementedError(f"fused cycle on a {n0}x{n1} level: want "
                                  f"square powers of two >= {4 * MIN_N}")


def fused_cycle(u, rhs, grid: Grid, fbc: bcs.FieldBC,
                params: MultilevelParams, dia=None, rhs_sub=0.0):
    """One sawtooth cycle as K1 -> K2 -> K3 (reference poisson.py:662-690):
      1. residual_restrict: r0 = (rhs - rhs_sub) - (L - dia) u, r1, r2;
      2. cascade_prolong_relax: the whole correction at and below n/2;
      3. prolong_relax: fine prolong + relax + u += du.
    Returns (u_new, r0)."""
    _check_fused(u, grid, fbc)
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
            "(ROADMAP Queue 1, item 1); give a fixed ncycles > 0")
    sub = 0.0 if rhs_sub is None else rhs_sub
    r0 = None
    for _ in range(params.ncycles):
        u, r0 = fused_cycle(u, rhs, grid, fbc, params, dia, sub)
    return u, SolveStats(niter=params.ncycles, r_before=r0, r_after=r0)


def batched_fixed_eligible(us, grid: Grid, fbcs, dias) -> bool:
    """Can the systems share one batched launch chain (the pair kernels
    K8a-c)?  2D, scalar dias, non-periodic rows, and the same ghost signs
    and y periodicity across the batch (reference poisson.py:781-790).
    The reference also asks for the TPU's fused-cycle constraints (the
    backend, f32, n >= 512); the port's route depends on the
    configuration only, and fused_cycle's own size limits apply to both
    routes alike."""
    if grid.dim != 2 or len(us) != 2:
        return False
    if not all(d is None or isinstance(d, (int, float)) for d in dias):
        return False
    if any(f.is_periodic(0) for f in fbcs):
        return False
    sp = [(_signs_offs(grid, f, False)[0], f.is_periodic(1)) for f in fbcs]
    return all(x == sp[0] for x in sp[1:])


def _pair_setup(grid: Grid, fbcs, dias):
    """(signs, per_y, [offs per system], [dia per system]) of a pair."""
    signs, _ = _signs_offs(grid, fbcs[0], homogeneous=False)
    offss = [_signs_offs(grid, f, homogeneous=False)[1] for f in fbcs]
    ds = [0.0 if d is None else float(d) for d in dias]
    return signs, fbcs[0].is_periodic(1), offss, ds


def solve_fixed_batched(us, rhss, grid: Grid, fbcs,
                        params: MultilevelParams, dias, subs=None,
                        rr_pre=None):
    """``params.ncycles`` fixed sawtooth cycles on the two independent
    scalar-dia systems of the U+V implicit-diffusion pair, each cycle as
    K8a -> K8b -> K8c, one launch chain for both systems (reference
    poisson.py:830-886).  The caller checks batched_fixed_eligible.
    ``subs``: each system's rhs mean, as solve's rhs_sub.  ``rr_pre``:
    the first cycle's precomputed ([r0s], [r1s], [r2s]) (K7's rr_dia
    mode), which replaces its K8a launch; ``rhss`` may then be None when
    ncycles == 1.  Returns ([u0, u1], stats of system 0)."""
    for u, fbc in zip(us, fbcs):
        _check_fused(u, grid, fbc)
    if rr_pre is None and rhss is None:
        raise ValueError("solve_fixed_batched: give rhss or rr_pre")
    if rhss is None and params.ncycles > 1:
        raise ValueError("solve_fixed_batched: cycles after the first "
                         "need rhss")
    signs, per_y, offss, ds = _pair_setup(grid, fbcs, dias)
    subs = [0.0, 0.0] if subs is None else \
        [0.0 if s is None else s for s in subs]
    h2 = grid.h * grid.h
    U = list(us)
    r0 = None
    for ic in range(params.ncycles):
        if ic == 0 and rr_pre is not None:
            r0, r1, r2 = rr_pre
        else:
            r0, r1, r2 = rbgs.residual_restrict_pair(
                U, rhss, ds, subs, h2=h2, signs=signs, offss=offss,
                per_y=per_y)
        du = rbgs.cascade_prolong_relax_pair(
            r1, r2, ds, nsweeps=params.nrelax,
            coarsest=params.coarsest_relax, h2_half=4.0 * h2, signs=signs,
            per_y=per_y, omega=params.omega, min_n=MIN_N)
        U = rbgs.prolong_relax_pair(du, r0, ds, U, nsweeps=params.nrelax,
                                    h2=h2, signs=signs, per_y=per_y,
                                    omega=params.omega)
    return U, SolveStats(niter=params.ncycles, r_before=r0[0],
                         r_after=r0[0])


def solve_relax_pair(us, rhss, grid: Grid, fbcs, params: MultilevelParams,
                     dias):
    """The pair's fine-relax-only solve (the "relax" solver): K8a for the
    residual, then K8c from a zero correction with max(nrelax, 4) sweeps
    and u += du (reference poisson.py:793-827).  Returns ([u0, u1], stats
    of system 0)."""
    _check_2d(grid)
    signs, per_y, offss, ds = _pair_setup(grid, fbcs, dias)
    h2 = grid.h * grid.h
    r0, _, _ = rbgs.residual_restrict_pair(us, rhss, ds, h2=h2, signs=signs,
                                           offss=offss, per_y=per_y)
    U = rbgs.prolong_relax_pair([None, None], r0, ds, list(us),
                                nsweeps=max(params.nrelax, 4), h2=h2,
                                signs=signs, per_y=per_y, omega=params.omega)
    return U, SolveStats(niter=1, r_before=r0[0], r_after=r0[0])
