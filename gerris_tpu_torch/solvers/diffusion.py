"""Implicit diffusion via multigrid (port of gerris_tpu/solvers/diffusion.py,
the scalar-D scalar-rho system).

Solves  rho u - beta dt D lap(u) = rho u_old + (1-beta) dt D lap(u_old)
[+ extra], divided through by beta dt D into the Helmholtz system
lap(u) - (rho / (beta dt D)) u = -rhs / (beta dt D) with a scalar dia.
Reference: src/poisson.c:1280-1467, src/timestep.c:720-790.
"""
from __future__ import annotations

from ..core.grid import Grid
from ..core import bc as bcs
from ..ops.stencils import laplacian
from . import poisson

# the reference's default schedule of a diffusion solve
# (gerris_tpu/solvers/diffusion.py:40-44: GfsMultilevelParams' tolerance,
# 10 cycles at most; the system is identity-dominated)
DEFAULT_PARAMS = poisson.MultilevelParams(tolerance=1e-3, nitermax=10)


def params_or_default(params):
    return DEFAULT_PARAMS if params is None else params


def diffuse(v, grid: Grid, fbc: bcs.FieldBC, dt: float, D: float,
            rho: float = 1.0, beta: float = 0.5,
            params: poisson.MultilevelParams = None, extra_rhs=None,
            t: float = 0.0):
    """One implicit diffusion solve for ``v``; returns (v_new, stats).
    ``params=None`` is the reference's adaptive default, DEFAULT_PARAMS."""
    if not isinstance(D, (int, float)) or not isinstance(rho, (int, float)):
        raise NotImplementedError("face-valued D or cell-valued rho "
                                  "(ROADMAP Queue 1, slice 3)")
    params = params_or_default(params)
    rhs = rho * v
    if beta < 1.0:
        v_pad = bcs.apply_bc(v, grid, fbc, 1, corners=False)
        rhs = rhs + (1.0 - beta) * dt * D * laplacian(v_pad, grid)
    if extra_rhs is not None:
        rhs = rhs + extra_rhs
    scale = beta * dt * D
    return poisson.solve(v, -rhs / scale, grid, fbc, params,
                         dia=rho / scale, t=t)


def diffuse_pair(vs, grid: Grid, fbcs, dt: float, D: float, beta: float,
                 params: poisson.MultilevelParams, extra_rhss=None,
                 rhss=None, rr_pre=None):
    """The U+V scalar implicit-diffusion systems solved together
    (reference: gerris_tpu/solvers/diffusion.py:82-125): where
    poisson.batched_fixed_eligible holds and beta = 1, one batched launch
    chain per cycle for both (solve_fixed_batched, or solve_relax_pair for the
    "relax" solver); else one solve per component.  Scalar D, unit rho.
    Give ``extra_rhss`` (momentum increments; the rhs is built here),
    ``rhss`` (the system rhs -dia (v + extra), e.g. from the advection
    kernels' oscale fold) or ``rr_pre`` (the first cycle's residual
    pyramid from K7's rr_dia mode; one multigrid cycle only).
    ``params=None`` is diffuse's default (adaptive, so one solve per
    component).  Returns ([v_new...], stats)."""
    if not isinstance(D, (int, float)):
        raise NotImplementedError("face-valued D (ROADMAP Queue 1, "
                                  "slice 3)")
    params = params_or_default(params)
    scale = beta * dt * D
    dia = 1.0 / scale
    n = len(vs)
    if rr_pre is not None:
        if params.ncycles != 1 or params.solver != "multigrid":
            raise ValueError("diffuse_pair: rr_pre needs one multigrid "
                             "cycle")
        return poisson.solve_fixed_batched(vs, None, grid, fbcs, params,
                                           [dia] * n, rr_pre=rr_pre)
    if beta < 1.0 and rhss is not None:
        raise ValueError("diffuse_pair: a prebuilt rhs omits the beta < 1 "
                         "explicit term; give extra_rhss")
    if (params.ncycles > 0 and beta == 1.0
            and poisson.batched_fixed_eligible(vs, grid, fbcs, [dia] * n)):
        if rhss is None:
            rhss = [-(vs[c] + extra_rhss[c]) * dia for c in range(n)]
        if params.solver == "relax":
            return poisson.solve_relax_pair(vs, rhss, grid, fbcs, params,
                                            [dia] * n)
        return poisson.solve_fixed_batched(vs, rhss, grid, fbcs, params,
                                           [dia] * n)
    outs, stats = [], None
    for c in range(n):
        if rhss is not None:
            v_new, stats = poisson.solve(vs[c], rhss[c], grid, fbcs[c],
                                         params, dia=dia)
        else:
            v_new, stats = diffuse(vs[c], grid, fbcs[c], dt, D, beta=beta,
                                   params=params, extra_rhs=extra_rhss[c])
        outs.append(v_new)
    return outs, stats
