"""Implicit diffusion via multigrid (port of gerris_tpu/solvers/diffusion.py).

Solves  rho u - beta dt div(D grad u) = rho u_old + (1-beta) dt div(D
grad u_old) [+ extra], D a scalar or face-valued (one face array per
axis: a variable viscosity), rho a scalar or a cell array.  With scalar
D and rho it is divided through by beta dt D into the Helmholtz system
lap(u) - (rho / (beta dt D)) u = -rhs / (beta dt D) with a scalar dia;
otherwise (a cell rho, the variable-density velocity diffusion, or a
face-valued D) it is div(beta dt D grad u) - rho u = -rhs, face
coefficients beta dt D and the cell dia rho (K15 in the multigrid).
Reference: src/poisson.c:1280-1467, src/timestep.c:720-790.
"""
from __future__ import annotations

import torch

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


def _diffuse_faces(v, grid, fbc, dt, D, rho, beta, params, extra_rhs, t):
    """diffuse with face-valued ``D`` (reference diffusion.py:47-79): the
    explicit beta < 1 term div(D grad v) on v padded with corners=False,
    face coefficients beta dt D and the cell dia rho (a scalar rho
    broadcast to the cells)."""
    rho_c = rho if isinstance(rho, torch.Tensor) else torch.full(
        grid.shape, rho, dtype=v.dtype, device=v.device)
    rhs = rho_c * v
    if beta < 1.0:
        v_pad = bcs.apply_bc(v, grid, fbc, 1, t=t, corners=False)
        rhs = rhs + (1.0 - beta) * dt * laplacian(v_pad, grid, D)
    if extra_rhs is not None:
        rhs = rhs + extra_rhs
    alpha = tuple(beta * dt * a for a in D)
    return poisson.solve(v, -rhs, grid, fbc, params, dia=rho_c, t=t,
                         alpha=alpha)


def diffuse(v, grid: Grid, fbc: bcs.FieldBC, dt: float, D,
            rho: float = 1.0, beta: float = 0.5,
            params: poisson.MultilevelParams = None, extra_rhs=None,
            t: float = 0.0):
    """One implicit diffusion solve for ``v``; returns (v_new, stats).
    ``D``: a scalar, or per-axis face arrays (a variable viscosity).
    ``rho``: a scalar or a cell array (the reference's rhoc mass
    coefficient, the density of the velocity diffusion).
    ``params=None`` is the reference's adaptive default, DEFAULT_PARAMS."""
    params = params_or_default(params)
    if not isinstance(D, (int, float)):
        return _diffuse_faces(v, grid, fbc, dt, tuple(D), rho, beta, params,
                              extra_rhs, t)
    rhs = rho * v
    if beta < 1.0:
        v_pad = bcs.apply_bc(v, grid, fbc, 1, t=t, corners=False)
        rhs = rhs + (1.0 - beta) * dt * D * laplacian(v_pad, grid)
    if extra_rhs is not None:
        rhs = rhs + extra_rhs
    if isinstance(rho, torch.Tensor):
        # the reference's alpha_imp / dia = rho branch (diffusion.py:
        # 50-56, :77-78): beta dt D on every face
        alpha = tuple(beta * dt * torch.full(grid.face_shape(c), D,
                                             dtype=v.dtype, device=v.device)
                      for c in range(grid.dim))
        return poisson.solve(v, -rhs, grid, fbc, params, dia=rho, t=t,
                             alpha=alpha)
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
        # the reference pairs no variable viscosity (gerris_tpu/models/
        # ns.py:255-259 asks for mu None)
        raise NotImplementedError("diffuse_pair takes a scalar D; a "
                                  "face-valued D takes diffuse per "
                                  "component")
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
