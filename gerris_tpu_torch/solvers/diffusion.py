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


def diffuse(v, grid: Grid, fbc: bcs.FieldBC, dt: float, D: float,
            rho: float = 1.0, beta: float = 0.5,
            params: poisson.MultilevelParams = None, extra_rhs=None):
    """One implicit diffusion solve for ``v``; returns (v_new, stats).
    ``params=None`` is the reference's adaptive default, which is not
    ported (poisson.solve raises)."""
    if not isinstance(D, (int, float)) or not isinstance(rho, (int, float)):
        raise NotImplementedError("face-valued D or cell-valued rho "
                                  "(ROADMAP Queue 1, slice 3)")
    if params is None:
        params = poisson.MultilevelParams(ncycles=0)
    rhs = rho * v
    if beta < 1.0:
        v_pad = bcs.apply_bc(v, grid, fbc, 1, corners=False)
        rhs = rhs + (1.0 - beta) * dt * D * laplacian(v_pad, grid)
    if extra_rhs is not None:
        rhs = rhs + extra_rhs
    scale = beta * dt * D
    return poisson.solve(v, -rhs / scale, grid, fbc, params,
                         dia=rho / scale)
