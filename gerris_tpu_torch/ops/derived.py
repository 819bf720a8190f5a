"""Derived variables (port of gerris_tpu/ops/derived.py).

The reference's derived GfsVariable classes (src/variable.c, init.c:166-189):
Vorticity (gfs_vorticity, src/fluid.c), the velocity norm, the 2D stream
function by a Poisson solve (GfsVariableStreamFunction) and the Laplacian
(GfsVariableLaplacian), as plain functions of the state.
"""
from __future__ import annotations

import torch

from ..core import bc as bcs
from ..core.grid import Grid
from .stencils import laplacian


def vorticity(U: list, grid: Grid, u_bcs: list, t: float = 0.0):
    """The 2D scalar vorticity, the 3D vector (GfsVariableVorticity)."""
    from ..physics.particles import vorticity_field

    return vorticity_field(U, grid, u_bcs, t)


def velocity_norm(U: list) -> torch.Tensor:
    """|u| (the 'Velocity' derived variable, src/simulation.c)."""
    return torch.sqrt(sum(u * u for u in U))


def velocity2(U: list) -> torch.Tensor:
    """|u|^2 ('Velocity2', test/oscillation's energy output)."""
    return sum(u * u for u in U)


def laplacian_of(f: torch.Tensor, grid: Grid, fbc: bcs.FieldBC,
                 t: float = 0.0) -> torch.Tensor:
    """GfsVariableLaplacian: the 5-point (7-point) Laplacian of f padded
    with its BCs."""
    return laplacian(bcs.apply_bc(f, grid, fbc, 1, t=t), grid)


def stream_function(U: list, grid: Grid, u_bcs: list, tol: float = 1e-8,
                    t: float = 0.0, params=None):
    """The 2D stream function psi, u = -dpsi/dy and v = dpsi/dx, so that
    lap(psi) = the vorticity; psi = 0 on the walls, its mean-free form on
    a doubly periodic box (GfsVariableStreamFunction, src/variable.c).
    The solve is poisson.solve's with MultilevelParams(tolerance=tol,
    nitermax=60) unless ``params`` is given."""
    from ..solvers import poisson

    if grid.dim != 2:
        raise ValueError("the stream function is 2D")
    w = vorticity(U, grid, u_bcs, t)
    periodic = all(b.kind == bcs.PERIODIC
                   for ax in u_bcs[0].sides for b in ax)
    if periodic:
        fbc = bcs.FieldBC.uniform(bcs.Periodic(), 2)
        w = w - torch.mean(w)
    else:
        fbc = bcs.FieldBC.uniform(bcs.Dirichlet(0.0), 2)
    if params is None:
        params = poisson.MultilevelParams(tolerance=tol, nitermax=60)
    psi, _ = poisson.solve(torch.zeros_like(w), w, grid, fbc, params)
    return psi
