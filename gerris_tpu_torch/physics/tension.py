"""Surface tension as well-balanced face sources in the projections
(port of gerris_tpu/physics/tension.py:26-84).

The force sigma kappa grad(c) is discretized with the pressure
gradient's face stencil and enters both projections (projection.
mac_projection's ``face_sources``), so a static droplet's Laplace
pressure balances it to the solver's tolerance (reference:
GfsSourceTension src/tension.c:307-385, tension_coeff src/poisson.c:
903-996, gfs_velocity_face_sources src/timestep.c:245-290).
kappa > 0 for a convex fluid body; the force is + sigma kappa grad(c).
The CSS variant (``css_tension_sources``, 2D) gives cell accelerations
instead: the divergence of the capillary stress from Youngs gradients.
"""
from __future__ import annotations

import math

import torch

from ..core import bc as bcs
from ..core.grid import Grid
from ..ops.stencils import face_gradient


def face_kappa_pair(kap, axis: int):
    """Curvature on the faces of ``axis`` (face shape) from the NaN-marked
    cell curvature: the mean where both cells have one, the one that is
    defined, else 0; the edge cells' values extend to the boundary
    faces."""
    kp = bcs.edge_extend(kap, axis, 1)
    n = kp.shape[axis]
    k1, k2 = kp.narrow(axis, 0, n - 1), kp.narrow(axis, 1, n - 1)
    ok1, ok2 = torch.isfinite(k1), torch.isfinite(k2)
    k1z = torch.where(ok1, k1, 0.0)
    k2z = torch.where(ok2, k2, 0.0)
    both = 0.5 * (k1z + k2z)
    return torch.where(ok1 & ok2, both,
                       torch.where(ok1, k1z, torch.where(ok2, k2z, 0.0)))


def tension_face_sources(T, kap, sigma, grid: Grid, fbc: bcs.FieldBC,
                         alpha=None, t: float = 0.0) -> list:
    """Per-axis face arrays dp = alpha sigma kappa_face grad_face(T), the
    projections' ``face_sources`` (T's BC values at time ``t``)."""
    T_pad = bcs.apply_bc(T, grid, fbc, 1, t=t)
    out = []
    for axis in range(grid.dim):
        dp = sigma * face_kappa_pair(kap, axis) * \
            face_gradient(T_pad, grid, axis)
        out.append(dp if alpha is None else dp * alpha[axis])
    return out


def stability_dt(grid: Grid, sigma: float, rho1: float = 1.0,
                 rho2: float = 1.0) -> float:
    """The capillary timestep bound sqrt(rho_avg h^3 / (pi sigma))
    (gfs_source_tension_generic_stability, src/tension.c:106-137)."""
    if sigma <= 0.0:
        return math.inf
    rho = 0.5 * (rho1 + rho2)
    return math.sqrt(rho * grid.h ** 3 / (math.pi * sigma))


def _youngs_gradient(a_pad):
    """2D Youngs (3x3, 1-2-1 weighted) gradient of a 1-ghost padded
    field, in per-cell units (gfs_youngs_gradient, src/fluid.c;
    gerris_tpu/physics/tension.py:85-94)."""
    gx = ((a_pad[2:, :-2] + 2.0 * a_pad[2:, 1:-1] + a_pad[2:, 2:])
          - (a_pad[:-2, :-2] + 2.0 * a_pad[:-2, 1:-1] + a_pad[:-2, 2:])
          ) / 8.0
    gy = ((a_pad[:-2, 2:] + 2.0 * a_pad[1:-1, 2:] + a_pad[2:, 2:])
          - (a_pad[:-2, :-2] + 2.0 * a_pad[1:-1, :-2] + a_pad[2:, :-2])
          ) / 8.0
    return gx, gy


def css_tension_sources(T, sigma, grid: Grid, fbc: bcs.FieldBC,
                        alpha_cell=None, t: float = 0.0) -> list:
    """The CSS surface tension's cell accelerations [t_x, t_y], 2D
    (GfsSourceTensionCSS, src/tension.c:181-305; gerris_tpu/physics/
    tension.py:97-128): from the Youngs gradient n of T (its BC values
    at time ``t``), g0 = (sigma/h) nx^2/|n|, g1 = (sigma/h) ny^2/|n|, g2
    = (sigma/h) nx ny/|n| on the default scalar BCs, then t_x = alpha
    (dx g1 - dy g2)/h and t_y = alpha (dy g0 - dx g2)/h, alpha the cell's
    1/rho (``alpha_cell``) or 1.  |n| = sqrt(nx^2 + ny^2 + 1e-50) as the
    reference takes it; where it is 0 (1e-50 is 0 in float32, so a cell
    with no gradient gives 0/0 in the reference) the g are 0."""
    if grid.dim != 2:
        raise NotImplementedError("CSS tension is 2D (the reference's is)")
    h = grid.h
    nx, ny = _youngs_gradient(bcs.apply_bc(T, grid, fbc, 1, t=t))
    nn = torch.sqrt(nx * nx + ny * ny + 1e-50)
    ok = nn > 0.0
    nns = torch.where(ok, nn, 1.0)
    sigh = sigma / h
    gbc = bcs.default_scalar_bc(2)

    def grad(g):
        return _youngs_gradient(bcs.apply_bc(torch.where(ok, g / nns, 0.0),
                                             grid, gbc, 1))

    g0x, g0y = grad(sigh * nx * nx)
    g1x, g1y = grad(sigh * ny * ny)
    g2x, g2y = grad(sigh * nx * ny)
    a = 1.0 if alpha_cell is None else alpha_cell
    return [a * (g1x - g2y) / h, a * (g0y - g2x) / h]

