"""Surface tension as well-balanced face sources in the projections
(port of gerris_tpu/physics/tension.py:26-84).

The force sigma kappa grad(c) is discretized with the pressure
gradient's face stencil and enters both projections (projection.
mac_projection's ``face_sources``), so a static droplet's Laplace
pressure balances it to the solver's tolerance (reference:
GfsSourceTension src/tension.c:307-385, tension_coeff src/poisson.c:
903-996, gfs_velocity_face_sources src/timestep.c:245-290).
kappa > 0 for a convex fluid body; the force is + sigma kappa grad(c).
The CSS variant is slice 3c.
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
