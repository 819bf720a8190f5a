"""Lagrangian particles (port of gerris_tpu/physics/particles.py, slice 6).

Only the vorticity field is here so far: the adaptation's vorticity cost
(physics/adapt.py) reads it.
"""
from __future__ import annotations

from ..core.grid import Grid
from ..core import bc as bcs
from ..ops.stencils import center_gradient


def vorticity_field(U: list, grid: Grid, u_bcs: list, t: float = 0.0):
    """Cell-centred vorticity: w_z in 2D, (w_x, w_y, w_z) in 3D, centred
    differences on the velocities padded with their BCs at time ``t``
    (gfs_vorticity, src/fluid.c; modules/particulatecommon.c:115-167)."""
    pads = [bcs.apply_bc(U[c], grid, u_bcs[c], 1, t=t)
            for c in range(grid.dim)]

    def d(c, a):
        return center_gradient(pads[c], grid, a)

    if grid.dim == 2:
        return d(1, 0) - d(0, 1)
    return d(2, 1) - d(1, 2), d(0, 2) - d(2, 0), d(1, 0) - d(0, 1)
