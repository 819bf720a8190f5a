"""MAC and approximate projections (port of gerris_tpu/solvers/projection.py;
unit density, no embedded solids, no face sources).

The MAC projection makes the face-normal velocity exactly
divergence-free: solve lap(p) = div(u_f)/dt, then u_f -= dt grad_f p.  The
cell-centred gradient is the mean of a cell's two face gradients.
Reference: src/timestep.c:60-145, 356-596.
"""
from __future__ import annotations

from ..core.grid import Grid
from ..core import bc as bcs
from ..ops.stencils import divergence, face_average, face_gradient
from . import poisson


def face_gradients(p, grid: Grid, p_bc: bcs.FieldBC) -> list:
    """grad_face p for every face, per axis (face shapes)."""
    p_pad = bcs.apply_bc(p, grid, p_bc, 1, corners=False)
    return [face_gradient(p_pad, grid, axis) for axis in range(grid.dim)]


def cell_gradient_from_faces(gf: list, grid: Grid) -> list:
    """Mean of the two face gradients of each cell (reference:
    src/timestep.c:60-113)."""
    out = []
    for axis in range(grid.dim):
        f = gf[axis]
        n = f.shape[axis]
        out.append(0.5 * (f.narrow(axis, 0, n - 1) + f.narrow(axis, 1, n - 1)))
    return out


def mac_projection(u_face: list, p, grid: Grid, p_bc: bcs.FieldBC, dt,
                   params: poisson.MultilevelParams, cells=None):
    """Project the MAC field.  Returns (u_face', p, g_cell, stats), and
    with ``cells`` (centred velocities) a fifth element, the cells
    corrected by -dt g_cell.  For a pressure BC without Dirichlet sides
    the compatibility mean of the rhs stays on the device and is
    subtracted inside the solver's first kernel."""
    div = divergence(u_face, grid) / dt
    rhs_sub = None
    if not any(b.kind == bcs.DIRICHLET for ax in p_bc.sides for b in ax):
        rhs_sub = div.mean().reshape(1)
    p, stats = poisson.solve(p, div, grid, p_bc, params, rhs_sub=rhs_sub)
    gf = face_gradients(p, grid, p_bc)
    u_face = [u_face[c] - dt * gf[c] for c in range(grid.dim)]
    g_cell = cell_gradient_from_faces(gf, grid)
    if cells is not None:
        cells = [cells[c] - dt * g_cell[c] for c in range(grid.dim)]
        return u_face, p, g_cell, stats, cells
    return u_face, p, g_cell, stats


def face_interpolated_velocity(u_cell: list, grid: Grid, u_bcs: list,
                               gp=None, dtv=None):
    """MAC velocities as the mean of the two adjacent centred values, with
    the Dirichlet value on boundary faces (reference: src/advection.c:
    546-566).  ``gp``/``dtv``: per-component cell gradients first folded
    into the cells (u += dtv gp, the gc re-add, src/simulation.c:520);
    then (faces, updated cells) is returned."""
    src = u_cell if gp is None else \
        [u_cell[c] + dtv * gp[c] for c in range(grid.dim)]
    out = []
    for c in range(grid.dim):
        pad = bcs.apply_bc(src[c], grid, u_bcs[c], 1, corners=False)
        out.append(bcs.apply_face_bc(face_average(pad, grid, c), grid,
                                     u_bcs[c], c))
    return out if gp is None else (out, src)
