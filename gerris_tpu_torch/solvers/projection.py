"""MAC and approximate projections (port of gerris_tpu/solvers/projection.py;
unit density, no embedded solids, no face sources).

The MAC projection makes the face-normal velocity exactly
divergence-free: solve lap(p) = div(u_f)/dt, then u_f -= dt grad_f p.  The
cell-centred gradient is the mean of a cell's two face gradients.
Reference: src/timestep.c:60-145, 356-596.

The divergence runs through K4 ``divergence_mac``, the correction
through K5 ``correct_project`` and the face interpolation through K9
``interp_faces`` (ops/cuda/projops.py).  BCs outside the kernels'
encoding (ops/cuda/bcg.kernel_spec: periodic rows, inhomogeneous Neumann;
for the faces also non-Dirichlet normal faces) take the kernels' plain
versions, the torch route, as in the reference.  The choice is made from
the configuration only.
"""
from __future__ import annotations

from ..core.grid import Grid
from ..core import bc as bcs
from ..ops.cuda import bcg, projops
from . import poisson


def mac_projection(u_face: list, p, grid: Grid, p_bc: bcs.FieldBC, dt,
                   params: poisson.MultilevelParams, cells=None,
                   div_pre=None):
    """Project the MAC field.  Returns (u_face', p, g_cell, stats,
    cells'): with ``cells`` (centred velocities) cells' are those cells
    corrected by -dt g_cell, else None.  ``div_pre``: the (div, total)
    that the producer of ``u_face`` already emitted (K6/K9 with
    div_scale), so no divergence launch runs here.  For a pressure BC
    without Dirichlet sides the compatibility mean total / ncells stays on
    the device and is subtracted inside the solver's first kernel."""
    if div_pre is None:
        div_pre = projops.divergence_mac(u_face[0], u_face[1], dt, grid.h)
    div, total = div_pre
    rhs_sub = None
    if not any(b.kind == bcs.DIRICHLET for ax in p_bc.sides for b in ax):
        rhs_sub = total / div.numel()
    p, stats = poisson.solve(p, div, grid, p_bc, params, rhs_sub=rhs_sub)
    kernel = bcg.applicable(grid) and bcg.kernel_spec(p_bc) is not None
    correct = projops.correct_project if kernel else \
        projops.correct_project_plain
    out = correct(p, u_face[0], u_face[1], dt, grid, p_bc, cells)
    cells = None if cells is None else [out[4], out[5]]
    return [out[0], out[1]], p, [out[2], out[3]], stats, cells


def face_interpolated_velocity(u_cell: list, grid: Grid, u_bcs: list,
                               gp=None, dtv=None, div_scale=None):
    """MAC velocities as the mean of the two adjacent centred values, with
    the Dirichlet value on boundary faces (reference: src/advection.c:
    546-566).  Returns (faces, cells, divp).  ``gp``/``dtv``: per-component
    cell gradients first folded into the cells (u += dtv gp, the gc
    re-add, src/simulation.c:520), and ``cells`` are the updated cells
    (else the given ones).  ``div_scale``: ``divp`` is the faces'
    divergence scaled by div_scale and its sum (K9's fold of the
    projection's divergence), else None."""
    kernel = bcg.applicable(grid) and bcg.face_specs(u_bcs) is not None
    interp = projops.interp_faces if kernel else projops.interp_faces_plain
    out = interp(u_cell[0], u_cell[1], grid, u_bcs, gp, dtv, div_scale)
    divp = None if div_scale is None else (out[4], out[5])
    return [out[0], out[1]], [out[2], out[3]], divp
