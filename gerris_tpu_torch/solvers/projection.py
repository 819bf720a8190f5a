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

With ``fold_div`` (poisson.fold_div_eligible) and no producer divergence,
a MAC projection takes the reference's fold route (projection.py:
135-155): its one cycle forms the divergence inside K16
``residual_restrict_div``, then runs K2, K3 and the K5 correction, or
with ``fold_correct`` K2 and K17 ``prolong_relax_correct``, whose
epilogue is the correction: three launches per projection.

In 3D both take the reference's generic torch route (gerris_tpu/solvers/
projection.py:24-58, :164-167, :201-209, :247-280, :333-343): the
divergence / dt with its mean subtracted, the solve, face gradients on
the pressure padded with corners=False, u_f -= dt grad_f p, cell
gradients as the mean of the two face gradients, and the cells' -dt g
correction.
"""
from __future__ import annotations

from ..core.grid import Grid
from ..core import bc as bcs
from ..ops.cuda import bcg, projops
from ..ops.stencils import divergence, face_average, face_gradient
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
    the device and is subtracted inside the solver's first kernel, except
    on the fold route, which drops it as the reference does."""
    if grid.dim == 3:
        return _mac_projection_3d(u_face, p, grid, p_bc, dt, params, cells)
    if (div_pre is None and bcg.applicable(grid)
            and poisson.fold_div_eligible(p, grid, p_bc, params)):
        # the fold route (reference projection.py:135-155): the divergence
        # is formed inside K16, and with fold_correct the correction runs
        # inside K17
        if params.fold_correct:
            out = poisson.solve_fused_div_correct(
                p, u_face[0], u_face[1], grid, p_bc, params, dt, cells)
            cells = None if cells is None else [out[6], out[7]]
            return [out[0], out[1]], out[2], [out[3], out[4]], out[5], cells
        p, stats = poisson.solve_fused_div(p, u_face[0], u_face[1], grid,
                                           p_bc, params, dt)
    else:
        if div_pre is None:
            div_pre = projops.divergence_mac(u_face[0], u_face[1], dt,
                                             grid.h)
        div, total = div_pre
        rhs_sub = None
        if not any(b.kind == bcs.DIRICHLET for ax in p_bc.sides
                   for b in ax):
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
    projection's divergence), else None (always in 3D)."""
    if grid.dim == 3:
        src = u_cell if gp is None else [u_cell[c] + dtv * gp[c]
                                         for c in range(3)]
        faces = [bcs.apply_face_bc(face_average(bcs.apply_bc(
            src[c], grid, u_bcs[c], 1, corners=False), grid, c), grid,
            u_bcs[c], c) for c in range(3)]
        return faces, src, None
    kernel = bcg.applicable(grid) and bcg.face_specs(u_bcs) is not None
    interp = projops.interp_faces if kernel else projops.interp_faces_plain
    out = interp(u_cell[0], u_cell[1], grid, u_bcs, gp, dtv, div_scale)
    divp = None if div_scale is None else (out[4], out[5])
    return [out[0], out[1]], [out[2], out[3]], divp


def _mac_projection_3d(u_face, p, grid, p_bc, dt, params, cells):
    div = divergence(u_face, grid) / dt
    if not any(b.kind == bcs.DIRICHLET for ax in p_bc.sides for b in ax):
        div = div - div.mean()
    p, stats = poisson.solve(p, div, grid, p_bc, params)
    p_pad = bcs.apply_bc(p, grid, p_bc, 1, corners=False)
    gf = [face_gradient(p_pad, grid, a) for a in range(3)]
    u_face = [u_face[c] - dt * gf[c] for c in range(3)]
    # a cell's gradient: the mean of its two face gradients
    n = grid.shape
    g_cell = [0.5 * (f.narrow(a, 0, n[a]) + f.narrow(a, 1, n[a]))
              for a, f in enumerate(gf)]
    if cells is not None:
        cells = [cells[c] - dt * g_cell[c] for c in range(3)]
    return u_face, p, g_cell, stats, cells
