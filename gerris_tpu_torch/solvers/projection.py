"""MAC and approximate projections (port of gerris_tpu/solvers/projection.py;
no embedded solids).

The MAC projection makes the face-normal velocity exactly
divergence-free: solve div(alpha grad p) = div(u_f)/dt, then u_f -= dt
alpha grad_f p.  The cell-centred gradient is the mean of a cell's two
face gradients.  ``alpha`` (1/rho per face, the two-phase projections)
and ``face_sources`` (the well-balanced tension dp per face: u_f += dt dp
before the solve, and the net gradient alpha grad p - dp after it) take
the reference's generic correction (projection.py:248-280): K4 still
forms the divergence (:156-163), the solve runs K15, and the face
gradients, the correction and the cell gradient are torch, as the TPU
runs them in jnp (K5 takes neither, :218-219).
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


def face_gradients(p, grid: Grid, p_bc: bcs.FieldBC, alpha=None,
                   t: float = 0.0) -> list:
    """alpha_face * grad_face p for every face, per axis, on p padded with
    corners=False (reference projection.py:24-42), callable BC values at
    time ``t``."""
    p_pad = bcs.apply_bc(p, grid, p_bc, 1, corners=False, t=t)
    out = []
    for axis in range(grid.dim):
        g = face_gradient(p_pad, grid, axis)
        out.append(g if alpha is None else g * alpha[axis])
    return out


def cell_gradient_from_faces(gf: list) -> list:
    """The mean of each cell's two face values, per axis (reference
    projection.py:45-58)."""
    return [0.5 * (f.narrow(a, 0, f.shape[a] - 1)
                   + f.narrow(a, 1, f.shape[a] - 1))
            for a, f in enumerate(gf)]


def _refuse_slice4(div_source, face_frac, vol_frac):
    if div_source is not None or face_frac is not None \
            or vol_frac is not None:
        raise NotImplementedError("div_source, face_frac and vol_frac "
                                  "(embedded solids) are slice 4 "
                                  "(ROADMAP Queue 1)")


def _mac_projection_generic(u_face, p, grid, p_bc, dt, params, alpha,
                            face_sources, cells, t):
    """mac_projection on the reference's generic route (projection.py:
    93-280), taken in 3D and with face coefficients and/or face sources:
    u_f += dt dp, the divergence (K4 in 2D) and its mean as rhs_sub (no
    Dirichlet side), the solve, then alpha grad_f p, u_f -= dt alpha
    grad_f p, the net gradient alpha grad_f p - dp averaged to the cells,
    and the cells corrected by -dt g_cell."""
    if face_sources is not None:
        u_face = [u_face[c] + dt * face_sources[c] for c in range(grid.dim)]
    rhs_sub = None
    pure = not any(b.kind == bcs.DIRICHLET for ax in p_bc.sides for b in ax)
    if grid.dim == 2:
        div, total = projops.divergence_mac(u_face[0], u_face[1], dt, grid.h)
        if pure:
            rhs_sub = total / div.numel()
    else:
        div = divergence(u_face, grid) / dt
        if pure:
            div = div - div.mean()
    p, stats = poisson.solve(p, div, grid, p_bc, params, rhs_sub=rhs_sub,
                             t=t, alpha=alpha)
    gf = face_gradients(p, grid, p_bc, alpha, t)
    u_face = [u_face[c] - dt * gf[c] for c in range(grid.dim)]
    if face_sources is not None:
        gf = [gf[c] - face_sources[c] for c in range(grid.dim)]
    g_cell = cell_gradient_from_faces(gf)
    if cells is not None:
        cells = [cells[c] - dt * g_cell[c] for c in range(grid.dim)]
    return u_face, p, g_cell, stats, cells


def mac_projection(u_face: list, p, grid: Grid, p_bc: bcs.FieldBC, dt,
                   params: poisson.MultilevelParams, cells=None,
                   div_pre=None, alpha=None, face_sources=None,
                   div_source=None, face_frac=None, vol_frac=None,
                   t: float = 0.0):
    """Project the MAC field.  Returns (u_face', p, g_cell, stats,
    cells'): with ``cells`` (centred velocities) cells' are those cells
    corrected by -dt g_cell, else None.  ``div_pre``: the (div, total)
    that the producer of ``u_face`` already emitted (K6/K9 with
    div_scale), so no divergence launch runs here.  For a pressure BC
    without Dirichlet sides the compatibility mean total / ncells stays on
    the device and is subtracted inside the solver's first kernel, except
    on the fold route, which drops it as the reference does.
    ``alpha``: per-axis face coefficients 1/rho; ``face_sources``: per-axis
    face accelerations dp (surface tension), see
    _mac_projection_generic.  ``div_source``, ``face_frac`` and
    ``vol_frac`` (embedded solids) are slice 4 and raise."""
    _refuse_slice4(div_source, face_frac, vol_frac)
    variable = alpha is not None or face_sources is not None
    if variable and div_pre is not None:
        raise ValueError("mac_projection: a producer divergence with alpha "
                         "or face sources (the reference folds none there)")
    if grid.dim == 3 or variable:
        return _mac_projection_generic(u_face, p, grid, p_bc, dt, params,
                                       alpha, face_sources, cells, t)
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
        p, stats = poisson.solve(p, div, grid, p_bc, params, rhs_sub=rhs_sub,
                                 t=t)
    if bcg.applicable(grid) and bcg.kernel_spec(p_bc) is not None:
        out = projops.correct_project(p, u_face[0], u_face[1], dt, grid,
                                      p_bc, cells)
    else:
        out = projops.correct_project_plain(p, u_face[0], u_face[1], dt,
                                            grid, p_bc, cells, t=t)
    cells = None if cells is None else [out[4], out[5]]
    return [out[0], out[1]], p, [out[2], out[3]], stats, cells


def face_interpolated_velocity(u_cell: list, grid: Grid, u_bcs: list,
                               gp=None, dtv=None, div_scale=None,
                               t: float = 0.0):
    """MAC velocities as the mean of the two adjacent centred values, with
    the Dirichlet value on boundary faces (reference: src/advection.c:
    546-566).  Returns (faces, cells, divp).  ``gp``/``dtv``: per-component
    cell gradients first folded into the cells (u += dtv gp, the gc
    re-add, src/simulation.c:520), and ``cells`` are the updated cells
    (else the given ones).  ``div_scale``: ``divp`` is the faces'
    divergence scaled by div_scale and its sum (K9's fold of the
    projection's divergence), else None (always in 3D).  Callable BC
    values (which K9 does not take) are evaluated at time ``t``."""
    if grid.dim == 3:
        src = u_cell if gp is None else [u_cell[c] + dtv * gp[c]
                                         for c in range(3)]
        faces = [bcs.apply_face_bc(face_average(bcs.apply_bc(
            src[c], grid, u_bcs[c], 1, corners=False, t=t), grid, c), grid,
            u_bcs[c], c, t=t) for c in range(3)]
        return faces, src, None
    if bcg.applicable(grid) and bcg.face_specs(u_bcs) is not None:
        out = projops.interp_faces(u_cell[0], u_cell[1], grid, u_bcs, gp,
                                   dtv, div_scale)
    else:
        out = projops.interp_faces_plain(u_cell[0], u_cell[1], grid, u_bcs,
                                         gp, dtv, div_scale, t=t)
    divp = None if div_scale is None else (out[4], out[5])
    return [out[0], out[1]], [out[2], out[3]], divp
