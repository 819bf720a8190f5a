"""MAC and approximate projections (port of gerris_tpu/solvers/projection.py).

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

With a divergence source or an embedded solid's face fractions a MAC
projection takes the generic route (projection.py:169-212, :247-276;
_mac_projection_generic): the s-weighted divergence in torch, the solve
with coefficients s alpha (K15 in 2D), the mean weighted by the fluid
volume, and closed faces left uncorrected.

In 3D both take the reference's generic torch route (gerris_tpu/solvers/
projection.py:24-58, :164-167, :201-209, :247-280, :333-343): the
divergence / dt with its mean subtracted, the solve, face gradients on
the pressure padded with corners=False, u_f -= dt grad_f p, cell
gradients as the mean of the two face gradients, and the cells' -dt g
correction.
"""
from __future__ import annotations

import torch

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


def _mac_projection_generic(u_face, p, grid, p_bc, dt, params, alpha,
                            face_sources, cells, t, div_source=None,
                            face_frac=None, vol_frac=None):
    """mac_projection on the reference's generic route (projection.py:
    93-280), taken in 3D and with face coefficients, face sources, a
    divergence source or an embedded solid: u_f += dt dp, the divergence
    (K4 in 2D without a solid) plus ``div_source``, and with no Dirichlet
    side its mean removed (K4's total as rhs_sub where nothing was added
    to it), the solve, then alpha grad_f p, u_f -= dt alpha grad_f p, the
    net gradient alpha grad_f p - dp averaged to the cells, and the cells
    corrected by -dt g_cell.

    With the face fractions ``face_frac`` of a solid (projection.py:169-
    212, :247-276) the divergence is that of s u_f (torch), the solve's
    coefficients s alpha, and a cell with no open face keeps rhs 0 (no
    pressure unknown there); the mean removed is weighted by the fluid
    volume ``vol_frac`` of the cells with an open face; the face
    gradients are zero on closed faces, and with face sources a cell's
    net gradient is the s-weighted mean over its open faces."""
    if face_sources is not None:
        u_face = [u_face[c] + dt * face_sources[c] for c in range(grid.dim)]
    total = rhs_sub = None
    alpha_solve = alpha
    if face_frac is not None:
        div = divergence([face_frac[c] * u_face[c] for c in range(grid.dim)],
                         grid) / dt
        alpha_solve = tuple(face_frac[c] * (1.0 if alpha is None else alpha[c])
                            for c in range(grid.dim))
    elif grid.dim == 2:
        div, total = projops.divergence_mac(u_face[0], u_face[1], dt, grid.h)
    else:
        div = divergence(u_face, grid) / dt
    if div_source is not None:
        # the mean removed below is that of div + div_source, as on the
        # reference's generic route (its CPU route); its K4 route on a TPU
        # subtracts K4's total alone (tests/test_torch_div_source.py)
        div, total = div + div_source, None
    if face_frac is not None:
        conn = sum(f.narrow(c, 0, f.shape[c] - 1)
                   + f.narrow(c, 1, f.shape[c] - 1)
                   for c, f in enumerate(face_frac)) > 1e-9
        div = torch.where(conn, div, 0.0)
        if vol_frac is not None:
            vol_frac = torch.where(conn, vol_frac, 0.0)
    if not any(b.kind == bcs.DIRICHLET for ax in p_bc.sides for b in ax):
        if vol_frac is not None:
            div = div - vol_frac * (div.sum() / torch.clamp(vol_frac.sum(),
                                                            min=1e-30))
        elif total is not None:
            rhs_sub = total / div.numel()
        else:
            div = div - div.mean()
    p, stats = poisson.solve(p, div, grid, p_bc, params, rhs_sub=rhs_sub,
                             t=t, alpha=alpha_solve)
    gf = face_gradients(p, grid, p_bc, alpha, t)
    if face_frac is not None:
        gf = [torch.where(face_frac[c] > 0.0, gf[c], 0.0)
              for c in range(grid.dim)]
    u_face = [u_face[c] - dt * gf[c] for c in range(grid.dim)]
    if face_sources is not None:
        gf = [gf[c] - face_sources[c] for c in range(grid.dim)]
    if face_frac is not None and face_sources is not None:
        g_cell = []
        for c, (f, w) in enumerate(zip(gf, face_frac)):
            n = f.shape[c]
            wf = w * f
            num = wf.narrow(c, 0, n - 1) + wf.narrow(c, 1, n - 1)
            den = w.narrow(c, 0, n - 1) + w.narrow(c, 1, n - 1)
            g_cell.append(num / torch.clamp(den, min=1e-30))
    else:
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
    face accelerations dp (surface tension); ``div_source``: a cell
    divergence added to the rhs; ``face_frac`` and ``vol_frac``: an
    embedded solid's face and cell fractions; see
    _mac_projection_generic."""
    variable = alpha is not None or face_sources is not None \
        or div_source is not None or face_frac is not None
    if variable and div_pre is not None:
        raise ValueError("mac_projection: a producer divergence with alpha, "
                         "face sources, a divergence source or a solid (the "
                         "reference folds none there)")
    if grid.dim == 3 or variable:
        return _mac_projection_generic(u_face, p, grid, p_bc, dt, params,
                                       alpha, face_sources, cells, t,
                                       div_source, face_frac, vol_frac)
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
