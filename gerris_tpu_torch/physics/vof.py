"""Volume-of-fluid interface tracking with PLIC reconstruction, 2D
(port of gerris_tpu/physics/vof.py: the line geometry, the MYC normals,
the direction-split geometric advection, the height-function curvature
with its parabola-fit fallback, and the fraction of a level set).

Whole-array torch with ``where`` ladders, as the reference writes it in
jnp; none of it runs a TPU kernel, so none of it is a kernel here.
Conventions (the reference's):
* f = 1 in the fluid phase, 0 outside;
* the PLIC normal m points OUT of the fluid; the fluid region of the unit
  cell is {x : m.x <= alpha} with |mx| + |my| = 1;
* kappa > 0 for a convex fluid body, the divergence of the outward
  normal.
3D VOF, contact angles and concentrations are slice 3b and raise.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core import bc as bcs
from ..core.device import default_device
from ..core.grid import Grid

EPS = 1e-30
FULL_TOL = 1e-10   # reference: f_over_dV clamping, src/vof.c:1616


def _check_2d(grid: Grid):
    if grid.dim != 2:
        raise NotImplementedError("3D VOF (curvature_3d, the plane "
                                  "geometry) is slice 3b (ROADMAP Queue 1)")


# ---------------------------------------------------------------------------
# PLIC line geometry (reference src/vof.c:40-230, gerris_tpu vof.py:41-102)
# ---------------------------------------------------------------------------

def line_area_positive(m1, m2, alpha):
    """Fraction of the unit square below m1 x + m2 y = alpha, for
    m1, m2 >= 0, m1 + m2 = 1 (gfs_line_area src/vof.c:40)."""
    a = torch.clamp(alpha, 0.0, 1.0)
    m1s = torch.clamp(m1, min=EPS)
    m2s = torch.clamp(m2, min=EPS)
    v = (a * a
         - torch.clamp(a - m1, min=0.0) ** 2
         - torch.clamp(a - m2, min=0.0) ** 2) / (2.0 * m1s * m2s)
    # degenerate (one-component) normals
    v = torch.where(m1 < EPS, torch.clamp(a / m2s, 0.0, 1.0), v)
    v = torch.where(m2 < EPS, torch.clamp(a / m1s, 0.0, 1.0), v)
    return torch.clamp(v, 0.0, 1.0)


def line_alpha_positive(m1, m2, c):
    """Inverse of line_area_positive: alpha such that the fraction is c
    (gfs_line_alpha src/vof.c:93)."""
    c = torch.clamp(c, 0.0, 1.0)
    mlo = torch.clamp(torch.minimum(m1, m2), min=0.0)
    mhi = torch.clamp(torch.maximum(m1, m2), min=EPS)
    cm = torch.minimum(c, 1.0 - c)        # mirror c > 1/2
    c1 = mlo / (2.0 * mhi)                # triangle regime threshold
    alpha_tri = torch.sqrt(torch.clamp(2.0 * cm * mlo * mhi, min=0.0))
    alpha_band = cm * mhi + mlo / 2.0
    a = torch.where(cm <= c1, alpha_tri, alpha_band)
    a = torch.where(c > 0.5, 1.0 - a, a)
    # exact full/empty
    return torch.where(c <= 0.0, 0.0, torch.where(c >= 1.0, 1.0, a))


def rectangle_fraction(m1, m2, alpha, x0, x1, y0, y1):
    """Fluid fraction of the sub-rectangle [x0,x1]x[y0,y1] of the unit cell
    cut by {m.x <= alpha}, m positive (gfs_rectangle_fraction)."""
    dx = torch.clamp(torch.as_tensor(x1 - x0), min=EPS)
    dy = torch.clamp(torch.as_tensor(y1 - y0), min=EPS)
    a = alpha - m1 * x0 - m2 * y0
    n1 = m1 * dx
    n2 = m2 * dy
    norm = torch.clamp(n1 + n2, min=EPS)
    return line_area_positive(n1 / norm, n2 / norm, a / norm)


def positive_normal(mx, my, alpha):
    """(m, alpha) of the fluid {m.x <= alpha} reflected onto positive m:
    (|mx|, |my|, alpha')."""
    a = alpha + torch.where(mx < 0.0, -mx, 0.0) \
        + torch.where(my < 0.0, -my, 0.0)
    return torch.abs(mx), torch.abs(my), a


# ---------------------------------------------------------------------------
# Interface normals: MYC (mixed Youngs-centred; gerris_tpu vof.py:292-346)
# ---------------------------------------------------------------------------

def mycs_normals(f_pad):
    """Per-cell interface normal, |mx|+|my| = 1, pointing OUT of the fluid,
    of a field padded by 1 on both axes; the output has the interior
    shape (Aulisa et al.'s MYC scheme, src/myc2d.h:6-66)."""
    n0, n1 = f_pad.shape

    def sh(i, j):
        return f_pad[i:n0 - 2 + i, j:n1 - 2 + j]

    c = {(i - 1, j - 1): sh(i, j) for i in range(3) for j in range(3)}
    c_t = c[-1, 1] + c[0, 1] + c[1, 1]
    c_b = c[-1, -1] + c[0, -1] + c[1, -1]
    c_r = c[1, -1] + c[1, 0] + c[1, 1]
    c_l = c[-1, -1] + c[-1, 0] + c[-1, 1]

    mx0 = 0.5 * (c_l - c_r)
    my0 = 0.5 * (c_b - c_t)
    use_y = torch.abs(mx0) <= torch.abs(my0)   # mostly horizontal
    mx0c = torch.where(use_y, mx0, torch.sign(mx0) + (mx0 == 0.0))
    my0c = torch.where(use_y, torch.sign(my0) + (my0 == 0.0), my0)

    # Youngs normal
    mx1 = (c[-1, -1] + 2.0 * c[-1, 0] + c[-1, 1]) - \
          (c[1, -1] + 2.0 * c[1, 0] + c[1, 1])
    my1 = (c[-1, -1] + 2.0 * c[0, -1] + c[1, -1]) - \
          (c[-1, 1] + 2.0 * c[0, 1] + c[1, 1])

    # Youngs where its slope estimate beats the central one
    slope_c = torch.where(use_y, torch.abs(mx0), torch.abs(my0))
    slope_y = torch.where(use_y,
                          torch.abs(mx1) / (torch.abs(my1) + EPS),
                          torch.abs(my1) / (torch.abs(mx1) + EPS))
    take_youngs = slope_y > slope_c
    mx = torch.where(take_youngs, mx1, mx0c)
    my = torch.where(take_youngs, my1, my0c)
    norm = torch.abs(mx) + torch.abs(my) + EPS
    return mx / norm, my / norm


def reconstruct_alpha(f, mx, my):
    """Per-cell alpha of the PLIC line {m.x <= alpha} holding fraction f
    (positive frame, mapped back to the signed one; src/vof.c:962)."""
    a_pos = line_alpha_positive(torch.abs(mx), torch.abs(my), f)
    return a_pos - torch.where(mx < 0.0, -mx, 0.0) \
        - torch.where(my < 0.0, -my, 0.0)


def is_full(f):
    return (f <= FULL_TOL) | (f >= 1.0 - FULL_TOL)


def has_contact(fbc: bcs.FieldBC) -> bool:
    """True if a side carries a contact angle.  Contact angles are slice
    3b: the port's BCs refuse the kind (core/bc.BC), and a side that
    names it raises here."""
    if any(b.kind == "contact" for pair in fbc.sides for b in pair):
        raise NotImplementedError("contact angles are slice 3b "
                                  "(ROADMAP Queue 1)")
    return False


def normals(f, grid: Grid, fbc: bcs.FieldBC):
    """MYC normals of f padded with its BCs (gerris_tpu vof.py:425-433)."""
    _check_2d(grid)
    has_contact(fbc)
    return mycs_normals(bcs.apply_bc(f, grid, fbc, 1))


# ---------------------------------------------------------------------------
# Direction-split geometric advection (gerris_tpu vof.py:351-424, :473-607)
# ---------------------------------------------------------------------------

def _band_fraction(donor_f, m1, m2, ap, neg_axis_m, neg_trans_m, uni,
                   axis, b0, b1):
    """Fluid fraction of the upwind slab of width |uni| restricted to the
    transverse band [b0, b1] of the donor cell (positive frame; the slab
    and band are reflected for the original normal's signs)."""
    cfl = torch.abs(uni)
    s0 = torch.where(uni > 0.0, 1.0 - cfl, 0.0)
    s1 = torch.where(uni > 0.0, 1.0, cfl)
    r0 = torch.where(neg_axis_m, 1.0 - s1, s0)
    r1 = torch.where(neg_axis_m, 1.0 - s0, s1)
    t0 = torch.where(neg_trans_m, 1.0 - b1, b0)
    t1 = torch.where(neg_trans_m, 1.0 - b0, b1)
    if axis == 0:
        frac = rectangle_fraction(m1, m2, ap, r0, r1, t0, t1)
    else:
        frac = rectangle_fraction(m1, m2, ap, t0, t1, r0, r1)
    return torch.where(is_full(donor_f), torch.clamp(donor_f, 0.0, 1.0),
                       frac)


def _face_flux_1d(f_pad, mx_pad, my_pad, un, axis, dun=None, bands=4):
    """Geometric fluid flux (fraction * CFL) through each face of ``axis``
    from the 1-ghost padded fraction and normals; ``un`` = u_face dt / h,
    ``dun`` the transverse velocity increment of the band refinement at
    interfacial faces (vof_flux src/vof.c:1476-1577: 4 bands with
    linearly interpolated velocities there, one band elsewhere)."""
    n = f_pad.shape[axis]

    def cr(a):
        idx = [slice(1, s - 1) for s in a.shape]
        idx[axis] = slice(None)
        return a[tuple(idx)]

    def lo(a):
        return cr(a).narrow(axis, 0, n - 1)

    def hi(a):
        return cr(a).narrow(axis, 1, n - 1)

    fL, fR = lo(f_pad), hi(f_pad)
    mxL, mxR = lo(mx_pad), hi(mx_pad)
    myL, myR = lo(my_pad), hi(my_pad)

    def donor_quantities(upos):
        donor_f = torch.where(upos, fL, fR)
        donor_mx = torch.where(upos, mxL, mxR)
        donor_my = torch.where(upos, myL, myR)
        a = reconstruct_alpha(donor_f, donor_mx, donor_my)
        m1, m2, ap = positive_normal(donor_mx, donor_my, a)
        neg_ax = (donor_mx if axis == 0 else donor_my) < 0.0
        neg_tr = (donor_my if axis == 0 else donor_mx) < 0.0
        return donor_f, m1, m2, ap, neg_ax, neg_tr

    flux = _band_fraction(*donor_quantities(un > 0.0), un, axis, 0.0,
                          1.0) * un
    if dun is None or bands <= 1:
        return flux
    # banded flux at interfacial faces: band velocity uni = un +
    # (1 - n + 2j) dun / (2n) (vof.c:1509-1530)
    flux_b = 0.0
    for j in range(bands):
        uni = un + (1 - bands + 2 * j) * dun / (2.0 * bands)
        fracj = _band_fraction(*donor_quantities(uni > 0.0), uni, axis,
                               j / bands, (j + 1) / bands)
        flux_b = flux_b + fracj * uni / bands
    interfacial = ~(is_full(fL) & is_full(fR))
    return torch.where(interfacial, flux_b, flux)


def sweep_flux(f, u_face: list, grid: Grid, fbc: bcs.FieldBC, c: int, dt):
    """(geometric flux, face CFL) of one direction-split sweep along ``c``
    (gerris_tpu vof.py:530-583): MYC normals on the 2-ghost padding, the
    band refinement's transverse velocity increment from the cell means
    of u_face[c] (grad_u src/vof.c:1595, dun :1491)."""
    _check_2d(grid)
    has_contact(fbc)
    f_pad = bcs.apply_bc(f, grid, fbc, 1)
    pad2 = bcs.apply_bc(f, grid, fbc, 2)
    un = u_face[c] * dt / grid.h
    mx, my = mycs_normals(pad2)     # on the +1 ring layout
    o = 1 - c
    uf = u_face[c]
    nfc = uf.shape[c]
    ucm = 0.5 * (uf.narrow(c, 0, nfc - 1) + uf.narrow(c, 1, nfc - 1))
    ue = bcs.edge_extend(bcs.edge_extend(ucm, 0, 1), 1, 1)
    inner = ue.narrow(c, 1, ue.shape[c] - 2)
    du_cell = (inner.narrow(o, 2, ue.shape[o] - 2)
               - inner.narrow(o, 0, ue.shape[o] - 2)) / (2.0 * grid.h)
    dup = bcs.edge_extend(du_cell, c, 1)
    nf2 = dup.shape[c]
    dun = 0.5 * (dup.narrow(c, 0, nf2 - 1) + dup.narrow(c, 1, nf2 - 1)) * dt
    return _face_flux_1d(f_pad, mx, my, un, c, dun=dun), un


def sweep_update(f, dV, flux, un, c: int):
    """One sweep's flux divergence with the dilation bookkeeping
    (f_times_dV / f_over_dV, src/vof.c:1577-1640).  Returns (f, dV)."""
    n = flux.shape[c]
    fv = -(flux.narrow(c, 1, n - 1) - flux.narrow(c, 0, n - 1))
    volflux = -(un.narrow(c, 1, n - 1) - un.narrow(c, 0, n - 1))
    f = f * dV + fv
    dV = dV + volflux
    f = f / torch.clamp(dV, min=EPS)
    f = torch.where(f < FULL_TOL, 0.0,
                    torch.where(f > 1.0 - FULL_TOL, 1.0, f))
    return f, dV


def advect(f, u_face: list, grid: Grid, fbc: bcs.FieldBC, dt,
           cstart: int = 0, concentrations=None):
    """One VOF advection step: direction-split sweeps starting at
    component ``cstart`` (rotated by the caller each step, src/vof.c:1648,
    1721), the dilation field carried across the sweeps (gerris_tpu
    vof.py:473-528).  Needs a per-sweep CFL u dt / h <= 0.5.
    Concentrations are slice 3b and raise."""
    if concentrations is not None:
        raise NotImplementedError("VOF concentrations are slice 3b "
                                  "(ROADMAP Queue 1)")
    dV = torch.ones_like(f)
    for k in range(grid.dim):
        c = (cstart + k) % grid.dim
        flux, un = sweep_flux(f, u_face, grid, fbc, c, dt)
        f, dV = sweep_update(f, dV, flux, un, c)
    return f


# ---------------------------------------------------------------------------
# Height-function curvature (gerris_tpu vof.py:610-733, :968-1112)
# ---------------------------------------------------------------------------

def curvature(f, grid: Grid, fbc: bcs.FieldBC, off_max: int = 2):
    """Interface curvature on interface cells (NaN elsewhere), 2D.

    Height functions: 7-cell column sums of f along each axis with
    recentred windows (offsets 0, -1, +1, ..., +-o_max, nearest first;
    curvature_along_direction_new src/vof.c:2732), kappa = -H'' / (1 +
    H'^2)^(3/2) / h; a window counts where all three columns straddle
    the interface and the slope is mild.  The dominant normal's estimate
    wins; cells with none take the parabola fit (src/vof.c:2201-2493).
    The padding is the reference's: P = R + o_max + 1 ghosts with
    corners, axis 0 then axis 1 (apply_bc's default order); the normals
    come from a 1-ghost padding, whose corner ghosts differ from the
    wide pad's (gerris_tpu vof.py:646-650)."""
    _check_2d(grid)
    has_contact(fbc)
    R = 3  # column half-height
    o_max = min(off_max, max(0, (min(grid.shape) - 2 * R) // 2))
    OFF = (0,) + sum(((-o, o) for o in range(1, o_max + 1)), ())
    P = R + o_max + 1
    f_pad = bcs.apply_bc(f, grid, fbc, P)
    n0, n1 = grid.shape

    def sub(di, dj):
        return f_pad[P + di:P + di + n0, P + dj:P + dj + n1]

    mx, my = mycs_normals(bcs.apply_bc(f, grid, fbc, 1))
    interface = (f > FULL_TOL) & (f < 1.0 - FULL_TOL)
    nan = torch.full_like(f, math.nan)

    kappas, valids = [], []
    for d in range(2):
        kap_d = nan
        val_d = torch.zeros_like(f, dtype=torch.bool)
        for o in OFF:
            if d == 1:
                def col(dtrans):
                    return sum(sub(dtrans, k)
                               for k in range(o - R, o + R + 1))
                top, bot = sub(0, o + R), sub(0, o - R)
            else:
                def col(dtrans):
                    return sum(sub(k, dtrans)
                               for k in range(o - R, o + R + 1))
                top, bot = sub(o + R, 0), sub(o - R, 0)
            Hm, H0, Hp = col(-1), col(0), col(1)
            Hx = 0.5 * (Hp - Hm)
            Hxx = Hp - 2.0 * H0 + Hm
            kap = -Hxx / grid.h / torch.pow(1.0 + Hx * Hx, 1.5)
            ends_ok = is_full(top) & is_full(bot) \
                & (torch.abs(top - bot) > 0.5)
            sane = (H0 > 0.0) & (H0 < 2.0 * R + 1.0) \
                & (torch.abs(Hx) <= 1.0)
            val = ends_ok & sane
            take = val & ~val_d
            kap_d = torch.where(take, kap, kap_d)
            val_d = val_d | val
        kappas.append(kap_d)
        valids.append(val_d)

    use_y = torch.abs(my) >= torch.abs(mx)   # mostly horizontal
    kap = torch.where(use_y & valids[1], kappas[1],
                      torch.where(valids[0], kappas[0],
                                  torch.where(valids[1], kappas[1], nan)))
    kap_fit = parabola_curvature(f, grid, fbc, mx, my)
    kap = torch.where(torch.isfinite(kap), kap, kap_fit)
    return torch.where(interface, kap, nan)


def interface_point(f, mx, my):
    """A point on each cell's PLIC line in cell-local coordinates centred
    at the cell centre: the centre's projection onto the line."""
    a = reconstruct_alpha(f, mx, my)
    d = a - 0.5 * (mx + my)
    m2 = mx * mx + my * my + EPS
    return mx * d / m2, my * d / m2


def _det3(M):
    return (M[0][0] * (M[1][1] * M[2][2] - M[1][2] * M[2][1])
            - M[0][1] * (M[1][0] * M[2][2] - M[1][2] * M[2][0])
            + M[0][2] * (M[1][0] * M[2][1] - M[1][1] * M[2][0]))


def parabola_curvature(f, grid: Grid, fbc: bcs.FieldBC, mx, my):
    """Least-squares parabola eta = a0 + a1 xi + a2 xi^2 through the
    interface points of the 5x5 stencil in the centre cell's normal frame;
    kappa = -2 a2 / (1 + a1^2)^(3/2) / h where at least 4 points and a
    regular system (ParabolaFit src/vof.c:2201-2493)."""
    _check_2d(grid)
    has_contact(fbc)
    W = 2
    f_all = bcs.apply_bc(f, grid, fbc, W)
    mcx, mcy = mycs_normals(bcs.apply_bc(f, grid, fbc, W + 1))
    n0, n1 = grid.shape

    def sub(a, di, dj):
        return a[W + di:W + di + n0, W + dj:W + dj + n1]

    px_all, py_all = interface_point(f_all, mcx, mcy)
    ifc_all = ((f_all > FULL_TOL) & (f_all < 1.0 - FULL_TOL)).to(f.dtype)

    mag = torch.sqrt(mx * mx + my * my) + EPS
    nx, ny = mx / mag, my / mag
    tx, ty = -ny, nx
    pcx, pcy = interface_point(f, mx, my)

    S = {k: 0.0 for k in ("w", "x", "x2", "x3", "x4", "y", "xy", "x2y")}
    for di in range(-W, W + 1):
        for dj in range(-W, W + 1):
            qx = sub(px_all, di, dj) + di
            qy = sub(py_all, di, dj) + dj
            wgt = sub(ifc_all, di, dj)
            rx = qx - pcx
            ry = qy - pcy
            xi = rx * tx + ry * ty
            eta = rx * nx + ry * ny
            S["w"] += wgt
            S["x"] += wgt * xi
            S["x2"] += wgt * xi * xi
            xi2 = xi * xi
            # jnp's integer powers: x * (x * x) and (x * x) * (x * x)
            S["x3"] += wgt * (xi * xi2)
            S["x4"] += wgt * (xi2 * xi2)
            S["y"] += wgt * eta
            S["xy"] += wgt * xi * eta
            S["x2y"] += wgt * xi * xi * eta
    A = [[S["w"], S["x"], S["x2"]],
         [S["x"], S["x2"], S["x3"]],
         [S["x2"], S["x3"], S["x4"]]]
    b = [S["y"], S["xy"], S["x2y"]]
    D = _det3(A)
    Dsafe = torch.where(torch.abs(D) < 1e-12, 1.0, D)
    a1 = _det3([[A[0][0], b[0], A[0][2]],
                [A[1][0], b[1], A[1][2]],
                [A[2][0], b[2], A[2][2]]]) / Dsafe
    a2 = _det3([[A[0][0], A[0][1], b[0]],
                [A[1][0], A[1][1], b[1]],
                [A[2][0], A[2][1], b[2]]]) / Dsafe
    kap = -2.0 * a2 / grid.h / torch.pow(1.0 + a1 * a1, 1.5)
    ok = (S["w"] >= 4.0) & (torch.abs(D) >= 1e-12)
    return torch.where(ok, kap, math.nan)


def fill_curvature(kap, interface_band=None, niter: int = 4):
    """Extend the defined curvature to neighbouring cells by averaging the
    defined neighbours, ``niter`` times (gerris_tpu vof.py:1085-1112, in
    place of the reference's interpolation, src/tension.c:390-760)."""
    dim = kap.dim()
    pad = (1, 1) * dim
    for _ in range(niter):
        ok = torch.isfinite(kap)
        pad_k = F.pad(torch.where(ok, kap, 0.0), pad)
        pad_ok = F.pad(ok.to(kap.dtype), pad)
        s = w = 0.0
        for ax in range(dim):
            for off in (0, 2):
                idx = [slice(1, -1)] * dim
                idx[ax] = slice(off, pad_k.shape[ax] - 2 + off)
                s = s + pad_k[tuple(idx)]
                w = w + pad_ok[tuple(idx)]
        avg = s / torch.clamp(w, min=1.0)
        kap = torch.where(ok, kap, torch.where(w > 0, avg, math.nan))
    return kap


# ---------------------------------------------------------------------------
# Fraction initialization from an implicit function (vof.py:1113-1196)
# ---------------------------------------------------------------------------

def fraction_from_levelset(grid: Grid, phi, refine: int = 0, device=None,
                           dtype=torch.float64):
    """Volume fraction of {phi > 0}, 2D, by a per-cell linearization of
    the level set sampled at the cell vertices: exact for linear phi,
    O(h^2 kappa) for curved interfaces (the dense form of gfs_vof_init).
    ``phi(x, y)`` takes torch tensors.  ``refine``: evaluate that many
    levels finer and average back (the reference's ``RefineSurface``).
    The result is on ``device``, the CUDA card by default
    (core/device.default_device)."""
    _check_2d(grid)
    device = default_device(device)
    if refine > 0:
        gf = dataclasses.replace(grid, level=grid.level + refine)
        f = fraction_from_levelset(gf, phi, device=device, dtype=dtype)
        r = 1 << refine
        n0, n1 = f.shape[0] // r, f.shape[1] // r
        return f.reshape(n0, r, n1, r).mean(dim=(1, 3))
    X, Y = np.meshgrid(grid.axis_faces(0), grid.axis_faces(1),
                       indexing="ij")
    pv = phi(torch.as_tensor(X, dtype=dtype, device=device),
             torch.as_tensor(Y, dtype=dtype, device=device))
    p00 = pv[:-1, :-1]
    p10 = pv[1:, :-1]
    p01 = pv[:-1, 1:]
    p11 = pv[1:, 1:]
    # gradient (per cell edge units) and centre value from the vertices
    gx = 0.5 * ((p10 + p11) - (p00 + p01))
    gy = 0.5 * ((p01 + p11) - (p00 + p10))
    pc = 0.25 * (p00 + p01 + p10 + p11)
    # phi(u) ~ pc + g.(u - 1/2) on the unit cell: the fluid {phi > 0} is
    # {m.u <= alpha} with m = -g, alpha = pc + (mx + my) / 2
    mx = -gx
    my = -gy
    alpha = pc + 0.5 * (mx + my)
    norm = torch.abs(mx) + torch.abs(my) + EPS
    m1, m2, a = positive_normal(mx / norm, my / norm, alpha / norm)
    f = line_area_positive(m1, m2, a)
    allpos = (p00 > 0) & (p01 > 0) & (p10 > 0) & (p11 > 0)
    allneg = (p00 <= 0) & (p01 <= 0) & (p10 <= 0) & (p11 <= 0)
    return torch.where(allpos, 1.0,
                       torch.where(allneg, 0.0, f)).contiguous()
