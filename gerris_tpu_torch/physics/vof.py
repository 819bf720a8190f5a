"""Volume-of-fluid interface tracking with PLIC reconstruction, 2D and 3D
(port of gerris_tpu/physics/vof.py: the line and plane geometry, the MYC
normals, the direction-split geometric advection, the height-function
curvature with its parabola-fit fallback in 2D, its extensions off the
interface (fill_curvature, and the Kmax variable's f(1-f)-weighted
fill_curvature_weighted), and the fraction of a level set).

Whole-array torch with ``where`` ladders, as the reference writes it in
jnp; none of it runs a TPU kernel, so none of it is a kernel here.
Conventions (the reference's):
* f = 1 in the fluid phase, 0 outside;
* the PLIC normal m points OUT of the fluid; the fluid region of the unit
  cell is {x : m.x <= alpha} with |mx| + |my| = 1;
* kappa > 0 for a convex fluid body, the divergence of the outward
  normal.
A contact-angle side (core/bc.Contact) pads the fraction as a mirror;
``contact_fill`` then writes the ghost band of the interface extended
into the wall at the angle, which the normals, the sweep fluxes and the
curvature read, and the heights next to such a wall are shifted by
cot(theta) (gerris_tpu vof.py:734-870).  ``advect`` carries phase
concentrations with the geometric fluxes.  In 3D (gerris_tpu vof.py:
103-289, :425-470, :895-966, :1142-1170) the plane's volume is the
piecewise form of gfs_plane_volume (the reference's closed form cancels
where a component is small), its alpha the reference's 40-step
bisection; the sweeps take one band, the curvature has no parabola
fallback (the caller's fill_curvature averages the defined neighbours
into its gaps), and a contact side pads as a mirror: the reference's
contact machinery is 2D, and ``contact_fill`` and
``parabola_curvature`` raise in 3D.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core import bc as bcs
from ..core.device import default_device
from ..core.grid import Grid, vertex_coords

EPS = 1e-30
FULL_TOL = 1e-10   # reference: f_over_dV clamping, src/vof.c:1616
# the reference's saturation SLOPE_MAX = 2 HMAX / 3 (src/vof.c:3211):
# |cot(theta)| at most this, theta within [atan(1/2), pi - atan(1/2)]
_SLOPE_MAX = 2.0
# the contact machinery needs the wall band resolved: below this many
# cells per axis the ghosts stay mirrors (gerris_tpu vof.py:741-744)
_CONTACT_MIN_CELLS = 12


def _check_2d(grid: Grid, what: str):
    if grid.dim != 2:
        raise NotImplementedError(f"{what} is 2D, as the reference's is")


# ---------------------------------------------------------------------------
# PLIC line geometry (reference src/vof.c:40-230, gerris_tpu vof.py:41-102)
# ---------------------------------------------------------------------------

def line_area_positive(m1, m2, alpha):
    """Fraction of the unit square below m1 x + m2 y = alpha, for
    m1, m2 >= 0, m1 + m2 = 1 (gfs_line_area src/vof.c:40), in the
    piecewise form on ordered components lo <= hi: the triangle a^2 /
    (2 lo hi) up to lo, the band (a - lo/2) / hi up to hi, and 1 - (1 -
    a)^2 / (2 lo hi) above.  The reference's closed form (gerris_tpu
    vof.py:41-53) divides a difference of squares by 2 lo hi, which
    loses ~eps / lo where lo is small (3.9e-2 at lo = 1e-6 in float32)."""
    a = torch.clamp(alpha, 0.0, 1.0)
    m1s = torch.clamp(m1, min=EPS)
    m2s = torch.clamp(m2, min=EPS)
    lo, hi = torch.minimum(m1s, m2s), torch.maximum(m1s, m2s)
    d = 2.0 * lo * hi
    v = torch.where(a <= lo, a * a / d,
                    torch.where(a <= hi, (a - 0.5 * lo) / hi,
                                1.0 - (1.0 - a) ** 2 / d))
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
# 3D plane geometry (reference src/vof.c:288-344, gerris_tpu vof.py:103-163)
# ---------------------------------------------------------------------------

def _plane_invariants(m1, m2, m3):
    """What plane_volume_positive computes from the normal alone (hoisted
    out of the bisection): the components ordered b1 <= b2 <= b3, b1 +
    b2, min(b1 + b2, b3), the guarded products 6 b1 b2 b3 and b2 b3, the
    cubic terms' coefficients and the masks of the branches that do not
    depend on alpha.  ``small``: b1 below eps^(1/3) b2, where the
    branches that divide by b1 (alpha within b1 of b2, or of b3 when b3
    <= b1 + b2) lose more to cancellation, ~eps b2^2 / (6 b1 b3), than
    the neighbouring branch's form is off there, < b1^2 / (6 b2 b3)."""
    fi = torch.finfo(m1.dtype)
    tiny = fi.tiny
    lo, hi = torch.minimum(m1, m2), torch.maximum(m1, m2)
    b1, b3 = torch.minimum(lo, m3), torch.maximum(hi, m3)
    b2 = torch.maximum(lo, torch.minimum(hi, m3))
    b12 = b1 + b2
    d23 = torch.clamp(b2 * b3, min=tiny)
    s1, s2 = b1 * b1, b2 * b2
    return (b1, b2, b3, b12, torch.minimum(b12, b3),
            torch.clamp(6.0 * b1 * b2 * b3, min=tiny), d23,
            s1 / (6.0 * d23), s1 * b1 + s2 * b2, s1 + s2, b3 * b3,
            b1 < fi.eps ** (1.0 / 3.0) * b2, b12 < b3)


def _plane_volume(inv, alpha):
    """The piecewise volume of one alpha (plane_volume_positive)."""
    b1, b2, b3, b12, bm, pr, d23, c2, k0, k1, s3, small, thin = inv
    a = torch.clamp(alpha, 0.0, 1.0)
    a0 = torch.minimum(a, 1.0 - a)
    a02 = a0 * a0
    v2 = 0.5 * a0 * (a0 - b1) / d23 + c2
    ends = k0 - 3.0 * a0 * k1
    v3 = (a02 * (3.0 * b12 - a0) + ends) / pr
    v5 = (a02 * (3.0 - 2.0 * a0) + ends + s3 * (b3 - 3.0 * a0)) / pr
    v = torch.where(
        a0 < b1, a0 * a02 / pr,
        torch.where(a0 < b2, v2, torch.where(
            a0 < bm, torch.where(small, v2, v3),
            torch.where(thin, (a0 - 0.5 * b12) / b3,
                        torch.where(small, v2, v5)))))
    return torch.clamp(torch.where(a <= 0.5, v, 1.0 - v), 0.0, 1.0)


def plane_volume_positive(m1, m2, m3, alpha):
    """Fraction of the unit cube below m1 x + m2 y + m3 z = alpha, for
    m >= 0 with m1 + m2 + m3 = 1: the piecewise form of gfs_plane_volume
    (src/vof.c:288; Scardovelli and Zaleski, J. Comput. Phys. 164 (2000)
    228-237) on the ordered components, for alpha <= 1/2 and by symmetry
    above.  The reference's inclusion-exclusion closed form (gerris_tpu
    vof.py:103-131) divides by every component: it agrees with this to
    rounding where they are not small, and cancels where one is (a
    float32 volume of 0 for a component of order 1e-5; ROADMAP Queue
    3).  A zero component gives the 2D fraction, two the 1D one."""
    return _plane_volume(_plane_invariants(m1, m2, m3), alpha)


def plane_alpha_positive(m1, m2, m3, c, iters: int = 40):
    """Inverse of plane_volume_positive: the reference's fixed bisection
    of ``iters`` steps on [0, 1], lo moving where the volume is below c,
    no early exit (gerris_tpu vof.py:134-145; src/vof.c:344 inverts the
    piecewise form analytically)."""
    c = torch.clamp(c, 0.0, 1.0)
    inv = _plane_invariants(m1, m2, m3)
    lo = torch.zeros_like(c)
    hi = torch.ones_like(c)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = _plane_volume(inv, mid) < c
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    a = 0.5 * (lo + hi)
    return torch.where(c <= 0.0, 0.0, torch.where(c >= 1.0, 1.0, a))


def box_fraction(m1, m2, m3, alpha, b0, b1):
    """Fluid fraction of the sub-box [b0, b1] (per-axis lists of tensors)
    of the unit cube cut by {m.x <= alpha}, m positive."""
    d = [torch.clamp(b1[k] - b0[k], min=EPS) for k in range(3)]
    a = alpha - m1 * b0[0] - m2 * b0[1] - m3 * b0[2]
    n = [m1 * d[0], m2 * d[1], m3 * d[2]]
    norm = torch.clamp(n[0] + n[1] + n[2], min=EPS)
    return plane_volume_positive(n[0] / norm, n[1] / norm, n[2] / norm,
                                 a / norm)


def positive_normal_3d(mx, my, mz, alpha):
    """(m, alpha) of the fluid {m.x <= alpha} reflected onto positive m."""
    a = alpha + torch.where(mx < 0.0, -mx, 0.0) \
        + torch.where(my < 0.0, -my, 0.0) + torch.where(mz < 0.0, -mz, 0.0)
    return torch.abs(mx), torch.abs(my), torch.abs(mz), a


def _shifts_3d(f_pad):
    n0, n1, n2 = f_pad.shape

    def sh(i, j, k):
        return f_pad[i:n0 - 2 + i, j:n1 - 2 + j, k:n2 - 2 + k]
    return sh


def youngs_normals_3d(f_pad):
    """Youngs-gradient normal, |mx| + |my| + |mz| = 1, pointing out of the
    fluid, of a field padded by 1 (gfs_youngs_gradient src/vof.c:
    672-891; gerris_tpu vof.py:254-278)."""
    sh = _shifts_3d(f_pad)

    def grad(axis):
        g = 0.0
        for a in (-1, 0, 1):
            for b in (-1, 0, 1):
                wt = (2.0 if a == 0 else 1.0) * (2.0 if b == 0 else 1.0)
                hi, lo = [a + 1, b + 1], [a + 1, b + 1]
                hi.insert(axis, 2)
                lo.insert(axis, 0)
                g = g + wt * (sh(*hi) - sh(*lo))
        return g

    mx, my, mz = -grad(0), -grad(1), -grad(2)
    norm = torch.abs(mx) + torch.abs(my) + torch.abs(mz) + EPS
    return mx / norm, my / norm, mz / norm


def mycs_normals_3d(f_pad):
    """3D mixed Youngs-centred normal (|m|_1 = 1, out of the fluid) of a
    field padded by 1, as the reference re-derives it (gerris_tpu
    vof.py:165-251; src/myc.h:17-200): the dominant axis is the largest
    Youngs component (the first on ties), the centred candidate takes
    its transverse slopes from 3-cell column sums along it, and Youngs
    wins where its transverse slope is steeper."""
    sh = _shifts_3d(f_pad)
    youngs = youngs_normals_3d(f_pad)

    def colsum(d, t1, t2):
        out = 0.0
        taxes = [a for a in range(3) if a != d]
        for k in (-1, 0, 1):
            off = [0, 0, 0]
            off[d] = k
            off[taxes[0]] += t1
            off[taxes[1]] += t2
            out = out + sh(off[0] + 1, off[1] + 1, off[2] + 1)
        return out

    cands = []
    for d in range(3):
        s_t1 = s_t2 = 0.0
        for t in (-1, 0, 1):
            w = 2.0 if t == 0 else 1.0
            s_t1 = s_t1 + w * (colsum(d, -1, t) - colsum(d, 1, t))
            s_t2 = s_t2 + w * (colsum(d, t, -1) - colsum(d, t, 1))
        off_m, off_p = [1, 1, 1], [1, 1, 1]
        off_m[d], off_p[d] = 0, 2
        dd = sh(*off_m) - sh(*off_p)
        cands.append((0.5 * s_t1 / 4.0, 0.5 * s_t2 / 4.0,
                      torch.sign(dd) + (dd == 0.0).to(dd.dtype)))

    absY = [torch.abs(c) for c in youngs]
    dom = torch.argmax(torch.stack(absY), dim=0)
    out = []
    for comp in range(3):
        v = 0.0
        for d in range(3):
            mt1, mt2, md = cands[d]
            taxes = [a for a in range(3) if a != d]
            c = md if comp == d else mt1 if comp == taxes[0] else mt2
            v = torch.where(dom == d, c, v)
        out.append(v)
    slope_c = slope_y = 0.0
    for d in range(3):
        mt1, mt2, _ = cands[d]
        taxes = [a for a in range(3) if a != d]
        sc = torch.maximum(torch.abs(mt1), torch.abs(mt2))
        sy = torch.maximum(absY[taxes[0]], absY[taxes[1]]) / \
            torch.clamp(absY[d], min=EPS)
        slope_c = torch.where(dom == d, sc, slope_c)
        slope_y = torch.where(dom == d, sy, slope_y)
    take_youngs = slope_y > slope_c
    m = [torch.where(take_youngs, y, c) for y, c in zip(youngs, out)]
    norm = torch.abs(m[0]) + torch.abs(m[1]) + torch.abs(m[2]) + EPS
    return m[0] / norm, m[1] / norm, m[2] / norm


def reconstruct_alpha_3d(f, mx, my, mz):
    """Per-cell alpha of the PLIC plane {m.x <= alpha} holding fraction f
    (positive frame, mapped back to the signed one)."""
    a_pos = plane_alpha_positive(torch.abs(mx), torch.abs(my), torch.abs(mz),
                                 f)
    return a_pos - torch.where(mx < 0.0, -mx, 0.0) \
        - torch.where(my < 0.0, -my, 0.0) - torch.where(mz < 0.0, -mz, 0.0)


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
    """True if a side carries a contact angle."""
    return bcs.has_kind(fbc, bcs.CONTACT)


def _contact_theta(grid: Grid, fbc: bcs.FieldBC, tr_ax: int, side: int,
                   t, like):
    """The contact angle in radians along the wall (tr_ax, side) at its
    face centres, a callable evaluated at time ``t``, saturated to
    [atan(1/SLOPE_MAX), pi - atan(1/SLOPE_MAX)] (gerris_tpu vof.py:
    747-760); ``like``'s dtype and device."""
    b = fbc.sides[tr_ax][side]
    ta = 1 - tr_ax
    ntan = grid.shape[ta]
    xt = grid.origin[ta] + (torch.arange(ntan, dtype=torch.float64,
                                         device=like.device) + 0.5) * grid.h
    xw = grid.boundary_coord(tr_ax, side)
    coords = (xt, xw) if tr_ax == 1 else (xw, xt)
    theta = torch.deg2rad(torch.broadcast_to(torch.as_tensor(
        bcs._eval(b.value, coords, t), dtype=like.dtype,
        device=like.device), (ntan,)))
    tmin = math.atan(1.0 / _SLOPE_MAX)
    return torch.clamp(theta, tmin, math.pi - tmin)


def contact_fill(f_pad, P: int, grid: Grid, fbc: bcs.FieldBC,
                 t: float = 0.0):
    """``f_pad`` (P ghost layers) with the ghost band of each contact-angle
    side replaced by the fractions of the PLIC interface extended into
    the wall at the angle (gerris_tpu vof.py:763-870; the reference
    imposes the angle on its height columns, contact_angle_height and
    height_contact_normal_bc, src/vof.c:3224-3313).  For each wall cell
    whose line wets part of the wall face (a contact-line cell), the
    line of fluid-out normal at angle theta to the inward wall normal
    and the cell's own fraction is evaluated in the ghost cells below it
    and, when |cot theta| carries it there, in the tangentially shifted
    ghost columns (the nearest shift written last); a wall cell with a
    fully wet (dry) wall face continues full (empty).  Below
    _CONTACT_MIN_CELLS cells a side the mirror ghosts stay."""
    _check_2d(grid, "contact_fill")
    n0, n1 = (s - 2 * P for s in f_pad.shape)
    if min(n0, n1) < _CONTACT_MIN_CELLS:
        return f_pad
    shape = (n0, n1)
    ms = mycs_normals(f_pad[P - 1:P + n0 + 1, P - 1:P + n1 + 1])
    f_pad = f_pad.clone()
    dtype = f_pad.dtype
    for tr_ax in range(2):
        for side in range(2):
            if fbc.sides[tr_ax][side].kind != bcs.CONTACT:
                continue
            ta = 1 - tr_ax
            ntan = shape[ta]
            r0 = 0 if side == 0 else shape[tr_ax] - 1

            def row(a):
                return a[r0, :] if tr_ax == 0 else a[:, r0]

            fr = row(f_pad[P:P + n0, P:P + n1])
            s_t = torch.where(row(ms[ta]) < 0.0, -1.0, 1.0).to(dtype)
            theta = _contact_theta(grid, fbc, tr_ax, side, t, f_pad)
            nrm = torch.sin(theta) + torch.abs(torch.cos(theta))
            mt = s_t * torch.sin(theta) / nrm
            mi = torch.cos(theta) / nrm
            negt, negi = torch.clamp(-mt, min=0.0), torch.clamp(-mi, min=0.0)
            alpha = line_alpha_positive(mt.abs(), mi.abs(), fr) - negt - negi
            # the wetted share of the wall face (local tr = 0 edge)
            w = torch.where(
                mt.abs() < 1e-6, (alpha > 0.0).to(dtype),
                torch.clamp((alpha - torch.clamp(mt, max=0.0))
                            / torch.clamp(mt.abs(), min=EPS), 0.0, 1.0))
            interf = (fr > FULL_TOL) & (fr < 1.0 - FULL_TOL)
            contact = interf & (w > FULL_TOL) & (w < 1.0 - FULL_TOL)

            idx = torch.arange(ntan, device=f_pad.device)
            for g in range(1, P + 1):
                ghost = torch.where(interf, (w >= 0.5).to(dtype),
                                    (fr >= 0.5).to(dtype))
                # the shifts k, farthest first (the nearest written last),
                # and k = 0 at the end: each shift's fraction of the line
                # in the ghost cell k columns over, g rows into the wall,
                # all shifts at once
                kmax = int(g * _SLOPE_MAX) + 1
                ks = sorted((q for q in range(-kmax, kmax + 1) if q),
                            key=lambda q: -abs(q)) + [0]
                kt = torch.tensor(ks, dtype=dtype,
                                  device=f_pad.device).unsqueeze(1)
                vals = line_area_positive(
                    mt.abs(), mi.abs(), alpha + kt * mt + g * mi + negt + negi)
                ghost = torch.where(contact, vals[-1], ghost)
                # the contact cell k columns over writes its line's value
                # into this column (no wrap)
                src = idx + kt[:-1].long()
                inside = (src >= 0) & (src < ntan)
                src = src.clamp(0, ntan - 1)
                cand = torch.gather(vals[:-1], 1, src)
                take = (contact[src] & inside & ~contact & (cand > FULL_TOL)
                        & (cand < 1.0 - FULL_TOL))
                # the last shift in the order that takes the column wins
                n_k = len(ks) - 1
                last = n_k - 1 - torch.argmax(
                    torch.flip(take, (0,)).to(torch.int8), dim=0)
                ghost = torch.where(take.any(dim=0),
                                    cand[last, idx], ghost)
                gi = P - g if side == 0 else P + shape[tr_ax] - 1 + g
                if tr_ax == 0:
                    f_pad[gi, P:P + n1] = ghost
                else:
                    f_pad[P:P + n0, gi] = ghost
    return f_pad


def _pad(f, grid: Grid, fbc: bcs.FieldBC, width: int, t: float):
    """f padded by ``width`` with its BCs, the contact sides' ghost band
    filled (contact_fill)."""
    p = bcs.apply_bc(f, grid, fbc, width, t=t)
    return contact_fill(p, width, grid, fbc, t) if has_contact(fbc) else p


def normals(f, grid: Grid, fbc: bcs.FieldBC, t: float = 0.0):
    """MYC normals of f padded with its BCs at time ``t``, contact sides
    filled in 2D (gerris_tpu vof.py:425-433)."""
    if grid.dim == 3:
        return mycs_normals_3d(bcs.apply_bc(f, grid, fbc, 1, t=t))
    return mycs_normals(_pad(f, grid, fbc, 1, t))


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


def _face_flux_3d(f_pad, m_pads, un, axis):
    """Single-band geometric flux (fraction * CFL) through the faces of
    ``axis`` from the 1-ghost padded fraction and the normals on the
    same layout (vof_flux's 3D branch with one band, src/vof.c:
    1510-1520; gerris_tpu vof.py:434-470)."""
    n = f_pad.shape[axis]

    def side(a, which):
        for ax in range(3):
            if ax != axis:
                a = a.narrow(ax, 1, a.shape[ax] - 2)
        return a.narrow(axis, which, n - 1)

    upos = un > 0.0
    donor_f = torch.where(upos, side(f_pad, 0), side(f_pad, 1))
    dm = [torch.where(upos, side(m, 0), side(m, 1)) for m in m_pads]
    a = reconstruct_alpha_3d(donor_f, *dm)
    m1, m2, m3, ap = positive_normal_3d(dm[0], dm[1], dm[2], a)
    cfl = torch.abs(un)
    b0 = [torch.zeros_like(cfl)] * 3
    b1 = [torch.ones_like(cfl)] * 3
    s0 = torch.where(upos, 1.0 - cfl, 0.0)
    s1 = torch.where(upos, 1.0, cfl)
    neg = dm[axis] < 0.0
    b0[axis] = torch.where(neg, 1.0 - s1, s0)
    b1[axis] = torch.where(neg, 1.0 - s0, s1)
    frac = box_fraction(m1, m2, m3, ap, b0, b1)
    frac = torch.where(is_full(donor_f), torch.clamp(donor_f, 0.0, 1.0), frac)
    return frac * un


def sweep_flux(f, u_face: list, grid: Grid, fbc: bcs.FieldBC, c: int, dt,
               t: float = 0.0):
    """(geometric flux, face CFL) of one direction-split sweep along ``c``
    (gerris_tpu vof.py:530-583): MYC normals on the 2-ghost padding, the
    band refinement's transverse velocity increment from the cell means
    of u_face[c] (grad_u src/vof.c:1595, dun :1491).  With a contact
    side both pads are the contact-filled 2-ghost one (gerris_tpu
    vof.py:541-548).  In 3D: one band, MYC normals on the 2-ghost
    padding, contact sides mirrored (gerris_tpu vof.py:553-556)."""
    if grid.dim == 3:
        un = u_face[c] * dt / grid.h
        m_pads = mycs_normals_3d(bcs.apply_bc(f, grid, fbc, 2, t=t))
        return _face_flux_3d(bcs.apply_bc(f, grid, fbc, 1, t=t), m_pads, un,
                             c), un
    if has_contact(fbc):
        pad2 = _pad(f, grid, fbc, 2, t)
        f_pad = pad2[1:-1, 1:-1]
    else:
        f_pad = bcs.apply_bc(f, grid, fbc, 1, t=t)
        pad2 = bcs.apply_bc(f, grid, fbc, 2, t=t)
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


def _conc_sweep(cq, f, dV, flux, un, c: int, grid: Grid, cbc, t):
    """One sweep of every concentration amount q = c f, with the donor
    cell's concentration on each face times the fraction flux and the
    dilation bookkeeping of f itself (gerris_tpu vof.py:490-510)."""
    n = flux.shape[c]
    volflux = -(un.narrow(c, 1, n - 1) - un.narrow(c, 0, n - 1))
    out = []
    for q in cq:
        ccur = torch.where(f > EPS, q / torch.clamp(f, min=EPS), 0.0)
        cp = bcs.apply_bc(ccur, grid, cbc, 1, t=t)
        for a in range(f.dim()):
            if a != c:
                cp = cp.narrow(a, 1, cp.shape[a] - 2)
        cflux = torch.where(un > 0.0, cp.narrow(c, 0, n),
                            cp.narrow(c, 1, n)) * flux
        cfv = -(cflux.narrow(c, 1, n - 1) - cflux.narrow(c, 0, n - 1))
        out.append((q * dV + cfv) / torch.clamp(dV + volflux, min=EPS))
    return out


def advect(f, u_face: list, grid: Grid, fbc: bcs.FieldBC, dt,
           cstart: int = 0, concentrations=None, t: float = 0.0,
           cbc: bcs.FieldBC = None):
    """One VOF advection step: direction-split sweeps starting at
    component ``cstart`` (rotated by the caller each step, src/vof.c:1648,
    1721), the dilation field carried across the sweeps (gerris_tpu
    vof.py:473-528).  Needs a per-sweep CFL u dt / h <= 0.5.
    ``concentrations``: phase-intensive fields c whose amounts c f are
    carried with the geometric fluxes, the donor cell's c on each face
    (GfsVariableVOFConcentration, src/vof.c:962-1010), padded with
    ``cbc`` (default ``fbc``); then returns (f, [c, ...]).  Callable BC
    values are evaluated at time ``t``."""
    dV = torch.ones_like(f)
    cq = None if concentrations is None else \
        [torch.as_tensor(c, dtype=f.dtype, device=f.device) * f
         for c in concentrations]
    for k in range(grid.dim):
        c = (cstart + k) % grid.dim
        flux, un = sweep_flux(f, u_face, grid, fbc, c, dt, t)
        if cq is not None:
            cq = _conc_sweep(cq, f, dV, flux, un, c, grid, cbc or fbc, t)
        f, dV = sweep_update(f, dV, flux, un, c)
    if cq is None:
        return f
    return f, [torch.where(f > EPS, q / torch.clamp(f, min=EPS), 0.0)
               for q in cq]


# ---------------------------------------------------------------------------
# Height-function curvature (gerris_tpu vof.py:610-733, :968-1112)
# ---------------------------------------------------------------------------

def curvature(f, grid: Grid, fbc: bcs.FieldBC, off_max: int = 2,
              t: float = 0.0):
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
    wide pad's (gerris_tpu vof.py:646-650).  Callable BC values are
    evaluated at time ``t``.  In 3D: curvature_3d (``off_max`` unused, as
    in the reference)."""
    if grid.dim == 3:
        return curvature_3d(f, grid, fbc, t)
    R = 3  # column half-height
    o_max = min(off_max, max(0, (min(grid.shape) - 2 * R) // 2))
    OFF = (0,) + sum(((-o, o) for o in range(1, o_max + 1)), ())
    P = R + o_max + 1
    contact = has_contact(fbc)
    f_pad = _pad(f, grid, fbc, P, t)
    n0, n1 = grid.shape

    def sub(di, dj):
        return f_pad[P + di:P + di + n0, P + dj:P + dj + n1]

    # the normals: the 1-ghost padding's (whose corner ghosts differ from
    # the wide pad's), or with a contact side the filled wide pad's ring
    mx, my = mycs_normals(f_pad[P - 1:P + n0 + 1, P - 1:P + n1 + 1]
                          if contact else
                          bcs.apply_bc(f, grid, fbc, 1, t=t))
    interface = (f > FULL_TOL) & (f < 1.0 - FULL_TOL)
    nan = torch.full_like(f, math.nan)

    kappas, valids = [], []
    for d in range(2):
        kap_d = nan
        val_d = torch.zeros_like(f, dtype=torch.bool)
        shifts = _contact_height_shifts(grid, fbc, d, t, f)
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
            for side, wall, cot in shifts:
                if side == 0:
                    Hm = torch.where(wall, H0 + cot, Hm)
                else:
                    Hp = torch.where(wall, H0 - cot, Hp)
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
    kap_fit = parabola_curvature(f, grid, fbc, mx, my, t)
    kap = torch.where(torch.isfinite(kap), kap, kap_fit)
    return torch.where(interface, kap, nan)


def curvature_3d(f, grid: Grid, fbc: bcs.FieldBC, t: float = 0.0):
    """3D height-function curvature on interface cells, NaN elsewhere and
    where no column is valid (gerris_tpu vof.py:895-966; the 3D branches
    of curvature_along_direction, src/vof.c:2068-2200, 2548): 7-cell
    column sums along each axis over the 3 x 3 transverse stencil,
    kappa = -(Hxx (1 + Hy^2) + Hyy (1 + Hx^2) - 2 Hxy Hx Hy) / (h (1 +
    Hx^2 + Hy^2)^(3/2)), the sum of the principal curvatures; a column
    counts where both window ends are full and opposite, the centre
    height inside the window and |Hx|, |Hy| <= 1.  The dominant normal's
    axis (the first on ties) wins, else the first valid axis.  The pads
    are the reference's: 4 ghosts with corners (edge and corner ghosts
    read by the transverse columns), the normals from a 1-ghost pad."""
    R = 3
    P = R + 1
    f_pad = bcs.apply_bc(f, grid, fbc, P, t=t)
    n0, n1, n2 = grid.shape

    def sub(di, dj, dk):
        return f_pad[P + di:P + di + n0, P + dj:P + dj + n1,
                     P + dk:P + dk + n2]

    m = mycs_normals_3d(bcs.apply_bc(f, grid, fbc, 1, t=t))
    interface = (f > FULL_TOL) & (f < 1.0 - FULL_TOL)
    kappas, valids = [], []
    for d in range(3):
        taxes = [a for a in range(3) if a != d]

        def col(t1, t2):
            s = 0.0
            for k in range(-R, R + 1):
                off = [0, 0, 0]
                off[d] = k
                off[taxes[0]] += t1
                off[taxes[1]] += t2
                s = s + sub(*off)
            return s

        H = {(t1, t2): col(t1, t2) for t1 in (-1, 0, 1) for t2 in (-1, 0, 1)}
        Hx = 0.5 * (H[1, 0] - H[-1, 0])
        Hy = 0.5 * (H[0, 1] - H[0, -1])
        Hxx = H[1, 0] - 2.0 * H[0, 0] + H[-1, 0]
        Hyy = H[0, 1] - 2.0 * H[0, 0] + H[0, -1]
        Hxy = 0.25 * (H[1, 1] - H[1, -1] - H[-1, 1] + H[-1, -1])
        den = torch.pow(1.0 + Hx * Hx + Hy * Hy, 1.5)
        kappas.append(-(Hxx * (1.0 + Hy * Hy) + Hyy * (1.0 + Hx * Hx)
                        - 2.0 * Hxy * Hx * Hy) / (grid.h * den))
        off_top, off_bot = [0, 0, 0], [0, 0, 0]
        off_top[d], off_bot[d] = R, -R
        top, bot = sub(*off_top), sub(*off_bot)
        ends_ok = is_full(top) & is_full(bot) & (torch.abs(top - bot) > 0.5)
        sane = (H[0, 0] > 0.0) & (H[0, 0] < 2.0 * R + 1.0) \
            & (torch.abs(Hx) <= 1.0) & (torch.abs(Hy) <= 1.0)
        valids.append(ends_ok & sane)
    dom = torch.argmax(torch.stack([torch.abs(c) for c in m]), dim=0)
    kap = torch.full_like(f, math.nan)
    for d in range(3):
        kap = torch.where((dom == d) & valids[d], kappas[d], kap)
    for d in range(3):
        kap = torch.where(torch.isnan(kap) & valids[d], kappas[d], kap)
    return torch.where(interface, kap, math.nan)


def _contact_height_shifts(grid: Grid, fbc: bcs.FieldBC, d: int, t, like):
    """For the heights along axis ``d``: (side, wall cells, cot theta) of
    each contact wall transverse to it, where the ghost column's height
    is the wall cell's shifted by +cot theta (low wall) or -cot theta
    (high wall), |cot| at most _SLOPE_MAX (contact_angle_height,
    src/vof.c:3282-3313; gerris_tpu vof.py:682-700)."""
    tr = 1 - d
    out = []
    if min(grid.shape) < _CONTACT_MIN_CELLS:
        return out
    for side in range(2):
        if fbc.sides[tr][side].kind != bcs.CONTACT:
            continue
        th = _contact_theta(grid, fbc, tr, side, t, like)
        cot = torch.clamp(1.0 / torch.tan(th), -_SLOPE_MAX, _SLOPE_MAX)
        shp = [1, 1]
        shp[d] = grid.shape[d]
        ridx = torch.arange(grid.shape[tr], device=like.device).reshape(
            [grid.shape[tr] if a == tr else 1 for a in range(2)])
        wall = ridx == (0 if side == 0 else grid.shape[tr] - 1)
        out.append((side, wall, cot.reshape(shp)))
    return out


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


def parabola_curvature(f, grid: Grid, fbc: bcs.FieldBC, mx, my,
                       t: float = 0.0):
    """Least-squares parabola eta = a0 + a1 xi + a2 xi^2 through the
    interface points of the 5x5 stencil in the centre cell's normal frame;
    kappa = -2 a2 / (1 + a1^2)^(3/2) / h where at least 4 points and a
    regular system (ParabolaFit src/vof.c:2201-2493).  2D: the reference
    fits no paraboloid in 3D."""
    _check_2d(grid, "parabola_curvature")
    W = 2
    if has_contact(fbc):
        f_big = _pad(f, grid, fbc, W + 1, t)
        f_all = f_big[1:-1, 1:-1]
        mcx, mcy = mycs_normals(f_big)
    else:
        f_all = bcs.apply_bc(f, grid, fbc, W, t=t)
        mcx, mcy = mycs_normals(bcs.apply_bc(f, grid, fbc, W + 1, t=t))
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


def fill_curvature_weighted(kap, T, niter: int = 2, fmin: float = 0.01):
    """The Kmax variable's f(1-f)-weighted curvature extension (the
    reference's diffuse_kmax, src/tension.c:540-565; gerris_tpu
    vof.py:1056-1082), ``niter`` times: a cell well inside the interface
    band (f(1-f) > fmin(1-fmin), finite curvature) keeps its value, any
    other takes the f(1-f)-weighted mean of such face neighbours (or
    keeps its value without one).  nD."""
    dim = kap.dim()
    pad = (1, 1) * dim
    thr = fmin * (1.0 - fmin)
    wt = T * (1.0 - T)
    for _ in range(niter):
        w_core = torch.where(torch.isfinite(kap) & (wt > thr), wt, 0.0)
        keep = w_core > 0.0
        pad_k = F.pad(torch.where(keep, kap, 0.0) * w_core, pad)
        pad_w = F.pad(w_core, pad)
        s = w = 0.0
        for ax in range(dim):
            for off in (0, 2):
                idx = [slice(1, -1)] * dim
                idx[ax] = slice(off, pad_k.shape[ax] - 2 + off)
                s = s + pad_k[tuple(idx)]
                w = w + pad_w[tuple(idx)]
        avg = s / torch.clamp(w, min=1e-30)
        kap = torch.where(keep, kap, torch.where(w > 0.0, avg, kap))
    return kap


# ---------------------------------------------------------------------------
# Fraction initialization from an implicit function (vof.py:1113-1196)
# ---------------------------------------------------------------------------

def fraction_from_levelset(grid: Grid, phi, refine: int = 0, device=None,
                           dtype=torch.float64):
    """Volume fraction of {phi > 0} by a per-cell linearization of the
    level set sampled at the cell vertices: exact for linear phi, O(h^2
    kappa) for curved interfaces (the dense form of gfs_vof_init).
    ``phi(x, y[, z])`` takes torch tensors.  ``refine``: evaluate that
    many levels finer and average back (the reference's
    ``RefineSurface``).  The result is on ``device``, the CUDA card by
    default (core/device.default_device)."""
    device = default_device(device)
    if refine > 0:
        gf = dataclasses.replace(grid, level=grid.level + refine)
        f = fraction_from_levelset(gf, phi, device=device, dtype=dtype)
        r = 1 << refine
        sh = []
        for n in f.shape:
            sh += [n // r, r]
        return f.reshape(sh).mean(dim=tuple(range(1, 2 * grid.dim, 2)))
    if grid.dim == 3:
        return _fraction_3d(grid, phi, device, dtype)
    pv = phi(*vertex_coords(grid, device, dtype))
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


def _fraction_3d(grid: Grid, phi, device, dtype):
    """fraction_from_levelset's 3D plane per cell (gerris_tpu vof.py:
    1142-1170): the gradient and centre value from the 8 vertices."""
    pv = phi(*(torch.as_tensor(a, dtype=dtype, device=device)
               for a in np.meshgrid(*(grid.axis_faces(k) for k in range(3)),
                                    indexing="ij")))
    n0, n1, n2 = (s - 1 for s in pv.shape)
    c = {(i, j, k): pv[i:n0 + i, j:n1 + j, k:n2 + k]
         for i in (0, 1) for j in (0, 1) for k in (0, 1)}
    gx = 0.25 * sum(c[1, j, k] - c[0, j, k] for j in (0, 1) for k in (0, 1))
    gy = 0.25 * sum(c[i, 1, k] - c[i, 0, k] for i in (0, 1) for k in (0, 1))
    gz = 0.25 * sum(c[i, j, 1] - c[i, j, 0] for i in (0, 1) for j in (0, 1))
    pc = 0.125 * sum(c.values())
    mx, my, mz = -gx, -gy, -gz
    alpha = pc + 0.5 * (mx + my + mz)
    norm = torch.abs(mx) + torch.abs(my) + torch.abs(mz) + EPS
    fr = plane_volume_positive(*positive_normal_3d(
        mx / norm, my / norm, mz / norm, alpha / norm))
    allpos = functools.reduce(torch.logical_and, [v > 0 for v in c.values()])
    allneg = functools.reduce(torch.logical_and, [v <= 0 for v in c.values()])
    return torch.where(allpos, 1.0,
                       torch.where(allneg, 0.0, fr)).contiguous()
