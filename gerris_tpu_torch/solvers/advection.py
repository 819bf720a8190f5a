"""Godunov/BCG second-order upwind advection
(port of gerris_tpu/solvers/advection.py; the centred, van Leer and
minmod slopes, the Godunov scheme or none; 2D and 3D).

Face value of v at t+dt/2, extrapolated from the upwind cell:
  v_face(+side) = v + min((1-u dt/h)/2, 1/2) * h dv/dx
                  - (dt/2) vtan dv/dy|upwind
then an upwind (Riemann) selection on the face-normal velocity and a
conservative flux-difference update.  Reference: src/advection.c:30-436.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.grid import Grid
from ..core import bc as bcs
from ..ops.stencils import face_average


@dataclasses.dataclass(frozen=True)
class AdvectionParams:
    """Reference defaults (src/advection.c:924-948): cfl 0.8, centred
    unlimited gradient, Godunov scheme, gc (explicit pressure gradient in
    the momentum rhs) on.  ``gradient``: "centered", "van_leer" or
    "minmod"; ``scheme``: "godunov", or "none" (face values v +- g/2, no
    time extrapolation or transverse term)."""
    cfl: float = 0.8
    gradient: str = "centered"
    scheme: str = "godunov"
    gc: bool = True

    def __post_init__(self):
        if self.gradient not in ("centered", "van_leer", "minmod"):
            raise ValueError(f"gradient {self.gradient!r}")
        if self.scheme not in ("godunov", "none"):
            raise ValueError(f"scheme {self.scheme!r}")


def _slope(a: torch.Tensor, axis: int,
           limiter: str = "centered") -> torch.Tensor:
    """The (limited) slope * h of a once-padded array along ``axis``
    (shrinks by 2 along it; reference advection.py:39-62)."""
    n = a.shape[axis]
    c = a.narrow(axis, 1, n - 2)
    s0 = c - a.narrow(axis, 0, n - 2)
    s1 = a.narrow(axis, 2, n - 2) - c
    if limiter == "centered":
        return 0.5 * (s0 + s1)
    if limiter == "van_leer":
        prod = s0 * s1
        harm = 2.0 * prod / torch.where(s0 + s1 == 0.0, 1.0, s0 + s1)
        return torch.where(prod > 0.0, harm, 0.0)
    if limiter == "minmod":
        return torch.where(s0 * s1 > 0.0,
                           torch.where(s0.abs() < s1.abs(), s0, s1), 0.0)
    raise ValueError(limiter)


def mac_cell_mean(u_face: list, grid: Grid) -> list:
    """Per-cell mean of the two MAC faces of each component, edge-padded
    by one ghost ring (reference: src/advection.c:34-35)."""
    out = []
    for c in range(grid.dim):
        uf = u_face[c]
        n = uf.shape[c]
        mean = 0.5 * (uf.narrow(c, 0, n - 1) + uf.narrow(c, 1, n - 1))
        for axis in range(grid.dim):
            mean = bcs.edge_extend(mean, axis, 1)
        out.append(mean)
    return out


def advected_face_values(v, grid: Grid, fbc: bcs.FieldBC, dt,
                         uc_pad: list, axes=None, kernel_corners=False,
                         t: float = 0.0, par: AdvectionParams = None):
    """BCG-extrapolated face values of ``v`` at t+dt/2: per axis
    (v_plus, v_minus) on the 1-ghost padded cell layout, or None for an
    axis not in ``axes``.  ``uc_pad``: the advecting velocity per
    component, 1-ghost padded.  Reference: src/advection.c:58-99.
    ``par`` (default: the centred Godunov scheme) gives the slope's
    limiter, and with scheme "none" the faces are v +- g/2 (reference
    advection.py:113-115).
    The transverse term of a ghost cell next to an edge reads the corner
    ghosts, and where a boundary face carries flux (periodic, outflow)
    they reach the result.  By default the ghosts of ``v`` are padded as
    the reference's generic route pads them (corners=False,
    gerris_tpu/solvers/advection.py:101).  ``kernel_corners`` (2D): pad
    them in the CUDA kernels' order (columns first, csrc/stencil.cuh),
    whose corner ghosts the TPU kernels share (gerris_tpu/ops/pallas/
    bcg.py, predict.py); the plain versions of K6/K14/K7 ask for it on
    the BCs their kernels take, and only there.  Callable BC values are
    evaluated at time ``t``."""
    dim = grid.dim
    h = grid.h
    par = par or AdvectionParams()
    if kernel_corners and dim == 2:
        v2 = bcs.apply_bc(v, grid, fbc, 2, axes=(1, 0), t=t)
    else:
        v2 = bcs.apply_bc(v, grid, fbc, 2, corners=False, t=t)
    v1 = v2[tuple(slice(1, s - 1) for s in v2.shape)]
    out = []
    for c in range(dim):
        if axes is not None and c not in axes:
            out.append(None)
            continue
        idx = [slice(1, s - 1) for s in v2.shape]
        idx[c] = slice(None)
        g = _slope(v2[tuple(idx)], c, par.gradient)
        if par.scheme == "none":
            out.append((v1 + 0.5 * g, v1 - 0.5 * g))
            continue
        unorm = dt * uc_pad[c] / h
        vp = v1 + torch.clamp((1.0 - unorm) / 2.0, max=0.5) * g
        vm = v1 + torch.clamp((-1.0 - unorm) / 2.0, min=-0.5) * g
        dv = 0.0
        for o in range(dim):
            if o == c:
                continue
            vtan = uc_pad[o]
            idxo = [slice(1, s - 1) for s in v2.shape]
            idxo[o] = slice(None)
            a = v2[tuple(idxo)]
            no = a.shape[o]
            mid = a.narrow(o, 1, no - 2)
            diff_up = mid - a.narrow(o, 0, no - 2)
            diff_dn = a.narrow(o, 2, no - 2) - mid
            gdiff = torch.where(vtan > 0.0, diff_up,
                                torch.where(vtan < 0.0, diff_dn,
                                            torch.zeros_like(mid)))
            dv = dv + dt * vtan * gdiff / (2.0 * h)
        out.append((vp - dv, vm - dv))
    return out


def upwind_face_value(vp, vm, un, axis: int):
    """Upwind selection of the two-sided face values by the face-normal
    velocity ``un`` (face shape).  Reference: src/advection.c:267-345."""
    n = vp.shape[axis]
    idx_l = [slice(1, s - 1) for s in vp.shape]
    idx_l[axis] = slice(0, n - 1)
    idx_r = list(idx_l)
    idx_r[axis] = slice(1, n)
    left = vp[tuple(idx_l)]
    right = vm[tuple(idx_r)]
    return torch.where(un > 0.0, left,
                       torch.where(un < 0.0, right, 0.5 * (left + right)))


def flux_divergence(v_face: list, u_face: list, grid: Grid, dt):
    """Conservative increment -(dt/h) sum_axis d(u v)_face.
    Reference: src/advection.c:356-385."""
    fv = 0.0
    for axis in range(len(v_face)):
        F = u_face[axis] * v_face[axis]
        n = F.shape[axis]
        fv = fv - dt * (F.narrow(axis, 1, n - 1) - F.narrow(axis, 0, n - 1)) / grid.h
    return fv


def advection_increment(v, uf: list, uc_pad: list, grid: Grid,
                        fbc: bcs.FieldBC, dt, par: AdvectionParams = None,
                        c: int = None, g_pad=None, t: float = 0.0,
                        kernel_corners: bool = False, face_frac=None):
    """The conservative increment of ``v`` on the reference's generic
    route (gerris_tpu/models/ns.py:335-347, :450-478): its face values
    under ``par``, upwinded by the MAC faces ``uf``, less dt/2 the face
    mean of ``g_pad`` (a 1-ghost padded cell gradient, the gmac
    correction) where given, the Dirichlet value on the faces of axis
    ``c`` (a velocity component; None for a tracer), and the flux
    difference.  ``uc_pad``: mac_cell_mean(uf); ``kernel_corners``: as
    in advected_face_values (the BCG kernels' plain versions).
    ``face_frac``: an embedded solid's face fractions s, by which both the
    face values and the MAC faces are weighted in the flux difference, as
    the reference weights them (gerris_tpu/models/ns.py:402-405: the flux
    is s^2 u v); the result is then the accumulated increment, not yet
    divided by the fluid fraction (solid.merged_cell_update)."""
    fvals = advected_face_values(v, grid, fbc, dt, uc_pad, t=t, par=par,
                                 kernel_corners=kernel_corners)
    faces = []
    for a in range(grid.dim):
        vface = upwind_face_value(fvals[a][0], fvals[a][1], uf[a], a)
        if g_pad is not None:
            vface = vface - face_average(g_pad, grid, a) * dt / 2.0
        if a == c:
            vface = bcs.apply_face_bc(vface, grid, fbc, a, t=t)
        faces.append(vface)
    if face_frac is not None:
        faces = [face_frac[a] * f for a, f in enumerate(faces)]
        uf = [face_frac[a] * u for a, u in enumerate(uf)]
    return flux_divergence(faces, uf, grid, dt)
