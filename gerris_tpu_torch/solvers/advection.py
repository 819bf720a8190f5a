"""Godunov/BCG second-order upwind advection
(port of gerris_tpu/solvers/advection.py; centred unlimited slope).

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


@dataclasses.dataclass(frozen=True)
class AdvectionParams:
    """Reference defaults (src/advection.c:924-948): cfl 0.8, centred
    unlimited gradient, Godunov scheme, gc (explicit pressure gradient in
    the momentum rhs) on.  Only these values are ported."""
    cfl: float = 0.8
    gradient: str = "centered"
    scheme: str = "godunov"
    gc: bool = True

    def __post_init__(self):
        if (self.gradient != "centered" or self.scheme != "godunov"
                or not self.gc):
            raise NotImplementedError(
                "only the centred Godunov scheme with gc is ported "
                "(limiters and gc=False: ROADMAP Queue 1, slice 3)")


def _slope(a: torch.Tensor, axis: int) -> torch.Tensor:
    """Centred slope * h of a once-padded array along ``axis`` (shrinks
    by 2 along it)."""
    n = a.shape[axis]
    c = a.narrow(axis, 1, n - 2)
    s0 = c - a.narrow(axis, 0, n - 2)
    s1 = a.narrow(axis, 2, n - 2) - c
    return 0.5 * (s0 + s1)


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
                         uc_pad: list, axes=None):
    """BCG-extrapolated face values of ``v`` at t+dt/2: per axis
    (v_plus, v_minus) on the 1-ghost padded cell layout, or None for an
    axis not in ``axes``.  ``uc_pad``: the advecting velocity per
    component, 1-ghost padded.  Reference: src/advection.c:58-99.
    The ghosts of ``v`` are padded in the CUDA kernels' order (columns
    first, csrc/stencil.cuh), whose corner ghosts the TPU kernels share
    (gerris_tpu/ops/pallas/bcg.py, predict.py); the transverse term of a
    ghost cell next to a corner reads them."""
    dim = grid.dim
    h = grid.h
    v2 = bcs.apply_bc(v, grid, fbc, 2, axes=tuple(reversed(range(dim))))
    v1 = v2[tuple(slice(1, s - 1) for s in v2.shape)]
    out = []
    for c in range(dim):
        if axes is not None and c not in axes:
            out.append(None)
            continue
        idx = [slice(1, s - 1) for s in v2.shape]
        idx[c] = slice(None)
        g = _slope(v2[tuple(idx)], c)
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
