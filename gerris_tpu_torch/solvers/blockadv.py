"""Block-windowed BCG advection: the composite step's corrector advection
with its work proportional to the leaves (port of
gerris_tpu/solvers/blockadv.py).

The per-level dense arrays stay (the mask engine keeps them, synced),
but the BCG chain (slopes, transverse terms, upwinding, flux divergence)
runs only on gathered [cap, B + 2g, B + 2g] windows of the active blocks
and is scattered back (the reference traverses the leaves only,
src/advection.c via gfs_domain_face_traverse).  The windows' ghosts come
from the synced level (slaves hold prolonged coarse data), which is what
the dense chain reads, so on the active blocks the result is the dense
chain's.  2D, one unit box, constant Dirichlet / Neumann sides, the
Godunov scheme.
"""
from __future__ import annotations

import torch

from ..core.grid import Grid
from ..core import bc as bcs
from .advection import AdvectionParams, _slope, mac_cell_mean
from .blockrt import _bc_kinds, _cells, scatter_blocks


def applicable(grid: Grid, par: AdvectionParams, fbc: bcs.FieldBC) -> bool:
    """The block solves' envelope and the Godunov scheme.  Contact-angle
    sides take the dense path: their ghosts (physics/vof.contact_fill)
    are not in the tables."""
    return (grid.dim == 2 and par.scheme == "godunov"
            and not any(callable(b.value)
                        or b.kind in (bcs.PERIODIC, bcs.CONTACT)
                        for ax in fbc.sides for b in ax))


def _win(dense_pad, t: dict, B: int, g: int):
    """A g-ghost padded dense level -> [cap, B + 2g, B + 2g] windows (block
    (bx, by) covers cells [bx B - g, bx B + B + g))."""
    return dense_pad[_cells(t, B, B + 2 * g, B + 2 * g)]


def _win_face(f, t: dict, B: int, axis: int):
    """A block's own B + 1 faces along ``axis`` with one transverse ghost
    each side (clamped at the box side; those entries are sliced off
    before use)."""
    if axis == 0:
        ii, jj = _cells(t, B, B + 1, B + 2, oj=-1)
        jj = torch.clamp(jj, 0, f.shape[1] - 1)
    else:
        ii, jj = _cells(t, B, B + 2, B + 1, oi=-1)
        ii = torch.clamp(ii, 0, f.shape[0] - 1)
    return f[ii, jj]


def _face_values_w(vw, ucw, dt, h, par: AdvectionParams, axis: int):
    """The BCG two-sided face values on the windows' 1-ghost layout
    [cap, B+2, B+2] (advection.advected_face_values' arithmetic,
    src/advection.c:58-99).  ``vw``: [cap, B+4, B+4] 2-ghost windows;
    ``ucw``: per component the advecting cell velocity's 1-ghost
    windows."""
    wax = axis + 1
    oax = 2 - axis
    g = _slope(vw.narrow(oax, 1, vw.shape[oax] - 2), wax, par.gradient)
    v1 = vw[:, 1:-1, 1:-1]
    if par.scheme == "none":
        return v1 + 0.5 * g, v1 - 0.5 * g
    unorm = dt * ucw[axis] / h
    vp = v1 + torch.clamp((1.0 - unorm) / 2.0, max=0.5) * g
    vm = v1 + torch.clamp((-1.0 - unorm) / 2.0, min=-0.5) * g
    o = 1 - axis
    woax = o + 1
    a = vw.narrow(2 - o, 1, vw.shape[2 - o] - 2)
    no = a.shape[woax]
    mid = a.narrow(woax, 1, no - 2)
    diff_up = mid - a.narrow(woax, 0, no - 2)
    diff_dn = a.narrow(woax, 2, no - 2) - mid
    vtan = ucw[o]
    gdiff = torch.where(vtan > 0.0, diff_up,
                        torch.where(vtan < 0.0, diff_dn,
                                    torch.zeros_like(mid)))
    dv = dt * vtan * gdiff / (2.0 * h)
    return vp - dv, vm - dv


def _upwind_w(vp, vm, un, axis: int):
    """Two-sided values + face-normal windows -> the upwind face values on
    the block's own B + 1 faces (B + 2 transverse entries)."""
    wax = axis + 1
    n = vp.shape[wax]
    left = vp.narrow(wax, 0, n - 1)
    right = vm.narrow(wax, 1, n - 1)
    return torch.where(un > 0.0, left,
                       torch.where(un < 0.0, right, 0.5 * (left + right)))


def _face_bc_w(vf, t, fbck, axis: int, B: int):
    """Constant Dirichlet values on the box-side faces of the windows
    (bc.apply_face_bc on blocks; Neumann keeps the computed value)."""
    isdir, dval = fbck
    wax = axis + 1
    shape = [1, 1, 1]
    shape[wax] = B + 1
    row = torch.arange(B + 1, device=vf.device).reshape(shape)
    for side, k in ((0, 2 * axis), (1, 2 * axis + 1)):
        if not isdir[k]:
            continue
        onb = t["bnd"][:, k][:, None, None]
        vf = torch.where(onb & (row == (0 if side == 0 else B)),
                         float(dval[k]), vf)
    return vf


def advect_blocks(v, uf: list, gmac_pad, grid: Grid, fbc: bcs.FieldBC, dt,
                  par: AdvectionParams, t_tab: dict, B: int, c: int,
                  tval: float = 0.0):
    """Component ``c``'s flux-divergence increment on the active blocks of
    one level, [cap, B, B]: the dense chain of amr_ns.amr_step's phase 3
    (with the gmac face-mean correction and the own-axis face BC) on
    windows.  ``v``: the synced dense level; ``uf``: its MAC faces;
    ``gmac_pad``: the MAC pressure gradient padded by one ghost."""
    h = grid.h
    fbck = _bc_kinds(fbc)
    v2 = bcs.apply_bc(v, grid, fbc, 2, t=tval, corners=False)
    uc_pad = mac_cell_mean(uf, grid)
    vw = _win(v2, t_tab, B, 2)
    ucw = [_win(uc_pad[a], t_tab, B, 1) for a in range(2)]
    gw = _win(gmac_pad, t_tab, B, 1)
    ufw = [_win_face(uf[a], t_tab, B, a) for a in range(2)]
    fv = 0.0
    for a in range(2):
        vp, vm = _face_values_w(vw, ucw, dt, h, par, a)
        vf = _upwind_w(vp, vm, ufw[a], a)
        if a == 0:
            gf = 0.5 * (gw[:, :-1, :] + gw[:, 1:, :])
        else:
            gf = 0.5 * (gw[:, :, :-1] + gw[:, :, 1:])
        vf = vf - gf * (dt / 2.0)
        if a == c:
            vf = _face_bc_w(vf, t_tab, fbck, a, B)
        if a == 0:
            F = (ufw[0] * vf)[:, :, 1:-1]
            fv = fv - dt * (F[:, 1:, :] - F[:, :-1, :]) / h
        else:
            F = (ufw[1] * vf)[:, 1:-1, :]
            fv = fv - dt * (F[:, :, 1:] - F[:, :, :-1]) / h
    return fv


def advect_level(v, uf, gmac, grid: Grid, fbc: bcs.FieldBC, gbc, dt,
                 par: AdvectionParams, t_tab: dict, B: int, c: int,
                 tval: float = 0.0):
    """Dense in and out: the increment on the active blocks, scattered
    into zeros (the non-active cells are refreshed downstream and never
    read from it)."""
    g_pad = bcs.apply_bc(gmac, grid, gbc, 1, t=tval)
    fvb = advect_blocks(v, uf, g_pad, grid, fbc, dt, par, t_tab, B, c,
                        tval=tval)
    return scatter_blocks(torch.zeros_like(v), fvb, t_tab, B)
