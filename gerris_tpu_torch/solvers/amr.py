"""Composite AMR numerics on dense per-level arrays with runtime leaf masks
(port of gerris_tpu/solvers/amr.py).

Each level l in [lmin, lmax] stores a full-domain array and a leaf mask
(a bool tensor on the device).  Cell roles per level, derived from the
masks:
  leaf(l)     the solution cells;
  covered(l)  under finer leaves: restricted fine data (the reference's
              gfs_cell_coarse_init);
  slave(l)    over a coarser leaf: prolonged coarse data (its fine-coarse
              ghosts).
With covered and slave cells synced, the uniform stencil at the leaves is
the composite operator, and a flux-conservative correction (``_reflux``)
replaces the coarse gradient at a fine-coarse face by the area-weighted
mean of the fine ones (gfs_face_weighted_gradient, src/fluid.c:905).

The operator is div(alpha grad u) - dia u with per-level face
coefficients ``alpha`` and a per-level scalar or cell ``dia``.  Every
level's residual, relaxation and the base level's correction are the
uniform solver's (solvers/poisson.py), so they run its kernels where its
dispatch takes them: K11 for the residual, one K10 (K15 with face
coefficients) launch per sweep on each whole dense level, and the base
correction's own route.  Reference: src/poisson.c:1109-1178 (the tree
multigrid), src/variable.h:46 (restriction / prolongation).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..core.grid import Grid
from ..core import bc as bcs
from . import poisson


@dataclasses.dataclass(frozen=True)
class Topo:
    """The composite mesh's static part: the base grid (at lmin) and the
    level range.  Which cells are leaves travels separately, as
    ``{level: bool tensor}``."""
    base: Grid
    lmin: int
    lmax: int

    def grid(self, l: int) -> Grid:
        return dataclasses.replace(self.base, level=l)

    @property
    def levels(self):
        return range(self.lmin, self.lmax + 1)

    @property
    def dim(self):
        return self.base.dim


def pool_any(m, dim: int):
    """2x2(x2) any-pool: child mask -> parent mask."""
    sh = []
    for a in range(dim):
        sh += [m.shape[a] // 2, 2]
    m = m.reshape(sh)
    for a in range(dim - 1, -1, -1):
        m = m.any(dim=2 * a + 1)
    return m


def covered_masks(leaf: Dict[int, torch.Tensor], topo: Topo
                  ) -> Dict[int, torch.Tensor]:
    """covered(l): some finer leaf lies under the cell."""
    cov = {topo.lmax: torch.zeros_like(leaf[topo.lmax])}
    acc = leaf[topo.lmax]
    for l in range(topo.lmax - 1, topo.lmin - 1, -1):
        cov[l] = pool_any(acc, topo.dim)
        acc = leaf[l] | cov[l]
    return cov


def _interleave(lo, hi, axis: int):
    """[lo0, hi0, lo1, hi1, ...] along ``axis``."""
    sh = list(lo.shape)
    sh[axis] *= 2
    return torch.stack([lo, hi], dim=axis + 1).reshape(sh)


def prolong_bc(c, grid_c: Grid, fbc: bcs.FieldBC, homogeneous: bool = True,
               t: float = 0.0):
    """Bilinear (trilinear) prolongation coarse -> fine with the BCs'
    ghosts (reference poisson.py:372-408): homogeneous ones by the
    uniform solver's ``prolong``; constant values axis by axis on the
    shifted neighbours (Dirichlet 2b - u, Neumann u -+ g h); callable
    values or a Navier side on the padded field, at time ``t``."""
    if homogeneous:
        return poisson.prolong(c, fbc, grid_c)
    dim = grid_c.dim
    a = c
    if all(not callable(b.value) and b.kind != bcs.NAVIER
           for ax in fbc.sides for b in ax):
        for axis in range(dim):
            n = a.shape[axis]
            left, right = torch.roll(a, 1, axis), torch.roll(a, -1, axis)
            if not fbc.is_periodic(axis):
                sh = [1] * a.dim()
                sh[axis] = n
                idx = torch.arange(n, device=a.device).reshape(sh)
                ghosts = []
                for side in (0, 1):
                    b = fbc.sides[axis][side]
                    if b.kind == bcs.DIRICHLET:
                        ghosts.append(2.0 * bcs.bc_value(b) - a)
                    else:
                        g = bcs.bc_value(b) * grid_c.h
                        ghosts.append(a + g if side else a - g)
                left = torch.where(idx == 0, ghosts[0], left)
                right = torch.where(idx == n - 1, ghosts[1], right)
            a = _interleave(0.75 * a + 0.25 * left, 0.75 * a + 0.25 * right,
                            axis)
        return a
    a = bcs.apply_bc(c, grid_c, fbc, 1, homogeneous=False, t=t)
    for axis in range(dim):
        n = a.shape[axis]
        center = a.narrow(axis, 1, n - 2)
        lo = 0.75 * center + 0.25 * a.narrow(axis, 0, n - 2)
        hi = 0.75 * center + 0.25 * a.narrow(axis, 2, n - 2)
        a = _interleave(lo, hi, axis)
    return a


def sync(u: Dict[int, torch.Tensor], topo: Topo, leaf, fbc: bcs.FieldBC,
         homogeneous: bool = False, t: float = 0.0, cov=None):
    """Restriction into covered cells (up), prolongation into slaves
    (down).  Reference: gfs_domain_cell_traverse coarse-init + the
    fine-coarse ghost interpolation (src/domain.c, src/variable.h:46)."""
    if cov is None:
        cov = covered_masks(leaf, topo)
    u = dict(u)
    for l in range(topo.lmax - 1, topo.lmin - 1, -1):
        u[l] = torch.where(cov[l], poisson.restrict(u[l + 1]), u[l])
    return fill_slaves(u, topo, leaf, fbc, homogeneous, t, cov)


def fill_slaves(u: Dict[int, torch.Tensor], topo: Topo, leaf,
                fbc: bcs.FieldBC, homogeneous: bool = False, t: float = 0.0,
                cov=None):
    """The downward half of ``sync`` only: slaves from fresh coarser data,
    covered cells untouched (after the leaf-only block advection,
    solvers/blockadv.py)."""
    if cov is None:
        cov = covered_masks(leaf, topo)
    u = dict(u)
    for l in range(topo.lmin + 1, topo.lmax + 1):
        p = prolong_bc(u[l - 1], topo.grid(l - 1), fbc, homogeneous, t)
        u[l] = torch.where(leaf[l] | cov[l], u[l], p)
    return u


def sync_vof(u: Dict[int, torch.Tensor], topo: Topo, leaf, fbc: bcs.FieldBC,
             t: float = 0.0, cov=None):
    """``sync`` for VOF fractions: the volume mean up, the PLIC-geometric
    prolongation down (vof.prolong_geometric, the reference's
    gfs_vof_coarse_fine, src/vof.c:210-296)."""
    from ..physics import vof as vofm
    if cov is None:
        cov = covered_masks(leaf, topo)
    u = dict(u)
    for l in range(topo.lmax - 1, topo.lmin - 1, -1):
        u[l] = torch.where(cov[l], poisson.restrict(u[l + 1]), u[l])
    for l in range(topo.lmin + 1, topo.lmax + 1):
        p = vofm.prolong_geometric(u[l - 1], topo.grid(l - 1), fbc, t=t)
        u[l] = torch.where(leaf[l] | cov[l], u[l], p)
    return u


def _pad0(a, axis: int):
    """``a`` with one zero (False) layer at each end of ``axis``."""
    sh = list(a.shape)
    sh[axis] = 1
    z = torch.zeros(sh, dtype=a.dtype, device=a.device)
    return torch.cat([z, a, z], dim=axis)


def face_mask(m, axis: int):
    """Faces of ``axis`` with a cell of mask ``m`` on either side."""
    p = _pad0(m, axis)
    n = p.shape[axis]
    return p.narrow(axis, 0, n - 1) | p.narrow(axis, 1, n - 1)


def _face_restrict(f, axis: int, dim: int):
    """Coarse face values: every second face along ``axis``, the mean of
    the aligned fine faces across the others."""
    idx = [slice(None)] * dim
    idx[axis] = slice(0, f.shape[axis], 2)
    g = f[tuple(idx)]
    for o in range(dim):
        if o == axis:
            continue
        sh = list(g.shape)
        sh[o:o + 1] = [sh[o] // 2, 2]
        g = g.reshape(sh).mean(dim=o + 1)
    return g


def sync_faces(uf: Dict[int, list], topo: Topo, leaf, cov=None):
    """Coarse face-normal values under refined regions := the mean of the
    aligned fine faces (gfs_face_coarse_fine's consistency: flux
    exactness at fine-coarse faces)."""
    if cov is None:
        cov = covered_masks(leaf, topo)
    dim = topo.dim
    out = {topo.lmax: list(uf[topo.lmax])}
    for l in range(topo.lmax - 1, topo.lmin - 1, -1):
        out[l] = [torch.where(face_mask(cov[l], a),
                              _face_restrict(out[l + 1][a], a, dim),
                              uf[l][a]) for a in range(dim)]
    return out


def _reflux(u, topo: Topo, leaf, cov, l: int, alpha_f=None, alpha_c=None):
    """The additive correction to the level-l operator at fine-coarse
    interface leaves: the coarse face gradient replaced by the
    area-weighted mean of the fine ones, alpha-weighted where given
    (gfs_face_weighted_gradient, src/fluid.c:905; src/poisson.c:634)."""
    gH = topo.grid(l)
    if l == topo.lmax:
        return torch.zeros(gH.shape, dtype=u[l].dtype, device=u[l].device)
    gh = topo.grid(l + 1)
    H, h = gH.h, gh.h
    dim = topo.dim
    uf, uc = u[l + 1], u[l]
    corr = torch.zeros_like(uc)
    for axis in range(dim):
        nH = gH.shape[axis]
        d = torch.diff(uf, dim=axis) / h
        if alpha_f is not None:
            d = d * alpha_f[axis].narrow(axis, 1, gh.shape[axis] - 1)
        g_fine = _face_restrict(_pad0(d, axis), axis, dim)
        dc = torch.diff(uc, dim=axis) / H
        if alpha_c is not None:
            dc = dc * alpha_c[axis].narrow(axis, 1, nH - 1)
        g_coarse = _pad0(dc, axis)
        covp, leafp = _pad0(cov[l], axis), _pad0(leaf[l], axis)
        iface = ((covp.narrow(axis, 0, nH + 1) & leafp.narrow(axis, 1, nH + 1))
                 | (leafp.narrow(axis, 0, nH + 1)
                    & covp.narrow(axis, 1, nH + 1)))
        delta = torch.where(iface, g_fine - g_coarse, 0.0)
        corr = corr + (delta.narrow(axis, 1, nH)
                       - delta.narrow(axis, 0, nH)) / H
    return torch.where(leaf[l], corr, 0.0)


def leaf_residual(u, rhs, topo: Topo, leaf, fbc: bcs.FieldBC, alpha=None,
                  dia=None, t: float = 0.0, reflux: bool = True, cov=None):
    """The composite residual on the leaves (zero elsewhere) of a synced
    u: the uniform residual per level (K11 where it applies) less the
    reflux correction."""
    if cov is None:
        cov = covered_masks(leaf, topo)
    out = {}
    for l in topo.levels:
        al = None if alpha is None else alpha[l]
        dl = None if dia is None else dia[l]
        r = poisson.residual(u[l], rhs[l], topo.grid(l), fbc, dia=dl, t=t,
                             alpha=al)
        if reflux:
            af = None if alpha is None else alpha.get(l + 1)
            r = r - _reflux(u, topo, leaf, cov, l, alpha_f=af, alpha_c=al)
        out[l] = torch.where(leaf[l], r, 0.0)
    return out


def cycle(u, rhs, topo: Topo, leaf, fbc: bcs.FieldBC,
          params: poisson.MultilevelParams, alpha=None, dia=None,
          t: float = 0.0, cov=None):
    """One sawtooth cycle over the composite hierarchy (gfs_poisson_cycle,
    src/poisson.c:1109-1178, on tree cuts; each masked dense level is the
    cut): the leaf residual restricted into covered cells, two uniform
    corrections of the base level, then per finer level the prolonged
    correction relaxed one sweep at a time on the whole level (one K10,
    or K15 with face coefficients, per sweep), kept on leaf | covered."""
    if cov is None:
        cov = covered_masks(leaf, topo)
    u = sync(u, topo, leaf, fbc, t=t, cov=cov)
    res = leaf_residual(u, rhs, topo, leaf, fbc, alpha=alpha, dia=dia, t=t,
                        cov=cov)
    r = {}
    acc = None
    for l in range(topo.lmax, topo.lmin - 1, -1):
        rl = res[l]
        if acc is not None:
            rl = torch.where(cov[l], poisson.restrict(acc), rl)
        r[l] = rl
        acc = rl
    a0 = None if alpha is None else alpha[topo.lmin]
    d0 = None if dia is None else dia[topo.lmin]
    du = torch.zeros_like(r[topo.lmin])
    for _ in range(2):
        rl = poisson.residual(du, r[topo.lmin], topo.base, fbc, dia=d0,
                              homogeneous=True, alpha=a0)
        du = du + poisson.correction(rl, topo.base, fbc, params, dia=d0,
                                     alpha=a0)
    dus = {topo.lmin: du}
    for l in range(topo.lmin + 1, topo.lmax + 1):
        du = poisson.prolong(dus[l - 1], fbc, topo.grid(l - 1))
        nswp = params.nrelax * (params.erelax ** (topo.lmax - l))
        act = leaf[l] | cov[l]
        al = None if alpha is None else alpha[l]
        dl = None if dia is None else dia[l]
        for _ in range(nswp):
            du_new = poisson.relax(du, r[l], topo.grid(l), fbc, 1, dia=dl,
                                   homogeneous=True, omega=params.omega,
                                   alpha=al)
            du = torch.where(act, du_new, du)
        dus[l] = du
    out = {l: u[l] + torch.where(leaf[l] | cov[l], dus[l], 0.0)
           for l in topo.levels}
    return sync(out, topo, leaf, fbc, t=t, cov=cov)


def leaf_volume_mean(f, topo: Topo, leaf):
    """The leaf-volume-weighted mean of a per-level field (a 0-d tensor)."""
    vol = tot = 0.0
    for l in topo.levels:
        w = leaf[l].to(f[l].dtype) * topo.grid(l).cell_volume
        vol = vol + w.sum()
        tot = tot + (f[l] * w).sum()
    return tot / vol


def _dirichlet(fbc: bcs.FieldBC) -> bool:
    return any(b.kind == bcs.DIRICHLET for ax in fbc.sides for b in ax)


@dataclasses.dataclass
class SolveStats:
    """A composite solve's cycle count, its final max leaf residual (a 0-d
    tensor) and its reads of the loop condition on the host."""
    niter: int
    rinf: torch.Tensor
    host_syncs: int = 0


def _tol_loop(u, params, step, rinf_of, tol):
    """Cycles while i < nitermin or (i < nitermax and rinf > tol): the
    reference's device while_loop, its condition read on the host once
    per cycle past nitermin."""
    rinf = None
    i = syncs = 0
    while i < params.nitermax:
        if i >= params.nitermin and rinf is not None:
            syncs += 1
            if not bool(rinf > tol):
                break
        u = step(u)
        rinf = rinf_of(u)
        i += 1
    return u, SolveStats(i, rinf, syncs)


def solve(rhs, topo: Topo, leaf, fbc: bcs.FieldBC,
          params: poisson.MultilevelParams = None, alpha=None, dia=None,
          u0=None, t: float = 0.0):
    """The tolerance-driven composite solve (reference amr.py:376-433):
    cycles until max|leaf residual| <= tolerance * max|leaf rhs|, at least
    nitermin and at most nitermax, one leaf residual a cycle.  Returns
    (u, stats).  With no Dirichlet side and no dia the leaf-volume mean
    of rhs is removed (GfsPoisson correct_div, src/simulation.c:2156)."""
    params = params or poisson.MultilevelParams()
    cov = covered_masks(leaf, topo)
    if u0 is None:
        u = {l: torch.zeros_like(rhs[l]) for l in topo.levels}
    else:
        u = dict(u0)
    if not _dirichlet(fbc) and dia is None:
        mean = leaf_volume_mean(rhs, topo, leaf)
        rhs = {l: rhs[l] - mean for l in rhs}
    scale = torch.stack([torch.where(leaf[l], rhs[l], 0.0).abs().max()
                         for l in topo.levels]).max()
    tol = params.tolerance * torch.clamp(
        scale, min=torch.finfo(scale.dtype).tiny)

    def rinf_of(uu):
        res = leaf_residual(uu, rhs, topo, leaf, fbc, alpha=alpha, dia=dia,
                            t=t, cov=cov)
        return torch.stack([res[l].abs().max() for l in topo.levels]).max()

    u = sync(u, topo, leaf, fbc, t=t, cov=cov)
    return _tol_loop(u, params,
                     lambda uu: cycle(uu, rhs, topo, leaf, fbc, params,
                                      alpha=alpha, dia=dia, t=t, cov=cov),
                     rinf_of, tol)


def flatten(u, topo: Topo, leaf, fbc: bcs.FieldBC, t: float = 0.0):
    """The finest level of the synced field."""
    return sync(u, topo, leaf, fbc, t=t)[topo.lmax]


def solve_block(rhs, topo: Topo, leaf, fbc: bcs.FieldBC,
                params: poisson.MultilevelParams, brt, btables, dia=None,
                u0=None, t: float = 0.0, alpha=None):
    """The leaf-proportional composite solve through the block engine
    (solvers/blockrt.py), with ``solve``'s dense per-level in/out: the
    active blocks gathered, solved (``params.ncycles`` fixed cycles, else
    to tolerance), scattered back and synced.  2D single box; ``alpha``:
    {level: (ax, ay)} dense face coefficients; ``dia``: None, a scalar,
    or {level: scalar or dense array}.  ``stats.rinf`` is the block
    engine's own leaf residual (its fine-coarse stencil is consistent but
    not the dense engine's).  Returns (u, stats)."""
    from . import blockrt as brtm

    params = params or poisson.MultilevelParams()
    B = brt.B
    d = 0.0
    dia_dense0 = None
    if dia is not None:
        if isinstance(dia, dict):
            if not isinstance(dia[topo.lmax], torch.Tensor) \
                    or dia[topo.lmax].dim() == 0:
                d = dia[topo.lmax]
            else:
                d = {l: brtm.gather_blocks(dia[l], btables[l], B)
                     for l in topo.levels}
                dia_dense0 = dia[topo.lmin]
        else:
            d = dia
    alphab = alpha_dense0 = None
    if alpha is not None:
        alphab = {l: brtm.gather_face_blocks(alpha[l], btables[l], B)
                  for l in topo.levels}
        alpha_dense0 = alpha[topo.lmin]
    rhs_b = {l: brtm.gather_blocks(rhs[l], btables[l], B)
             for l in topo.levels}
    if not _dirichlet(fbc) and dia is None:
        rhs_b = brtm.demean_leaf(rhs_b, btables, brt)
        mean = leaf_volume_mean(rhs, topo, leaf)
        rhs = {l: rhs[l] - mean for l in rhs}
    u0_b = None
    if u0 is not None:
        u0_b = {l: brtm.gather_blocks(u0[l], btables[l], B)
                for l in topo.levels}
    kw = dict(dia=d, u0=u0_b, alphab=alphab, alpha_dense0=alpha_dense0,
              dia_dense0=dia_dense0)
    if params.ncycles > 0:
        u_b = brtm.solve(rhs_b, btables, brt, fbc, params,
                         ncycles=params.ncycles, **kw)
        stats = SolveStats(params.ncycles, None)
    else:
        u_b, stats = brtm.solve_tol(rhs_b, btables, brt, fbc, params, **kw)
    u = {}
    for l in topo.levels:
        dense = u0[l] if u0 is not None else torch.zeros_like(rhs[l])
        u[l] = brtm.scatter_blocks(dense, u_b[l], btables[l], B)
    u = sync(u, topo, leaf, fbc, t=t)
    res_b = brtm.leaf_residual(u_b, rhs_b, btables, brt.base,
                               brtm._bc_kinds(fbc), d, brt.lmin, brt.lmax,
                               B, brt.caps_dict, alphab=alphab)
    stats.rinf = torch.stack([res_b[l].abs().max()
                              for l in topo.levels]).max()
    return u, stats
