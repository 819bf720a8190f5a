"""Embedded solid boundaries (cut cells) (port of gerris_tpu/physics/solid.py).

Fractions come from a level set phi (fluid = {phi > 0}) sampled at the
cell vertices: cell volume fractions by the PLIC linearization
(vof.fraction_from_levelset), face fractions by the exact 1D cut of each
face between its two vertices in 2D and by the 2D cut of each square face
in 3D.  The cut-cell Poisson operator is the face-coefficient multigrid
with alpha = the face fractions and the rhs weighted by the volume
fraction: the natural Neumann condition on the solid surface (test/circle).
``DirichletSurface`` adds a Dirichlet value on the surface (test/dirichlet,
the no-slip wall of the velocity diffusion).  Reference: src/solid.c:213-
272, :385-601, :970; src/poisson.c:561-586, :756-901; src/fluid.c:778-1000;
src/advection.c:595-851.

``phi`` is a callable of torch tensors: phi(x, y) in 2D, phi(x, y, z) in
3D.  Every function builds its arrays on an explicit device and dtype (the
CUDA card by default, core/device.default_device); the reference's 1e-300
guards, which are 0 in float32, are the dtype's smallest normal number.
None of it runs a TPU kernel, so none of it is a kernel here: the solves
run the multigrid's kernels (K15 in 2D).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device import default_device
from ..core.grid import Grid, center_coords, vertex_coords
from . import vof


def _tiny(t: torch.Tensor) -> float:
    return torch.finfo(t.dtype).tiny


def _vertex_values(grid: Grid, phi, device, dtype):
    """phi at the (n0 + 1) x (n1 + 1) cell vertices (2D)."""
    return phi(*vertex_coords(grid, device, dtype))


def _edge_fraction(p0, p1):
    """Fluid fraction of a 1D edge with vertex level-set values p0, p1
    (reference solid.py:36-43)."""
    both_pos = (p0 > 0) & (p1 > 0)
    both_neg = (p0 <= 0) & (p1 <= 0)
    frac = torch.abs(torch.maximum(p0, p1)) / torch.clamp(
        torch.abs(p0 - p1), min=_tiny(p0))
    return torch.where(both_pos, 1.0, torch.where(both_neg, 0.0,
                                                  torch.clamp(frac, 0.0, 1.0)))


def _corner_plane(p00, p10, p01, p11):
    """The linearized level set of a unit square from its corners: (gx,
    gy, pc) and the PLIC line (m1, m2, alpha) of its fluid side reflected
    onto positive m, the normal's 1-norm guarded by the dtype's tiny
    (reference solid.py:52-58, :113-126: 1e-300, so a saddle square, gx =
    gy = 0 with corners of both signs, gives 0/0 = NaN in float32)."""
    gx = 0.5 * ((p10 + p11) - (p00 + p01))
    gy = 0.5 * ((p01 + p11) - (p00 + p10))
    pc = 0.25 * (p00 + p01 + p10 + p11)
    mx, my = -gx, -gy
    alpha = pc + 0.5 * (mx + my)
    norm = torch.abs(mx) + torch.abs(my) + _tiny(pc)
    return (gx, gy, pc) + vof.positive_normal(mx / norm, my / norm,
                                              alpha / norm)


def _all_signs(p00, p10, p01, p11):
    allpos = (p00 > 0) & (p01 > 0) & (p10 > 0) & (p11 > 0)
    allneg = (p00 <= 0) & (p01 <= 0) & (p10 <= 0) & (p11 <= 0)
    return allpos, allneg


def _face_fraction_2d(p00, p10, p01, p11):
    """Fluid area fraction of a square face from its 4 corner level-set
    values (the 2D cell machinery on one 3D face; reference solid.py:46-
    62, src/solid.c:385-601)."""
    m1, m2, a = _corner_plane(p00, p10, p01, p11)[3:]
    f = vof.line_area_positive(m1, m2, a)
    allpos, allneg = _all_signs(p00, p10, p01, p11)
    return torch.where(allpos, 1.0, torch.where(allneg, 0.0,
                                                torch.clamp(f, 0.0, 1.0)))


def solid_fractions(grid: Grid, phi, device=None, dtype=torch.float64):
    """(a, s): the cell volume fractions and the per-axis face fractions
    (face shapes) of the fluid {phi > 0} (reference solid.py:65-94,
    gfs_domain_init_solid_fractions src/solid.c:970)."""
    device = default_device(device)
    a = vof.fraction_from_levelset(grid, phi, device=device, dtype=dtype)
    if grid.dim == 3:
        pv = phi(*(torch.as_tensor(c, dtype=dtype, device=device)
                   for c in np.meshgrid(*(grid.axis_faces(k)
                                          for k in range(3)), indexing="ij")))
        sx = _face_fraction_2d(pv[:, :-1, :-1], pv[:, 1:, :-1],
                               pv[:, :-1, 1:], pv[:, 1:, 1:])
        sy = _face_fraction_2d(pv[:-1, :, :-1], pv[1:, :, :-1],
                               pv[:-1, :, 1:], pv[1:, :, 1:])
        sz = _face_fraction_2d(pv[:-1, :-1, :], pv[1:, :-1, :],
                               pv[:-1, 1:, :], pv[1:, 1:, :])
        return a, (sx.contiguous(), sy.contiguous(), sz.contiguous())
    pv = _vertex_values(grid, phi, device, dtype)
    # x faces span the vertices (i, j)-(i, j+1), y faces (i, j)-(i+1, j)
    sx = _edge_fraction(pv[:, :-1], pv[:, 1:])
    sy = _edge_fraction(pv[:-1, :], pv[1:, :])
    return a, (sx.contiguous(), sy.contiguous())


def _check_2d(grid: Grid, what: str):
    if grid.dim != 2:
        raise NotImplementedError(f"{what} is 2D, as the reference's is "
                                  "(gerris_tpu/physics/solid.py:105)")


def _cells(pv):
    """The four corner arrays of every cell from the vertex values."""
    return pv[:-1, :-1], pv[1:, :-1], pv[:-1, 1:], pv[1:, 1:]


def surface_geometry(grid: Grid, phi, device=None, dtype=torch.float64):
    """Per cell, the PLIC cut segment's length and the distance from the
    cell centre to the surface line, both in units of h, the distance at
    least 0.05; the length 0 outside mixed cells (reference solid.py:97-
    150, src/fluid.h:54-59, src/poisson.c:561-586)."""
    _check_2d(grid, "surface_geometry")
    device = default_device(device)
    corners = _cells(_vertex_values(grid, phi, device, dtype))
    m1, m2, a = _corner_plane(*corners)[3:]
    tiny = _tiny(a)
    # the cut's intersections with the x = 0, 1 and y = 0, 1 edges
    pts = []
    for x0 in (0.0, 1.0):
        y0 = (a - m1 * x0) / torch.where(m2 == 0, tiny, m2)
        pts.append((torch.full_like(y0, x0), y0, (y0 >= 0.0) & (y0 <= 1.0)))
    for y0 in (0.0, 1.0):
        x0 = (a - m2 * y0) / torch.where(m1 == 0, tiny, m1)
        pts.append((x0, torch.full_like(x0, y0), (x0 >= 0.0) & (x0 <= 1.0)))
    # the segment: the largest distance between two valid intersections
    length = torch.zeros_like(a)
    for i in range(4):
        for j in range(i + 1, 4):
            xi, yi, oki = pts[i]
            xj, yj, okj = pts[j]
            d = torch.sqrt((xi - xj) ** 2 + (yi - yj) ** 2)
            length = torch.maximum(length, torch.where(oki & okj, d, 0.0))
    dist = torch.abs(0.5 * (m1 + m2) - a) / (torch.sqrt(m1 * m1 + m2 * m2)
                                             + tiny)
    allpos, allneg = _all_signs(*corners)
    mixed = ~allpos & ~allneg & (length > 1e-6)
    return torch.where(mixed, length, 0.0), torch.clamp(dist, min=0.05)


def dirichlet_terms(grid: Grid, phi, u_s, device=None, dtype=torch.float64):
    """(dia_s, rhs_s) adding the embedded Dirichlet flux ell (u_s - u) /
    (d h^2) to the operator div(s grad u) - dia u = rhs: dia += dia_s, rhs
    += rhs_s.  ``u_s``: a constant or a callable f(x, y) of the cell
    centres (reference solid.py:153-168)."""
    length, dist = surface_geometry(grid, phi, device, dtype)
    dia_s = length / (dist * (grid.h * grid.h))
    if callable(u_s):
        us = u_s(*(torch.as_tensor(c, dtype=dtype, device=length.device)
                   for c in grid.centers))
    else:
        us = u_s
    return dia_s, -dia_s * us


class DirichletSurface:
    """The embedded Dirichlet condition of one static level set (2D).

    The flux through the cut segment is ell (u_p - u_s) / d_p, u_s the
    boundary value at the centre's projection on the surface and u_p the
    solution sampled bilinearly at a probe d_p = 1.2 h beyond it along the
    inward normal, split as ell / d_p [(u_c - u_s) implicit + (u_p - u_c)
    explicit] so that the implicit operator keeps the 5-point stencil
    (reference solid.py:171-253, src/poisson.c:561-586, src/fluid.c:
    778-1000).  The probes' four gather indices and bilinear weights are
    kept for the mixed cells only, the only cells whose probe the
    reference reads (every use is where(mixed, ...)), as flat indices on
    the device: a probe is four gathers of those cells."""

    def __init__(self, grid: Grid, phi, dp_cells: float = 1.2, device=None,
                 dtype=torch.float64):
        _check_2d(grid, "DirichletSurface")
        device = default_device(device)
        self.grid = grid
        self.a, self.s = solid_fractions(grid, phi, device, dtype)
        gx, gy, pc = _corner_plane(*_cells(
            _vertex_values(grid, phi, device, dtype)))[:3]
        mnorm = torch.sqrt(gx * gx + gy * gy) + _tiny(pc)
        # inward normal (into the fluid {phi > 0}) and the signed distance
        # (cells) from the centre to the surface along it
        nx, ny = gx / mnorm, gy / mnorm
        dsurf = -pc / mnorm
        self.length, _ = surface_geometry(grid, phi, device, dtype)
        self.mixed = self.length > 0.0
        h = grid.h
        x, y = center_coords(grid, device, dtype)
        sx_ = x + dsurf * nx * h
        sy_ = y + dsurf * ny * h
        self.surf_xy = (sx_, sy_)
        self.dp = dp_cells * h
        px = sx_ + nx * self.dp
        py = sy_ + ny * self.dp
        n0, n1 = grid.shape
        fx = torch.clamp((px - grid.origin[0]) / h - 0.5, 0.0, n0 - 1.001)
        fy = torch.clamp((py - grid.origin[1]) / h - 0.5, 0.0, n1 - 1.001)
        i0 = torch.floor(fx)
        j0 = torch.floor(fy)
        wx, wy = fx - i0, fy - j0
        self.dia = torch.where(self.mixed, self.length / (dp_cells * h * h),
                               0.0)
        cells = torch.nonzero(self.mixed.reshape(-1)).squeeze(1)
        i0 = i0.reshape(-1)[cells].long()
        j0 = j0.reshape(-1)[cells].long()
        i1 = torch.clamp(i0 + 1, max=n0 - 1)
        j1 = torch.clamp(j0 + 1, max=n1 - 1)
        wx, wy = wx.reshape(-1)[cells], wy.reshape(-1)[cells]
        self._cells = cells
        self._nb = (i0 * n1 + j0, i1 * n1 + j0, i0 * n1 + j1, i1 * n1 + j1)
        self._w = ((1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy,
                   wx * wy)
        self._dia = self.dia.reshape(-1)[cells]

    def _probe_cells(self, u):
        uf = u.reshape(-1)
        w, nb = self._w, self._nb
        return (w[0] * uf[nb[0]] + w[1] * uf[nb[1]] + w[2] * uf[nb[2]]
                + w[3] * uf[nb[3]])

    def probe(self, u):
        """The bilinear probe value of cell field ``u`` at each mixed
        cell's probe point, 0 at the other cells."""
        out = torch.zeros_like(u)
        out.view(-1)[self._cells] = self._probe_cells(u)
        return out

    def correction(self, u, scale=1.0):
        """where(mixed, scale dia (probe(u) - u), 0): the explicit part of
        the deferred correction (reference solid.py:241-242, models/ns.py:
        811-813)."""
        out = torch.zeros_like(u)
        out.view(-1)[self._cells] = (scale * self._dia) * (
            self._probe_cells(u) - u.reshape(-1)[self._cells])
        return out

    def surface_value(self, u_s, t: float = 0.0):
        """u_s at the surface points: a constant, or a callable f(x, y)
        of torch tensors."""
        if callable(u_s):
            return u_s(*self.surf_xy)
        return u_s

    def solve(self, rhs_pointwise, u_s, fbc, params, u0=None, t: float = 0.0,
              outer: int = 4):
        """div(s grad u) = a f with u = u_s on the embedded surface:
        ``outer`` solves, each with the probe correction of the last
        (reference solid.py:228-253)."""
        from ..solvers import poisson

        base = self.a * rhs_pointwise - self.dia * self.surface_value(u_s, t)
        u = torch.zeros_like(base) if u0 is None else u0
        stats = None
        for _ in range(outer):
            u, stats = poisson.solve(u, base + self.correction(u), self.grid,
                                     fbc, params, alpha=self.s, dia=self.dia,
                                     t=t)
        return u, stats


def poisson_dirichlet_solve(rhs_pointwise, grid: Grid, phi, u_s, fbc, params,
                            u0=None, outer: int = 4):
    """Poisson with the value ``u_s`` on the embedded surface {phi = 0}
    (fluid {phi > 0}), the test/dirichlet class, on the device and dtype
    of ``rhs_pointwise``.  Returns (u, stats, a, s)."""
    ds = DirichletSurface(grid, phi, device=rhs_pointwise.device,
                          dtype=rhs_pointwise.dtype)
    u, stats = ds.solve(rhs_pointwise, u_s, fbc, params, u0=u0, outer=outer)
    return u, stats, ds.a, ds.s


def poisson_solid_solve(rhs_pointwise, grid: Grid, phi, fbc, params,
                        u0=None):
    """Poisson in the fluid region around an embedded solid with the
    natural Neumann condition on its surface: div(s grad u) = a f with the
    fluid-volume-weighted mean removed (reference solid.py:268-285, GfsPoisson
    src/simulation.c:2156-2310), 2D or 3D, on the device and dtype of
    ``rhs_pointwise``.  Returns (u, stats, a, s)."""
    from ..solvers import poisson

    a, s = solid_fractions(grid, phi, rhs_pointwise.device,
                           rhs_pointwise.dtype)
    rhs = a * rhs_pointwise
    rhs = rhs - a * (rhs.sum() / torch.clamp(a.sum(), min=_tiny(a)))
    u = torch.zeros_like(rhs) if u0 is None else u0
    u, stats = poisson.solve(u, rhs, grid, fbc, params, alpha=s)
    return u, stats, a, s


# ---------------------------------------------------------------------------
# The merged-cell update (reference solid.py:288-358, src/advection.c:595-851)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MergeGroups:
    """The merge groups of one (a, s): the cells of the groups (each of two
    or more) as ``members`` (flat indices, grouped, each group in
    increasing index order), ``index`` (groups, the largest group's size)
    member positions into ``members`` padded with len(members) (a zero
    slot), and ``group`` each member's row.  The cells of no group are
    their own singletons."""
    members: torch.Tensor
    index: torch.Tensor
    group: torch.Tensor

    @property
    def ngroups(self) -> int:
        return self.index.shape[0]


def _merge_targets(a, s, cut=None):
    """(small, target): the small cut cells (a / s_d < 1/2 through some
    open face, among the cells ``cut``: by default 0 < a < 1) and each
    cell's best neighbour's flat index, a full neighbour through an open
    face before the mixed one of largest a (the first in the order x lo,
    x hi, y lo, y hi[, z lo, z hi] among equals, and x lo when none
    qualifies), as the reference picks them (solid.py:318-347,
    src/advection.c:595-667).  With a metric, ``a`` and ``s`` are the
    products of the fractions and the metric's factors, and ``cut`` the
    cells the solid cuts: the C merges cut cells only (trap of the
    reference, ROADMAP Queue 3)."""
    dim = a.dim()
    shape = a.shape
    flat = torch.arange(a.numel(), device=a.device).reshape(shape)
    pad_a = torch.nn.functional.pad(a, (1, 1) * dim)   # 0 outside: never
    score, targets = [], []
    small = torch.zeros(shape, dtype=torch.bool, device=a.device)
    for ax in range(dim):
        s_lo = s[ax].narrow(ax, 0, shape[ax])
        s_hi = s[ax].narrow(ax, 1, shape[ax])
        ctr = [slice(1, -1)] * dim
        lo, hi = list(ctr), list(ctr)
        lo[ax] = slice(0, -2)
        hi[ax] = slice(2, None)
        for s_d in (s_lo, s_hi):
            small = small | ((s_d > 0.0)
                             & (a / torch.clamp(s_d, min=1e-30) < 0.5))
        for s_d, a_nb, shift in ((s_lo, pad_a[tuple(lo)], -1),
                                 (s_hi, pad_a[tuple(hi)], 1)):
            ok = (s_d > 0.0) & (a_nb > 0.0)
            score.append(torch.where(ok, a_nb + 1e6 * (a_nb >= 1.0), -1.0))
            targets.append(torch.roll(flat, -shift, ax))
    small = small & ((a > 0.0) & (a < 1.0) if cut is None else cut)
    best = torch.argmax(torch.stack(score), dim=0)
    tgt = torch.gather(torch.stack(targets), 0, best[None])[0]
    return small, tgt


def merge_groups(a, s, cut=None) -> MergeGroups:
    """The transitive merge groups of the small cut cells (among ``cut``,
    _merge_targets), on the device of ``a`` in two host reads whatever
    the groups' sizes or the chains' lengths: the linked cells (the small
    ones and their targets; nonzero), then the count of groups and the
    largest.  Each small cell links to one target, so a group (a
    connected component of the links) holds one root, a target that is
    not small, or one cycle, a mutual pair or longer; ceil(log2(count))
    passes of pointer doubling take every cell to its root or round its
    cycle, carrying the least slot on the way, and each group is labelled
    by its least flat index.  Rows are the groups in increasing least
    index, each group's members in increasing flat index (so
    merged_cell_update sums them in the same order on every run).  The
    reference (solid.py:350-351) follows each cell's target two hops
    only, so a mutual pair of small cells, or a chain of more than four,
    does not end in one group (ROADMAP Queue 3); the C builds the full
    transitive merge (src/advection.c:613-667), as this does."""
    dev = a.device
    n = a.numel()
    small, tgt = _merge_targets(a, s, cut)
    small, tgt = small.reshape(-1), tgt.reshape(-1)
    linked = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    linked[:n] = small
    linked.index_put_((torch.where(small, tgt, n),),
                      torch.ones((), dtype=torch.bool, device=dev))
    members = torch.nonzero(linked[:n]).squeeze(1)
    count = members.numel()
    slots = torch.arange(count, device=dev)
    # each small member's target's slot (members are sorted), else its own
    nxt = torch.where(small[members],
                      torch.searchsorted(members, tgt[members]), slots)
    least = slots
    for _ in range(max(count - 1, 1).bit_length()):
        least = torch.minimum(least, least[nxt])
        nxt = nxt[nxt]
    # the least slot of each cell's root or cycle, then of its group
    root = least[nxt]
    label = torch.full((count,), count, dtype=torch.long, device=dev)
    label = label.scatter_reduce(0, root, slots, "amin")[root]
    order = torch.sort(label, stable=True).indices
    members, label = members[order], label[order]
    first = torch.ones(count, dtype=torch.bool, device=dev)
    first[1:] = label[1:] != label[:-1]
    group = torch.cumsum(first, 0) - 1
    pos = slots - torch.cummax(torch.where(first, slots, 0), 0).values
    ngroups, width = torch.stack([first.sum(), torch.cat(
        [pos, pos.new_zeros(1)]).max() + 1]).tolist()
    index = torch.full((ngroups, width), count, dtype=torch.long, device=dev)
    index[group, pos] = slots
    return MergeGroups(members=members, index=index, group=group)


def _row_sums(rows):
    """Each row's sum, its columns added left to right."""
    out = rows[:, 0]
    for k in range(1, rows.shape[1]):
        out = out + rows[:, k]
    return out


def cell_update(v, fv, a):
    """(a v + fv) / a on the cells of a > 0, v elsewhere: the advection
    update of a cell that merges with none (merged_cell_update's
    singletons; the whole update where no solid cuts a cell)."""
    return torch.where(a > 0.0, (a * v + fv) / torch.clamp(a, min=1e-30), v)


def merged_cell_update(v, fv, a, s, groups: MergeGroups = None):
    """The merged-cell advection update: every member of a merge group
    takes the group's fluid-volume-weighted average w = sum(a v + fv) /
    sum(a), and every other fluid cell (a singleton group) (a v + fv) / a;
    cells with a = 0 keep v (reference solid.py:288-358,
    gfs_advection_update src/advection.c:784-851).  ``fv``: the
    accumulated increment (the flux sum, not yet divided by a).
    ``groups``: merge_groups(a, s), built here when not given.  A group's
    sums run over its members left to right (_row_sums), so they give the
    same bits on every run; the reference's scatter-add has no fixed
    order on the card."""
    if groups is None:
        groups = merge_groups(a, s)
    num = a * v + fv
    w = num / torch.clamp(a, min=1e-30)
    if groups.ngroups:
        nf, af = num.reshape(-1), a.reshape(-1)
        zero = torch.zeros(1, dtype=v.dtype, device=v.device)
        gnum = _row_sums(torch.cat([nf[groups.members], zero])[groups.index])
        gden = _row_sums(torch.cat([af[groups.members], zero])[groups.index])
        w.view(-1)[groups.members] = (gnum / torch.clamp(gden, min=1e-30))[
            groups.group]
    return torch.where(a > 0.0, w, v)
