"""Block-sparse composite multigrid: the AMR Poisson solve with its cost
proportional to the leaves (port of gerris_tpu/solvers/blockmg.py).

Each level stores only its active blocks, a ``[nblocks, B, B]`` tensor;
the topology lives in index tables built on the host (``BlockMesh``,
numpy, Morton-ordered with core/blocks.py's keys) and uploaded once.
The device work is gathers and elementwise torch on the blocks:
  halo fill (same-level gather, parent-interpolated at patch edges)
      <- the fine-coarse ghosts of gfs_face_gradient (src/fluid.c:905);
  reflux scatter <- the fine->coarse face-gradient sum of the residual
      (src/poisson.c:634-747);
  restrict / prolong via child / parent gathers <- get_from_below /
      get_from_above (src/poisson.c:1005-1068);
  the dense base-level solve <- the tree below the shallowest leaf.
The base level's correction is the uniform solver's (its kernels where
its dispatch takes them); the block sweeps are torch, as the reference's
are jnp.  2D, one unit box, Dirichlet / Neumann box sides.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..core.device import default_device
from ..core.grid import Grid
from ..core import bc as bcs
from ..core.blocks import morton_encode_2d
from . import poisson
from .composite import _dilate_max, grade_depth_map

OPP = (1, 0, 3, 2)


@dataclasses.dataclass
class BlockMesh:
    """Host-built block tables of one adaptive mesh.  Level l has
    2**l / B blocks per axis, each of B x B cells of size size / 2**l."""
    B: int
    lmin: int
    lmax: int
    base: Grid                      # the cell grid at lmin
    lv: dict                        # level -> {name: numpy index array}

    @staticmethod
    def build(base: Grid, lmax: int, depth_cells: np.ndarray, B: int = 8):
        """``depth_cells``: the target level of every finest cell (or of
        every finest block).  A block's depth is the largest of its
        cells'; the block map is graded 2:1, and deepened until adjacent
        leaf blocks differ by at most one level (where the reference's
        stops at the map's grading: ROADMAP Queue 3)."""
        lmin = base.level
        if tuple(base.extents) != (1, 1):
            raise ValueError("blockmg: single-box domains")
        nfb = (1 << lmax) // B
        D = np.asarray(depth_cells, np.int32)
        if D.shape[0] == (1 << lmax):
            D = D.reshape(nfb, B, nfb, B).max(axis=(1, 3))
        Db = grade_depth_map(np.maximum(D, lmin))
        # the depth map's grading bounds neighbouring finest blocks, not
        # the leaves: a leaf takes the deepest of its finest blocks, so
        # two adjacent leaves may differ by more than one level, and a
        # fine block's ghosts then find neither a same-level nor a
        # parent-level neighbour (the reference's block engine diverges
        # from 5 levels on).  Deepen the map until the leaves' levels
        # differ by at most one between (8-)neighbours.
        while True:
            masks = _block_leaves(Db, lmin, lmax, nfb)
            L = np.zeros_like(Db)
            for l, m in masks.items():
                rep = 1 << (lmax - l)
                L = np.where(m.repeat(rep, 0).repeat(rep, 1), l, L)
            Dn = np.maximum(Db, _dilate_max(L) - 1)
            if np.array_equal(Dn, Db):
                break
            Db = Dn
        cov = {lmax: np.zeros_like(masks[lmax])}
        acc = masks[lmax]
        for l in range(lmax - 1, lmin - 1, -1):
            cov[l] = acc.reshape(acc.shape[0] // 2, 2, -1, 2).any(
                axis=(1, 3))
            acc = masks[l] | cov[l]
        active = {l: masks[l] | cov[l] for l in range(lmin, lmax + 1)}
        lv, slot_of = {}, {}
        for l in range(lmin, lmax + 1):
            bx, by = np.nonzero(active[l])
            order = np.argsort(morton_encode_2d(bx, by))
            bx, by = bx[order], by[order]
            slot = -np.ones(active[l].shape, np.int64)
            slot[bx, by] = np.arange(len(bx))
            slot_of[l] = slot
            lv[l] = {"bx": bx, "by": by,
                     "leaf": masks[l][bx, by].astype(np.bool_)}
        DIRS = np.array([[-1, 0], [1, 0], [0, -1], [0, 1]])
        for l in range(lmin, lmax + 1):
            d = lv[l]
            n = len(d["bx"])
            nb = np.full((n, 4), -1, np.int64)
            pnb = np.full((n, 4), -1, np.int64)
            bnd = np.zeros((n, 4), np.bool_)
            nbl = active[l].shape[0]
            for k in range(4):
                qx = d["bx"] + DIRS[k, 0]
                qy = d["by"] + DIRS[k, 1]
                inside = (qx >= 0) & (qx < nbl) & (qy >= 0) & (qy < nbl)
                bnd[:, k] = ~inside
                s = slot_of[l][np.clip(qx, 0, nbl - 1),
                               np.clip(qy, 0, nbl - 1)]
                nb[:, k] = np.where(inside, s, -1)
                if l > lmin:
                    ps = slot_of[l - 1][np.clip(qx // 2, 0, nbl // 2 - 1),
                                        np.clip(qy // 2, 0, nbl // 2 - 1)]
                    pnb[:, k] = np.where(inside & (s < 0), ps, -1)
            d["nbr"], d["pnbr"], d["bnd"] = nb, pnb, bnd
            if l > lmin:
                d["parent"] = slot_of[l - 1][d["bx"] // 2, d["by"] // 2]
                d["parity"] = np.stack([d["bx"] & 1, d["by"] & 1], 1)
            if l < lmax:
                ch = np.full((n, 2, 2), -1, np.int64)
                nf = active[l + 1].shape[0]
                for cx in (0, 1):
                    for cy in (0, 1):
                        fx, fy = 2 * d["bx"] + cx, 2 * d["by"] + cy
                        ok = (fx < nf) & (fy < nf)
                        ch[:, cx, cy] = np.where(
                            ok, slot_of[l + 1][np.clip(fx, 0, nf - 1),
                                               np.clip(fy, 0, nf - 1)], -1)
                d["children"] = ch
        return BlockMesh(B=B, lmin=lmin, lmax=lmax, base=base, lv=lv)

    def grid(self, l: int) -> Grid:
        return dataclasses.replace(self.base, level=l)

    def n_active(self) -> int:
        return sum(len(self.lv[l]["bx"]) for l in self.lv) * self.B ** 2

    def n_leaf_cells(self) -> int:
        return sum(int(self.lv[l]["leaf"].sum()) for l in self.lv) \
            * self.B ** 2

    def field_from_fn(self, fn, device=None, dtype=torch.float64
                      ) -> Dict[int, torch.Tensor]:
        """fn(x, y) (numpy) at the cell centres of every active block, as
        tensors on ``device`` (the card by default)."""
        device = default_device(device)
        out = {}
        for l in range(self.lmin, self.lmax + 1):
            d = self.lv[l]
            h = self.grid(l).h
            o = self.base.origin
            ci = (np.arange(self.B) + 0.5) * h
            x = o[0] + d["bx"][:, None, None] * self.B * h + ci[None, :, None]
            y = o[1] + d["by"][:, None, None] * self.B * h + ci[None, None, :]
            out[l] = torch.as_tensor(np.asarray(fn(x + 0 * y, y + 0 * x)),
                                     dtype=dtype, device=device)
        return out

    def to_dense(self, u: Dict[int, torch.Tensor], l: int) -> np.ndarray:
        """Level l's active blocks in the dense level array (zero
        elsewhere), on the host."""
        d = self.lv[l]
        N = self.grid(l).shape[0]
        out = np.zeros((N, N))
        a = u[l].double().cpu().numpy()
        for s in range(len(d["bx"])):
            x0, y0 = d["bx"][s] * self.B, d["by"][s] * self.B
            out[x0:x0 + self.B, y0:y0 + self.B] = a[s]
        return out


def _block_leaves(Db, lmin, lmax, nfb):
    """The leaf blocks per level of a finest-block depth map: a level-l
    block is a leaf where its deepest finest block asks for level l at
    most and its parent is split."""
    Ms = {}
    for l in range(lmax, lmin - 1, -1):
        rep = 1 << (lmax - l)
        Ms[l] = Db.reshape(nfb // rep, rep, nfb // rep, rep).max(axis=(1, 3))
    masks = {}
    for l in range(lmin, lmax + 1):
        leaf = Ms[l] <= l
        if l > lmin:
            leaf &= (Ms[l - 1] > l - 1).repeat(2, 0).repeat(2, 1)
        masks[l] = leaf
    return masks


# ---------------------------------------------------------------------------
# block operations (the index tables are tensors on the device)
# ---------------------------------------------------------------------------

def _interp_strip(c):
    """[n, B/2] coarse strip -> [n, B] fine with the 0.75/0.25 stencil,
    edge-clamped (get_from_above, src/poisson.c:1005)."""
    lo = torch.cat([c[:, :1], c[:, :-1]], dim=1)
    hi = torch.cat([c[:, 1:], c[:, -1:]], dim=1)
    return torch.stack([0.75 * c + 0.25 * lo, 0.75 * c + 0.25 * hi],
                       dim=-1).reshape(c.shape[0], -1)


def _edge(a, k: int, off: int = 0):
    """The edge strip of [n, B, B] blocks on side k (0:-x 1:+x 2:-y 3:+y),
    ``off`` cells in from the face."""
    if k == 0:
        return a[:, off, :]
    if k == 1:
        return a[:, -1 - off, :]
    if k == 2:
        return a[:, :, off]
    return a[:, :, -1 - off]


def _halfsel(idx, k: int, B: int):
    """Per block, the transverse half of the coarse strip it faces on
    side k (from its parity)."""
    if "_half" in idx:
        return idx["_half"][k]
    parity = idx["parity"][:, 1 if k < 2 else 0]
    return parity[:, None] * (B // 2) + torch.arange(
        B // 2, device=parity.device)[None]


def with_helpers(t: dict, B: int) -> dict:
    """A level's tables with the index tensors every halo fill reads
    derived once (on the device, no host read): the neighbours clamped
    to valid slots and their validity, and each side's transverse half
    of the parent strip."""
    out = dict(t)
    for name in ("nbr", "pnbr"):
        out[f"_{name}_ok"] = t[name] >= 0
        out[f"_{name}_c"] = torch.clamp(t[name], min=0)
    if "parity" in t:
        out["_half"] = [_halfsel(t, k, B) for k in range(4)]
    return out


def _coarse_ghosts(up, idx, B: int):
    """Per side, (valid, ghost strip) of the ghosts that the parent level
    ``up`` supplies: 0.75 of the coarse neighbour's edge and 0.25 of the
    own parent's, interpolated to the fine strip (the fine-coarse
    ghosts).  They depend on ``up`` only, so a block sweep computes them
    once for all its half-sweeps."""
    out = []
    for k in range(4):
        sel = _halfsel(idx, k, B)
        c0 = torch.gather(_edge(up, OPP[k])[idx["_pnbr_c"][:, k]], 1, sel)
        c1 = torch.gather(_edge(up, k)[idx["parent"]], 1, sel)
        out.append((idx["_pnbr_ok"][:, k],
                    0.75 * _interp_strip(c0) + 0.25 * _interp_strip(c1)))
    return out


def _halo(u, up, idx, B: int, bvals=None, homogeneous=True, coarse=None):
    """[n, B, B] -> [n, B+2, B+2] with ghosts: the same-level neighbour's
    edge, else the parent level's interpolated edge (``up``: the parent
    level's blocks, None at lmin; or ``coarse``: its _coarse_ghosts), and
    at the box sides the BCs' (``bvals``: (isdir [n, 4], None, dval [n,
    4, B])).  ``idx``: the level's tables with_helpers."""
    n = u.shape[0]
    pad = torch.zeros((n, B + 2, B + 2), dtype=u.dtype, device=u.device)
    pad[:, 1:-1, 1:-1] = u
    if coarse is None and up is not None:
        coarse = _coarse_ghosts(up, idx, B)
    for k in range(4):
        ghost = torch.where(idx["_nbr_ok"][:, k][:, None],
                            _edge(u, OPP[k])[idx["_nbr_c"][:, k]], 0.0)
        if coarse is not None:
            pvalid, fine = coarse[k]
            ghost = torch.where(pvalid[:, None], fine, ghost)
        if bvals is not None:
            isdir, _, dval = bvals
            own = _edge(u, k)
            d = isdir[:, k][:, None]
            bg = torch.where(d, -own, own) if homogeneous else \
                torch.where(d, 2.0 * dval[:, k] - own, own)
            ghost = torch.where(idx["bnd"][:, k][:, None], bg, ghost)
        if k == 0:
            pad[:, 0, 1:-1] = ghost
        elif k == 1:
            pad[:, -1, 1:-1] = ghost
        elif k == 2:
            pad[:, 1:-1, 0] = ghost
        else:
            pad[:, 1:-1, -1] = ghost
    return pad


def _nsum_den(pad, fxy):
    """(sum_d alpha_d u_d, sum_d alpha_d) of the 5-point stencil on padded
    blocks; ``fxy = (fx [n, B+1, B], fy [n, B, B+1])`` face coefficients
    (gfs_poisson_coefficients, src/poisson.c:756-901), or None for unit
    ones."""
    if fxy is None:
        return (pad[:, :-2, 1:-1] + pad[:, 2:, 1:-1] + pad[:, 1:-1, :-2]
                + pad[:, 1:-1, 2:]), 4.0
    fx, fy = fxy
    nsum = (fx[:, :-1, :] * pad[:, :-2, 1:-1]
            + fx[:, 1:, :] * pad[:, 2:, 1:-1]
            + fy[:, :, :-1] * pad[:, 1:-1, :-2]
            + fy[:, :, 1:] * pad[:, 1:-1, 2:])
    den = fx[:, :-1, :] + fx[:, 1:, :] + fy[:, :, :-1] + fy[:, :, 1:]
    return nsum, den


def _lap(pad, h, fxy=None):
    c = pad[:, 1:-1, 1:-1]
    if fxy is None:
        return (pad[:, :-2, 1:-1] + pad[:, 2:, 1:-1] + pad[:, 1:-1, :-2]
                + pad[:, 1:-1, 2:] - 4.0 * c) / (h * h)
    nsum, den = _nsum_den(pad, fxy)
    return (nsum - den * c) / (h * h)


def _restrict_children(u_f, ch):
    """[n_f, B, B] children -> [n_c, B, B], the 2x2 means, for the coarse
    blocks with children (``ch``: [n_c, 2, 2] child slots, -1 absent)."""
    B = u_f.shape[1]
    chc = torch.clamp(ch, min=0)
    quads = []
    for cx in (0, 1):
        row = [u_f[chc[:, cx, cy]].reshape(-1, B // 2, 2, B // 2, 2)
               .mean(dim=(2, 4)) for cy in (0, 1)]
        quads.append(torch.cat(row, dim=2))
    return torch.where((ch[:, 0, 0] >= 0)[:, None, None],
                       torch.cat(quads, dim=1), 0.0)


def _interp_axis(a, axis: int):
    n = a.shape[axis]
    lo = torch.cat([a.narrow(axis, 0, 1), a.narrow(axis, 0, n - 1)], axis)
    hi = torch.cat([a.narrow(axis, 1, n - 1), a.narrow(axis, n - 1, 1)],
                   axis)
    sh = list(a.shape)
    sh[axis] *= 2
    return torch.stack([0.75 * a + 0.25 * lo, 0.75 * a + 0.25 * hi],
                       dim=axis + 1).reshape(sh)


def _prolong_parent(du_c, idxf, B):
    """The parent level's correction -> child blocks: bilinear within the
    parent quadrant, edge-clamped at its borders (get_from_above; relax
    sweeps follow)."""
    pb = du_c[idxf["parent"]]
    h = B // 2
    ar = torch.arange(h, device=pb.device)
    qx = idxf["parity"][:, 0][:, None] * h + ar[None]
    qy = idxf["parity"][:, 1][:, None] * h + ar[None]
    q = torch.gather(pb, 1, qx[:, :, None].expand(-1, -1, B))
    q = torch.gather(q, 2, qy[:, None, :].expand(-1, h, -1))
    return _interp_axis(_interp_axis(q, 1), 2)


def _reflux_to_parent(u_pad, idx, B, n_coarse, h_f, af4=None):
    """Flux-conservative corrections from this fine level into its parent
    level's leaves: the coarse interface gradient replaced by the mean of
    the fine one-sided ones (src/fluid.c:905, src/poisson.c:634-747),
    alpha-weighted with ``af4`` ([n, 4, B] fine boundary-face
    coefficients, the coarse one their pair mean).  Returns [n_coarse, B,
    B] to add to the coarse operator at the leaves."""
    H = 2.0 * h_f
    corr = torch.zeros((n_coarse, B, B), dtype=u_pad.dtype,
                       device=u_pad.device)
    interior = u_pad[:, 1:-1, 1:-1]
    for k in range(4):
        valid = idx["_pnbr_ok"][:, k]
        ghost = _edge(u_pad, k)[:, 1:-1]
        own = _edge(interior, k, 0)
        gf = (ghost - own) / h_f
        own_e1 = _edge(interior, k, 1)
        own_r = 0.25 * (own[:, 0::2] + own[:, 1::2]
                        + own_e1[:, 0::2] + own_e1[:, 1::2])
        cnb = idx["_pn_edge"][:, k]
        if af4 is None:
            gpair = 0.5 * (gf[:, 0::2] + gf[:, 1::2])
            gc = (cnb - own_r) / H
        else:
            af = af4[:, k]
            gfw = af * gf
            gpair = 0.5 * (gfw[:, 0::2] + gfw[:, 1::2])
            gc = 0.5 * (af[:, 0::2] + af[:, 1::2]) * (cnb - own_r) / H
        delta = torch.where(valid[:, None], gpair - gc, 0.0)
        cells = _halfsel(idx, k, B)
        edge = torch.full_like(cells, 0 if OPP[k] in (0, 2) else B - 1)
        ii, jj = (edge, cells) if OPP[k] < 2 else (cells, edge)
        # each coarse edge cell takes one fine pair per side (pad rows and
        # rows without a coarse neighbour add 0 to block 0): a sum in a
        # fixed order, as index_add_'s atomics give it here
        flat = (idx["_pnbr_c"][:, k][:, None] * B + ii) * B + jj
        corr.view(-1).index_add_(0, flat.reshape(-1),
                                 (-delta / H).reshape(-1))
    return corr


def _pn_edge_cache(u_c, idx, B):
    """Per fine block and side, the coarse neighbour's edge cells on its
    transverse half: [n, 4, B/2]."""
    return torch.stack(
        [torch.gather(_edge(u_c, OPP[k])[idx["_pnbr_c"][:, k]], 1,
                      _halfsel(idx, k, B)) for k in range(4)], dim=1)


def _bvals(mesh: BlockMesh, l: int, fbc: bcs.FieldBC, homogeneous, device,
           dtype):
    """(isdir [n, 4], None, dval [n, 4, B]) of level l (callable Dirichlet
    values evaluated at the boundary face centres)."""
    d = mesh.lv[l]
    n, B = len(d["bx"]), mesh.B
    g = mesh.grid(l)
    isdir = np.zeros((n, 4), np.bool_)
    dval = np.zeros((n, 4, B))
    for k in range(4):
        ax, sd = k // 2, k % 2
        b = fbc.sides[ax][sd]
        if b.kind != bcs.DIRICHLET:
            continue
        isdir[:, k] = d["bnd"][:, k]
        if homogeneous:
            continue
        tr = d["by"] if ax == 0 else d["bx"]
        tcoord = mesh.base.origin[1 - ax] + (tr[:, None] * B
                                             + np.arange(B)[None] + 0.5) * g.h
        if callable(b.value):
            bc_coord = np.full_like(tcoord, g.boundary_coord(ax, sd))
            xy = (bc_coord, tcoord) if ax == 0 else (tcoord, bc_coord)
            dval[:, k] = np.asarray(b.value(*xy))
        else:
            dval[:, k] = bcs.bc_value(b)
    return (torch.as_tensor(isdir, device=device), None,
            torch.as_tensor(dval, dtype=dtype, device=device))


def level_tables(mesh: BlockMesh, l: int, device) -> dict:
    """Level l's index tables as tensors on ``device``."""
    d = mesh.lv[l]
    names = ["nbr", "pnbr", "bnd", "leaf"]
    if l > mesh.lmin:
        names += ["parent", "parity"]
    if l < mesh.lmax:
        names.append("children")
    return with_helpers({k: torch.as_tensor(np.ascontiguousarray(d[k]),
                                            device=device) for k in names},
                        mesh.B)


class BlockSolver:
    """Composite multigrid on one block-sparse mesh (built once per mesh,
    its tables on the device)."""

    def __init__(self, mesh: BlockMesh, fbc: bcs.FieldBC,
                 params: poisson.MultilevelParams = None, device=None,
                 dtype=torch.float64):
        self.mesh = mesh
        self.fbc = fbc
        self.params = params or poisson.MultilevelParams()
        device = default_device(device)
        levels = range(mesh.lmin, mesh.lmax + 1)
        self.idx = {l: level_tables(mesh, l, device) for l in levels}
        self.bv = {l: _bvals(mesh, l, fbc, False, device, dtype)
                   for l in levels}
        self.bv0 = {l: _bvals(mesh, l, fbc, True, device, dtype)
                    for l in levels}
        d0 = mesh.lv[mesh.lmin]
        B = mesh.B
        ar = np.arange(B)
        self._ii0 = torch.as_tensor(d0["bx"][:, None, None] * B
                                    + ar[None, :, None], device=device)
        self._jj0 = torch.as_tensor(d0["by"][:, None, None] * B
                                    + ar[None, None, :], device=device)

    def _sync_up(self, u):
        m = self.mesh
        for l in range(m.lmax - 1, m.lmin - 1, -1):
            r = _restrict_children(u[l + 1], self.idx[l]["children"])
            u[l] = torch.where((~self.idx[l]["leaf"])[:, None, None], r, u[l])
        return u

    def leaf_residual(self, u, rhs):
        m = self.mesh
        u = self._sync_up(dict(u))
        res, reflux = {}, {}
        for l in range(m.lmax, m.lmin - 1, -1):
            h = m.grid(l).h
            up = u.get(l - 1)
            idx = dict(self.idx[l])
            if up is not None:
                idx["_pn_edge"] = _pn_edge_cache(up, idx, m.B)
            pad = _halo(u[l], up, idx, m.B, bvals=self.bv[l],
                        homogeneous=False)
            r = rhs[l] - _lap(pad, h)
            if l in reflux:
                r = r - reflux[l]
            if up is not None:
                reflux[l - 1] = _reflux_to_parent(pad, idx, m.B,
                                                  u[l - 1].shape[0], h)
            res[l] = torch.where(idx["leaf"][:, None, None], r, 0.0)
        return res

    def cycle(self, u, rhs):
        m, p, B = self.mesh, self.params, self.mesh.B
        u = self._sync_up(dict(u))
        res = self.leaf_residual(u, rhs)
        r, acc = {}, None
        for l in range(m.lmax, m.lmin - 1, -1):
            rl = res[l]
            if acc is not None:
                rr = _restrict_children(acc, self.idx[l]["children"])
                rl = torch.where((~self.idx[l]["leaf"])[:, None, None], rr,
                                 rl)
            r[l] = acc = rl
        g0 = m.base
        ii, jj = self._ii0, self._jj0
        dense_r = torch.zeros(g0.shape, dtype=r[m.lmin].dtype,
                              device=r[m.lmin].device)
        dense_r[ii, jj] = r[m.lmin]
        du0 = poisson.correction(dense_r, g0, self.fbc, p)
        rl0 = poisson.residual(du0, dense_r, g0, self.fbc, homogeneous=True)
        du0 = du0 + poisson.correction(rl0, g0, self.fbc, p)
        dus = {m.lmin: du0[ii, jj]}
        cb = (torch.arange(B)[:, None] + torch.arange(B)[None, :]) % 2
        for l in range(m.lmin + 1, m.lmax + 1):
            h = m.grid(l).h
            idx = self.idx[l]
            du = _prolong_parent(dus[l - 1], idx, B)
            coarse = _coarse_ghosts(dus[l - 1], idx, B)
            for _ in range(p.nrelax * (p.erelax ** (m.lmax - l))):
                for color in (0, 1):
                    pad = _halo(du, None, idx, B, bvals=self.bv0[l],
                                homogeneous=True, coarse=coarse)
                    nsum, _ = _nsum_den(pad, None)
                    new = (nsum - h * h * r[l]) / 4.0
                    # B is even: a cell's global parity is its local one
                    red = (cb == color).to(du.device)
                    du = torch.where(red, new, du)
            dus[l] = du
        return self._sync_up({l: u[l] + dus[l]
                              for l in range(m.lmin, m.lmax + 1)})

    def solve(self, rhs, u0=None, tol_abs=None, max_cycles=20):
        m = self.mesh
        u = u0 or {l: torch.zeros_like(rhs[l])
                   for l in range(m.lmin, m.lmax + 1)}
        hist = []
        for _ in range(max_cycles):
            u = self.cycle(u, rhs)
            res = self.leaf_residual(u, rhs)
            rinf = max(float(res[l].abs().max()) for l in res)
            hist.append(rinf)
            if tol_abs is not None and rinf < tol_abs:
                break
        return u, hist
