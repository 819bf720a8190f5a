"""The block engine with runtime tables: composite solves whose work is
proportional to the leaves inside the adaptive NS step (port of
gerris_tpu/solvers/blockrt.py).

The tables of solvers/blockmg.py are padded to per-level capacities
(``bucket``: at least 8, ~25% steps) and travel as ordinary tensors, so
an adaptation rebuilds them on the host (numpy) and uploads them once;
pad rows are inert (neighbours and children -1, leaf / active False,
parent 0).  The relaxation and residual work per cycle is that of the
active blocks, as the reference relaxes leaves only (src/poisson.c:
604-631).  2D, one unit box, constant Dirichlet / Neumann sides; unit or
per-face ``alpha`` blocks and a scalar or per-cell ``dia``.  The sweeps
are torch, as the reference's are jnp; the base level's correction is the
uniform solver's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..core.device import default_device, upload
from ..core.grid import Grid
from ..core import bc as bcs
from . import poisson
from .blockmg import (BlockMesh, _coarse_ghosts, _halo, _lap, _nsum_den,
                      _restrict_children, _prolong_parent, _reflux_to_parent,
                      _pn_edge_cache, with_helpers)


def bucket(n: int) -> int:
    """A level's block capacity: at least 8, in ~25% steps, 8-aligned, so
    the tables' shapes change only when the active count crosses a
    bucket and the padded work stays below ~25%."""
    c = 8
    while c < n:
        c = -(-int(c * 1.25) // 8) * 8
    return c


def build_tables(mesh: BlockMesh, caps: Optional[Dict[int, int]] = None,
                 device=None):
    """A BlockMesh's per-level tables padded to capacity, built in numpy
    and uploaded to ``device`` in one copy.  Returns (tables, caps);
    ``tables[l]["n"]`` is the level's active block count (a host int: its
    rows come first)."""
    caps = dict(caps or {})
    host = {}
    counts = {}
    for l in range(mesh.lmin, mesh.lmax + 1):
        d = mesh.lv[l]
        n = len(d["bx"])
        cap = caps.get(l) or (n if l == mesh.lmin else bucket(n))
        caps[l] = cap
        if cap < n:
            raise ValueError(f"level {l}: capacity {cap} < {n} blocks")

        def pad(a, fill):
            out = np.full((cap,) + a.shape[1:], fill, a.dtype)
            out[:n] = a
            return out

        t = {"bx": pad(d["bx"].astype(np.int64), 0),
             "by": pad(d["by"].astype(np.int64), 0),
             "active": np.arange(cap) < n,
             "leaf": pad(d["leaf"], False), "nbr": pad(d["nbr"], -1),
             "pnbr": pad(d["pnbr"], -1), "bnd": pad(d["bnd"], False)}
        if l > mesh.lmin:
            t["parent"] = pad(np.maximum(d["parent"], 0), 0)
            t["parity"] = pad(d["parity"], 0)
        if l < mesh.lmax:
            t["children"] = pad(d["children"], -1)
        host.update({(l, k): v for k, v in t.items()})
        counts[l] = n
    dev = upload(host, default_device(device))
    tables = {l: {"n": n} for l, n in counts.items()}
    for (l, k), v in dev.items():
        tables[l][k] = v
    return {l: with_helpers(t, mesh.B) for l, t in tables.items()}, caps


def _cells(t: dict, B: int, wi: int, wj: int, oi: int = 0, oj: int = 0):
    """(ii, jj) broadcast cell indices of each block's wi x wj window
    starting oi, oj cells from its corner: [cap, wi, 1], [cap, 1, wj]."""
    dev = t["bx"].device
    ii = t["bx"][:, None, None] * B + oi + torch.arange(
        wi, device=dev)[None, :, None]
    jj = t["by"][:, None, None] * B + oj + torch.arange(
        wj, device=dev)[None, None, :]
    return ii, jj


def gather_blocks(dense, t: dict, B: int):
    """A dense level array -> [cap, B, B] blocks."""
    return dense[_cells(t, B, B, B)]


def scatter_blocks(dense, u, t: dict, B: int):
    """The active blocks written back into a copy of the dense level array
    (pad rows dropped)."""
    n = t["n"]
    ii, jj = _cells(t, B, B, B)
    out = dense.clone()
    out[ii[:n], jj[:n]] = u[:n]
    return out


def gather_face_blocks(alpha_l, t: dict, B: int):
    """Dense face coefficients ((N+1, N), (N, N+1)) -> (fx [cap, B+1, B],
    fy [cap, B, B+1]): every face a block touches, so the 5-point stencil
    needs no face halo."""
    ax, ay = alpha_l
    return ax[_cells(t, B, B + 1, B)], ay[_cells(t, B, B, B + 1)]


def _edge_alpha(fxy, B: int):
    """[n, 4, B] boundary-face coefficients of each block (sides -x, +x,
    -y, +y) for the alpha-weighted reflux."""
    fx, fy = fxy
    return torch.stack([fx[:, 0, :], fx[:, B, :], fy[:, :, 0], fy[:, :, B]],
                       dim=1)


def _bc_kinds(fbc: bcs.FieldBC):
    """Static (isdir[k], dval[k]) per side k.  A callable value maps to
    0.0, as the reference's does: callers keep such BCs off this engine
    (models/amr_ns.AMRSimulation)."""
    isdir, dval = [], []
    for k in range(4):
        b = fbc.sides[k // 2][k % 2]
        isdir.append(b.kind == bcs.DIRICHLET)
        dval.append(0.0 if callable(b.value)
                    else float(bcs.bc_value(b) or 0.0))
    return tuple(isdir), tuple(dval)


def _bvals_rt(t: dict, isdir, dval, homogeneous: bool, B: int, dtype):
    """(isdir [cap, 4], None, dval [cap, 4, B]) from the tables and the
    static BCs (filled on the device: no host copy).  The values pass
    through float32 on their way, as the reference's do (blockrt.py:158,
    ``astype(jnp.float32)``)."""
    isd = torch.stack([t["bnd"][:, k] & bool(isdir[k]) for k in range(4)],
                      dim=1)
    cap = isd.shape[0]
    dv = torch.stack([torch.full((cap, B), 0.0 if homogeneous
                                 else float(np.float32(dval[k])),
                                 dtype=dtype, device=isd.device)
                      for k in range(4)], dim=1)
    return isd, None, dv


def _relax_blocks(du, r, t, up, bv0, B, h, dia, nswp, fxy=None):
    """nswp red-black sweeps on [cap, B, B] blocks, homogeneous BCs (B is
    even: a cell's global parity is its local (i + j) % 2).  ``dia``: a
    scalar or [cap, B, B]; ``fxy``: face-coefficient blocks or None."""
    ar = torch.arange(B, device=du.device)
    parity = (ar[:, None] + ar[None, :]) % 2
    # the parent level's ghosts do not change during the sweeps
    coarse = None if up is None else _coarse_ghosts(up, t, B)
    for _ in range(nswp):
        for color in (0, 1):
            pad = _halo(du, None, t, B, bvals=bv0, homogeneous=True,
                        coarse=coarse)
            nsum, den = _nsum_den(pad, fxy)
            new = (nsum - h * h * r) / (den + dia * h * h)
            du = torch.where((parity == color)[None], new, du)
    return du


def sync_up(u, tables, lmin, lmax):
    """Restrict fine data into the covered coarse blocks."""
    out = dict(u)
    for l in range(lmax - 1, lmin - 1, -1):
        t = tables[l]
        cov = (~t["leaf"]) & t["active"]
        out[l] = torch.where(cov[:, None, None],
                             _restrict_children(out[l + 1], t["children"]),
                             out[l])
    return out


def leaf_residual(u, rhs, tables, base: Grid, fbck, dia, lmin, lmax, B,
                  caps, alphab=None):
    """The leaf-masked composite residual with the flux-conservative
    reflux at fine-coarse faces (src/poisson.c:634-747, src/fluid.c:905).
    ``dia``: scalar or {level: [cap, B, B]}; ``alphab``: {level: (fx,
    fy)} face-coefficient blocks or None."""
    isdir, dval = fbck
    u = sync_up(dict(u), tables, lmin, lmax)
    res, reflux = {}, {}
    for l in range(lmax, lmin - 1, -1):
        t = tables[l]
        h = base.size / (1 << l)
        up = u.get(l - 1) if l > lmin else None
        idx = dict(t)
        if up is not None:
            idx["_pn_edge"] = _pn_edge_cache(up, t, B)
        bv = _bvals_rt(t, isdir, dval, False, B, u[l].dtype)
        pad = _halo(u[l], up, idx, B, bvals=bv, homogeneous=False)
        fxy = None if alphab is None else alphab[l]
        dl = dia[l] if isinstance(dia, dict) else dia
        r = rhs[l] - _lap(pad, h, fxy) + dl * u[l]
        if l in reflux:
            r = r - reflux[l]
        if up is not None:
            reflux[l - 1] = _reflux_to_parent(
                pad, idx, B, caps[l - 1], h,
                af4=None if fxy is None else _edge_alpha(fxy, B))
        res[l] = torch.where((t["leaf"] & t["active"])[:, None, None], r,
                             0.0)
    return res


def cycle(u, rhs, tables, base: Grid, fbc: bcs.FieldBC,
          params: poisson.MultilevelParams, dia, lmin, lmax, B, caps,
          alphab=None, alpha_dense0=None, dia_dense0=None):
    """One composite sawtooth cycle on the runtime tables.  ``alphab`` /
    ``dia`` may carry per-level face / cell coefficient blocks, and
    ``alpha_dense0`` / ``dia_dense0`` the base level's dense ones for its
    uniform correction."""
    fbck = _bc_kinds(fbc)
    u = sync_up(dict(u), tables, lmin, lmax)
    res = leaf_residual(u, rhs, tables, base, fbck, dia, lmin, lmax, B,
                        caps, alphab=alphab)
    r, acc = {}, None
    for l in range(lmax, lmin - 1, -1):
        t = tables[l]
        rl = res[l]
        if acc is not None:
            cov = (~t["leaf"]) & t["active"]
            rl = torch.where(cov[:, None, None],
                             _restrict_children(acc, t["children"]), rl)
        r[l] = acc = rl
    # the base level is fully active (every cell's depth is >= lmin), so
    # its capacity is its exact block count
    ii, jj = _cells(tables[lmin], B, B, B)
    dense_r = torch.zeros(base.shape, dtype=r[lmin].dtype,
                          device=r[lmin].device)
    dense_r[ii, jj] = r[lmin]
    if dia_dense0 is None:
        if isinstance(dia, dict):
            raise ValueError("per-cell dia blocks need dia_dense0")
        dia0 = dia
    else:
        dia0 = dia_dense0
    du0 = poisson.correction(dense_r, base, fbc, params, dia=dia0,
                             alpha=alpha_dense0)
    rl0 = poisson.residual(du0, dense_r, base, fbc, dia=dia0,
                           homogeneous=True, alpha=alpha_dense0)
    du0 = du0 + poisson.correction(rl0, base, fbc, params, dia=dia0,
                                   alpha=alpha_dense0)
    dus = {lmin: du0[ii, jj]}
    isdir, dval = fbck
    for l in range(lmin + 1, lmax + 1):
        t = tables[l]
        du = _prolong_parent(dus[l - 1], t, B)
        bv0 = _bvals_rt(t, isdir, dval, True, B, du.dtype)
        dus[l] = _relax_blocks(
            du, r[l], t, dus[l - 1], bv0, B, base.size / (1 << l),
            dia[l] if isinstance(dia, dict) else dia,
            params.nrelax * (params.erelax ** (lmax - l)),
            fxy=None if alphab is None else alphab[l])
    return sync_up({l: u[l] + dus[l] for l in range(lmin, lmax + 1)},
                   tables, lmin, lmax)


@dataclasses.dataclass(frozen=True)
class BlockRT:
    """The static part of a runtime-table block solve: the base grid, the
    level range, the block size and the per-level capacities."""
    base: Grid
    lmin: int
    lmax: int
    B: int
    caps: tuple          # ((level, cap), ...)

    @property
    def caps_dict(self):
        return dict(self.caps)


def make_blockrt(base: Grid, lmax: int, depth_cells: np.ndarray, B: int = 8,
                 caps: Optional[dict] = None, device=None):
    """(descriptor, tables, mesh) of a depth map, the tables uploaded to
    ``device`` once.  Give the previous descriptor's caps on a later
    adaptation, so that the tables keep their shapes while the counts fit
    them."""
    mesh = BlockMesh.build(base, lmax, depth_cells, B=B)
    caps = dict(caps or {})
    for l in range(mesh.lmin, mesh.lmax + 1):
        need = len(mesh.lv[l]["bx"])
        if caps.get(l, 0) < need:
            caps[l] = need if l == mesh.lmin else bucket(need)
    tables, caps = build_tables(mesh, caps, device=device)
    rt = BlockRT(base=base, lmin=mesh.lmin, lmax=mesh.lmax, B=B,
                 caps=tuple(sorted(caps.items())))
    return rt, tables, mesh


def demean_leaf(rhs_blocks, tables, rt: BlockRT):
    """Less the leaf-volume-weighted mean (pure-Neumann compatibility,
    GfsPoisson correct_div, src/simulation.c:2156-2186)."""
    tot = vol = 0.0
    for l in rhs_blocks:
        t = tables[l]
        w = (t["leaf"] & t["active"])[:, None, None]
        cv = (rt.base.size / (1 << l)) ** 2
        tot = tot + torch.where(w, rhs_blocks[l], 0.0).sum() * cv
        vol = vol + w.sum().to(rhs_blocks[l].dtype) * (rt.B ** 2) * cv
    mean = tot / torch.clamp(vol, min=torch.finfo(tot.dtype).tiny)
    return {l: rhs_blocks[l] - mean for l in rhs_blocks}


def solve_tol(rhs_blocks, tables, rt: BlockRT, fbc: bcs.FieldBC,
              params: poisson.MultilevelParams, dia=0.0, u0=None,
              alphab=None, alpha_dense0=None, dia_dense0=None):
    """The tolerance-driven block solve (gfs_poisson_solve's semantics,
    src/poisson.c:1225-1269): cycles, one leaf residual each, while i <
    nitermin or (i < nitermax and max|residual| > tolerance * max|leaf
    rhs|), the condition read on the host.  Returns (u_blocks, stats)."""
    from .amr import _tol_loop
    u = u0 if u0 is not None else {
        l: torch.zeros_like(rhs_blocks[l]) for l in rhs_blocks}
    fbck = _bc_kinds(fbc)
    lmin, lmax, B = rt.lmin, rt.lmax, rt.B
    caps = rt.caps_dict
    scale = torch.stack([
        torch.where((tables[l]["leaf"] & tables[l]["active"])[:, None, None],
                    rhs_blocks[l], 0.0).abs().max() for l in rhs_blocks]).max()
    tol = params.tolerance * torch.clamp(scale,
                                         min=torch.finfo(scale.dtype).tiny)

    def rinf_of(uu):
        res = leaf_residual(uu, rhs_blocks, tables, rt.base, fbck, dia,
                            lmin, lmax, B, caps, alphab=alphab)
        return torch.stack([res[l].abs().max() for l in res]).max()

    return _tol_loop(
        u, params,
        lambda uu: cycle(uu, rhs_blocks, tables, rt.base, fbc, params, dia,
                         lmin, lmax, B, caps, alphab=alphab,
                         alpha_dense0=alpha_dense0, dia_dense0=dia_dense0),
        rinf_of, tol)


def solve(rhs_blocks, tables, rt: BlockRT, fbc: bcs.FieldBC,
          params: poisson.MultilevelParams, dia=0.0, u0=None,
          ncycles: int = None, alphab=None, alpha_dense0=None,
          dia_dense0=None):
    """A fixed number of composite cycles on block arrays ({level: [cap,
    B, B]}); ``ncycles`` defaults to max(nitermin, 2)."""
    n = ncycles if ncycles is not None else max(params.nitermin, 2)
    u = u0 if u0 is not None else {
        l: torch.zeros_like(rhs_blocks[l]) for l in rhs_blocks}
    for _ in range(n):
        u = cycle(u, rhs_blocks, tables, rt.base, fbc, params, dia, rt.lmin,
                  rt.lmax, rt.B, rt.caps_dict, alphab=alphab,
                  alpha_dense0=alpha_dense0, dia_dense0=dia_dense0)
    return u


def solve_dense(rhs_dense, tables, rt: BlockRT, fbc: bcs.FieldBC,
                params: poisson.MultilevelParams, dia=0.0, u0_dense=None,
                ncycles: int = None):
    """Dense per-level in and out: the active blocks gathered, solved and
    scattered back (inactive regions keep u0)."""
    B = rt.B
    rhs_b = {l: gather_blocks(rhs_dense[l], tables[l], B) for l in rhs_dense}
    u0_b = None if u0_dense is None else {
        l: gather_blocks(u0_dense[l], tables[l], B) for l in u0_dense}
    u_b = solve(rhs_b, tables, rt, fbc, params, dia=dia, u0=u0_b,
                ncycles=ncycles)
    return {l: scatter_blocks(u0_dense[l] if u0_dense is not None
                              else torch.zeros_like(rhs_dense[l]),
                              u_b[l], tables[l], B) for l in rhs_dense}
