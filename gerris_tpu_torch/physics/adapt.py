"""Adaptation criteria and the adapt step (port of
gerris_tpu/physics/adapt.py).

A criterion is a cost field at the finest resolution (a tensor); the
adapt step turns it into a CompositeGrid on the host with the
reference's thresholds: refine where cost > cmax, keep a refined cell
while cost > cmax / cfactor (hysteresis), the 2:1 grading from the mesh
builder (GfsAdapt, src/adaptive.h:38-181; gfs_simulation_adapt,
src/adaptive.c:1445; gradient_cost :545).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.grid import Grid
from ..core import bc as bcs
from ..solvers.composite import CompositeGrid


@dataclasses.dataclass(frozen=True)
class AdaptParams:
    """GfsAdapt's parameters (adaptive.h:38-80): the threshold cmax, its
    hysteresis factor and the level bounds."""
    cmax: float
    cfactor: float = 4.0
    minlevel: int = 4
    maxlevel: int = 8


def gradient_cost(f, grid: Grid, fbc: bcs.FieldBC):
    """|grad f| h (GfsAdaptGradient, adaptive.c:545), 2D."""
    p = bcs.apply_bc(f, grid, fbc, 1)
    gx = (p[2:, 1:-1] - p[:-2, 1:-1]) / 2.0
    gy = (p[1:-1, 2:] - p[1:-1, :-2]) / 2.0
    return torch.sqrt(gx * gx + gy * gy)


def vorticity_cost(U: list, grid: Grid, u_bcs: list):
    """|vorticity| h / max|u| (GfsAdaptVorticity, adaptive.h:98), 2D."""
    from .particles import vorticity_field
    w = vorticity_field(U, grid, u_bcs)
    speed = torch.sqrt(sum(u * u for u in U)).max()
    umax = torch.clamp(speed, min=torch.finfo(speed.dtype).tiny)
    return torch.abs(w) * grid.h / umax


def interface_cost(f):
    """1 at interface cells (test/oscillation's AdaptFunction 'T > 0 && T
    < 1 ? 1 : ...')."""
    return ((f > 1e-6) & (f < 1.0 - 1e-6)).to(f.dtype)


def adapt_mesh(cost_fine, base: Grid, params: AdaptParams,
               previous: Optional[CompositeGrid] = None) -> CompositeGrid:
    """The adapted composite mesh from a cost field at the finest
    resolution (read to the host once): a level-l cell wants children
    while the largest cost under it exceeds cmax, and with a ``previous``
    mesh a cell refined there stays so while it exceeds cmax / cfactor
    (adapt_local / refine_cell_mark, adaptive.c:1351-1449).  2D."""
    cost = cost_fine.double().cpu().numpy() \
        if isinstance(cost_fine, torch.Tensor) else np.asarray(cost_fine)
    nfx = cost.shape[0]
    keep = None
    if previous is not None:
        keep = np.zeros_like(cost, bool)
        for l in range(previous.lmin, previous.lmax + 1):
            if l <= params.minlevel:
                continue
            rep = nfx // previous.grid(l).shape[0]
            keep |= previous.leaf_np(l).repeat(rep, 0).repeat(rep, 1)

    def refine(x, y, l):
        g = dataclasses.replace(base, level=l)
        rep = nfx // g.shape[0]
        m = cost.reshape(g.shape[0], rep, g.shape[1], rep).max(axis=(1, 3))
        want = m > params.cmax
        if keep is not None:
            kl = keep.reshape(g.shape[0], rep, g.shape[1], rep).any(
                axis=(1, 3))
            want |= kl & (m > params.cmax / params.cfactor)
        return want

    b = dataclasses.replace(base, level=params.minlevel)
    return CompositeGrid.from_refine_fn(b, params.maxlevel, refine)


def resample(u: dict, old: CompositeGrid, new: CompositeGrid,
             fbc: bcs.FieldBC) -> dict:
    """A composite field carried onto a new mesh: synced on the old one,
    its level arrays copied (a level the old mesh lacks prolonged from the
    next coarser one), then synced on the new one (the refine / coarsen
    cell init, gfs_cell_fine_init, src/variable.h:46)."""
    from ..solvers import composite as comp
    from ..solvers.amr import prolong_bc
    u = comp.sync(u, old, fbc)
    out = {}
    for l in range(new.lmin, new.lmax + 1):
        if l in u:
            out[l] = u[l]
            continue
        src = max(k for k in u if k < l)
        v = u[src]
        for ll in range(src, l):
            v = prolong_bc(v, dataclasses.replace(new.base, level=ll), fbc,
                           homogeneous=False)
        out[l] = v
    return comp.sync(out, new, fbc)
