"""Discrete differential operators on uniform grids
(port of gerris_tpu/ops/stencils.py).

Whole-array torch expressions; fields are unpadded cell-centred tensors
unless stated otherwise.
"""
from __future__ import annotations

import torch

from ..core.grid import Grid


def _crop_other(a: torch.Tensor, axis: int) -> torch.Tensor:
    """Crop one ghost layer on all axes except ``axis``."""
    idx = [slice(1, s - 1) for s in a.shape]
    idx[axis] = slice(None)
    return a[tuple(idx)]


def center_gradient(u_pad: torch.Tensor, grid: Grid,
                    axis: int) -> torch.Tensor:
    """Centred gradient (u[i+1] - u[i-1]) / 2h at the cell centres from a
    1-ghost padded field (interior shape).  Reference: src/fluid.c:434
    gfs_center_gradient."""
    a = _crop_other(u_pad, axis)
    n = a.shape[axis]
    return (a.narrow(axis, 2, n - 2) - a.narrow(axis, 0, n - 2)) / (2.0 * grid.h)


def face_gradient(u_pad: torch.Tensor, grid: Grid, axis: int) -> torch.Tensor:
    """Normal gradient at every face of ``axis`` from a 1-ghost padded
    field (face shape).  Reference: src/fluid.c:778 gfs_face_gradient."""
    a = _crop_other(u_pad, axis)
    n = a.shape[axis]
    return (a.narrow(axis, 1, n - 1) - a.narrow(axis, 0, n - 1)) / grid.h


def face_average(u_pad: torch.Tensor, grid: Grid, axis: int) -> torch.Tensor:
    """Mean of the two cells adjacent to each face (face shape)."""
    a = _crop_other(u_pad, axis)
    n = a.shape[axis]
    return 0.5 * (a.narrow(axis, 1, n - 1) + a.narrow(axis, 0, n - 1))


def divergence(fluxes, grid: Grid) -> torch.Tensor:
    """Cell-centred divergence of face-normal fields (``fluxes[axis]``
    has face shape).  Reference: src/fluid.c:2310."""
    out = 0.0
    for axis, f in enumerate(fluxes):
        n = f.shape[axis]
        out = out + (f.narrow(axis, 1, n - 1) - f.narrow(axis, 0, n - 1)) / grid.h
    return out


def laplacian(u_pad: torch.Tensor, grid: Grid, alpha=None) -> torch.Tensor:
    """div(alpha grad u) of a 1-ghost padded field, alpha per axis face
    arrays or None for unit coefficients (the 5-point Laplacian)."""
    fluxes = [face_gradient(u_pad, grid, a) for a in range(grid.dim)]
    if alpha is not None:
        fluxes = [f * a for f, a in zip(fluxes, alpha)]
    return divergence(fluxes, grid)


def norms(e: torch.Tensor, w: torch.Tensor = None) -> dict:
    """Volume-weighted L1/L2/Linf + bias of a cell field (0-d tensors).
    Reference: src/fluid.c gfs_norm_add / gfs_norm_update."""
    if w is None:
        w = torch.ones_like(e)
    tw = w.sum()
    return {"first": (e.abs() * w).sum() / tw,
            "second": torch.sqrt((e * e * w).sum() / tw),
            "infty": e.abs().max(),
            "bias": (e * w).sum() / tw,
            "w": tw}


def unbiased_error(e: torch.Tensor, w: torch.Tensor = None) -> torch.Tensor:
    """Subtract the volume-weighted mean before taking norms
    (reference: src/output.c OutputErrorNorm ``unbiased = 1``)."""
    if w is None:
        w = torch.ones_like(e)
    return e - (e * w).sum() / w.sum()
