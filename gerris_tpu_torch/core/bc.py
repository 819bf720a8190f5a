"""Boundary conditions applied as ghost-cell padding
(port of gerris_tpu/core/bc.py; constant BC values only).

Ghost-cell formulas follow the reference (src/boundary.c):
* Dirichlet: ghost = 2*b - interior;
* Neumann:   ghost = interior -/+ g * (2k-1) h for ghost layer k;
* Periodic:  wrap-around copy.
``homogeneous=True`` gives the zero-valued variants used by the multigrid
correction sweeps.  Callable (space/time dependent) values, Navier slip
and contact angles are outside this slice and raise.
"""
from __future__ import annotations

import dataclasses

import torch

from .grid import Grid

DIRICHLET = "dirichlet"
NEUMANN = "neumann"
PERIODIC = "periodic"
_KINDS = (DIRICHLET, NEUMANN, PERIODIC)


@dataclasses.dataclass(frozen=True)
class BC:
    kind: str
    value: float = 0.0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise NotImplementedError(
                f"BC kind {self.kind!r} is not ported yet "
                "(ROADMAP Queue 1, slices 3-4)")
        if callable(self.value):
            raise NotImplementedError(
                "callable BC values are not ported yet (ROADMAP Queue 1, "
                "slice 7); the port takes constant values only")
        object.__setattr__(self, "value", float(self.value))


def Dirichlet(value: float = 0.0) -> BC:
    return BC(DIRICHLET, value)


def Neumann(grad: float = 0.0) -> BC:
    return BC(NEUMANN, grad)


def Periodic() -> BC:
    return BC(PERIODIC)


def bc_value(b: BC) -> float:
    """BC value for static-offset ghost consumers (the kernels' "ghost =
    sgn*mirror + off" encoding).  The reference maps a contact angle to
    0 here; contact angles are not ported, so this is the plain value."""
    return b.value


@dataclasses.dataclass(frozen=True)
class FieldBC:
    """One BC per (axis, side): ``sides[axis][side]``, side 0=low, 1=high."""

    sides: tuple

    @staticmethod
    def uniform(bc: BC, dim: int = 2) -> "FieldBC":
        return FieldBC(tuple((bc, bc) for _ in range(dim)))

    @staticmethod
    def make(dim: int = 2, default: BC = None, **named) -> "FieldBC":
        """Build from side names: left/right (x), bottom/top (y),
        back/front (z)."""
        default = default if default is not None else Neumann()
        names = {"left": (0, 0), "right": (0, 1), "bottom": (1, 0),
                 "top": (1, 1), "back": (2, 0), "front": (2, 1)}
        sides = [[default, default] for _ in range(dim)]
        for k, bc in named.items():
            ax, sd = names[k]
            if ax < dim:
                sides[ax][sd] = bc
        return FieldBC(tuple(tuple(s) for s in sides))

    def is_periodic(self, axis: int) -> bool:
        return self.sides[axis][0].kind == PERIODIC


def default_scalar_bc(dim: int = 2) -> FieldBC:
    """Reference default: symmetry (zero-Neumann) on solid box walls."""
    return FieldBC.uniform(Neumann(), dim)


def grad_bc(u_bc: FieldBC) -> FieldBC:
    """BC for pressure(-gradient) fields: periodic where the domain is
    periodic, symmetric (Neumann 0) otherwise."""
    return FieldBC(tuple(
        tuple(Periodic() if b.kind == PERIODIC else Neumann() for b in ax)
        for ax in u_bc.sides))


def _ghost(interior: torch.Tensor, b: BC, side: int, k: int, h: float,
           homogeneous: bool) -> torch.Tensor:
    """Ghost layer k (1-based) from the interior layer mirrored through
    the boundary face."""
    v = 0.0 if homogeneous else b.value
    if b.kind == DIRICHLET:
        return 2.0 * v - interior
    step = v * (2 * k - 1) * h
    return interior + step if side else interior - step


def edge_extend(a: torch.Tensor, axis: int, width: int) -> torch.Tensor:
    """Extend ``a`` by ``width`` copies of its edge values along ``axis``."""
    n = a.shape[axis]
    idx = torch.arange(-width, n + width, device=a.device).clamp(0, n - 1)
    return a.index_select(axis, idx)


def apply_bc(field: torch.Tensor, grid: Grid, fbc: FieldBC, width: int = 1,
             homogeneous: bool = False, corners: bool = True,
             axes=None) -> torch.Tensor:
    """Return ``field`` padded with ``width`` ghost layers per the BCs.

    ``corners=True`` pads axis by axis in the order ``axes`` (default 0,
    1[, 2]), so corner ghosts are ghosts of ghosts; ``axes=(1, 0)`` is the
    CUDA kernels' order (csrc/stencil.cuh: a corner ghost is the row ghost
    of a column ghost).  ``corners=False`` is the reference's SPMD-native
    variant: each axis' ghost slabs come from the unpadded field,
    edge-extended along the other axes, the later axis overwriting the
    corners.  All give the reference's values bit for bit off the
    corners."""
    if not corners:
        return _apply_bc_nocorner(field, grid, fbc, width, homogeneous)
    out = field
    for axis in (range(grid.dim) if axes is None else axes):
        lo_bc, hi_bc = fbc.sides[axis]
        n = out.shape[axis]
        if fbc.is_periodic(axis):
            out = torch.cat([out.narrow(axis, n - width, width), out,
                             out.narrow(axis, 0, width)], dim=axis)
            continue
        lo, hi = [], []
        for k in range(1, width + 1):
            lo.append(_ghost(out.narrow(axis, k - 1, 1), lo_bc, 0, k,
                             grid.h, homogeneous))
            hi.append(_ghost(out.narrow(axis, n - k, 1), hi_bc, 1, k,
                             grid.h, homogeneous))
        out = torch.cat(lo[::-1] + [out] + hi, dim=axis)
    return out


def _apply_bc_nocorner(field, grid, fbc, width, homogeneous):
    n = field.shape
    g = field.new_zeros(tuple(s + 2 * width for s in n))
    g[tuple(slice(width, width + s) for s in n)] = field
    for axis in range(grid.dim):
        lo_bc, hi_bc = fbc.sides[axis]
        per = fbc.is_periodic(axis)
        for k in range(1, width + 1):
            if per:
                lo = field.narrow(axis, n[axis] - k, 1)
                hi = field.narrow(axis, k - 1, 1)
            else:
                lo = _ghost(field.narrow(axis, k - 1, 1), lo_bc, 0, k,
                            grid.h, homogeneous)
                hi = _ghost(field.narrow(axis, n[axis] - k, 1), hi_bc, 1, k,
                            grid.h, homogeneous)
            for a in range(grid.dim):
                if a != axis:
                    lo = edge_extend(lo, a, width)
                    hi = edge_extend(hi, a, width)
            g.narrow(axis, width - k, 1).copy_(lo)
            g.narrow(axis, width + n[axis] + k - 1, 1).copy_(hi)
    return g


def apply_face_bc(f: torch.Tensor, grid: Grid, fbc: FieldBC, axis: int,
                  homogeneous: bool = False) -> torch.Tensor:
    """Overwrite the two boundary slabs of a face-shaped array with the
    Dirichlet value (Neumann/periodic keep the computed values).  Writes
    in place — the callers own the freshly computed face array — and
    returns ``f``."""
    n = f.shape[axis]
    for side in (0, 1):
        bc = fbc.sides[axis][side]
        if bc.kind != DIRICHLET:
            continue
        f.narrow(axis, 0 if side == 0 else n - 1, 1).fill_(
            0.0 if homogeneous else bc.value)
    return f
