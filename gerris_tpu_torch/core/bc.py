"""Boundary conditions applied as ghost-cell padding
(port of gerris_tpu/core/bc.py).

Ghost-cell formulas follow the reference (src/boundary.c):
* Dirichlet: ghost = 2*b - interior;
* Neumann:   ghost = interior -/+ g * (2k-1) h for ghost layer k;
* Periodic:  wrap-around copy.
``homogeneous=True`` gives the zero-valued variants used by the multigrid
correction sweeps.  A Dirichlet or Neumann value is a constant or a
callable ``f(x, y[, t])`` of torch tensors (space/time dependent values,
evaluated at time ``t`` at the boundary face centres by ``apply_bc`` and
``apply_face_bc``); the kernels' static ghost encoding takes constants
only (``static_values``), so a configuration with a callable value takes
the torch routes.  A Navier side (slip length lambda, a constant) has
the ghost (2 lambda - h) / (2 lambda + h) * interior, homogeneous or
not; a contact-angle side pads as a mirror (the angle acts in
physics/vof.py only).  The kernels take neither: ``kernel_ghosts``.
"""
from __future__ import annotations

import dataclasses

import torch

from .grid import Grid

DIRICHLET = "dirichlet"
NEUMANN = "neumann"
PERIODIC = "periodic"
NAVIER = "navier"
CONTACT = "contact"
_KINDS = (DIRICHLET, NEUMANN, PERIODIC, NAVIER, CONTACT)


@dataclasses.dataclass(frozen=True)
class BC:
    kind: str
    value: float = 0.0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown BC kind {self.kind!r}")
        if self.kind == NAVIER and callable(self.value):
            raise ValueError("a Navier slip length is a constant (the "
                             "reference reads it with float())")
        if not callable(self.value):
            object.__setattr__(self, "value", float(self.value))


def Dirichlet(value: float = 0.0) -> BC:
    return BC(DIRICHLET, value)


def Neumann(grad: float = 0.0) -> BC:
    return BC(NEUMANN, grad)


def Periodic() -> BC:
    return BC(PERIODIC)


def Navier(slip_length: float = 0.0) -> BC:
    """Navier slip, u = lambda du/dn at the wall (GfsBcNavier,
    src/boundary.c; gerris_tpu/core/bc.py:61-66): lambda = 0 is no-slip,
    lambda -> infinity free slip."""
    return BC(NAVIER, slip_length)


def Contact(angle=90.0) -> BC:
    """A contact angle in degrees for a VOF fraction, a constant or a
    function of the wall-face coordinates and t (GfsBcAngle,
    src/boundary.c:412-457; gerris_tpu/core/bc.py:78-86).  The fraction
    pads as a mirror; the angle acts on the normals, the sweep fluxes and
    the heights in physics/vof.py."""
    return BC(CONTACT, angle)


def navier_factor(b: BC, h: float) -> float:
    """The Navier ghost's factor (2 lambda - h) / (2 lambda + h) at cell
    size ``h`` (gerris_tpu/core/bc.py:206-209)."""
    return (2.0 * b.value - h) / (2.0 * b.value + h)


def bc_value(b: BC) -> float:
    """BC value for static-offset ghost consumers (the kernels' "ghost =
    sgn*mirror + off" encoding): a contact angle pads as a mirror, value
    0 (gerris_tpu/core/bc.py:69-76).  A callable value has no static
    offset: the callers check ``static_values`` first."""
    if b.kind == CONTACT:
        return 0.0
    if callable(b.value):
        raise ValueError("a callable BC value has no static ghost offset")
    return b.value


def has_kind(fbc: "FieldBC", kind: str) -> bool:
    return any(b.kind == kind for ax in fbc.sides for b in ax)


def static_values(fbc: "FieldBC") -> bool:
    """True when every side's ghost is a constant factor times the mirror
    plus a constant: no callable value, a contact angle's aside (it pads
    as a mirror whatever the angle).  The torch routes' shifted
    neighbours take such BCs (reference: poisson.residual's static_ok
    and _bc_values_static)."""
    return not any(callable(b.value) and b.kind != CONTACT
                   for ax in fbc.sides for b in ax)


def kernel_ghosts(fbc: "FieldBC", homogeneous: bool = False) -> bool:
    """True when the kernels' ghost encoding (sgn = -1 or 1, a constant
    offset) takes the BCs: static values (or ``homogeneous`` ghosts) and
    no Navier side, whose factor the kernels do not take
    (gerris_tpu/solvers/poisson.py:193, 245; ops/pallas/bcg.py:
    423-425)."""
    return not has_kind(fbc, NAVIER) and (homogeneous or static_values(fbc))


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


def velocity_bc(component: int, dim: int = 2) -> FieldBC:
    """The reference's default wall for a velocity component: Dirichlet 0
    on the walls normal to it, Neumann 0 (free slip) on the others
    (gerris_tpu/core/bc.py:125-132)."""
    return FieldBC(tuple((Dirichlet(0.0), Dirichlet(0.0)) if ax == component
                         else (Neumann(), Neumann()) for ax in range(dim)))


def grad_bc(u_bc: FieldBC) -> FieldBC:
    """BC for pressure(-gradient) fields: periodic where the domain is
    periodic, symmetric (Neumann 0) otherwise."""
    return FieldBC(tuple(
        tuple(Periodic() if b.kind == PERIODIC else Neumann() for b in ax)
        for ax in u_bc.sides))


def _ghost(interior: torch.Tensor, b: BC, side: int, k: int, h: float,
           homogeneous: bool, v=None) -> torch.Tensor:
    """Ghost layer k (1-based) from the interior layer mirrored through
    the boundary face; ``v``: the value evaluated on the slab (a callable
    BC), else the constant.  A Navier side: its factor times the
    interior, homogeneous or not; a contact side: the mirror."""
    if b.kind == NAVIER:
        return navier_factor(b, h) * interior
    if b.kind == CONTACT:
        return interior
    if homogeneous:
        v = 0.0
    elif v is None:
        v = b.value
    if b.kind == DIRICHLET:
        return 2.0 * v - interior
    step = v * (2 * k - 1) * h
    return interior + step if side else interior - step


def _boundary_coords(grid: Grid, axis: int, side: int, pad: list,
                     like: torch.Tensor) -> tuple:
    """Coordinates of the face centres of one boundary slab, as tensors of
    ``like``'s dtype and device broadcastable to the slab: the boundary
    plane along ``axis`` (a one-element tensor); cell centres along the
    other axes, extended by the ghost layers ``pad[a]`` already added on
    axis a (reference gerris_tpu/core/bc.py:_boundary_coords)."""
    coords = []
    for a in range(grid.dim):
        if a == axis:
            coords.append(like.new_full((1,) * grid.dim,
                                        grid.boundary_coord(axis, side)))
            continue
        i = torch.arange(-pad[a], grid.shape[a] + pad[a], dtype=like.dtype,
                         device=like.device)
        shape = [1] * grid.dim
        shape[a] = i.numel()
        coords.append((grid.origin[a] + (i + 0.5) * grid.h).reshape(shape))
    return tuple(coords)


def _eval(value, coords, t=0.0):
    """A callable value at ``coords`` (with the time t when it takes
    one), or the constant (reference gerris_tpu/core/bc.py:_eval)."""
    if callable(value):
        try:
            return value(*coords, t)
        except TypeError:
            return value(*coords)
    return value


def edge_extend(a: torch.Tensor, axis: int, width: int) -> torch.Tensor:
    """Extend ``a`` by ``width`` copies of its edge values along ``axis``."""
    n = a.shape[axis]
    idx = torch.arange(-width, n + width, device=a.device).clamp(0, n - 1)
    return a.index_select(axis, idx)


def apply_bc(field: torch.Tensor, grid: Grid, fbc: FieldBC, width: int = 1,
             homogeneous: bool = False, corners: bool = True,
             axes=None, t: float = 0.0) -> torch.Tensor:
    """Return ``field`` padded with ``width`` ghost layers per the BCs.

    ``corners=True`` pads axis by axis in the order ``axes`` (default 0,
    1[, 2]), so corner ghosts are ghosts of ghosts; ``axes=(1, 0)`` is the
    CUDA kernels' order (csrc/stencil.cuh: a corner ghost is the row ghost
    of a column ghost).  ``corners=False`` is the reference's SPMD-native
    variant: each axis' ghost slabs come from the unpadded field,
    edge-extended along the other axes, the later axis overwriting the
    corners.  All give the reference's values bit for bit off the
    corners.  A callable value is evaluated at time ``t`` on each slab's
    boundary face centres: with corners the slab spans the ghost layers
    already added, without them the unpadded field's (reference
    gerris_tpu/core/bc.py:182-300)."""
    if not corners:
        return _apply_bc_nocorner(field, grid, fbc, width, homogeneous, t)
    out = field
    pad = [0] * grid.dim
    for axis in (range(grid.dim) if axes is None else axes):
        lo_bc, hi_bc = fbc.sides[axis]
        n = out.shape[axis]
        if fbc.is_periodic(axis):
            out = torch.cat([out.narrow(axis, n - width, width), out,
                             out.narrow(axis, 0, width)], dim=axis)
            pad[axis] = width
            continue
        lo, hi = [], []
        for k in range(1, width + 1):
            vals = _slab_values(grid, fbc, axis, homogeneous, pad, field, t)
            g_lo = _ghost(out.narrow(axis, k - 1, 1), lo_bc, 0, k, grid.h,
                          homogeneous, vals[0])
            g_hi = _ghost(out.narrow(axis, n - k, 1), hi_bc, 1, k, grid.h,
                          homogeneous, vals[1])
            lo.append(g_lo.expand_as(out.narrow(axis, 0, 1)))
            hi.append(g_hi.expand_as(out.narrow(axis, 0, 1)))
        out = torch.cat(lo[::-1] + [out] + hi, dim=axis)
        pad[axis] = width
    return out


def _slab_values(grid, fbc, axis, homogeneous, pad, like, t):
    """The (lo, hi) values of one axis' callable BCs on their boundary
    slabs at time ``t`` (None for a constant, or with homogeneous)."""
    return [None if homogeneous or not callable(b.value)
            or b.kind == CONTACT else
            _eval(b.value, _boundary_coords(grid, axis, sd, pad, like), t)
            for sd, b in enumerate(fbc.sides[axis])]


def _apply_bc_nocorner(field, grid, fbc, width, homogeneous, t):
    n = field.shape
    g = field.new_zeros(tuple(s + 2 * width for s in n))
    g[tuple(slice(width, width + s) for s in n)] = field
    for axis in range(grid.dim):
        lo_bc, hi_bc = fbc.sides[axis]
        per = fbc.is_periodic(axis)
        vals = None if per else _slab_values(grid, fbc, axis, homogeneous,
                                             [0] * grid.dim, field, t)
        for k in range(1, width + 1):
            if per:
                lo = field.narrow(axis, n[axis] - k, 1)
                hi = field.narrow(axis, k - 1, 1)
            else:
                lo = _ghost(field.narrow(axis, k - 1, 1), lo_bc, 0, k,
                            grid.h, homogeneous, vals[0])
                hi = _ghost(field.narrow(axis, n[axis] - k, 1), hi_bc, 1, k,
                            grid.h, homogeneous, vals[1])
                if vals != [None, None]:    # a value of the slab's shape
                    shape = list(field.shape)
                    shape[axis] = 1
                    lo, hi = lo.expand(shape), hi.expand(shape)
            for a in range(grid.dim):
                if a != axis:
                    lo = edge_extend(lo, a, width)
                    hi = edge_extend(hi, a, width)
            g.narrow(axis, width - k, 1).copy_(lo)
            g.narrow(axis, width + n[axis] + k - 1, 1).copy_(hi)
    return g


def apply_face_bc(f: torch.Tensor, grid: Grid, fbc: FieldBC, axis: int,
                  homogeneous: bool = False, t: float = 0.0) -> torch.Tensor:
    """Overwrite the two boundary slabs of a face-shaped array with the
    Dirichlet value (Neumann/periodic keep the computed values), a
    callable one evaluated at time ``t`` on the boundary face centres
    (reference gerris_tpu/core/bc.py:apply_face_bc).  Writes in place —
    the callers own the freshly computed face array — and returns
    ``f``."""
    n = f.shape[axis]
    for side in (0, 1):
        bc = fbc.sides[axis][side]
        if bc.kind != DIRICHLET:
            continue
        slab = f.narrow(axis, 0 if side == 0 else n - 1, 1)
        if homogeneous or not callable(bc.value):
            slab.fill_(0.0 if homogeneous else bc.value)
        else:
            slab.copy_(torch.as_tensor(
                _eval(bc.value, _boundary_coords(grid, axis, side,
                                                 [0] * grid.dim, f), t),
                dtype=f.dtype, device=f.device).expand_as(slab))
    return f
