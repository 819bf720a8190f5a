"""K13 ``rbgs_relax_3d``: the 3D smoother's CUDA wrapper and the 3D
stencils' plain versions.

Port of gerris_tpu/ops/pallas/rbgs3d.py: ``nsweeps`` red-black
Gauss-Seidel sweeps (red = global (i+j+k) even, red half first) on
(L7 - dia) u = rhs, L7 the 7-point Laplacian and dia a scalar, with
homogeneous ghosts ghost = sgn * u per side, sides ordered (x lo, x hi,
y lo, y hi, z lo, z hi), -1 Dirichlet and +1 Neumann.  The kernel is in
``gerris_tpu_torch/csrc/rbgs3d.cu`` (one launch per half-sweep, in
place); it takes a contiguous (n0, n1, n2) float32/float64 field of any
shape.  The wrapper, as those of ops/cuda/rbgs.py:
* for CPU tensors returns the plain PyTorch version below (the CPU tests
  and the card-side reference in chip_smoke.py use it);
* for CUDA tensors launches the kernel on the current stream and counts
  the call in ``LAUNCHES``, or raises.  There is no fallback.

The plain versions (torch.roll + torch.where, the style of
ops/cuda/rbgs.py) also serve the torch routes of the 3D multigrid
(solvers/poisson.py): the residual, the trilinear prolongation, and the
sweeps on periodic sides or with inhomogeneous ghosts (ghost = sgn * u +
off per side), which the reference takes outside its kernel too.
"""
from __future__ import annotations

import torch

from .rbgs import _call, _on_cpu, doubles

# K13 calls, and the half-sweep launches they make (2 * nsweeps each)
LAUNCHES = {"rbgs_relax_3d": 0, "rbgs_relax_3d.half_sweep": 0}

HOMOGENEOUS = (0.0,) * 6
NOT_PERIODIC = (False, False, False)


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -----------------------------------------------------------------------------
# Plain versions
# -----------------------------------------------------------------------------

def axis_neighbours(u, axis, signs, offs=HOMOGENEOUS, periodic=False):
    """(lo, hi): the neighbours of every cell along ``axis`` of an n-D
    field, with ghost = signs[2 axis + side] * u + offs[...] at the domain
    edges, or wrapped on a periodic axis (reference
    gerris_tpu/solvers/poisson.py:_shifted_neighbor)."""
    lo, hi = torch.roll(u, 1, axis), torch.roll(u, -1, axis)
    if periodic:
        return lo, hi
    n = u.shape[axis]
    shape = [1] * u.dim()
    shape[axis] = n
    idx = torch.arange(n, device=u.device).reshape(shape)
    lo = torch.where(idx == 0, signs[2 * axis] * u + offs[2 * axis], lo)
    hi = torch.where(idx == n - 1, signs[2 * axis + 1] * u
                     + offs[2 * axis + 1], hi)
    return lo, hi


def neighbour_sum(u, signs, offs=HOMOGENEOUS, periodic=NOT_PERIODIC):
    """xm + xp + ym + yp + zm + zp (in that order) of every cell."""
    nb = 0.0
    for axis in range(u.dim()):
        lo, hi = axis_neighbours(u, axis, signs, offs, periodic[axis])
        nb = nb + lo + hi
    return nb


def red_cells(shape, device):
    """The red colour, global (i+j+k) even, as a boolean field."""
    i, j, k = (torch.arange(n, device=device) for n in shape)
    return ((i.view(-1, 1, 1) + j.view(1, -1, 1) + k.view(1, 1, -1))
            % 2) == 0


def rbgs3d_plain(u, rhs, nsweeps, h2, inv_denom, signs,
                 periodic=NOT_PERIODIC, omega=1.0, offs=HOMOGENEOUS):
    """``nsweeps`` red-black sweeps, red half first, on (L7 - dia) u = rhs
    with inv_denom = 1 / (6 + dia h2); ghosts sgn * u + off, or wrapped
    on a periodic axis."""
    red = red_cells(u.shape, u.device)
    for _ in range(nsweeps):
        for color in (red, ~red):
            nb = neighbour_sum(u, signs, offs, periodic)
            new = (nb - h2 * rhs) * inv_denom
            if omega != 1.0:
                new = (1.0 - omega) * u + omega * new
            u = torch.where(color, new, u)
    return u


def rbgs_relax_3d_plain(u, rhs, dia=0.0, *, nsweeps, h2, signs, omega=1.0):
    return rbgs3d_plain(u, rhs, nsweeps, h2, 1.0 / (6.0 + dia * h2), signs,
                        omega=omega)


# -----------------------------------------------------------------------------
# Wrapper
# -----------------------------------------------------------------------------

def _check(t, name, shape=None):
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {t.dtype}, want float32/float64")
    if t.dim() != 3 or min(t.shape) < 1:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want (n0, n1, n2)")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def rbgs_relax_3d(u, rhs, dia=0.0, *, nsweeps, h2, signs, omega=1.0):
    """K13: ``nsweeps`` red-black sweeps from ``u`` on (L7 - dia) u = rhs
    with homogeneous ghosts sgn * u (``signs`` per side, x lo .. z hi);
    returns the new u (u itself is left as it was).  On the card: one
    launch per half-sweep."""
    _check(u, "u")
    _check(rhs, "rhs", u.shape)
    if len(signs) != 6:
        raise ValueError(f"signs: {len(signs)} values, want 6")
    if _on_cpu(u, rhs):
        return rbgs_relax_3d_plain(u, rhs, dia, nsweeps=nsweeps, h2=h2,
                                   signs=signs, omega=omega)
    n0, n1, n2 = u.shape
    out = torch.empty_like(u)
    _call("rbgs_relax_3d", u.dtype, u.device, u.data_ptr(), rhs.data_ptr(),
          out.data_ptr(), n0, n1, n2, int(nsweeps), float(h2),
          1.0 / (6.0 + float(dia) * h2), float(omega), doubles(*signs))
    LAUNCHES["rbgs_relax_3d"] += 1
    LAUNCHES["rbgs_relax_3d.half_sweep"] += 2 * int(nsweeps)
    return out
