"""K13 ``rbgs_relax_3d``: the 3D smoother's CUDA wrapper and the 3D
stencils' plain versions.

Port of gerris_tpu/ops/pallas/rbgs3d.py: ``nsweeps`` red-black
Gauss-Seidel sweeps (red = global (i+j+k) even, red half first) on
(L7 - dia) u = rhs, L7 the 7-point Laplacian and dia a scalar, with
homogeneous ghosts ghost = sgn * u per side, sides ordered (x lo, x hi,
y lo, y hi, z lo, z hi), -1 Dirichlet and +1 Neumann.  The start value is
a given u, or the trilinear prolongation of a coarse correction
(``coarse=``), and the result may have a field added (``add=``): every
upward level of a 3D correction is then one call.  The kernel is in
``gerris_tpu_torch/csrc/rbgs3d.cu`` (one launch per call, every
half-sweep inside it, on a persistent grid with a grid barrier between
the half-sweeps); it takes a contiguous (n0, n1, n2) float32/float64
field of any shape.
The wrapper, as those of ops/cuda/rbgs.py:
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

from .rbgs import _call, _on_cpu, doubles, pointers

# K13 calls, the kernel launches they make (one each), and the calls that
# prolonged a coarse correction at placement
LAUNCHES = {"rbgs_relax_3d": 0, "rbgs_relax_3d.launch": 0,
            "rbgs_relax_3d.prolong": 0}

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


def prolong3d_plain(c, signs, periodic=NOT_PERIODIC):
    """Trilinear prolongation coarse -> fine with homogeneous ghosts
    (reference: gerris_tpu/solvers/poisson.py:379-390): axis 0, then 1,
    then 2, each step 0.75 a + 0.25 nb of the partly prolonged array, the
    fine cell 2c taking the low neighbour and 2c + 1 the high one; ghosts
    sgn * a + 0.0 at a domain edge, or wrapped on a periodic axis.  The
    body of solvers/poisson.py:prolong in 3D, and K13's placement with
    ``coarse=`` rounds as it does."""
    a = c
    for axis in range(3):
        lo, hi = axis_neighbours(a, axis, signs, periodic=periodic[axis])
        shape = list(a.shape)
        shape[axis] *= 2
        a = torch.stack([0.75 * a + 0.25 * lo, 0.75 * a + 0.25 * hi],
                        axis + 1).reshape(shape)
    return a


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


def rbgs_relax_3d_plain(u, rhs, dia=0.0, *, nsweeps, h2, signs, omega=1.0,
                        coarse=None, add=None):
    """K13's function: from ``u``, or with u None from
    prolong3d_plain(coarse), ``nsweeps`` sweeps, then + ``add``."""
    if u is None:
        u = prolong3d_plain(coarse, signs)
    du = rbgs3d_plain(u, rhs, nsweeps, h2, 1.0 / (6.0 + dia * h2), signs,
                      omega=omega)
    return du if add is None else add + du


# -----------------------------------------------------------------------------
# Wrapper
# -----------------------------------------------------------------------------

# the launch's defaults: threads per block, bricks of rows a block walks
THREADS = 512
BRICK = (4, 8)


def plan(blocks=None, threads=None, brick=None):
    """(blocks, threads, brick) of a K13 launch: as many blocks of THREADS
    as fit on the card (``blocks`` 0), walking bricks of BRICK rows, at
    every level (the fastest of the candidates timed at 32^3, 64^3 and
    128^3, PERF.md).  The knobs are test-only: the result is the same bit
    for bit for every block count, thread count (256 or 512) and brick."""
    threads = THREADS if threads is None else threads
    if threads not in (256, 512):
        raise ValueError(f"threads {threads}, want 256 or 512")
    brick = tuple(brick or BRICK)
    if len(brick) != 2 or min(brick) < 1:
        raise ValueError(f"brick {brick}: want two sizes >= 1")
    return blocks or 0, threads, brick


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


def rbgs_relax_3d(u, rhs, dia=0.0, *, nsweeps, h2, signs, omega=1.0,
                  coarse=None, add=None, blocks=None, threads=None,
                  brick=None):
    """K13: ``nsweeps`` red-black sweeps on (L7 - dia) u = rhs with
    homogeneous ghosts sgn * u (``signs`` per side, x lo .. z hi), from
    ``u``, or with u None from the trilinear prolongation of ``coarse``
    (a (n0/2, n1/2, n2/2) correction, prolong3d_plain's rounding); returns
    the new u, + ``add`` when given (u, coarse and add are left as they
    were).  On the card: one launch (``plan``; blocks, threads and brick
    are test-only knobs)."""
    if (u is None) == (coarse is None):
        raise ValueError("give exactly one of u and coarse")
    _check(rhs, "rhs")
    shape = tuple(rhs.shape)
    if u is not None:
        _check(u, "u", shape)
    else:
        if any(n % 2 for n in shape):
            raise ValueError(f"coarse: rhs shape {shape} is not even")
        _check(coarse, "coarse", tuple(n // 2 for n in shape))
    if add is not None:
        _check(add, "add", shape)
    if len(signs) != 6:
        raise ValueError(f"signs: {len(signs)} values, want 6")
    if _on_cpu(u, coarse, rhs, add):
        return rbgs_relax_3d_plain(u, rhs, dia, nsweeps=nsweeps, h2=h2,
                                   signs=signs, omega=omega, coarse=coarse,
                                   add=add)
    nb, nt, (bi, bj) = plan(blocks, threads, brick)
    out = torch.empty_like(rhs)
    # du lives in device memory between half-sweeps: out itself, or its
    # own buffer when out receives add + du
    work = out if add is None else torch.empty_like(rhs)
    src = coarse if u is None else u
    n0, n1, n2 = shape
    _call("rbgs_relax_3d", rhs.dtype, rhs.device,
          pointers((src, rhs, add, work, out)), int(u is None), n0, n1, n2,
          int(nsweeps), float(h2), 1.0 / (6.0 + float(dia) * h2),
          float(omega), doubles(*signs), int(nb), int(nt), int(bi), int(bj))
    LAUNCHES["rbgs_relax_3d"] += 1
    LAUNCHES["rbgs_relax_3d.launch"] += 1
    LAUNCHES["rbgs_relax_3d.prolong"] += int(u is None)
    return out
