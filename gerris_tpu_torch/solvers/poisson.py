"""Geometric multigrid for (L - dia) u = rhs on uniform 2D and 3D grids
(port of gerris_tpu/solvers/poisson.py).

L is the 5-point (2D) or 7-point (3D) Laplacian, div(alpha grad u) with
per-face coefficients ``alpha`` (one face array per axis) or unit ones,
and dia a scalar or a cell array.  ``solve`` takes the reference's
branches (poisson.py:1090-1162):
* ``ncycles > 0``: that many fixed sawtooth cycles, each the three-step
  fused cycle of the TPU production path (``fused_cycle``: K1 -> K2 ->
  K3) where the BCs allow it (static values, non-periodic rows), else
  residual + ``correction`` per cycle;
* a registry solver (``solver != "multigrid"``, SOLVER_REGISTRY): the
  fine-relax-only ``solve_relax`` (K11 -> K10 -> K11), the
  Jacobi-preconditioned CG ``solve_cg`` and the V-cycle-preconditioned
  flexible CG ``solve_mgcg``, their loop conditions read on the host;
* ``nitermin == nitermax``: that many cycles, looped from the host;
* else the adaptive tolerance loop (``_solve_adaptive``): one residual
  (K11) per cycle, cycles until max|r| <= tolerance * max|rhs| or
  nitermax, at least nitermin, the condition read on the host once per
  cycle.
A cycle's ``correction`` restricts the residual (restrict_pyramid) and
solves the coarsest level by one of three branches: K12 ``coarse_vcycle``
for a level above ``coarse_top`` with non-periodic rows, the dense
eigendecomposed solve at or below ``dense_coarse_max`` unknowns, or
relaxation from zero; then it prolongs and relaxes upward in K3 launches
(u folded into the last), or by ``prolong`` + K10 on periodic rows.
The schedule is what the parameters say on every device: the reference
raises nrelax and coarsest_relax to its ``tpu_nrelax`` floors on the TPU
and caps ``dense_coarse_max`` at 1024 elsewhere; the port takes neither
from the device (utils/convert.params_from_jax applies the floors).

With per-face coefficients or a cell dia (the two-phase projections and
the variable-density diffusion) every branch takes the reference's
generic route: the torch residual, and a ``correction`` that coarsens the
coefficients with the residual (``coarsen_face_coeff``: every second
face, the mean of its transverse pair; the cell dia pooled) down to
``minlevel`` with no K12, dense solve or K3, relaxes there from zero with
nrelax * erelax**(levels) + coarsest_relax sweeps, then prolongs and
relaxes each level upward.  In 2D with face coefficients each level is
one K15 ``rbgs_relax_alpha`` launch: the coarsest from zero, every upward
level with the bilinear prolongation of the coarser one's result placed
in the kernel, and the finest with u added, where the TPU ran K15 at
128^2 and above and the same function in jnp below, prolonging in jnp
between the levels.

The U+V implicit-diffusion pair solves both systems together, every
launch of the cycle serving both (``solve_fixed_batched``, K8a-c;
``solve_relax_pair``, the "relax" solver's fine-relax-only correction,
K8a + K8c).

In 3D the reference runs one kernel, K13 ``rbgs_relax_3d``, and so does
the port (poisson.py:304-319): ``relax`` with homogeneous ghosts and only
Dirichlet/Neumann sides, and every upward level of a correction on such
sides as one K13 launch that places the trilinear prolongation of the
coarser level's du itself (and adds u at the finest).  The residual, the
2x2x2 restriction, the prolongation on periodic sides and the dense
coarsest solve are torch (the reference's generic jnp route); the fused
cycle, K1-K3, K11 and K12 are 2D only, and no fixed 3D schedule is
fused (poisson.py:534-538, :595-598, :648-659).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core.grid import Grid
from ..core import bc as bcs
from ..ops.stencils import norms
from ..ops.cuda import rbgs, rbgs3d

# the fused cycle's cascade stops at min(MIN_N, n/4) cells per side, as
# does K12's
MIN_N = 16
# the fused cycle's and K12's coarsest level always gets at least this
# many sweeps (gerris_tpu poisson.py:568, :683)
COARSEST_FLOOR = 40


@dataclasses.dataclass(frozen=True)
class MultilevelParams:
    """The solver's schedule (reference: GfsMultilevelParams,
    src/poisson.c:40-126, and gerris_tpu MultilevelParams, whose fields
    and defaults these are, without its TPU floor ``tpu_nrelax``).

    tolerance: the adaptive loop stops at max|r| <= tolerance * max|rhs|;
    nrelax: RBGS sweeps per level (times erelax**k at k levels above the
    fine one); minlevel: the coarsest level of the hierarchy; nitermax /
    nitermin: the adaptive loop's cycle bounds; omega: over-relaxation;
    coarsest_relax: extra sweeps from zero at the coarsest level; solver:
    "multigrid" or a SOLVER_REGISTRY name; ncycles: > 0 runs that many
    fixed cycles with no tolerance check, 0 the adaptive loop;
    coarse_top: the level at and below which K12 runs the whole cascade;
    dense_coarse_max: the most unknowns of a dense direct coarsest solve
    (0 disables it); fold_div: a MAC projection's one fixed cycle forms
    its divergence rhs inside its first kernel (K16, solve_fused_div),
    where fold_div_eligible holds; fold_correct: with fold_div, the
    projection's correction also runs inside its last kernel (K17,
    solve_fused_div_correct)."""

    tolerance: float = 1e-3
    nrelax: int = 4
    erelax: int = 1
    minlevel: int = 2
    nitermax: int = 100
    nitermin: int = 1
    omega: float = 1.0
    coarsest_relax: int = 8
    solver: str = "multigrid"
    ncycles: int = 0
    coarse_top: int = 512
    dense_coarse_max: int = 4096
    fold_div: bool = False
    fold_correct: bool = False


@dataclasses.dataclass
class SolveStats:
    """Reference: src/poisson.h output fields.  The residual tensors are
    kept and their norms computed on demand, so an unread statistic costs
    no device work.  ``host_syncs``: the adaptive loop's reads of its
    condition on the host."""
    niter: int
    r_before: torch.Tensor
    r_after: torch.Tensor
    host_syncs: int = 0

    @property
    def residual_before(self) -> dict:
        return norms(self.r_before)

    @property
    def residual_after(self) -> dict:
        return norms(self.r_after)

    def reduction(self):
        # the reference guards with 1e-300, which is 0 in float32
        tiny = torch.finfo(self.r_after.dtype).tiny
        return (self.residual_before["infty"]
                / torch.clamp(self.residual_after["infty"], min=tiny))


def _sign(b: bcs.BC, grid: Grid) -> float:
    if b.kind == bcs.DIRICHLET:
        return -1.0
    return bcs.navier_factor(b, grid.h) if b.kind == bcs.NAVIER else 1.0


def _signs_offs(grid: Grid, fbc: bcs.FieldBC, homogeneous: bool):
    """(signs, offs) ghost encodings (ghost = sign * mirror + off per
    side, sides ordered (x lo, x hi, y lo, y hi[, z lo, z hi]); reference
    poisson.py:628-645).  A Navier side's sign is its factor on ``grid``
    (the torch routes take it; the kernels do not, ``bcs.kernel_ghosts``),
    with no offset."""
    dim = len(fbc.sides)
    signs = tuple(_sign(fbc.sides[ax][sd], grid)
                  for ax in range(dim) for sd in range(2))
    offs = []
    for ax in range(dim):
        for sd in range(2):
            b = fbc.sides[ax][sd]
            if homogeneous or b.kind in (bcs.PERIODIC, bcs.NAVIER):
                offs.append(0.0)
            elif b.kind == bcs.DIRICHLET:
                offs.append(2.0 * bcs.bc_value(b))
            else:
                offs.append((1.0 if sd else -1.0) * bcs.bc_value(b) * grid.h)
    return signs, tuple(offs)


def _periodic(fbc: bcs.FieldBC):
    return tuple(fbc.is_periodic(a) for a in range(len(fbc.sides)))


def _check_2d(grid: Grid):
    if grid.dim != 2:
        raise NotImplementedError("the fused and paired cycles are 2D (the "
                                  "reference's are too)")


def _scalar_dia(dia) -> float:
    """The scalar dia of the unit-coefficient kernels (K1-K3, K8, K10-K12,
    K16, K17), which take no cell dia, as on the TPU."""
    if dia is None:
        return 0.0
    if isinstance(dia, (int, float)):
        return float(dia)
    raise NotImplementedError("a cell dia takes the variable-coefficient "
                              "route (alpha, K15), not this one")


def _variable(alpha, dia) -> bool:
    """Face coefficients or a cell dia: the generic route (K15 in 2D)."""
    return alpha is not None or isinstance(dia, torch.Tensor)


def _shifted(u, grid: Grid, fbc: bcs.FieldBC, homogeneous: bool):
    """Per axis (lo, hi) neighbour values of u, same shape, with the
    static ghosts sgn * mirror + off at non-periodic domain edges
    (reference poisson.py:_shifted_neighbor)."""
    signs, offs = _signs_offs(grid, fbc, homogeneous)
    out = []
    for axis in range(grid.dim):
        n = u.shape[axis]
        lo, hi = torch.roll(u, 1, axis), torch.roll(u, -1, axis)
        if not fbc.is_periodic(axis):
            shape = [1] * grid.dim
            shape[axis] = n
            idx = torch.arange(n, device=u.device).reshape(shape)
            lo = torch.where(idx == 0, signs[2 * axis] * u + offs[2 * axis],
                             lo)
            hi = torch.where(idx == n - 1,
                             signs[2 * axis + 1] * u + offs[2 * axis + 1],
                             hi)
        out.append((lo, hi))
    return out


def _padded(u, grid: Grid, fbc: bcs.FieldBC, homogeneous: bool, t: float):
    """Per axis (lo, hi) neighbours from the padded field (callable BC
    values evaluated at ``t``; reference poisson.py:_neighbor_sums)."""
    p = bcs.apply_bc(u, grid, fbc, 1, homogeneous=homogeneous, t=t)
    out = []
    for axis in range(grid.dim):
        inner = [slice(1, s - 1) for s in p.shape]
        pair = []
        for lo in (0, 2):
            inner[axis] = slice(lo, lo + p.shape[axis] - 2)
            pair.append(p[tuple(inner)])
        out.append(tuple(pair))
    return out


def _neighbor_sums(nbs, alpha):
    """(sum_d alpha_lo u_lo + alpha_hi u_hi, sum_d alpha_lo + alpha_hi)
    per cell, axis by axis in the reference's order (poisson.py:103-133,
    :249-273); unit coefficients when ``alpha`` is None."""
    num = den = 0.0
    for axis, (u_lo, u_hi) in enumerate(nbs):
        if alpha is None:
            num = num + u_lo + u_hi
            den = den + 2.0
            continue
        a = alpha[axis]
        n = a.shape[axis]
        a_lo, a_hi = a.narrow(axis, 0, n - 1), a.narrow(axis, 1, n - 1)
        num = num + a_lo * u_lo + a_hi * u_hi
        den = den + a_lo + a_hi
    return num, den


def _neighbours_of(u, grid, fbc, homogeneous, t):
    if homogeneous or bcs.static_values(fbc):
        return _shifted(u, grid, fbc, homogeneous)
    return _padded(u, grid, fbc, homogeneous, t)


def _residual_generic(u, rhs, grid, fbc, alpha, dia, homogeneous, t):
    """The reference's jnp residual (poisson.py:173-182): face
    coefficients or unit ones, a scalar or cell dia, shifted neighbours
    with static ghosts or the padded field (callable values at ``t``)."""
    num, den = _neighbor_sums(_neighbours_of(u, grid, fbc, homogeneous, t),
                              alpha)
    lap = (num - den * u) / (grid.h * grid.h)
    d = 0.0 if dia is None else dia
    return rhs - (lap - d * u)


def _relax_generic(u, rhs, grid, fbc, nsweeps, alpha, dia, homogeneous,
                   omega, t):
    """The reference's jnp red-black sweeps (poisson.py:321-346) with face
    coefficients or a cell dia: the route of what K15 does not take (3D,
    inhomogeneous ghosts, a cell dia with unit coefficients)."""
    h2 = grid.h * grid.h
    idx = sum(torch.arange(n, device=u.device).reshape(
        [n if a == b else 1 for b in range(grid.dim)])
        for a, n in enumerate(u.shape))
    red = (idx % 2) == 0
    d = 0.0 if dia is None else dia

    def half(u, mask):
        num, den = _neighbor_sums(
            _neighbours_of(u, grid, fbc, homogeneous, t), alpha)
        dd = den + d * h2
        new = (num - h2 * rhs) / torch.clamp(dd, min=1e-30)
        if omega != 1.0:
            new = (1.0 - omega) * u + omega * new
        new = torch.where(dd > 1e-20, new, u)
        return torch.where(mask, new, u)

    for _ in range(nsweeps):
        u = half(u, red)
        u = half(u, ~red)
    return u


def residual(u, rhs, grid: Grid, fbc: bcs.FieldBC, dia=None,
             homogeneous: bool = False, t: float = 0.0, alpha=None):
    """r = rhs - (L - dia) u (reference: src/poisson.c:634-747,
    gerris_tpu poisson.py:136-182) where the ghosts are static
    (homogeneous, or constant values): K11 in 2D, in 3D the reference's
    shifted-neighbour torch route (``_neighbor_sums_shifted``); else the
    reference's padded route (poisson.py:177-182), which evaluates
    callable values at time ``t``.  With face coefficients ``alpha`` or a
    cell dia, the reference's torch route on every device (K11 takes
    neither, as residual_pallas does not); so too with a Navier side, on
    the shifted neighbours with its factor."""
    if _variable(alpha, dia) or not bcs.kernel_ghosts(fbc, homogeneous):
        return _residual_generic(u, rhs, grid, fbc, alpha, dia, homogeneous,
                                 t)
    d = _scalar_dia(dia)
    h2 = grid.h * grid.h
    signs, offs = _signs_offs(grid, fbc, homogeneous)
    if grid.dim == 2:
        return rbgs.residual(u, rhs, d, h2=h2, signs=signs, offs=offs,
                             periodic=_periodic(fbc))
    nb = rbgs3d.neighbour_sum(u, signs, offs, _periodic(fbc))
    return rhs - ((nb - 6.0 * u) / h2 - d * u)


def relax(u, rhs, grid: Grid, fbc: bcs.FieldBC, nsweeps: int, dia=None,
          homogeneous: bool = True, omega: float = 1.0, alpha=None,
          t: float = 0.0):
    """Red-black Gauss-Seidel sweeps (reference: src/poisson.c:507-586):
    with homogeneous ghosts (the multigrid's sweeps) K10 in 2D, and in 3D
    K13 where every side is Dirichlet or Neumann (reference
    poisson.py:304-319); else the torch route with the BCs' static
    offsets, periodic sides included.  With face coefficients ``alpha``
    (and a scalar or cell dia) K15 in 2D with homogeneous ghosts
    (poisson.py:289-303), at every level size; otherwise, and for a cell
    dia with unit coefficients, the reference's jnp sweeps in torch.  A
    Navier side takes the torch sweeps with its factor."""
    kernel = bcs.kernel_ghosts(fbc, homogeneous=True)
    if _variable(alpha, dia):
        if alpha is not None and homogeneous and grid.dim == 2 and kernel:
            return _relax_alpha(u, rhs, grid, fbc, nsweeps, dia, alpha,
                                omega)
        return _relax_generic(u, rhs, grid, fbc, nsweeps, alpha, dia,
                              homogeneous, omega, t)
    d = _scalar_dia(dia)
    h2 = grid.h * grid.h
    signs, offs = _signs_offs(grid, fbc, homogeneous)
    if grid.dim == 3:
        if homogeneous and not any(_periodic(fbc)) and kernel:
            return rbgs3d.rbgs_relax_3d(u, rhs, d, nsweeps=nsweeps, h2=h2,
                                        signs=signs, omega=omega)
        return rbgs3d.rbgs3d_plain(u, rhs, nsweeps, h2, 1.0 / (6.0 + d * h2),
                                   signs, _periodic(fbc), omega, offs)
    if homogeneous and kernel:
        return rbgs.rbgs_relax(u, rhs, d, nsweeps=nsweeps, h2=h2,
                               signs=signs, periodic=_periodic(fbc),
                               omega=omega)
    return rbgs.rbgs_plain(u, rhs, nsweeps, h2, 1.0 / (4.0 + d * h2), signs,
                           _periodic(fbc), omega, offs)


def _relax_alpha(u, rhs, grid, fbc, nsweeps, dia, alpha, omega,
                 coarse=None, add=None):
    """K15 on a 2D level with face coefficients and homogeneous ghosts:
    from ``u``, or with u None from the prolongation of ``coarse`` (zero
    without one), + ``add``."""
    cell = isinstance(dia, torch.Tensor)
    return rbgs.rbgs_relax_alpha(
        u, rhs, alpha[0], alpha[1], dia if cell else _scalar_dia(dia),
        nsweeps=nsweeps, h2=grid.h * grid.h,
        signs=_signs_offs(grid, fbc, True)[0], periodic=_periodic(fbc),
        omega=omega, dia_cell=cell, coarse=coarse, add=add)


def restrict(r):
    """Mean of the 2x2 (2D) or 2x2x2 (3D) children (reference:
    get_from_below, src/poisson.c:1044-1068)."""
    if r.dim() == 2:
        return rbgs.pool_plain(r)
    n0, n1, n2 = r.shape
    return r.reshape(n0 // 2, 2, n1 // 2, 2, n2 // 2, 2).mean(dim=(1, 3, 5))


def prolong(c, fbc: bcs.FieldBC, grid_c: Grid):
    """Bilinear (2D) or trilinear (3D) prolongation coarse -> fine with
    homogeneous BCs (reference: get_from_above, src/poisson.c:1005-1042;
    in 3D poisson.py:379-390: axis by axis, weights 0.75/0.25, ghosts
    sgn * c or wrapped).  ``grid_c``: the coarse level, whose cell size
    sets a Navier side's factor."""
    signs, _ = _signs_offs(grid_c, fbc, True)
    if c.dim() == 2:
        return rbgs.prolong_plain(c, signs, _periodic(fbc))
    return rbgs3d.prolong3d_plain(c, signs, _periodic(fbc))


def coarsen_face_coeff(alpha, dim: int):
    """Coarse face coefficients: every second face along its axis, the
    mean of each transverse pair of child faces (reference
    poisson.py:411-431)."""
    out = []
    for axis in range(dim):
        a = alpha[axis]
        idx = [slice(None)] * a.dim()
        idx[axis] = slice(0, a.shape[axis], 2)
        a = a[tuple(idx)]
        for ax2 in range(dim):
            if ax2 == axis:
                continue
            sh = list(a.shape)
            sh[ax2:ax2 + 1] = [sh[ax2] // 2, 2]
            a = a.reshape(sh).mean(dim=ax2 + 1)
        out.append(a.contiguous())
    return tuple(out)


def _coeff_hierarchy(grid: Grid, minlevel: int, alpha, dia):
    """Face coefficients and dia down the levels (reference
    poisson.py:442-452): faces by coarsen_face_coeff, a cell dia by the
    children's mean, a scalar dia as it is."""
    alphas, dias = [alpha], [dia]
    for _ in range(grid.level - minlevel):
        alphas.append(None if alphas[-1] is None
                      else coarsen_face_coeff(alphas[-1], grid.dim))
        d = dias[-1]
        dias.append(restrict(d).contiguous()
                    if isinstance(d, torch.Tensor) else d)
    return alphas, dias


def _laplacian_matrix(shape, h: float, kinds) -> np.ndarray:
    """The dense homogeneous-BC Laplacian of a 2D or 3D level, row-major
    cells (reference poisson.py:_coarse_eig); a side's kind is periodic,
    Dirichlet or Neumann, or (navier, its factor)."""
    ncell = int(np.prod(shape))
    strides = [int(np.prod(shape[a + 1:])) for a in range(len(shape))]
    A = np.zeros((ncell, ncell))
    for pos in np.ndindex(*shape):
        k = sum(p * s for p, s in zip(pos, strides))
        for axis, n in enumerate(shape):
            for side, step in ((0, -1), (1, 1)):
                q = pos[axis] + step
                if 0 <= q < n or kinds[axis][side] == bcs.PERIODIC:
                    A[k, k + (q % n - pos[axis]) * strides[axis]] += 1.0
                    A[k, k] -= 1.0
                elif kinds[axis][side] == bcs.DIRICHLET:
                    A[k, k] -= 2.0      # homogeneous ghost = -interior
                elif isinstance(kinds[axis][side], tuple):
                    # Navier: ghost = factor * interior
                    A[k, k] += kinds[axis][side][1] - 1.0
                # homogeneous Neumann: ghost = interior, no net term
    return A / (h * h)


@functools.lru_cache(maxsize=8)
def _coarse_eig(shape, h: float, kinds, device, dtype):
    """(w, Q) of the dense coarse Laplacian, eigendecomposed once per
    (level, BC kinds, device, dtype) by torch.linalg.eigh in float64 on
    the solve's device, then cast to the solve's dtype (reference
    poisson.py:459-499, which decomposes in numpy on the host)."""
    A = torch.from_numpy(_laplacian_matrix(shape, h, kinds)).to(device)
    w, Q = torch.linalg.eigh(A)
    return w.to(dtype), Q.to(dtype)


def _dense_solve(rc, grid_c: Grid, fbc: bcs.FieldBC, d: float):
    """du = Q diag(1/(w - d)) Q^T r on the coarsest level: the exact
    solve of (L - d) du = r for any scalar d, with the zero-eigenvalue
    mode of a pure-Neumann or periodic level projected out (reference
    poisson.py:571-583).  The products are torch.matmul, as the
    reference leaves them to XLA outside any kernel."""
    kinds = tuple(tuple((b.kind, bcs.navier_factor(b, grid_c.h))
                        if b.kind == bcs.NAVIER else b.kind for b in ax)
                  for ax in fbc.sides)
    w, Q = _coarse_eig(tuple(rc.shape), grid_c.h, kinds, rc.device,
                       rc.dtype)
    denom = w - d
    z = torch.matmul(Q.T, rc.reshape(-1))
    keep = denom.abs() > 1e-12 / grid_c.h ** 2
    z = torch.where(keep, z / torch.where(denom == 0, 1.0, denom), 0.0)
    return torch.matmul(Q, z).reshape(rc.shape)


def _residual_levels(r, levels):
    """[r, restrict(r), ...]: r and its ``levels`` coarser levels, one
    restrict_pyramid launch in 2D."""
    if r.dim() == 2:
        return [r] + (rbgs.restrict_pyramid(r, levels) if levels else [])
    rs = [r]
    for _ in range(levels):
        rs.append(restrict(rs[-1]))
    return rs


def _correction_variable(r, grid, fbc, params, alpha, dia, u_fine):
    """The correction with face coefficients or a cell dia (reference
    poisson.py:534-617 with alpha): no K12, dense solve or K3; the
    residual and the coefficients restricted down to ``minlevel``,
    nrelax * erelax**(levels) + coarsest_relax sweeps from zero there,
    then ``prolong`` + ``relax`` up every level.  In 2D with face
    coefficients each level is one K15 launch: the coarsest from zero,
    each upward level with the prolongation of the coarser one's du
    placed in the kernel, the finest with u_fine added."""
    minlevel = min(params.minlevel, grid.level)
    grids = [dataclasses.replace(grid, level=lv)
             for lv in range(grid.level, minlevel - 1, -1)]
    alphas, dias = _coeff_hierarchy(grid, minlevel, alpha, dia)
    rs = _residual_levels(r, len(grids) - 1)
    nl = len(grids)
    coarsest = (params.nrelax * params.erelax ** (nl - 1)
                + params.coarsest_relax)
    if (grid.dim == 2 and alpha is not None
            and bcs.kernel_ghosts(fbc, homogeneous=True)):
        du = None
        for k in range(nl - 1, -1, -1):
            nswp = coarsest if k == nl - 1 else \
                params.nrelax * params.erelax ** k
            du = _relax_alpha(None, rs[k], grids[k], fbc, nswp, dias[k],
                              alphas[k], params.omega, coarse=du,
                              add=u_fine if k == 0 else None)
        return du
    du = relax(torch.zeros_like(rs[-1]), rs[-1], grids[-1], fbc, coarsest,
               dias[-1], omega=params.omega, alpha=alphas[-1])
    for k in range(nl - 2, -1, -1):
        du = relax(prolong(du, fbc, grids[k + 1]), rs[k], grids[k], fbc,
                   params.nrelax * params.erelax ** k, dias[k],
                   omega=params.omega, alpha=alphas[k])
    return du if u_fine is None else u_fine + du


def correction(r, grid: Grid, fbc: bcs.FieldBC, params: MultilevelParams,
               dia=None, u_fine=None, alpha=None):
    """The correction phase of one sawtooth cycle (reference
    poisson.py:520-617, src/poisson.c:1109-1166): restrict the residual
    (one restrict_pyramid launch in 2D, the 2x2x2 mean in 3D) down the
    hierarchy, solve the coarsest level, then prolong + relax upward with
    homogeneous BCs; with ``u_fine`` returns u_fine + du, folded into the
    last K3 launch in 2D.
    The coarsest level is
    * K12 (``coarse_vcycle`` with max(coarsest_relax, 40) coarsest sweeps)
      at ``coarse_top`` when the level is 2D, above it, and its rows are
      not periodic;
    * else the dense solve at the finest level of at most
      ``dense_coarse_max`` unknowns;
    * else ``minlevel``, relaxed from zero with nrelax * erelax**(levels)
      + coarsest_relax sweeps.
    Upward, each 2D level is one K3 launch, or ``prolong`` + K10 on
    periodic rows (K3 takes periodic columns only); each 3D level is one
    K13 launch with the coarser level's du prolonged at placement (+
    u_fine at the finest), or ``prolong`` + ``relax`` in torch on
    periodic sides.  With face coefficients ``alpha`` or a
    cell dia: _correction_variable."""
    if _variable(alpha, dia):
        return _correction_variable(r, grid, fbc, params, alpha, dia,
                                    u_fine)
    d = _scalar_dia(dia)
    per_x = fbc.is_periodic(0)
    kernel = bcs.kernel_ghosts(fbc, homogeneous=True)
    flat = grid.dim == 2
    minlevel = min(params.minlevel, grid.level)
    fused_coarse = (flat and not per_x and kernel
                    and grid.shape[0] > params.coarse_top)
    if fused_coarse:
        minlevel = params.coarse_top.bit_length() - 1
    else:
        while (minlevel < grid.level and int(np.prod(dataclasses.replace(
                grid, level=minlevel + 1).shape)) <= params.dense_coarse_max):
            minlevel += 1
    grids = [dataclasses.replace(grid, level=lv)
             for lv in range(grid.level, minlevel - 1, -1)]
    rs = _residual_levels(r, len(grids) - 1)
    signs, _ = _signs_offs(grid, fbc, True)
    per_y = fbc.is_periodic(1)
    nl = len(grids)
    gc = grids[-1]
    if fused_coarse:
        du = rbgs.coarse_vcycle(
            rs[-1], d, nsweeps=params.nrelax,
            coarsest=max(params.coarsest_relax, COARSEST_FLOOR),
            h2=gc.h ** 2, signs=signs, per_y=per_y, min_n=MIN_N)
    elif int(np.prod(gc.shape)) <= params.dense_coarse_max:
        du = _dense_solve(rs[-1], gc, fbc, d)
    else:
        du = relax(torch.zeros_like(rs[-1]), rs[-1], gc, fbc,
                   params.nrelax * params.erelax ** (nl - 1)
                   + params.coarsest_relax, dia, omega=params.omega)
    k13 = not flat and not any(_periodic(fbc)) and kernel
    for k in range(nl - 2, -1, -1):
        nswp = params.nrelax * params.erelax ** k
        add_u = k == 0 and u_fine is not None
        if flat and not per_x and kernel:
            du = rbgs.prolong_relax(du, rs[k], d, u_fine if add_u else None,
                                    nsweeps=nswp, h2=grids[k].h ** 2,
                                    signs=signs, per_y=per_y,
                                    omega=params.omega)
        elif k13:
            h = grids[k].h
            du = rbgs3d.rbgs_relax_3d(None, rs[k], d, nsweeps=nswp, h2=h * h,
                                      signs=signs, omega=params.omega,
                                      coarse=du,
                                      add=u_fine if add_u else None)
        else:
            du = relax(prolong(du, fbc, grids[k + 1]), rs[k], grids[k], fbc,
                       nswp, dia, omega=params.omega)
            continue
        if add_u:
            return du
    return du if u_fine is None else u_fine + du


def cycle(u, rhs, grid: Grid, fbc: bcs.FieldBC, params: MultilevelParams,
          dia=None, t: float = 0.0, alpha=None):
    """One sawtooth cycle: residual + correction (reference
    src/poisson.c:1109-1178 gfs_poisson_cycle)."""
    r = residual(u, rhs, grid, fbc, dia, t=t, alpha=alpha)
    return correction(r, grid, fbc, params, dia, u_fine=u, alpha=alpha)


def _fused_eligible(u, grid: Grid, fbc: bcs.FieldBC, dia,
                    alpha=None) -> bool:
    """The levels and BCs the fused cycle's kernels take: 2D, unit
    coefficients, a scalar dia, static BC values, non-periodic rows,
    square power-of-two levels of at least 4 * MIN_N (reference
    poisson.py:648-659, without its device, dtype and size tests)."""
    if grid.dim != 2 or alpha is not None:
        return False
    n0, n1 = u.shape
    return ((dia is None or isinstance(dia, (int, float)))
            and bcs.kernel_ghosts(fbc) and not fbc.is_periodic(0)
            and n0 == n1 and n0 >= 4 * MIN_N and not n0 & (n0 - 1))


def fused_cycle(u, rhs, grid: Grid, fbc: bcs.FieldBC,
                params: MultilevelParams, dia=None, rhs_sub=0.0):
    """One sawtooth cycle as K1 -> K2 -> K3 (reference poisson.py:662-690):
      1. residual_restrict: r0 = (rhs - rhs_sub) - (L - dia) u, r1, r2;
      2. cascade_prolong_relax: the whole correction at and below n/2,
         with max(coarsest_relax, 40) sweeps at the coarsest level;
      3. prolong_relax: fine prolong + relax + u += du.
    Returns (u_new, r0)."""
    if not _fused_eligible(u, grid, fbc, dia):
        raise NotImplementedError(
            f"fused cycle on a {tuple(u.shape)} level with these BCs: want "
            "2D, a scalar dia, static BC values, non-periodic rows and "
            f"square powers of two >= {4 * MIN_N}")
    signs, offs = _signs_offs(grid, fbc, homogeneous=False)
    per_y = fbc.is_periodic(1)
    d = _scalar_dia(dia)
    h2 = grid.h * grid.h
    r0, r1, r2 = rbgs.residual_restrict(u, rhs, d, rhs_sub, h2=h2,
                                        signs=signs, offs=offs, per_y=per_y)
    du = rbgs.cascade_prolong_relax(
        r1, r2, d, nsweeps=params.nrelax,
        coarsest=max(params.coarsest_relax, COARSEST_FLOOR),
        h2_half=4.0 * h2, signs=signs, per_y=per_y, omega=params.omega,
        min_n=MIN_N)
    u = rbgs.prolong_relax(du, r0, d, u, nsweeps=params.nrelax, h2=h2,
                           signs=signs, per_y=per_y, omega=params.omega)
    return u, r0


def fold_div_eligible(u, grid: Grid, fbc: bcs.FieldBC,
                      params: MultilevelParams) -> bool:
    """Does a MAC projection take the folded solve (reference
    poisson.py:770-778)?  ``fold_div``, one fixed multigrid cycle, no
    Dirichlet side in the pressure BCs (so the compatibility mean is
    analytically zero), and the fused cycle's levels and BCs."""
    return (params.fold_div and params.ncycles == 1
            and params.solver == "multigrid"
            and not any(b.kind == bcs.DIRICHLET
                        for ax in fbc.sides for b in ax)
            and _fused_eligible(u, grid, fbc, None))


def _fold_cycle(u, ufx, ufy, grid, fbc, params, dt, dia):
    """K16 -> K2 of a folded solve: r0 = div(uf) / dt - (L - dia) u with
    sub = 0 (the reference drops the compatibility mean here, poisson.py:
    711-714, and so does the port) and its pools, then the correction at
    and below n/2.  Returns (r0, du at n/2, the fine level's K3 or K17
    arguments)."""
    signs, offs = _signs_offs(grid, fbc, homogeneous=False)
    per_y = fbc.is_periodic(1)
    d = _scalar_dia(dia)
    h2 = grid.h * grid.h
    r0, r1, r2 = rbgs.residual_restrict_div(u, ufx, ufy, dt * grid.h, d, 0.0,
                                            h2=h2, signs=signs, offs=offs,
                                            per_y=per_y)
    du = rbgs.cascade_prolong_relax(
        r1, r2, d, nsweeps=params.nrelax,
        coarsest=max(params.coarsest_relax, COARSEST_FLOOR),
        h2_half=4.0 * h2, signs=signs, per_y=per_y, omega=params.omega,
        min_n=MIN_N)
    fine = dict(nsweeps=params.nrelax, h2=h2, signs=signs, per_y=per_y,
                omega=params.omega)
    return r0, du, d, offs, fine


def solve_fused_div(u, ufx, ufy, grid: Grid, fbc: bcs.FieldBC,
                    params: MultilevelParams, dt, dia=None):
    """The MAC projection's one fixed cycle with its rhs div(uf) / dt
    formed inside the first kernel (reference poisson.py:693-727): K16
    ``residual_restrict_div`` -> K2 -> K3 (+ u), so no divergence launch
    runs.  The caller checks fold_div_eligible.  Stats report r0 before
    and after, as the reference does.  Returns (p, stats)."""
    r0, du, d, _, fine = _fold_cycle(u, ufx, ufy, grid, fbc, params, dt,
                                     dia)
    u = rbgs.prolong_relax(du, r0, d, u, **fine)
    return u, SolveStats(niter=1, r_before=r0, r_after=r0)


def solve_fused_div_correct(u, ufx, ufy, grid: Grid, fbc: bcs.FieldBC,
                            params: MultilevelParams, dt, cells=None,
                            dia=None):
    """solve_fused_div with the projection's correction in its last
    kernel (reference poisson.py:730-761): K16 -> K2 -> K17
    ``prolong_relax_correct``, the whole MAC projection in three
    launches.  Returns (ufx', ufy', p, gx, gy, stats[, U', V'])."""
    r0, du, d, offs, fine = _fold_cycle(u, ufx, ufy, grid, fbc, params, dt,
                                        dia)
    p, ufx, ufy, gx, gy, uc, vc = rbgs.prolong_relax_correct(
        du, r0, d, u, ufx, ufy, dt, grid.h, cells, offs=offs, **fine)
    stats = SolveStats(niter=1, r_before=r0, r_after=r0)
    out = (ufx, ufy, p, gx, gy, stats)
    return out if cells is None else out + (uc, vc)


def _solve_adaptive(u, rhs, grid, fbc, params, dia, t, r, tol, alpha=None):
    """The tolerance loop with one residual per cycle: the residual that
    ends cycle i is the correction's input of cycle i + 1 (reference
    poisson.py:914-932).  The condition i < nitermin or (i < nitermax and
    max|r| > tol) is read on the host, one sync per check.  Returns (u,
    niter, final residual, host syncs)."""
    i = syncs = 0
    while True:
        if i >= params.nitermin:
            if i >= params.nitermax:
                break
            syncs += 1
            if not bool(r.abs().max() > tol):
                break
        u = correction(r, grid, fbc, params, dia, u_fine=u, alpha=alpha)
        r = residual(u, rhs, grid, fbc, dia, t=t, alpha=alpha)
        i += 1
    return u, i, r, syncs


def solve(u, rhs, grid: Grid, fbc: bcs.FieldBC,
          params: MultilevelParams = MultilevelParams(), dia=None,
          rhs_sub=None, t: float = 0.0, alpha=None):
    """Solve (L - dia) u = rhs - rhs_sub (reference poisson.py:1090-1162;
    the branches are listed in the module's docstring).  ``rhs_sub``: the
    pure-Neumann compatibility mean, a float or a one-element tensor,
    folded into the fused cycle's first kernel.  ``t``: the time at
    which callable BC values are evaluated.  ``alpha``: per-axis face
    coefficients (None: unit); ``dia`` a scalar or a cell array.  Stats
    of a fused fixed schedule report the residual entering the last
    cycle; the others report the residuals before and after the
    solve."""
    kw = dict(t=t, alpha=alpha)
    if params.ncycles > 0 and params.solver == "multigrid":
        if _fused_eligible(u, grid, fbc, dia, alpha):
            sub = 0.0 if rhs_sub is None else rhs_sub
            r0 = None
            for _ in range(params.ncycles):
                u, r0 = fused_cycle(u, rhs, grid, fbc, params, dia, sub)
            return u, SolveStats(niter=params.ncycles, r_before=r0,
                                 r_after=r0)
        if rhs_sub is not None:
            rhs = rhs - rhs_sub
        r0 = residual(u, rhs, grid, fbc, dia, **kw)
        for _ in range(params.ncycles):
            u = cycle(u, rhs, grid, fbc, params, dia, **kw)
        return u, SolveStats(niter=params.ncycles, r_before=r0,
                             r_after=residual(u, rhs, grid, fbc, dia, **kw))
    if rhs_sub is not None:
        rhs = rhs - rhs_sub
    if params.solver != "multigrid":
        if params.solver not in SOLVER_REGISTRY:
            raise ValueError(f"unknown solver {params.solver!r}")
        extra = {} if alpha is None else {"alpha": alpha}
        return SOLVER_REGISTRY[params.solver](u, rhs, grid, fbc, params, dia,
                                              t, **extra)
    r0 = residual(u, rhs, grid, fbc, dia, **kw)
    if params.nitermin == params.nitermax:
        for _ in range(params.nitermax):
            u = cycle(u, rhs, grid, fbc, params, dia, **kw)
        return u, SolveStats(niter=params.nitermax, r_before=r0,
                             r_after=residual(u, rhs, grid, fbc, dia, **kw))
    # the reference guards with 1e-300, which is 0 in float32
    scale = torch.clamp(rhs.abs().max(), min=torch.finfo(rhs.dtype).tiny)
    u, niter, r1, syncs = _solve_adaptive(u, rhs, grid, fbc, params, dia, t,
                                          r0, params.tolerance * scale,
                                          alpha)
    return u, SolveStats(niter=niter, r_before=r0, r_after=r1,
                         host_syncs=syncs)


def solve_relax(u, rhs, grid: Grid, fbc: bcs.FieldBC,
                params: MultilevelParams = None, dia=None, t: float = 0.0,
                alpha=None):
    """The fine-level-relaxation-only solve (reference poisson.py:996-
    1017): r0 (K11), max(nrelax, 4) homogeneous sweeps of the correction
    from zero (K10, or K15 with face coefficients), u + du, and the
    final residual (K11)."""
    params = params or MultilevelParams()
    r0 = residual(u, rhs, grid, fbc, dia, t=t, alpha=alpha)
    du = relax(torch.zeros_like(u), r0, grid, fbc, max(params.nrelax, 4),
               dia, omega=params.omega, alpha=alpha)
    u = u + du
    return u, SolveStats(niter=1, r_before=r0,
                         r_after=residual(u, rhs, grid, fbc, dia, t=t,
                                          alpha=alpha))


def _krylov_setup(u, rhs, grid, fbc, params, dia, t, alpha):
    """What cg and mgcg share (reference poisson.py:935-975, 1022-1046):
    r0, the tolerance tolerance * max|rhs|, whether the operator is
    singular (then b's and every residual's mean is removed), the
    operator -(L - dia) v with homogeneous ghosts (SPD), and the Krylov
    rhs b = -r0.  The operator is singular only with no Dirichlet side,
    no Navier side (its factor is below 1) and no dia; the reference
    looks at the Dirichlet sides alone and so drops mean(b)/dia from a
    Neumann Helmholtz solve (ROADMAP Queue 3)."""
    r0 = residual(u, rhs, grid, fbc, dia, t=t, alpha=alpha)
    # the reference guards with 1e-300, which is 0 in float32
    tol = params.tolerance * torch.clamp(rhs.abs().max(),
                                         min=torch.finfo(rhs.dtype).tiny)
    singular = (not bcs.has_kind(fbc, bcs.DIRICHLET)
                and not bcs.has_kind(fbc, bcs.NAVIER)
                and (dia is None or (not isinstance(dia, torch.Tensor)
                                     and dia == 0.0)))

    def aop(v):
        return residual(v, torch.zeros_like(v), grid, fbc, dia,
                        homogeneous=True, t=t, alpha=alpha)

    b = -r0
    if singular:
        b = b - b.mean()
    return r0, tol, singular, aop, b


def _safe(x):
    return torch.where(x == 0, torch.ones_like(x), x)


def _krylov(u, r0, tol, singular, aop, prec, b, itmax, flexible):
    """The (flexible) preconditioned CG loop of the reference's
    while_loops (poisson.py:960-991, 1048-1076), its condition i < itmax
    and max|r| > tol read on the host once per check, so it stops at the
    reference's iteration.  Returns (u + du, SolveStats)."""
    z = prec(b)
    du, r, p = torch.zeros_like(u), b, z
    rz = (b * z).sum()
    i = syncs = 0
    while i < itmax:
        syncs += 1
        if not bool(r.abs().max() > tol):
            break
        ap = aop(p)
        a = rz / _safe((p * ap).sum())
        du = du + a * p
        r_new = r - a * ap
        if singular:
            r_new = r_new - r_new.mean()
        z = prec(r_new)
        rz_new = (r_new * z).sum()
        if flexible:
            # Polak-Ribiere: z.(r_new - r), clipped at 0
            beta = torch.clamp(((r_new - r) * z).sum() / _safe(rz), min=0.0)
        else:
            beta = rz_new / _safe(rz)
        p = z + beta * p
        r, rz = r_new, rz_new
        i += 1
    return u + du, SolveStats(niter=i, r_before=r0, r_after=-r,
                              host_syncs=syncs)


def solve_cg(u, rhs, grid: Grid, fbc: bcs.FieldBC,
             params: MultilevelParams = MultilevelParams(), dia=None,
             t: float = 0.0, alpha=None):
    """Jacobi-preconditioned conjugate gradients on -(L - dia) du = -r0
    (reference poisson.py:935-993): the diagonal (the sum of the cell's
    face coefficients) / h^2 + dia, at most 20 * nitermax iterations,
    the operator K11 (unit coefficients) or the torch residual."""
    r0, tol, singular, aop, b = _krylov_setup(u, rhs, grid, fbc, params,
                                               dia, t, alpha)
    if alpha is None:
        den = 2.0 * grid.dim
    else:
        den = sum(a.narrow(ax, 0, a.shape[ax] - 1)
                  + a.narrow(ax, 1, a.shape[ax] - 1)
                  for ax, a in enumerate(alpha))
    diag = torch.clamp(torch.as_tensor(
        den / (grid.h * grid.h) + (0.0 if dia is None else dia),
        dtype=u.dtype, device=u.device), min=1e-30)
    return _krylov(u, r0, tol, singular, aop, lambda r: r / diag, b,
                   20 * params.nitermax, flexible=False)


def solve_mgcg(u, rhs, grid: Grid, fbc: bcs.FieldBC,
               params: MultilevelParams = MultilevelParams(), dia=None,
               t: float = 0.0, alpha=None):
    """Multigrid-preconditioned flexible CG (reference poisson.py:
    1022-1080): one ``correction`` V-cycle from zero as the
    preconditioner (with face coefficients in 2D, one K15 launch per
    level), Polak-Ribiere beta, at most nitermax iterations."""
    r0, tol, singular, aop, b = _krylov_setup(u, rhs, grid, fbc, params,
                                               dia, t, alpha)

    def prec(r):
        return -correction(r, grid, fbc, params, dia, alpha=alpha)

    return _krylov(u, r0, tol, singular, aop, prec, b, params.nitermax,
                   flexible=True)


# the reference's pluggable-solver seam (par->poisson_solve): a registered
# name is usable as MultilevelParams.solver; a solver is called as
# fn(u, rhs, grid, fbc, params, dia, t[, alpha=]) -> (u, SolveStats)
SOLVER_REGISTRY = {"relax": solve_relax, "cg": solve_cg,
                   "mgcg": solve_mgcg}


def register_solver(name: str, fn):
    SOLVER_REGISTRY[name] = fn


def batched_fixed_eligible(us, grid: Grid, fbcs, dias) -> bool:
    """Can the systems share one batched launch chain (the pair kernels
    K8a-c)?  2D, scalar dias, non-periodic rows, and the same ghost signs
    and y periodicity across the batch (reference poisson.py:781-790).
    The reference also asks for the TPU's fused-cycle constraints (the
    backend, f32, n >= 512); the port's route depends on the
    configuration only, and fused_cycle's own size limits apply to both
    routes alike."""
    if grid.dim != 2 or len(us) != 2:
        return False
    if not all(d is None or isinstance(d, (int, float)) for d in dias):
        return False
    if any(f.is_periodic(0) or not bcs.kernel_ghosts(f) for f in fbcs):
        return False
    sp = [(_signs_offs(grid, f, False)[0], f.is_periodic(1)) for f in fbcs]
    return all(x == sp[0] for x in sp[1:])


def _pair_setup(grid: Grid, fbcs, dias):
    """(signs, per_y, [offs per system], [dia per system]) of a pair."""
    signs, _ = _signs_offs(grid, fbcs[0], homogeneous=False)
    offss = [_signs_offs(grid, f, homogeneous=False)[1] for f in fbcs]
    ds = [0.0 if d is None else float(d) for d in dias]
    return signs, fbcs[0].is_periodic(1), offss, ds


def solve_fixed_batched(us, rhss, grid: Grid, fbcs,
                        params: MultilevelParams, dias, subs=None,
                        rr_pre=None):
    """``params.ncycles`` fixed sawtooth cycles on the two independent
    scalar-dia systems of the U+V implicit-diffusion pair, each cycle as
    K8a -> K8b -> K8c, one launch chain for both systems (reference
    poisson.py:830-886).  The caller checks batched_fixed_eligible.
    ``subs``: each system's rhs mean, as solve's rhs_sub.  ``rr_pre``:
    the first cycle's precomputed ([r0s], [r1s], [r2s]) (K7's rr_dia
    mode), which replaces its K8a launch; ``rhss`` may then be None when
    ncycles == 1.  Returns ([u0, u1], stats of system 0)."""
    for u, fbc, d in zip(us, fbcs, dias):
        if not _fused_eligible(u, grid, fbc, d):
            raise NotImplementedError("solve_fixed_batched: a system the "
                                      "fused cycle does not take")
    if rr_pre is None and rhss is None:
        raise ValueError("solve_fixed_batched: give rhss or rr_pre")
    if rhss is None and params.ncycles > 1:
        raise ValueError("solve_fixed_batched: cycles after the first "
                         "need rhss")
    signs, per_y, offss, ds = _pair_setup(grid, fbcs, dias)
    subs = [0.0, 0.0] if subs is None else \
        [0.0 if s is None else s for s in subs]
    h2 = grid.h * grid.h
    U = list(us)
    r0 = None
    for ic in range(params.ncycles):
        if ic == 0 and rr_pre is not None:
            r0, r1, r2 = rr_pre
        else:
            r0, r1, r2 = rbgs.residual_restrict_pair(
                U, rhss, ds, subs, h2=h2, signs=signs, offss=offss,
                per_y=per_y)
        du = rbgs.cascade_prolong_relax_pair(
            r1, r2, ds, nsweeps=params.nrelax,
            coarsest=max(params.coarsest_relax, COARSEST_FLOOR),
            h2_half=4.0 * h2, signs=signs,
            per_y=per_y, omega=params.omega, min_n=MIN_N)
        U = rbgs.prolong_relax_pair(du, r0, ds, U, nsweeps=params.nrelax,
                                    h2=h2, signs=signs, per_y=per_y,
                                    omega=params.omega)
    return U, SolveStats(niter=params.ncycles, r_before=r0[0],
                         r_after=r0[0])


def solve_relax_pair(us, rhss, grid: Grid, fbcs, params: MultilevelParams,
                     dias):
    """The pair's fine-relax-only solve (the "relax" solver): K8a for the
    residual, then K8c from a zero correction with max(nrelax, 4) sweeps
    and u += du (reference poisson.py:793-827).  Returns ([u0, u1], stats
    of system 0)."""
    _check_2d(grid)
    signs, per_y, offss, ds = _pair_setup(grid, fbcs, dias)
    h2 = grid.h * grid.h
    r0, _, _ = rbgs.residual_restrict_pair(us, rhss, ds, h2=h2, signs=signs,
                                           offss=offss, per_y=per_y)
    U = rbgs.prolong_relax_pair([None, None], r0, ds, list(us),
                                nsweeps=max(params.nrelax, 4), h2=h2,
                                signs=signs, per_y=per_y, omega=params.omega)
    return U, SolveStats(niter=1, r_before=r0[0], r_after=r0[0])
