"""The multigrid kernels: CUDA wrappers and their plain versions.

Port of the TPU kernels of gerris_tpu/ops/pallas/rbgs.py: the fixed
sawtooth cycle's K1 ``residual_restrict``, K2 ``cascade_prolong_relax``,
K3 ``prolong_relax``, their U+V pairs K8a ``residual_restrict_pair``, K8b
``cascade_prolong_relax_pair`` and K8c ``prolong_relax_pair``, and the
adaptive solve's K10 ``rbgs_relax``, K11 ``residual`` (the TPU's
``residual_pallas``) and K12 ``coarse_vcycle``, the variable-coefficient
smoother K15 ``rbgs_relax_alpha`` (the two-phase projections and the
variable-density diffusion), and the fold route's K16
``residual_restrict_div`` (K1 with the MAC divergence as its rhs) and K17
``prolong_relax_correct`` (K3 with the projection's correction as its
epilogue), and the restriction pyramid ``restrict_pyramid`` (every level
of the cascades' and the 2D corrections' restriction in one launch,
``restrict2`` its one-level case) and the block kernel ``coarse_block``
(K12's levels at and below 64^2, and every cascade's: one launch of a
block per system, with omega).  K3, K8c, K17, the cascades' K3
launches above 64^2, K10 and K15 share one sweep engine and pick their
tile per level from the card's shared memory and multiprocessor count
(K10 and K15 their threads too, and they split their sweeps over
launches when the halo outgrows shared memory).  K15 also takes the
prolongation of a coarse correction as its start and adds u to its
result, so that an alpha correction's upward level is one launch.  The
kernels are in ``gerris_tpu_torch/csrc/rbgs.cu``; each one's source note
says what it replaces, what bounds it on the H100 and what its design
does about it.  A pair launches the single kernel with a batch of two
systems, which share the ghost signs and the periodicity and have their
own dia, sub and ghost offsets; its plain version is the single plain
version per system.

Each wrapper checks its inputs (dtype float32/float64, contiguous, square
power-of-two levels; ``restrict_pyramid``, K10, K11 and K15 also the
levels of a box of several unit boxes, whose longer side is a multiple of
its shorter, power-of-two one, such as n x 2n or n x 3n) and then:
* for tensors on the CPU, returns the plain PyTorch version below (the
  CPU tests and the card-side reference in chip_smoke.py use these);
* for CUDA tensors, launches the kernel on the current stream and adds
  one to its count in ``LAUNCHES``, or raises.  There is no fallback.

Ghosts are encoded per side as ghost = sgn * mirror + off, sides ordered
(x lo, x hi, y lo, y hi) (poisson._signs_offs); the correction-phase
kernels use off = 0 (homogeneous).  K10, K11 and K15 take periodic rows
and columns; the others periodic columns only (``per_y``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

# kernel launches by wrapper name, counted only where a kernel launches.
# A cascade counts calls of its host-side sequence; the restrict_pyramid,
# coarse_block and prolong_relax launches it makes are counted apart from
# the wrappers' own: "cascade.restrict_pyramid", "cascade.coarse_block"
# and "cascade.prolong_relax" for K2, the same under "cascade_pair." for
# K8b, and "coarse_vcycle.restrict_pyramid", "coarse_block" and
# "coarse_vcycle.prolong_relax" for K12 (whose block launches share the
# block kernel's own count); the block kernel's wrappers count their
# pyramids under "coarse_block.restrict_pyramid" and
# "coarse_block_pair.restrict_pyramid".  "rbgs_relax_alpha.prolong"
# counts the K15 launches (also counted under "rbgs_relax_alpha") that
# prolonged a coarse correction at placement.
LAUNCHES = {"residual_restrict": 0, "restrict2": 0, "restrict_pyramid": 0,
            "restrict_pyramid_pair": 0, "prolong_relax": 0,
            "cascade_prolong_relax": 0, "cascade.restrict_pyramid": 0,
            "cascade.coarse_block": 0, "cascade.prolong_relax": 0,
            "residual_restrict_pair": 0, "prolong_relax_pair": 0,
            "cascade_prolong_relax_pair": 0,
            "cascade_pair.restrict_pyramid": 0,
            "cascade_pair.coarse_block": 0,
            "cascade_pair.prolong_relax": 0, "residual": 0,
            "rbgs_relax": 0, "coarse_vcycle": 0,
            "coarse_vcycle.restrict_pyramid": 0, "coarse_block": 0,
            "coarse_block_pair": 0, "coarse_vcycle.prolong_relax": 0,
            "coarse_block.restrict_pyramid": 0,
            "coarse_block_pair.restrict_pyramid": 0,
            "residual_restrict_div": 0, "prolong_relax_correct": 0,
            "rbgs_relax_alpha": 0, "rbgs_relax_alpha.prolong": 0}

_SMEM_MAX = 232448        # dynamic shared memory a block may use on sm_90
MAX_BATCH = 2             # systems in one launch (csrc/rbgs.cu)
_HOMOGENEOUS = (0.0, 0.0, 0.0, 0.0)
# the block kernel (coarse_block) holds levels of at most this many cells
# per side: K12's levels and every cascade's at and below this size are
# one launch of it
COARSE_BLOCK_MAX = 64
# the warps (of its 16) that sweep its levels of 16^2 and below and its
# 32^2 level (the times per choice on an H100: PERF.md), and the launch
# shapes that a test may ask for instead (``warps``, test-only: the
# launch geometry changes, the result is bit-identical)
CB_WARPS = (4, 8)
CB_WARPS_SHAPES = (CB_WARPS, (1, 4), (8, 4), (4, 16), (16, 16))


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -----------------------------------------------------------------------------
# Plain versions (torch.roll + torch.where, the style of rbgs._cv_relax)
# -----------------------------------------------------------------------------

def _neighbours(u, signs, offs, periodic):
    """(up, down, left, right) neighbour values with ghost = sgn*u + off
    at non-periodic domain edges."""
    n0, n1 = u.shape
    up, dn = torch.roll(u, 1, 0), torch.roll(u, -1, 0)
    lf, rt = torch.roll(u, 1, 1), torch.roll(u, -1, 1)
    if not periodic[0]:
        rows = torch.arange(n0, device=u.device).unsqueeze(1)
        up = torch.where(rows == 0, signs[0] * u + offs[0], up)
        dn = torch.where(rows == n0 - 1, signs[1] * u + offs[1], dn)
    if not periodic[1]:
        cols = torch.arange(n1, device=u.device).unsqueeze(0)
        lf = torch.where(cols == 0, signs[2] * u + offs[2], lf)
        rt = torch.where(cols == n1 - 1, signs[3] * u + offs[3], rt)
    return up, dn, lf, rt


def pool_plain(r):
    """2x2 mean: rows first, then columns."""
    a = 0.5 * (r[0::2] + r[1::2])
    return 0.5 * (a[:, 0::2] + a[:, 1::2])


def pyramid_plain(r, levels):
    """The ``levels`` successive 2x2 means of r, finest first: the chain
    of pool_plain."""
    out = []
    for _ in range(levels):
        r = pool_plain(r)
        out.append(r)
    return out


def prolong_plain(c, signs, periodic):
    """Bilinear prolongation (weights 0.75/0.25 per axis, rows first) with
    homogeneous ghosts sgn * c at the domain edges."""
    up, dn, lf, rt = _neighbours(c, signs, _HOMOGENEOUS, periodic)
    n0, n1 = c.shape
    a = torch.stack([0.75 * c + 0.25 * up, 0.75 * c + 0.25 * dn],
                    1).reshape(2 * n0, n1)
    _, _, lf, rt = _neighbours(a, signs, _HOMOGENEOUS, periodic)
    return torch.stack([0.75 * a + 0.25 * lf, 0.75 * a + 0.25 * rt],
                       2).reshape(2 * n0, 2 * n1)


def rbgs_plain(u, rhs, nsweeps, h2, inv_denom, signs, periodic, omega=1.0,
               offs=_HOMOGENEOUS):
    """``nsweeps`` red-black Gauss-Seidel sweeps (red = global (i+j) even
    first) on (L - dia) u = rhs, inv_denom = 1 / (4 + dia h2)."""
    n0, n1 = u.shape
    rows = torch.arange(n0, device=u.device).unsqueeze(1)
    cols = torch.arange(n1, device=u.device).unsqueeze(0)
    red = ((rows + cols) % 2) == 0
    for _ in range(nsweeps):
        for color in (red, ~red):
            up, dn, lf, rt = _neighbours(u, signs, offs, periodic)
            new = (up + dn + lf + rt - h2 * rhs) * inv_denom
            if omega != 1.0:
                new = (1.0 - omega) * u + omega * new
            u = torch.where(color, new, u)
    return u


def residual_plain(u, rhs, dia=0.0, *, h2, signs, offs=_HOMOGENEOUS,
                   periodic=(False, False)):
    up, dn, lf, rt = _neighbours(u, signs, offs, periodic)
    return rhs - (up + dn + lf + rt - 4.0 * u) / h2 + dia * u


def rbgs_relax_plain(u, rhs, dia=0.0, *, nsweeps, h2, signs,
                     periodic=(False, False), omega=1.0):
    return rbgs_plain(u, rhs, nsweeps, h2, 1.0 / (4.0 + dia * h2), signs,
                      periodic, omega)


def rbgs_relax_alpha_plain(u, rhs, ax, ay, dia=0.0, *, nsweeps, h2, signs,
                           periodic=(False, False), omega=1.0,
                           dia_cell=False, coarse=None, add=None):
    """K15's function (gerris_tpu/ops/pallas/rbgs.py:_kernel_alpha):
    ``nsweeps`` red-black sweeps (red = global (i+j) even first) on
    div(alpha grad u) - dia u = rhs with face coefficients ``ax`` (n0+1,
    n1) and ``ay`` (n0, n1+1), a scalar or (``dia_cell``) per-cell dia,
    homogeneous ghosts sgn * mirror or a wrap on a periodic axis, where
    face n is face 0 (the TPU kernel's wrapped face windows, rbgs.py:
    127-129).  den = ax_lo + ax_hi + ay_lo + ay_hi + dia h2, in that
    order; a cell with den <= 1e-20 (a zero diagonal) is left
    untouched.  From ``u``; with u None from prolong_plain(``coarse``),
    or from zero without a coarse; ``add`` is added to the result."""
    if u is None:
        u = torch.zeros_like(rhs) if coarse is None else \
            prolong_plain(coarse, signs, periodic)
    n0, n1 = u.shape
    ax_lo, ay_lo = ax[:n0], ay[:, :n1]
    ax_hi = torch.cat([ax[1:n0], ax[:1]]) if periodic[0] else ax[1:]
    ay_hi = torch.cat([ay[:, 1:n1], ay[:, :1]], 1) if periodic[1] \
        else ay[:, 1:]
    den0 = ax_lo + ax_hi + ay_lo + ay_hi + dia * h2
    den = torch.clamp(den0, min=1e-30)
    live = den0 > 1e-20
    rows = torch.arange(n0, device=u.device).unsqueeze(1)
    cols = torch.arange(n1, device=u.device).unsqueeze(0)
    red = ((rows + cols) % 2) == 0
    for _ in range(nsweeps):
        for color in (red, ~red):
            up, dn, lf, rt = _neighbours(u, signs, _HOMOGENEOUS, periodic)
            num = ax_lo * up + ax_hi * dn + ay_lo * lf + ay_hi * rt
            new = (num - h2 * rhs) / den
            if omega != 1.0:
                new = (1.0 - omega) * u + omega * new
            u = torch.where(color & live, new, u)
    return u if add is None else u + add


def coarse_tail_plain(rs, dia=0.0, *, nsweeps, coarsest, h2, signs,
                      per_y=False, omega=1.0):
    """The block kernel's function, a cascade's coarse tail: given each
    level's rhs ``rs``, finest first (each half the side of the one
    before), du = 0 and ``coarsest`` sweeps at the coarsest level, then
    prolong + ``nsweeps`` sweeps at each level up to rs[0]'s, whose du it
    returns; h2 is rs[0]'s level's."""
    n = rs[0].shape[0]
    du = None
    for rk in reversed(rs):
        du = prolong_relax_plain(
            du, rk, dia, nsweeps=coarsest if du is None else nsweeps,
            h2=h2 * (n // rk.shape[0]) ** 2, signs=signs, per_y=per_y,
            omega=omega)
    return du


def _tail_levels(n, min_n):
    """The levels below an n^2 level down to min(min_n, n)^2."""
    return (n // min(min_n, n)).bit_length() - 1


def coarse_vcycle_plain(r, dia=0.0, *, nsweeps, coarsest, h2, signs,
                        per_y=False, min_n=16, omega=1.0):
    """The ladder of tests/test_mgfuse.py: restrict r down to min(min_n,
    n), ``coarsest`` sweeps from zero there, then prolong + ``nsweeps``
    sweeps at each level up to r's (K12's omega is 1); h2 is r's
    level's."""
    return coarse_tail_plain(
        [r] + pyramid_plain(r, _tail_levels(r.shape[0], min_n)), dia,
        nsweeps=nsweeps, coarsest=coarsest, h2=h2, signs=signs, per_y=per_y,
        omega=omega)


def residual_restrict_plain(u, rhs, dia=0.0, sub=0.0, *, h2, signs,
                            offs=_HOMOGENEOUS, per_y=False):
    up, dn, lf, rt = _neighbours(u, signs, offs, (False, per_y))
    r0 = rhs - sub - (up + dn + lf + rt - 4.0 * u) / h2 + dia * u
    r1 = pool_plain(r0)
    return r0, r1, pool_plain(r1)


def prolong_relax_plain(coarse, rhs, dia=0.0, u=None, *, nsweeps, h2,
                        signs, per_y=False, omega=1.0):
    per = (False, per_y)
    du = (torch.zeros_like(rhs) if coarse is None
          else prolong_plain(coarse, signs, per))
    du = rbgs_plain(du, rhs, nsweeps, h2, 1.0 / (4.0 + dia * h2), signs,
                    per, omega)
    return du if u is None else du + u


def residual_restrict_div_plain(u, ufx, ufy, dtm, dia=0.0, sub=0.0, *, h2,
                                signs, offs=_HOMOGENEOUS, per_y=False):
    """K4's divergence div(uf) / dt (``dtm`` = dt * h) as the rhs of K1."""
    from .projops import divergence_plain  # projops imports this module
    rhs = divergence_plain(ufx, ufy, 1.0 / dtm)[0]
    return residual_restrict_plain(u, rhs, dia, sub, h2=h2, signs=signs,
                                   offs=offs, per_y=per_y)


def correct_plain(p, ufx, ufy, dt, h, signs, offs, per_y=False, cells=None):
    """K5's function (projops.correct_project_plain) with p's ghosts in
    the kernels' encoding: face gradients of p, uf -= dt grad_f p, the
    cell gradient as the mean of its two face gradients, and with
    ``cells`` U, V -= dt g.  Returns (ufx', ufy', gx, gy, U', V'), the
    last two None without cells."""
    up, dn, lf, rt = _neighbours(p, signs, offs, (False, per_y))
    gfx = torch.cat([p[:1] - up[:1], p[1:] - p[:-1], dn[-1:] - p[-1:]]) / h
    gfy = torch.cat([p[:, :1] - lf[:, :1], p[:, 1:] - p[:, :-1],
                     rt[:, -1:] - p[:, -1:]], 1) / h
    gx = 0.5 * (gfx[:-1] + gfx[1:])
    gy = 0.5 * (gfy[:, :-1] + gfy[:, 1:])
    cells = (None, None) if cells is None else \
        (cells[0] - dt * gx, cells[1] - dt * gy)
    return (ufx - dt * gfx, ufy - dt * gfy, gx, gy) + cells


def prolong_relax_correct_plain(coarse, rhs, dia, u, ufx, ufy, dt, h,
                                cells=None, *, nsweeps, h2, signs, offs,
                                per_y=False, omega=1.0):
    """K3 (p' = u + relax^nsweeps(prolong(coarse)), homogeneous ghosts),
    then K5's correction by p' with the real ghosts (signs, offs)."""
    p = prolong_relax_plain(coarse, rhs, dia, u, nsweeps=nsweeps, h2=h2,
                            signs=signs, per_y=per_y, omega=omega)
    return (p,) + correct_plain(p, ufx, ufy, dt, h, signs, offs, per_y,
                                cells)


def cascade_prolong_relax_plain(r1, r2, dia=0.0, *, nsweeps, coarsest,
                                h2_half, signs, per_y=False, omega=1.0,
                                min_n=16):
    return _cascade([r1], [r2], [dia], nsweeps, coarsest, h2_half, signs,
                    per_y, omega, min_n, _pyramids_plain,
                    _tails_plain, _each(prolong_relax_plain))[0]


def _pyramids_plain(rs, levels):
    return [pyramid_plain(r, levels) for r in rs]


def _tails_plain(levels, dias, **kw):
    return [coarse_tail_plain(lv, d, **kw) for lv, d in zip(levels, dias)]


def _each(fn):
    """fn applied per system: lists in, a list out (the pair's plain
    versions, and the single cascade's steps)."""
    def per_system(*lists, **kw):
        return [fn(*args, **kw) for args in zip(*lists)]
    return per_system


def _transpose(outs):
    """Per-system (r0, r1, r2) -> ([r0 per system], [r1 ...], [r2 ...])."""
    return tuple(list(x) for x in zip(*outs))


def residual_restrict_pair_plain(us, rhss, dias, subs=(0.0, 0.0), *, h2,
                                 signs, offss, per_y=False):
    return _transpose(
        residual_restrict_plain(u, r, d, s, h2=h2, signs=signs, offs=o,
                                per_y=per_y)
        for u, r, d, s, o in zip(us, rhss, dias, subs, offss))


def prolong_relax_pair_plain(coarses, rhss, dias, us, *, nsweeps, h2, signs,
                             per_y=False, omega=1.0):
    return _each(prolong_relax_plain)(coarses, rhss, dias, us,
                                      nsweeps=nsweeps, h2=h2, signs=signs,
                                      per_y=per_y, omega=omega)


def cascade_prolong_relax_pair_plain(r1s, r2s, dias, *, nsweeps, coarsest,
                                     h2_half, signs, per_y=False, omega=1.0,
                                     min_n=16):
    return [cascade_prolong_relax_plain(
        r1, r2, d, nsweeps=nsweeps, coarsest=coarsest, h2_half=h2_half,
        signs=signs, per_y=per_y, omega=omega, min_n=min_n)
        for r1, r2, d in zip(r1s, r2s, dias)]


def _cascade(r1s, r2s, dias, nsweeps, coarsest, h2_half, signs, per_y,
             omega, min_n, pyramid, tail, prolong_relax_fn):
    """Every correction level at or below n/2 = r1.shape[0] of each
    system: restrict r2 down to min(min_n, n/4), ``coarsest`` sweeps from
    zero there, then prolong + ``nsweeps`` sweeps at each level up to
    n/2.  At level size m the cell size squared is h2_half * (n/2 / m)**2.
    Lists over the systems in and out: ``pyramid(rs, levels)`` returns
    each system's levels; ``tail(levels, dias, **kw)`` takes each
    system's levels at and below COARSE_BLOCK_MAX cells per side (finest
    first, h2 the finest's) and returns each system's du at the finest of
    them; ``prolong_relax_fn(coarses, rhss, dias, **kw)`` runs each level
    above."""
    n_half = r1s[0].shape[0]
    min_n = min(min_n, n_half // 2)
    levels = (n_half // 2 // min_n).bit_length() - 1
    pyr = pyramid(r2s, levels) if levels else [[] for _ in r2s]
    # each system's levels, finest first, and the first of the tail
    lvs = [[r1, r2] + list(p) for r1, r2, p in zip(r1s, r2s, pyr)]
    top = next(k for k, r in enumerate(lvs[0])
               if r.shape[0] <= COARSE_BLOCK_MAX)
    kw = dict(signs=signs, per_y=per_y, omega=omega)
    du = tail([lv[top:] for lv in lvs], dias, nsweeps=nsweeps,
              coarsest=coarsest,
              h2=h2_half * (n_half // lvs[0][top].shape[0]) ** 2, **kw)
    for k in reversed(range(top)):
        rk = [lv[k] for lv in lvs]
        du = prolong_relax_fn(du, rk, dias, nsweeps=nsweeps,
                              h2=h2_half * (n_half // rk[0].shape[0]) ** 2,
                              **kw)
    return du


# -----------------------------------------------------------------------------
# Wrappers
# -----------------------------------------------------------------------------

def _check_level(t, name, n=None, min_n=16):
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {t.dtype}, want float32/float64")
    if t.dim() != 2 or t.shape[0] != t.shape[1]:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want square 2D")
    m = t.shape[0]
    if n is not None and m != n:
        raise ValueError(f"{name}: size {m}, want {n}")
    if m < min_n or m & (m - 1):
        raise ValueError(f"{name}: size {m}, want a power of two >= {min_n}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_box(t, name, shape=None, min_n=2):
    """A level of a box of unit boxes: 2D, the shorter side a power of two
    of at least ``min_n`` and the longer side a multiple of it (a square
    level is the one-box case), of ``shape`` if given."""
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {t.dtype}, want float32/float64")
    if t.dim() != 2:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want 2D")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
    m = min(t.shape)
    if m < min_n or m & (m - 1):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want its shorter "
                         f"side a power of two >= {min_n}")
    if max(t.shape) % m:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want its longer "
                         "side a multiple of its shorter one")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def check(t, name, shape):
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {t.dtype}, want float32/float64")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def check_faces(ufx, ufy, n0, n1):
    check(ufx, "ufx", (n0 + 1, n1))
    check(ufy, "ufy", (n0, n1 + 1))


def _check_pair(*lists):
    for ts in lists:
        if len(ts) != 2:
            raise ValueError(f"a pair wants two systems, got {len(ts)}")


def _on_cpu(*tensors):
    """True for CPU tensors (plain version), False for CUDA (kernel)."""
    ts = [t for t in tensors if t is not None]
    dev, dtype = ts[0].device, ts[0].dtype
    for t in ts[1:]:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"inputs on {[t.device for t in ts]} with "
                             f"dtypes {[t.dtype for t in ts]}: want one")
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        return False
    raise RuntimeError(f"no kernel for device {dev}")


@functools.lru_cache(maxsize=1024)
def doubles(*vals):
    """A host array of C doubles (the kernels' scalars and BC values),
    cached: a solve passes the same values at every launch, and building
    the array costs host time that the shortest kernels would see.  The
    kernels only read it."""
    return (ctypes.c_double * len(vals))(*map(float, vals))


def pointers(*groups):
    """One host table of the device pointers of a launch: the groups'
    tensors in order (NULL for None)."""
    ptrs = [None if t is None else t.data_ptr() for ts in groups for t in ts]
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


@functools.lru_cache(maxsize=None)
def _kernel_fn(fn_name, dtype):
    """The library's C function of a kernel, looked up once per (name,
    dtype)."""
    from .build import library
    suffix = "f32" if dtype == torch.float32 else "f64"
    return getattr(library(), f"gtt_{fn_name}_{suffix}")


# the current stream's handle without a Stream object (PyTorch's own
# launchers read it so); torch.cuda.current_stream where it is missing
_CURRENT_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _raw_stream(index):
    """The current stream of device ``index`` as a handle."""
    if _CURRENT_RAW_STREAM is not None:
        return _CURRENT_RAW_STREAM(index)
    return torch.cuda.current_stream(index).cuda_stream


def _call(fn_name, dtype, device, *args):
    """Launch ``fn_name`` on the current stream of ``device``, entering the
    device only when it is not the current one; raise on a launch error."""
    fn = _kernel_fn(fn_name, dtype)
    index = device.index
    if index == torch.cuda.current_device():
        err = fn(*args, _raw_stream(index))
    else:
        with torch.cuda.device(device):
            err = fn(*args, _raw_stream(index))
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err} at launch")


def _sub_tensor(sub, u):
    """``sub`` as a one-element tensor of u's dtype and device, or None for
    0.0 (the kernel reads it, so a device-side mean costs no host sync)."""
    if not isinstance(sub, torch.Tensor):
        return None if sub == 0.0 else \
            torch.full((1,), sub, dtype=u.dtype, device=u.device)
    if sub.numel() != 1 or sub.dtype != u.dtype or sub.device != u.device:
        raise ValueError("sub: want one element of u's dtype and device")
    return sub


# residual_restrict's tile rows (its tiles are rows x 128 cells): 32, or 8
# and 16 on request (test-only, to time them)
RR_ROWS = (32, 16, 8)


def _rr_rows(tile_rows):
    rows = RR_ROWS[0] if tile_rows is None else tile_rows
    if rows not in RR_ROWS:
        raise ValueError(f"tile_rows {rows}, want one of {RR_ROWS}")
    return rows


def _residual_restrict_cuda(us, rhss, dias, subs, h2, signs, offss, per_y,
                            counter, tile_rows=None):
    n = us[0].shape[0]
    r0s = [torch.empty_like(u) for u in us]
    r1s = [u.new_empty((n // 2, n // 2)) for u in us]
    r2s = [u.new_empty((n // 4, n // 4)) for u in us]
    sub_ts = [_sub_tensor(s, u) for s, u in zip(subs, us)]  # held to launch
    _call("residual_restrict", us[0].dtype, us[0].device, len(us),
          pointers(us, rhss, sub_ts, r0s, r1s, r2s), doubles(*dias),
          doubles(*(o for offs in offss for o in offs)), float(h2), n, n,
          doubles(*signs), int(per_y), _rr_rows(tile_rows))
    LAUNCHES[counter] += 1
    return r0s, r1s, r2s


def residual_restrict(u, rhs, dia=0.0, sub=0.0, *, h2, signs,
                      offs=_HOMOGENEOUS, per_y=False, tile_rows=None):
    """(r0, r1, r2): r0 = (rhs - sub) - (L - dia) u with static ghosts
    (sgn, off), r1 = pool(r0), r2 = pool(r1).  ``dia`` is a float; ``sub``
    a float or a one-element tensor on the device of ``u`` (read by the
    kernel, so a device-side mean costs no host sync).  ``tile_rows``
    (RR_ROWS; test-only): the kernel's tile height."""
    _check_level(u, "u")
    _check_level(rhs, "rhs", u.shape[0])
    if _on_cpu(u, rhs):
        return residual_restrict_plain(u, rhs, dia, sub, h2=h2, signs=signs,
                                       offs=offs, per_y=per_y)
    out = _residual_restrict_cuda([u], [rhs], [dia], [sub], h2, signs,
                                  [offs], per_y, "residual_restrict",
                                  tile_rows)
    return tuple(x[0] for x in out)


def residual_restrict_pair(us, rhss, dias, subs=(0.0, 0.0), *, h2, signs,
                           offss, per_y=False, tile_rows=None):
    """K1 for the two systems of a pair in one launch: each has its own
    ``dia``, ``sub`` (as in residual_restrict) and ghost offsets
    ``offss[b]``; the signs and ``per_y`` are shared.  Returns ([r0_0,
    r0_1], [r1_0, r1_1], [r2_0, r2_1])."""
    _check_pair(us, rhss, dias, subs, offss)
    n = us[0].shape[0]
    for b in range(2):
        _check_level(us[b], f"us[{b}]", n)
        _check_level(rhss[b], f"rhss[{b}]", n)
    if _on_cpu(*us, *rhss):
        return residual_restrict_pair_plain(us, rhss, dias, subs, h2=h2,
                                            signs=signs, offss=offss,
                                            per_y=per_y)
    return _residual_restrict_cuda(us, rhss, dias, subs, h2, signs, offss,
                                   per_y, "residual_restrict_pair",
                                   tile_rows)


# the pyramid's arrival counts (one per system of a launch) by device and
# stream, 0 between launches: the last block of a launch resets its own;
# and the cascades' pyramid workspaces by (device, stream, dtype, size,
# levels, batch)
_ARRIVALS = {}
_WORKSPACES = {}


def _pyramid_levels(r, batch, levels):
    """``batch`` buffers of the levels below r's, and each one's levels
    as (m0, m1) views of it, finest first."""
    n0, n1 = r.shape
    bufs, outs = [], []
    for _ in range(batch):
        buf = r.new_empty(sum((n0 >> k) * (n1 >> k)
                              for k in range(1, levels + 1)))
        views, off = [], 0
        for k in range(1, levels + 1):
            m0, m1 = n0 >> k, n1 >> k
            views.append(buf[off:off + m0 * m1].view(m0, m1))
            off += m0 * m1
        bufs.append(buf)
        outs.append(views)
    return bufs, outs


def _pyramid_cuda(rs, levels, counter, workspace=False):
    """One restrict_pyramid launch over the systems ``rs``: each system's
    ``levels`` levels, finest first.  With ``workspace`` (the cascades,
    whose own launches consume the levels in stream order before the
    next pyramid on the stream) the levels are one reused workspace per
    shape and stream, which saves the host the tensors' creation; else
    new tensors."""
    r, dev = rs[0], rs[0].device
    stream = _raw_stream(dev.index)
    count = _ARRIVALS.get((dev.index, stream))
    if count is None:
        count = _ARRIVALS[dev.index, stream] = torch.zeros(
            MAX_BATCH, dtype=torch.int32, device=dev)
    key = (dev.index, stream, r.dtype, tuple(r.shape), levels, len(rs))
    made = _WORKSPACES.get(key) if workspace else None
    if made is None:
        made = _pyramid_levels(r, len(rs), levels)
        if workspace:
            _WORKSPACES[key] = made
    bufs, outs = made
    _call("restrict_pyramid", r.dtype, dev, len(rs), pointers(rs, bufs),
          r.shape[0], r.shape[1], levels, count.data_ptr())
    LAUNCHES[counter] += 1
    return outs


def _check_pyramid(r, levels, name="r", shape=None):
    _check_box(r, name, shape)
    m = min(r.shape)
    if not 1 <= levels or m >> levels < 1:
        raise ValueError(f"restrict_pyramid: {levels} levels of a "
                         f"{tuple(r.shape)} level, want 1 to "
                         f"{m.bit_length() - 1}")


def restrict_pyramid(r, levels):
    """The ``levels`` successive 2x2 means of r, finest first: [pool(r),
    pool(pool(r)), ...], in one launch (the corrections' and cascades'
    restriction).  r is a square level or a box's (n0, n1) level
    (_check_box)."""
    _check_pyramid(r, levels)
    if _on_cpu(r):
        return pyramid_plain(r, levels)
    return _pyramid_cuda([r], levels, "restrict_pyramid")[0]


def restrict_pyramid_pair(rs, levels):
    """restrict_pyramid of the two systems of a pair in one launch: [levels
    of rs[0], levels of rs[1]]."""
    _check_pair(rs)
    for b in range(2):
        _check_pyramid(rs[b], levels, f"rs[{b}]", rs[0].shape)
    if _on_cpu(*rs):
        return [pyramid_plain(r, levels) for r in rs]
    return _pyramid_cuda(rs, levels, "restrict_pyramid_pair")


def restrict2(r):
    """One 2x2 mean pool: restrict_pyramid's one-level case."""
    _check_pyramid(r, 1)
    if _on_cpu(r):
        return pool_plain(r)
    return _pyramid_cuda([r], 1, "restrict2")[0][0]


def _engine_smem(side, itemsize, buffers=2):
    """Shared memory of a sweep-engine block of ``side`` cells a side and
    ``buffers`` buffers (K3 and K10: du and rhs; K15 five), each in two
    colour halves padded as csrc/rbgs.cu:pr_half."""
    e = side * (side // 2)
    return 2 * buffers * (e + (48 - e % 32) % 32) * itemsize


@functools.lru_cache(maxsize=1024)
def _prolong_geometry(n, nsweeps, tile, whole_max, itemsize, blocks=1):
    """(tile, halo) of a K3-family launch: a level of at most
    ``whole_max`` cells per side is one block with no halo; a larger
    level uses tile x tile tiles with a halo of 2*nsweeps, ``tile`` if
    given, else the largest of 64, 32, 16 whose buffers fit in shared
    memory and that still gives each of the card's multiprocessors a
    block (``blocks``: the multiprocessors over the batch), else the
    smallest that fits.  The tile changes the launch geometry only: the
    result is bit-identical for every tile."""
    if n <= whole_max:
        tile, halo = n, 0
    else:
        halo = 2 * nsweeps
        if tile is None:
            fits = [t for t in (64, 32, 16) if n % t == 0 and _engine_smem(
                t + 2 * halo + 2, itemsize) <= _SMEM_MAX]
            wide = [t for t in fits if (n // t) ** 2 >= blocks]
            tile = wide[0] if wide else fits[-1] if fits else 16
        if n % tile:
            raise ValueError(f"tile {tile} does not divide {n}")
    side = tile + 2 * halo + 2
    if _engine_smem(side, itemsize) > _SMEM_MAX:
        raise ValueError(f"prolong_relax: a {side}^2 buffer does not fit "
                         "in shared memory (fewer sweeps or a smaller tile)")
    return tile, halo


def _prolong_plan(rhs, nsweeps, tile, whole_max, batch=1):
    """_prolong_geometry for a launch of ``batch`` systems like ``rhs``
    on its card."""
    sms = _multiprocessors(rhs.device)
    return _prolong_geometry(rhs.shape[0], nsweeps, tile, whole_max,
                             rhs.element_size(), -(-sms // batch))


def _prolong_relax_cuda(coarses, rhss, dias, us, nsweeps, h2, signs, per_y,
                        omega, tile, whole_max, counter):
    n = rhss[0].shape[0]
    tile, halo = _prolong_plan(rhss[0], nsweeps, tile, whole_max, len(rhss))
    outs = [torch.empty_like(r) for r in rhss]
    _call("prolong_relax", rhss[0].dtype, rhss[0].device, len(rhss),
          pointers(coarses, rhss, us, outs), doubles(*dias), n, n, tile, halo,
          int(nsweeps), float(h2), float(omega), doubles(*signs),
          int(per_y))
    LAUNCHES[counter] += 1
    return outs


def _check_prolong(coarse, rhs, u, n=None, tag=""):
    _check_level(rhs, "rhs" + tag, n, min_n=2)
    n = rhs.shape[0]
    if coarse is not None:
        _check_level(coarse, "coarse" + tag, n // 2, min_n=1)
    if u is not None:
        _check_level(u, "u" + tag, n, min_n=2)


def prolong_relax(coarse, rhs, dia=0.0, u=None, *, nsweeps, h2, signs,
                  per_y=False, omega=1.0, tile=None, whole_max=64):
    """du = relax^nsweeps(prolong(coarse)) on (L - dia) du = rhs with
    homogeneous ghosts; returns du, or u + du when ``u`` is given.
    ``coarse=None`` starts from du = 0 (the coarsest level)."""
    _check_prolong(coarse, rhs, u)
    if _on_cpu(coarse, rhs, u):
        return prolong_relax_plain(coarse, rhs, dia, u, nsweeps=nsweeps,
                                   h2=h2, signs=signs, per_y=per_y,
                                   omega=omega)
    return _prolong_relax_cuda([coarse], [rhs], [dia], [u], nsweeps, h2,
                               signs, per_y, omega, tile, whole_max,
                               "prolong_relax")[0]


def prolong_relax_pair(coarses, rhss, dias, us, *, nsweeps, h2, signs,
                       per_y=False, omega=1.0, tile=None, whole_max=64):
    """K3 for the two systems of a pair in one launch, each with its own
    ``dia``: [u_b + relax^nsweeps(prolong(coarses[b]))].  A coarse of
    None starts that system from du = 0; ``us`` entries may be None
    (du alone)."""
    _check_pair(coarses, rhss, dias, us)
    n = rhss[0].shape[0]
    for b in range(2):
        _check_prolong(coarses[b], rhss[b], us[b], n, f"[{b}]")
    if _on_cpu(*coarses, *rhss, *us):
        return prolong_relax_pair_plain(coarses, rhss, dias, us,
                                        nsweeps=nsweeps, h2=h2, signs=signs,
                                        per_y=per_y, omega=omega)
    return _prolong_relax_cuda(coarses, rhss, dias, us, nsweeps, h2, signs,
                               per_y, omega, tile, whole_max,
                               "prolong_relax_pair")


def residual_restrict_div(u, ufx, ufy, dtm, dia=0.0, sub=0.0, *, h2, signs,
                          offs=_HOMOGENEOUS, per_y=False, tile_rows=None):
    """K16: K1's (r0, r1, r2) with the rhs formed in the kernel from the
    MAC faces ufx (n+1, n) and ufy (n, n+1): rhs = div(uf) / dt, where
    ``dtm`` = dt * h.  One launch in place of K4 + K1.  ``sub`` as in
    residual_restrict (the fold route passes 0)."""
    _check_level(u, "u")
    n = u.shape[0]
    check_faces(ufx, ufy, n, n)
    if _on_cpu(u, ufx, ufy):
        return residual_restrict_div_plain(u, ufx, ufy, dtm, dia, sub, h2=h2,
                                           signs=signs, offs=offs,
                                           per_y=per_y)
    r0 = torch.empty_like(u)
    r1, r2 = u.new_empty((n // 2, n // 2)), u.new_empty((n // 4, n // 4))
    sub_t = _sub_tensor(sub, u)  # held to the launch
    _call("residual_restrict_div", u.dtype, u.device,
          pointers((u, ufx, ufy, sub_t, r0, r1, r2)), float(dia),
          doubles(*offs), float(h2), 1.0 / float(dtm), n, n, doubles(*signs),
          int(per_y), _rr_rows(tile_rows))
    LAUNCHES["residual_restrict_div"] += 1
    return r0, r1, r2


def prolong_relax_correct(coarse, rhs, dia, u, ufx, ufy, dt, h, cells=None,
                          *, nsweeps, h2, signs, offs, per_y=False,
                          omega=1.0, tile=None, whole_max=64):
    """K17: p' = u + relax^nsweeps(prolong(coarse)) as K3 computes it
    (homogeneous ghosts), then in the same launch the projection's
    correction by p' with the real ghosts (signs, offs): (p', ufx', ufy',
    gx, gy, U', V'), with uf' = uf - dt grad_f p', g the mean of a cell's
    two face gradients and, with ``cells`` = (U, V), U' = U - dt gx, V' =
    V - dt gy (else None, None).  One launch in place of K3 + K5."""
    if u is None:
        raise ValueError("prolong_relax_correct: u is required")
    _check_prolong(coarse, rhs, u)
    n = rhs.shape[0]
    check_faces(ufx, ufy, n, n)
    cells = None if cells is None else tuple(cells)
    for c in cells or ():
        _check_level(c, "cells", n, min_n=2)
    if _on_cpu(coarse, rhs, u, ufx, ufy, *(cells or ())):
        return prolong_relax_correct_plain(
            coarse, rhs, dia, u, ufx, ufy, dt, h, cells, nsweeps=nsweeps,
            h2=h2, signs=signs, offs=offs, per_y=per_y, omega=omega)
    # K3's geometry: its frozen outer ring lies beyond the halo, so du,
    # and hence p', is exact on the ring around each tile that the tile's
    # face gradients read (csrc/rbgs.cu, K17's note)
    tile, halo = _prolong_plan(rhs, nsweeps, tile, whole_max)
    p = torch.empty_like(rhs)
    out = [p, torch.empty_like(ufx), torch.empty_like(ufy),
           torch.empty_like(rhs), torch.empty_like(rhs)]
    out += [None, None] if cells is None else \
        [torch.empty_like(rhs), torch.empty_like(rhs)]
    _call("prolong_relax_correct", rhs.dtype, rhs.device,
          pointers((coarse, rhs, u, ufx, ufy) + (cells or (None, None)),
                   out), float(dia), n, n, tile, halo, int(nsweeps),
          float(h2), float(omega), float(dt), float(h), doubles(*signs),
          doubles(*offs), int(per_y))
    LAUNCHES["prolong_relax_correct"] += 1
    return tuple(out)


def _cascade_cuda(r1s, r2s, dias, nsweeps, coarsest, h2_half, signs, per_y,
                  omega, min_n, counter):
    """The cascade on the card: one restrict_pyramid launch down to
    min(min_n, n/4), one coarse_block launch for the levels at and below
    COARSE_BLOCK_MAX (from zero with ``coarsest`` sweeps at the coarsest;
    the whole cascade when n/2 is that small), then prolong_relax
    launches, each over the whole batch of systems, counted under
    ``counter``.restrict_pyramid, .coarse_block and .prolong_relax.  The
    TPU kernels ran this in one launch with the sub-cascade carried
    across grid steps in VMEM; blocks of a GPU grid carry nothing, so the
    sequence runs from the host."""
    def pyramid(rs, levels):
        return _pyramid_cuda(rs, levels, counter + ".restrict_pyramid", True)

    def tail(levels, ds, *, nsweeps, coarsest, h2, signs, per_y, omega):
        return _coarse_block_cuda(levels, ds, nsweeps, coarsest, h2, signs,
                                  per_y, omega, counter + ".coarse_block")

    def launch(coarses, rhss, ds, *, nsweeps, h2, signs, per_y, omega):
        return _prolong_relax_cuda(coarses, rhss, ds, [None] * len(ds),
                                   nsweeps, h2, signs, per_y, omega, None,
                                   64, counter + ".prolong_relax")

    return _cascade(r1s, r2s, dias, nsweeps, coarsest, h2_half, signs,
                    per_y, omega, min_n, pyramid, tail, launch)


def _check_min_n(min_n):
    if not 2 <= min_n <= 16:
        raise ValueError(f"cascade: min_n {min_n}, want 2 to 16")


def cascade_prolong_relax(r1, r2, dia=0.0, *, nsweeps, coarsest, h2_half,
                          signs, per_y=False, omega=1.0, min_n=16):
    """The whole correction at and below n/2 = r1.shape[0], returned as a
    plain (n/2, n/2) du (no rep layout)."""
    _check_level(r1, "r1", min_n=32)
    _check_level(r2, "r2", r1.shape[0] // 2)
    _check_min_n(min_n)
    if _on_cpu(r1, r2):
        return cascade_prolong_relax_plain(
            r1, r2, dia, nsweeps=nsweeps, coarsest=coarsest,
            h2_half=h2_half, signs=signs, per_y=per_y, omega=omega,
            min_n=min_n)
    LAUNCHES["cascade_prolong_relax"] += 1
    return _cascade_cuda([r1], [r2], [dia], nsweeps, coarsest, h2_half,
                         signs, per_y, omega, min_n, "cascade")[0]


def cascade_prolong_relax_pair(r1s, r2s, dias, *, nsweeps, coarsest,
                               h2_half, signs, per_y=False, omega=1.0,
                               min_n=16):
    """K2 for the two systems of a pair, each with its own ``dia`` and its
    own pyramid: [du_0, du_1], plain (n/2, n/2) corrections.  On the card
    every step of the sequence is one launch for both systems."""
    _check_pair(r1s, r2s, dias)
    for b in range(2):
        _check_level(r1s[b], f"r1s[{b}]", r1s[0].shape[0], min_n=32)
        _check_level(r2s[b], f"r2s[{b}]", r1s[0].shape[0] // 2)
    _check_min_n(min_n)
    if _on_cpu(*r1s, *r2s):
        return cascade_prolong_relax_pair_plain(
            r1s, r2s, dias, nsweeps=nsweeps, coarsest=coarsest,
            h2_half=h2_half, signs=signs, per_y=per_y, omega=omega,
            min_n=min_n)
    LAUNCHES["cascade_prolong_relax_pair"] += 1
    return _cascade_cuda(r1s, r2s, dias, nsweeps, coarsest, h2_half, signs,
                         per_y, omega, min_n, "cascade_pair")


# -----------------------------------------------------------------------------
# The adaptive solve's kernels: K11 residual, K10 rbgs_relax, K12
# coarse_vcycle
# -----------------------------------------------------------------------------

def residual(u, rhs, dia=0.0, *, h2, signs, offs=_HOMOGENEOUS,
             periodic=(False, False)):
    """K11: r = rhs - (L - dia) u with static ghosts (sgn, off), periodic
    on either axis (``periodic`` per axis overrides the signs).  The level
    may be a box's rectangle (n0, n1) (_check_box)."""
    _check_box(u, "u", min_n=1)
    _check_box(rhs, "rhs", u.shape, min_n=1)
    if _on_cpu(u, rhs):
        return residual_plain(u, rhs, dia, h2=h2, signs=signs, offs=offs,
                              periodic=periodic)
    n0, n1 = u.shape
    r = torch.empty_like(u)
    _call("residual", u.dtype, u.device, u.data_ptr(), rhs.data_ptr(),
          r.data_ptr(), n0, n1, float(dia), float(h2), doubles(*signs),
          doubles(*offs), int(periodic[0]), int(periodic[1]))
    LAUNCHES["residual"] += 1
    return r


# shared-memory buffers of a sweep-engine block: u and rhs (K3, K10),
# and K15's two face buffers and den
BUFFERS = {"rbgs_relax": 2, "rbgs_relax_alpha": 5}


@functools.lru_cache(maxsize=4096)
def _sweep_plan(shape, nsweeps, buffers, itemsize, sms=1, tile=None,
                threads=None, whole_max=64):
    """(tile, sweeps per launch, threads) of a K10 (``buffers`` 2) or K15
    (5) launch on an n0 x n1 level (``shape``, or n for a square one; a
    box's rectangle).  A level of at most ``whole_max`` cells per side is
    one block with no halo that takes every sweep, its tile the longer
    side (rounded up to even).
    A larger one uses tile x tile tiles with a halo of 2 sweeps per
    launch:
    ``tile`` if given, else the largest of 64, 32, 16 whose buffers hold
    the halo of all the sweeps in shared memory and that still gives each
    of the card's ``sms`` multiprocessors a block (else the smallest that
    holds them: a level's blocks run side by side, and its half-sweeps
    one after another), else 32 with the sweeps split over consecutive
    launches of as many as fit.  ``threads``, unless given: 512 for whole
    levels (their serial half-sweeps hide shared-memory latency better
    with 16 warps than with 8), for tile 64, and for K15's tile 32 (five
    buffers, more work per cell), else 256 (the times per tile and
    threads on an H100: PERF.md, and chip_smoke.py's phase 2).  The tile, the threads and the split change the
    launch geometry only: the result is bit-identical for all of them."""
    if threads not in (None, 256, 512):
        raise ValueError(f"threads {threads}, want 256 or 512")
    shape = (shape, shape) if isinstance(shape, int) else tuple(shape)
    n = max(shape)
    if n <= whole_max:
        # the engine's colour halves want an even buffer side: a (1, 3)
        # level takes tile 4, its sweeps and write clipped to the level
        n += n & 1
        if _engine_smem(n + 2, itemsize, buffers) > _SMEM_MAX:
            raise ValueError(f"a whole {shape} level does not fit in shared "
                             "memory (a smaller whole_max)")
        return n, nsweeps, threads or 512
    n0, n1 = shape

    def most(t):
        """The most sweeps (up to nsweeps) of one launch at tile t."""
        k = 0
        while k < nsweeps and _engine_smem(t + 4 * k + 6, itemsize,
                                           buffers) <= _SMEM_MAX:
            k += 1
        return k

    if tile is None:
        fits = [t for t in (64, 32, 16) if n0 % t == 0 and n1 % t == 0
                and most(t) == nsweeps]
        wide = [t for t in fits if (n0 // t) * (n1 // t) >= sms]
        tile = wide[0] if wide else fits[-1] if fits else \
            32 if min(shape) % 32 == 0 else 16
    if n0 % tile or n1 % tile:
        raise ValueError(f"tile {tile} does not divide {shape}")
    per = most(tile)
    if per < 1:
        raise ValueError(f"tile {tile} does not fit in shared memory")
    wide = 64 if buffers == BUFFERS["rbgs_relax"] else 32
    return tile, per, threads or (512 if tile >= wide else 256)


def _plan(kernel, u, nsweeps, tile, threads, whole_max):
    return _sweep_plan(tuple(u.shape), int(nsweeps), BUFFERS[kernel],
                       u.element_size(), _multiprocessors(u.device), tile,
                       threads, whole_max)


def rbgs_relax(u, rhs, dia=0.0, *, nsweeps, h2, signs,
               periodic=(False, False), omega=1.0, tile=None, threads=None,
               whole_max=64):
    """K10: ``nsweeps`` red-black Gauss-Seidel sweeps from ``u`` on
    (L - dia) u = rhs with homogeneous ghosts, periodic on either axis.
    One launch, unless the sweeps' halo outgrows shared memory (then
    consecutive launches of fewer sweeps each).  The level may be a box's
    rectangle (n0, n1) (_check_box).  ``tile``, ``threads`` and
    ``whole_max`` override the plan (_sweep_plan; tests)."""
    _check_box(u, "u", min_n=1)
    _check_box(rhs, "rhs", u.shape, min_n=1)
    if _on_cpu(u, rhs):
        return rbgs_relax_plain(u, rhs, dia, nsweeps=nsweeps, h2=h2,
                                signs=signs, periodic=periodic, omega=omega)
    n0, n1 = u.shape
    tile, per, threads = _plan("rbgs_relax", u, nsweeps, tile, threads,
                               whole_max)
    whole = tile >= max(n0, n1)
    left = nsweeps
    while left > 0:
        k = min(left, per)
        out = torch.empty_like(u)
        _call("rbgs_relax", u.dtype, u.device, u.data_ptr(), rhs.data_ptr(),
              out.data_ptr(), n0, n1, tile, 0 if whole else 2 * k, k,
              float(dia), float(h2), float(omega), doubles(*signs),
              int(periodic[0]), int(periodic[1]), threads)
        LAUNCHES["rbgs_relax"] += 1
        u, left = out, left - k
    return u


@functools.lru_cache(maxsize=8)
def _multiprocessors(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_alpha(u, rhs, ax, ay, dia, dia_cell, coarse, add):
    _check_box(rhs, "rhs")
    n0, n1 = rhs.shape
    if u is not None:
        if coarse is not None:
            raise ValueError("rbgs_relax_alpha: give u or coarse, not both")
        _check_box(u, "u", rhs.shape)
    if coarse is not None:
        _check_box(coarse, "coarse", (n0 // 2, n1 // 2), min_n=1)
    if add is not None:
        _check_box(add, "add", rhs.shape)
    check_faces(ax, ay, n0, n1)
    if dia_cell:
        check(dia, "dia", (n0, n1))
    elif isinstance(dia, torch.Tensor):
        raise TypeError("rbgs_relax_alpha: a tensor dia needs dia_cell")


def rbgs_relax_alpha(u, rhs, ax, ay, dia=0.0, *, nsweeps, h2, signs,
                     periodic=(False, False), omega=1.0, dia_cell=False,
                     coarse=None, add=None, tile=None, threads=None,
                     whole_max=64):
    """K15: ``nsweeps`` red-black Gauss-Seidel sweeps on div(alpha grad
    u) - dia u = rhs with face coefficients ``ax`` (n0+1, n1), ``ay``
    (n0, n1+1) and a scalar or (``dia_cell``) per-cell ``dia``,
    homogeneous ghosts, periodic on either axis; from ``u``, or with u
    None from the bilinear prolongation of ``coarse`` (n/2 x n/2,
    homogeneous ghosts, placed in the kernel), or from zero without one;
    ``add`` is added to the result.  The level may be a box's rectangle
    (n0, n1) (_check_box), ``coarse`` then (n0/2, n1/2).  One launch,
    unless the sweeps' halo outgrows shared memory (then consecutive
    launches of fewer sweeps each: the first places the prolongation, the
    last adds).  ``tile``, ``threads`` and ``whole_max`` override the plan
    (_sweep_plan; tests)."""
    _check_alpha(u, rhs, ax, ay, dia, dia_cell, coarse, add)
    if _on_cpu(u, rhs, ax, ay, dia if dia_cell else None, coarse, add):
        return rbgs_relax_alpha_plain(u, rhs, ax, ay, dia, nsweeps=nsweeps,
                                      h2=h2, signs=signs, periodic=periodic,
                                      omega=omega, dia_cell=dia_cell,
                                      coarse=coarse, add=add)
    n0, n1 = rhs.shape
    tile, per, threads = _plan("rbgs_relax_alpha", rhs, nsweeps, tile,
                               threads, whole_max)
    whole = tile >= max(n0, n1)
    src, prolong = (coarse, 1) if u is None else (u, 0)
    left = nsweeps
    while True:
        k = min(left, per)
        out = torch.empty_like(rhs)
        _call("rbgs_relax_alpha", rhs.dtype, rhs.device,
              pointers((src, rhs, ax, ay, dia if dia_cell else None,
                        add if k >= left else None, out)),
              prolong, n0, n1, tile, 0 if whole else 2 * k, k,
              0.0 if dia_cell else float(dia), float(h2), float(omega),
              doubles(*signs), int(periodic[0]), int(periodic[1]), threads)
        LAUNCHES["rbgs_relax_alpha"] += 1
        if prolong and src is not None:
            LAUNCHES["rbgs_relax_alpha.prolong"] += 1
        src, prolong, left = out, 0, left - k
        if left <= 0:
            return src


def _check_coarse(r, min_n, name="r", n=None):
    _check_level(r, name, n, min_n=2)
    if not 2 <= min(min_n, r.shape[0]) <= COARSE_BLOCK_MAX:
        raise ValueError(f"coarse_vcycle: min_n {min_n}, want 2 to "
                         f"{COARSE_BLOCK_MAX}")


def _coarse_block_cuda(levels, dias, nsweeps, coarsest, h2, signs, per_y,
                       omega, counter, fused=False, warps=None):
    """One coarse_block launch, a block per system: ``levels`` holds each
    system's levels' rhs, finest first, the finest (at most
    COARSE_BLOCK_MAX per side) with h2 ``h2``.  Returns each system's du
    at the finest level.  ``fused``: each level's 1 / (4 + dia h2) formed
    with one rounding of dia h2 + 4, as K12's block kernel did before the
    cascades took it (K12's route); else as K3's launches form it."""
    top = levels[0][0]
    n = top.shape[0]
    if n > COARSE_BLOCK_MAX or n >> (len(levels[0]) - 1) < 2:
        raise ValueError(f"coarse_block: levels {n}^2 to "
                         f"{n >> (len(levels[0]) - 1)}^2, want at most "
                         f"{COARSE_BLOCK_MAX}^2 down to at least 2^2")
    warps = _check_warps(warps)
    dus = [torch.empty_like(lv[0]) for lv in levels]
    _call("coarse_block", top.dtype, top.device, len(levels),
          pointers(*levels, dus), doubles(*dias), n, len(levels[0]),
          int(nsweeps), int(coarsest), float(h2), float(omega),
          doubles(*signs), int(per_y), int(fused), *warps)
    LAUNCHES[counter] += 1
    return dus


def _check_warps(warps):
    warps = tuple(warps or CB_WARPS)
    if warps not in CB_WARPS_SHAPES:
        raise ValueError(f"coarse_block: warps {warps} (16^2 and below, "
                         f"32^2), want one of {CB_WARPS_SHAPES}")
    return warps


def _with_pyramid(rs, min_n, counter):
    """Each system's levels, finest first: its r and, by one
    restrict_pyramid launch over the systems, its levels down to
    min(min_n, n)."""
    levels = _tail_levels(rs[0].shape[0], min_n)
    if not levels:
        return [[r] for r in rs]
    return [[r] + lv for r, lv in zip(rs, _pyramid_cuda(rs, levels, counter,
                                                          True))]


def coarse_block(r, dia=0.0, *, nsweeps, coarsest, h2, signs, per_y=False,
                 min_n=16, omega=1.0, warps=None):
    """The block kernel alone (K12's route): coarse_vcycle of a level of at
    most COARSE_BLOCK_MAX cells per side, its levels down to min(min_n,
    n) from one restrict_pyramid launch, then one launch of one block.
    ``warps`` (test-only, one of CB_WARPS_SHAPES) overrides the launch's
    (CB_WARPS)."""
    _check_coarse(r, min_n)
    _check_warps(warps)
    if r.shape[0] > COARSE_BLOCK_MAX:
        raise ValueError(f"coarse_block: {r.shape[0]}^2 above "
                         f"{COARSE_BLOCK_MAX}^2")
    if _on_cpu(r):
        return coarse_vcycle_plain(r, dia, nsweeps=nsweeps, coarsest=coarsest,
                                   h2=h2, signs=signs, per_y=per_y,
                                   min_n=min_n, omega=omega)
    return _coarse_block_cuda(
        _with_pyramid([r], min_n, "coarse_block.restrict_pyramid"), [dia],
        nsweeps, coarsest, h2, signs, per_y, omega, "coarse_block", True,
        warps)[0]


def coarse_block_pair(rs, dias, *, nsweeps, coarsest, h2, signs,
                      per_y=False, min_n=16, omega=1.0, warps=None):
    """coarse_block for the two systems of a pair, each with its own
    ``dia``: one pair pyramid, one launch of two blocks; [du_0, du_1]."""
    _check_pair(rs, dias)
    for b in range(2):
        _check_coarse(rs[b], min_n, f"rs[{b}]", rs[0].shape[0])
    _check_warps(warps)
    if rs[0].shape[0] > COARSE_BLOCK_MAX:
        raise ValueError(f"coarse_block_pair: {rs[0].shape[0]}^2 above "
                         f"{COARSE_BLOCK_MAX}^2")
    if _on_cpu(*rs):
        return [coarse_vcycle_plain(r, d, nsweeps=nsweeps, coarsest=coarsest,
                                    h2=h2, signs=signs, per_y=per_y,
                                    min_n=min_n, omega=omega)
                for r, d in zip(rs, dias)]
    return _coarse_block_cuda(
        _with_pyramid(rs, min_n, "coarse_block_pair.restrict_pyramid"), dias,
        nsweeps, coarsest, h2, signs, per_y, omega, "coarse_block_pair", True,
        warps)


def coarse_vcycle(r, dia=0.0, *, nsweeps, coarsest, h2, signs, per_y=False,
                  min_n=16):
    """K12: du for the sub-hierarchy at and below r's level (homogeneous
    ghosts, non-periodic rows, omega 1; ``h2`` is r's level's).  On the
    card: one restrict_pyramid launch down to min_n, one coarse_block
    launch for the levels at and below COARSE_BLOCK_MAX and K3 launches
    up from there (1 + 1 + 3 launches at 512^2; 1 + 1 at most that
    size).  A TPU kernel held the whole cascade in one launch, and a
    512^2 level does not fit one block's shared memory."""
    _check_coarse(r, min_n)
    if _on_cpu(r):
        return coarse_vcycle_plain(r, dia, nsweeps=nsweeps, coarsest=coarsest,
                                   h2=h2, signs=signs, per_y=per_y,
                                   min_n=min_n)
    LAUNCHES["coarse_vcycle"] += 1
    n = r.shape[0]
    rs = _with_pyramid([r], min_n, "coarse_vcycle.restrict_pyramid")[0]
    top = next(k for k, x in enumerate(rs) if x.shape[0] <= COARSE_BLOCK_MAX)
    du = _coarse_block_cuda([rs[top:]], [dia], nsweeps, coarsest,
                            h2 * (n // rs[top].shape[0]) ** 2, signs, per_y,
                            1.0, "coarse_block", True)[0]
    for rk in reversed(rs[:top]):
        du = _prolong_relax_cuda([du], [rk], [dia], [None], nsweeps,
                                 h2 * (n // rk.shape[0]) ** 2, signs, per_y,
                                 1.0, None, 64,
                                 "coarse_vcycle.prolong_relax")[0]
    return du
