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
epilogue).  The kernels are in
``gerris_tpu_torch/csrc/rbgs.cu``; each one's source note says what it
replaces, what bounds it on the H100 and what its design does about it.
A pair launches the single kernel with a batch of two systems, which
share the ghost signs and the periodicity and have their own dia, sub
and ghost offsets; its plain version is the single plain version per
system.

Each wrapper checks its inputs (dtype float32/float64, contiguous, square
power-of-two levels) and then:
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
# A cascade counts calls of its host-side sequence; the restrict2,
# prolong_relax and coarse_block launches it makes are counted apart from
# the wrappers' own: "restrict2" and "cascade.prolong_relax" for K2,
# "restrict2_pair" and "cascade_pair.prolong_relax" for K8b,
# "coarse_vcycle.restrict2", "coarse_block" and
# "coarse_vcycle.prolong_relax" for K12.
LAUNCHES = {"residual_restrict": 0, "restrict2": 0, "prolong_relax": 0,
            "cascade_prolong_relax": 0, "cascade.prolong_relax": 0,
            "residual_restrict_pair": 0, "prolong_relax_pair": 0,
            "cascade_prolong_relax_pair": 0, "restrict2_pair": 0,
            "cascade_pair.prolong_relax": 0, "residual": 0,
            "rbgs_relax": 0, "coarse_vcycle": 0,
            "coarse_vcycle.restrict2": 0, "coarse_block": 0,
            "coarse_vcycle.prolong_relax": 0, "residual_restrict_div": 0,
            "prolong_relax_correct": 0, "rbgs_relax_alpha": 0}

_SMEM_MAX = 232448        # dynamic shared memory a block may use on sm_90
_HOMOGENEOUS = (0.0, 0.0, 0.0, 0.0)
# K12's block kernel holds levels of at most this many cells per side
COARSE_BLOCK_MAX = 64


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
                           dia_cell=False):
    """K15's function (gerris_tpu/ops/pallas/rbgs.py:_kernel_alpha):
    ``nsweeps`` red-black sweeps (red = global (i+j) even first) on
    div(alpha grad u) - dia u = rhs with face coefficients ``ax`` (n0+1,
    n1) and ``ay`` (n0, n1+1), a scalar or (``dia_cell``) per-cell dia,
    homogeneous ghosts sgn * mirror or a wrap on a periodic axis, where
    face n is face 0 (the TPU kernel's wrapped face windows, rbgs.py:
    127-129).  den = ax_lo + ax_hi + ay_lo + ay_hi + dia h2, in that
    order; a cell with den <= 1e-20 (a zero diagonal) is left
    untouched."""
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
    return u


def coarse_vcycle_plain(r, dia=0.0, *, nsweeps, coarsest, h2, signs,
                        per_y=False, min_n=16):
    """The ladder of tests/test_mgfuse.py: restrict r down to min(min_n,
    n), ``coarsest`` sweeps from zero there, then prolong + ``nsweeps``
    sweeps (omega 1) at each level up to r's; h2 is r's level's."""
    n = r.shape[0]
    rs = [r]
    while rs[-1].shape[0] > min(min_n, n):
        rs.append(pool_plain(rs[-1]))
    du = None
    for rk in reversed(rs):
        du = prolong_relax_plain(
            du, rk, dia, nsweeps=coarsest if du is None else nsweeps,
            h2=h2 * (n // rk.shape[0]) ** 2, signs=signs, per_y=per_y)
    return du


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
                    per_y, omega, min_n, _each(pool_plain),
                    _each(prolong_relax_plain))[0]


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
             omega, min_n, pool, prolong_relax_fn):
    """Every correction level at or below n/2 = r1.shape[0] of each
    system: restrict r2 down to min(min_n, n/4), ``coarsest`` sweeps from
    zero there, then prolong + ``nsweeps`` sweeps at each level up to
    n/2.  At level size m the cell size squared is h2_half * (n/2 / m)**2.
    Lists over the systems in and out: ``pool(rs)`` and
    ``prolong_relax_fn(coarses, rhss, dias, **kw)`` take and return lists."""
    n_half = r1s[0].shape[0]
    min_n = min(min_n, n_half // 2)
    rs = {n_half // 2: list(r2s)}
    n = n_half // 2
    while n > min_n:
        rs[n // 2] = pool(rs[n])
        n //= 2
    kw = dict(signs=signs, per_y=per_y, omega=omega)
    du = prolong_relax_fn([None] * len(dias), rs[min_n], dias,
                          nsweeps=coarsest,
                          h2=h2_half * (n_half // min_n) ** 2, **kw)
    n = 2 * min_n
    while n <= n_half // 2:
        du = prolong_relax_fn(du, rs[n], dias, nsweeps=nsweeps,
                              h2=h2_half * (n_half // n) ** 2, **kw)
        n *= 2
    return prolong_relax_fn(du, r1s, dias, nsweeps=nsweeps, h2=h2_half, **kw)


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
    devs = {t.device for t in ts}
    dtypes = {t.dtype for t in ts}
    if len(devs) != 1 or len(dtypes) != 1:
        raise ValueError(f"inputs on {devs} with dtypes {dtypes}: want one")
    dev = devs.pop()
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


def _call(fn_name, dtype, device, *args):
    from .build import library
    suffix = "f32" if dtype == torch.float32 else "f64"
    fn = getattr(library(), f"gtt_{fn_name}_{suffix}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
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


def _residual_restrict_cuda(us, rhss, dias, subs, h2, signs, offss, per_y,
                            counter):
    n = us[0].shape[0]
    r0s = [torch.empty_like(u) for u in us]
    r1s = [u.new_empty((n // 2, n // 2)) for u in us]
    r2s = [u.new_empty((n // 4, n // 4)) for u in us]
    sub_ts = [_sub_tensor(s, u) for s, u in zip(subs, us)]  # held to launch
    _call("residual_restrict", us[0].dtype, us[0].device, len(us),
          pointers(us, rhss, sub_ts, r0s, r1s, r2s), doubles(*dias),
          doubles(*(o for offs in offss for o in offs)), float(h2), n, n,
          doubles(*signs), int(per_y))
    LAUNCHES[counter] += 1
    return r0s, r1s, r2s


def residual_restrict(u, rhs, dia=0.0, sub=0.0, *, h2, signs,
                      offs=_HOMOGENEOUS, per_y=False):
    """(r0, r1, r2): r0 = (rhs - sub) - (L - dia) u with static ghosts
    (sgn, off), r1 = pool(r0), r2 = pool(r1).  ``dia`` is a float; ``sub``
    a float or a one-element tensor on the device of ``u`` (read by the
    kernel, so a device-side mean costs no host sync)."""
    _check_level(u, "u")
    _check_level(rhs, "rhs", u.shape[0])
    if _on_cpu(u, rhs):
        return residual_restrict_plain(u, rhs, dia, sub, h2=h2, signs=signs,
                                       offs=offs, per_y=per_y)
    out = _residual_restrict_cuda([u], [rhs], [dia], [sub], h2, signs,
                                  [offs], per_y, "residual_restrict")
    return tuple(x[0] for x in out)


def residual_restrict_pair(us, rhss, dias, subs=(0.0, 0.0), *, h2, signs,
                           offss, per_y=False):
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
                                   per_y, "residual_restrict_pair")


def _restrict2_cuda(rs, counter):
    n = rs[0].shape[0]
    outs = [r.new_empty((n // 2, n // 2)) for r in rs]
    _call("restrict2", rs[0].dtype, rs[0].device, len(rs),
          pointers(rs, outs), n, n)
    LAUNCHES[counter] += 1
    return outs


def restrict2(r):
    """One 2x2 mean pool (the cascades' and the correction's
    restriction)."""
    _check_level(r, "r", min_n=2)
    if _on_cpu(r):
        return pool_plain(r)
    return _restrict2_cuda([r], "restrict2")[0]


def _prolong_geometry(n, nsweeps, tile, whole_max, itemsize):
    """(tile, halo) of a launch: a level of at most ``whole_max`` cells
    per side is one block with no halo; larger levels use ``tile`` x
    ``tile`` tiles with a halo of 2*nsweeps."""
    if n <= whole_max:
        tile, halo = n, 0
    else:
        halo = 2 * nsweeps
        if n % tile:
            raise ValueError(f"tile {tile} does not divide {n}")
    side = tile + 2 * halo + 2
    if 2 * side * side * itemsize > _SMEM_MAX:
        raise ValueError(f"prolong_relax: a {side}^2 buffer does not fit "
                         "in shared memory (fewer sweeps or a smaller tile)")
    return tile, halo


def _prolong_relax_cuda(coarses, rhss, dias, us, nsweeps, h2, signs, per_y,
                        omega, tile, whole_max, counter):
    n = rhss[0].shape[0]
    tile, halo = _prolong_geometry(n, nsweeps, tile, whole_max,
                                   rhss[0].element_size())
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
                  per_y=False, omega=1.0, tile=32, whole_max=64):
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
                       per_y=False, omega=1.0, tile=32, whole_max=64):
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
                          offs=_HOMOGENEOUS, per_y=False):
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
          int(per_y))
    LAUNCHES["residual_restrict_div"] += 1
    return r0, r1, r2


def prolong_relax_correct(coarse, rhs, dia, u, ufx, ufy, dt, h, cells=None,
                          *, nsweeps, h2, signs, offs, per_y=False,
                          omega=1.0, tile=32, whole_max=64):
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
    tile, halo = _prolong_geometry(n, nsweeps, tile, whole_max,
                                   rhs.element_size())
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
                  omega, min_n, restrict_counter, prolong_counter):
    """The cascade on the card: restrict2 launches down to min(min_n,
    n/4), then prolong_relax launches (the coarsest from zero with
    ``coarsest`` sweeps), each over the whole batch of systems.  The TPU
    kernels ran this in one launch with the sub-cascade carried across
    grid steps in VMEM; blocks of a GPU grid carry nothing, so the
    sequence runs from the host."""
    def pool(rs):
        return _restrict2_cuda(rs, restrict_counter)

    def launch(coarses, rhss, ds, *, nsweeps, h2, signs, per_y, omega):
        return _prolong_relax_cuda(coarses, rhss, ds, [None] * len(ds),
                                   nsweeps, h2, signs, per_y, omega, 32, 64,
                                   prolong_counter)

    return _cascade(r1s, r2s, dias, nsweeps, coarsest, h2_half, signs,
                    per_y, omega, min_n, pool, launch)


def cascade_prolong_relax(r1, r2, dia=0.0, *, nsweeps, coarsest, h2_half,
                          signs, per_y=False, omega=1.0, min_n=16):
    """The whole correction at and below n/2 = r1.shape[0], returned as a
    plain (n/2, n/2) du (no rep layout)."""
    _check_level(r1, "r1", min_n=32)
    _check_level(r2, "r2", r1.shape[0] // 2)
    if _on_cpu(r1, r2):
        return cascade_prolong_relax_plain(
            r1, r2, dia, nsweeps=nsweeps, coarsest=coarsest,
            h2_half=h2_half, signs=signs, per_y=per_y, omega=omega,
            min_n=min_n)
    LAUNCHES["cascade_prolong_relax"] += 1
    return _cascade_cuda([r1], [r2], [dia], nsweeps, coarsest, h2_half,
                         signs, per_y, omega, min_n, "restrict2",
                         "cascade.prolong_relax")[0]


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
    if _on_cpu(*r1s, *r2s):
        return cascade_prolong_relax_pair_plain(
            r1s, r2s, dias, nsweeps=nsweeps, coarsest=coarsest,
            h2_half=h2_half, signs=signs, per_y=per_y, omega=omega,
            min_n=min_n)
    LAUNCHES["cascade_prolong_relax_pair"] += 1
    return _cascade_cuda(r1s, r2s, dias, nsweeps, coarsest, h2_half, signs,
                         per_y, omega, min_n, "restrict2_pair",
                         "cascade_pair.prolong_relax")


# -----------------------------------------------------------------------------
# The adaptive solve's kernels: K11 residual, K10 rbgs_relax, K12
# coarse_vcycle
# -----------------------------------------------------------------------------

def residual(u, rhs, dia=0.0, *, h2, signs, offs=_HOMOGENEOUS,
             periodic=(False, False)):
    """K11: r = rhs - (L - dia) u with static ghosts (sgn, off), periodic
    on either axis (``periodic`` per axis overrides the signs)."""
    _check_level(u, "u", min_n=2)
    _check_level(rhs, "rhs", u.shape[0], min_n=2)
    if _on_cpu(u, rhs):
        return residual_plain(u, rhs, dia, h2=h2, signs=signs, offs=offs,
                              periodic=periodic)
    n = u.shape[0]
    r = torch.empty_like(u)
    _call("residual", u.dtype, u.device, u.data_ptr(), rhs.data_ptr(),
          r.data_ptr(), n, n, float(dia), float(h2), doubles(*signs),
          doubles(*offs), int(periodic[0]), int(periodic[1]))
    LAUNCHES["residual"] += 1
    return r


def _relax_plan(n, nsweeps, tile, whole_max, itemsize):
    """(tile, sweeps per launch) of K10: a level of at most ``whole_max``
    cells per side is one block with no halo and takes every sweep in one
    launch; a larger level uses tile x tile tiles with a halo of 2 sweeps
    per launch, as many sweeps per launch as the halo lets fit in shared
    memory (the sweeps of consecutive launches compose exactly)."""
    if n <= whole_max:
        if 2 * (n + 2) ** 2 * itemsize > _SMEM_MAX:
            raise ValueError(f"rbgs_relax: a whole {n}^2 level does not fit "
                             "in shared memory (a smaller whole_max)")
        return n, nsweeps
    if n % tile:
        raise ValueError(f"tile {tile} does not divide {n}")
    side_max = int((_SMEM_MAX / (2 * itemsize)) ** 0.5)
    per = (side_max - tile - 2) // 4
    if per < 1:
        raise ValueError(f"rbgs_relax: tile {tile} does not fit in shared "
                         "memory")
    return tile, min(per, nsweeps)


def rbgs_relax(u, rhs, dia=0.0, *, nsweeps, h2, signs,
               periodic=(False, False), omega=1.0, tile=32, whole_max=64):
    """K10: ``nsweeps`` red-black Gauss-Seidel sweeps from ``u`` on
    (L - dia) u = rhs with homogeneous ghosts, periodic on either axis.
    One launch, unless the sweeps' halo outgrows shared memory (then
    consecutive launches of fewer sweeps each)."""
    _check_level(u, "u", min_n=2)
    _check_level(rhs, "rhs", u.shape[0], min_n=2)
    if _on_cpu(u, rhs):
        return rbgs_relax_plain(u, rhs, dia, nsweeps=nsweeps, h2=h2,
                                signs=signs, periodic=periodic, omega=omega)
    n = u.shape[0]
    tile, per = _relax_plan(n, nsweeps, tile, whole_max, u.element_size())
    left = nsweeps
    while left > 0:
        k = min(left, per)
        out = torch.empty_like(u)
        _call("rbgs_relax", u.dtype, u.device, u.data_ptr(), rhs.data_ptr(),
              out.data_ptr(), n, n, tile, 0 if tile == n else 2 * k, k,
              float(dia), float(h2), float(omega), doubles(*signs),
              int(periodic[0]), int(periodic[1]))
        LAUNCHES["rbgs_relax"] += 1
        u, left = out, left - k
    return u


def _alpha_plan(n, nsweeps, tile, whole_max, itemsize, sms=1):
    """(tile, sweeps per launch) of K15, K10's plan with five B x B
    buffers (u, rhs, the x and y face coefficients, den) per block, B =
    tile + 2 halo + 2: a level of at most ``whole_max`` cells per side is
    one block with no halo; a larger one takes ``tile`` if given, else
    the largest of 64, 32, 16 whose halo of 2 nsweeps fits in shared
    memory and that still gives every one of the card's ``sms``
    multiprocessors a block (else the smallest that fits: a level's
    blocks run side by side, and its half-sweeps one after another), else
    32 with the sweeps split over launches.  The tile changes the launch
    geometry only: the result is bit-identical for every tile."""
    if n <= whole_max:
        if 5 * (n + 2) ** 2 * itemsize > _SMEM_MAX:
            raise ValueError(f"rbgs_relax_alpha: a whole {n}^2 level does "
                             "not fit in shared memory (a smaller "
                             "whole_max)")
        return n, nsweeps
    side_max = int((_SMEM_MAX / (5 * itemsize)) ** 0.5)
    if tile is None:
        fits = [t for t in (64, 32, 16)
                if n % t == 0 and t + 4 * nsweeps + 2 <= side_max]
        wide = [t for t in fits if (n // t) ** 2 >= sms]
        tile = wide[0] if wide else fits[-1] if fits else 32
    if n % tile:
        raise ValueError(f"tile {tile} does not divide {n}")
    per = (side_max - tile - 2) // 4
    if per < 1:
        raise ValueError(f"rbgs_relax_alpha: tile {tile} does not fit in "
                         "shared memory")
    return tile, min(per, nsweeps)


@functools.lru_cache(maxsize=8)
def _multiprocessors(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_alpha(u, rhs, ax, ay, dia, dia_cell):
    _check_level(u, "u", min_n=2)
    _check_level(rhs, "rhs", u.shape[0], min_n=2)
    n = u.shape[0]
    check_faces(ax, ay, n, n)
    if dia_cell:
        check(dia, "dia", (n, n))
    elif isinstance(dia, torch.Tensor):
        raise TypeError("rbgs_relax_alpha: a tensor dia needs dia_cell")


def rbgs_relax_alpha(u, rhs, ax, ay, dia=0.0, *, nsweeps, h2, signs,
                     periodic=(False, False), omega=1.0, dia_cell=False,
                     tile=None, whole_max=64):
    """K15: ``nsweeps`` red-black Gauss-Seidel sweeps from ``u`` on
    div(alpha grad u) - dia u = rhs with face coefficients ``ax`` (n0+1,
    n1), ``ay`` (n0, n1+1) and a scalar or (``dia_cell``) per-cell
    ``dia``, homogeneous ghosts, periodic on either axis.  One launch,
    unless the sweeps' halo outgrows shared memory (then consecutive
    launches of fewer sweeps each)."""
    _check_alpha(u, rhs, ax, ay, dia, dia_cell)
    if _on_cpu(u, rhs, ax, ay, dia if dia_cell else None):
        return rbgs_relax_alpha_plain(u, rhs, ax, ay, dia, nsweeps=nsweeps,
                                      h2=h2, signs=signs, periodic=periodic,
                                      omega=omega, dia_cell=dia_cell)
    n = u.shape[0]
    tile, per = _alpha_plan(n, nsweeps, tile, whole_max, u.element_size(),
                            _multiprocessors(u.device))
    left = nsweeps
    while left > 0:
        k = min(left, per)
        out = torch.empty_like(u)
        _call("rbgs_relax_alpha", u.dtype, u.device,
              pointers((u, rhs, ax, ay, dia if dia_cell else None, out)),
              n, n, tile, 0 if tile == n else 2 * k, k,
              0.0 if dia_cell else float(dia), float(h2), float(omega),
              doubles(*signs), int(periodic[0]), int(periodic[1]))
        LAUNCHES["rbgs_relax_alpha"] += 1
        u, left = out, left - k
    return u


def _check_coarse(r, min_n):
    _check_level(r, "r", min_n=2)
    if min(min_n, r.shape[0]) > COARSE_BLOCK_MAX:
        raise ValueError(f"coarse_vcycle: min_n {min_n} above the block "
                         f"kernel's {COARSE_BLOCK_MAX}")


def _coarse_block_cuda(r, dia, nsweeps, coarsest, h2, signs, per_y, min_n):
    n = r.shape[0]
    du = torch.empty_like(r)
    _call("coarse_block", r.dtype, r.device, r.data_ptr(), du.data_ptr(), n,
          min(min_n, n), int(nsweeps), int(coarsest), float(dia), float(h2),
          doubles(*signs), int(per_y))
    LAUNCHES["coarse_block"] += 1
    return du


def coarse_block(r, dia=0.0, *, nsweeps, coarsest, h2, signs, per_y=False,
                 min_n=16):
    """K12's block kernel alone: coarse_vcycle of a level of at most
    COARSE_BLOCK_MAX cells per side, in one launch of one block."""
    _check_coarse(r, min_n)
    if r.shape[0] > COARSE_BLOCK_MAX:
        raise ValueError(f"coarse_block: {r.shape[0]}^2 above "
                         f"{COARSE_BLOCK_MAX}^2")
    if _on_cpu(r):
        return coarse_vcycle_plain(r, dia, nsweeps=nsweeps, coarsest=coarsest,
                                   h2=h2, signs=signs, per_y=per_y,
                                   min_n=min_n)
    return _coarse_block_cuda(r, dia, nsweeps, coarsest, h2, signs, per_y,
                              min_n)


def coarse_vcycle(r, dia=0.0, *, nsweeps, coarsest, h2, signs, per_y=False,
                  min_n=16):
    """K12: du for the sub-hierarchy at and below r's level (homogeneous
    ghosts, non-periodic rows, omega 1; ``h2`` is r's level's).  On the
    card the levels above COARSE_BLOCK_MAX are restrict2 launches down and
    K3 launches up around one coarse_block launch (3 + 1 + 3 launches at
    512^2): a TPU kernel held the whole cascade in one launch, and a
    512^2 level does not fit one block's shared memory."""
    _check_coarse(r, min_n)
    if _on_cpu(r):
        return coarse_vcycle_plain(r, dia, nsweeps=nsweeps, coarsest=coarsest,
                                   h2=h2, signs=signs, per_y=per_y,
                                   min_n=min_n)
    LAUNCHES["coarse_vcycle"] += 1
    n = r.shape[0]
    rs = [r]
    while rs[-1].shape[0] > COARSE_BLOCK_MAX:
        rs.append(_restrict2_cuda(rs[-1:], "coarse_vcycle.restrict2")[0])
    du = _coarse_block_cuda(rs[-1], dia, nsweeps, coarsest,
                            h2 * (n // rs[-1].shape[0]) ** 2, signs, per_y,
                            min_n)
    for rk in reversed(rs[:-1]):
        du = _prolong_relax_cuda([du], [rk], [dia], [None], nsweeps,
                                 h2 * (n // rk.shape[0]) ** 2, signs, per_y,
                                 1.0, 32, 64,
                                 "coarse_vcycle.prolong_relax")[0]
    return du
