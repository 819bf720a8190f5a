"""The multigrid cycle's kernels: CUDA wrappers and their plain versions.

Port of the three TPU kernels of the fixed sawtooth cycle in
gerris_tpu/ops/pallas/rbgs.py (K1 ``residual_restrict``, K2
``cascade_prolong_relax``, K3 ``prolong_relax``).  The kernels are in
``gerris_tpu_torch/csrc/rbgs.cu``; each one's source note says what it
replaces, what bounds it on the H100 and what its design does about it.

Each wrapper checks its inputs (dtype float32/float64, contiguous, square
power-of-two levels >= 16) and then:
* for tensors on the CPU, returns the plain PyTorch version below (the
  CPU tests and the card-side reference in chip_smoke.py use these);
* for CUDA tensors, launches the kernel on the current stream and adds
  one to its count in ``LAUNCHES``, or raises.  There is no fallback.

Ghosts are encoded per side as ghost = sgn * mirror + off, sides ordered
(x lo, x hi, y lo, y hi) (poisson._signs_offs); the correction-phase
kernels use off = 0 (homogeneous).  Periodic rows are not supported;
periodic columns are (``per_y``).
"""
from __future__ import annotations

import torch

# kernel launches by wrapper name, counted only where a kernel launches.
# "cascade_prolong_relax" counts calls of that host-side sequence; the
# prolong_relax launches it makes are counted apart from K3's own.
LAUNCHES = {"residual_restrict": 0, "restrict2": 0, "prolong_relax": 0,
            "cascade_prolong_relax": 0, "cascade.prolong_relax": 0}

_SMEM_MAX = 232448        # dynamic shared memory a block may use on sm_90
_HOMOGENEOUS = (0.0, 0.0, 0.0, 0.0)


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


def cascade_prolong_relax_plain(r1, r2, dia=0.0, *, nsweeps, coarsest,
                                h2_half, signs, per_y=False, omega=1.0,
                                min_n=16):
    return _cascade(r1, r2, dia, nsweeps, coarsest, h2_half, signs, per_y,
                    omega, min_n, pool_plain, prolong_relax_plain)


def _cascade(r1, r2, dia, nsweeps, coarsest, h2_half, signs, per_y, omega,
             min_n, pool, prolong_relax_fn):
    """Every correction level at or below n/2 = r1.shape[0]: restrict r2
    down to min(min_n, n/4), ``coarsest`` sweeps from zero there, then
    prolong + ``nsweeps`` sweeps at each level up to n/2.  At level
    size m the cell size squared is h2_half * (n/2 / m)**2."""
    n_half = r1.shape[0]
    min_n = min(min_n, n_half // 2)
    rs = {n_half // 2: r2}
    n = n_half // 2
    while n > min_n:
        rs[n // 2] = pool(rs[n])
        n //= 2
    kw = dict(signs=signs, per_y=per_y, omega=omega)
    du = prolong_relax_fn(None, rs[min_n], dia, nsweeps=coarsest,
                          h2=h2_half * (n_half // min_n) ** 2, **kw)
    n = 2 * min_n
    while n <= n_half // 2:
        du = prolong_relax_fn(du, rs[n], dia, nsweeps=nsweeps,
                              h2=h2_half * (n_half // n) ** 2, **kw)
        n *= 2
    return prolong_relax_fn(du, r1, dia, nsweeps=nsweeps, h2=h2_half, **kw)


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


def _call(fn_name, dtype, device, *args):
    from .build import library
    suffix = "f32" if dtype == torch.float32 else "f64"
    fn = getattr(library(), f"gtt_{fn_name}_{suffix}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err} at launch")


def residual_restrict(u, rhs, dia=0.0, sub=0.0, *, h2, signs,
                      offs=_HOMOGENEOUS, per_y=False):
    """(r0, r1, r2): r0 = (rhs - sub) - (L - dia) u with static ghosts
    (sgn, off), r1 = pool(r0), r2 = pool(r1).  ``dia`` is a float; ``sub``
    a float or a one-element tensor on the device of ``u`` (read by the
    kernel, so a device-side mean costs no host sync)."""
    _check_level(u, "u")
    _check_level(rhs, "rhs", u.shape[0])
    sub_t = sub if isinstance(sub, torch.Tensor) else None
    if _on_cpu(u, rhs):
        return residual_restrict_plain(u, rhs, dia, sub, h2=h2, signs=signs,
                                       offs=offs, per_y=per_y)
    n = u.shape[0]
    if sub_t is None and sub != 0.0:
        sub_t = torch.full((1,), sub, dtype=u.dtype, device=u.device)
    if sub_t is not None and (sub_t.numel() != 1 or sub_t.dtype != u.dtype
                              or sub_t.device != u.device):
        raise ValueError("sub: want one element of u's dtype and device")
    r0 = torch.empty_like(u)
    r1 = u.new_empty((n // 2, n // 2))
    r2 = u.new_empty((n // 4, n // 4))
    _call("residual_restrict", u.dtype, u.device, u.data_ptr(),
          rhs.data_ptr(), None if sub_t is None else sub_t.data_ptr(),
          float(dia), float(h2), n, n, *map(float, signs),
          *map(float, offs), int(per_y), r0.data_ptr(), r1.data_ptr(),
          r2.data_ptr())
    LAUNCHES["residual_restrict"] += 1
    return r0, r1, r2


def restrict2(r):
    """One 2x2 mean pool (the cascade's restriction)."""
    _check_level(r, "r", min_n=32)
    if _on_cpu(r):
        return pool_plain(r)
    n = r.shape[0]
    out = r.new_empty((n // 2, n // 2))
    _call("restrict2", r.dtype, r.device, r.data_ptr(), n, n, out.data_ptr())
    LAUNCHES["restrict2"] += 1
    return out


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


def _prolong_relax_cuda(coarse, rhs, dia, u, nsweeps, h2, signs, per_y,
                        omega, tile, whole_max, counter):
    n = rhs.shape[0]
    tile, halo = _prolong_geometry(n, nsweeps, tile, whole_max,
                                   rhs.element_size())
    out = torch.empty_like(rhs)
    _call("prolong_relax", rhs.dtype, rhs.device,
          None if coarse is None else coarse.data_ptr(), rhs.data_ptr(),
          None if u is None else u.data_ptr(), out.data_ptr(), n, n, tile,
          halo, int(nsweeps), float(h2), 1.0 / (4.0 + dia * h2),
          float(omega), *map(float, signs), int(per_y))
    LAUNCHES[counter] += 1
    return out


def _check_prolong(coarse, rhs, u):
    _check_level(rhs, "rhs")
    n = rhs.shape[0]
    if coarse is not None:
        _check_level(coarse, "coarse", n // 2, min_n=8)
    if u is not None:
        _check_level(u, "u", n)


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
    return _prolong_relax_cuda(coarse, rhs, dia, u, nsweeps, h2, signs,
                               per_y, omega, tile, whole_max,
                               "prolong_relax")


def cascade_prolong_relax(r1, r2, dia=0.0, *, nsweeps, coarsest, h2_half,
                          signs, per_y=False, omega=1.0, min_n=16):
    """The whole correction at and below n/2 = r1.shape[0], returned as a
    plain (n/2, n/2) du.  On the card: restrict2 launches down to
    min(min_n, n/4), then prolong_relax launches (the coarsest from zero
    with ``coarsest`` sweeps).  The TPU kernel ran this in one launch with
    the sub-cascade carried across grid steps in VMEM; blocks of a GPU
    grid carry nothing, so the sequence runs from the host."""
    _check_level(r1, "r1", min_n=32)
    _check_level(r2, "r2", r1.shape[0] // 2)
    if _on_cpu(r1, r2):
        return cascade_prolong_relax_plain(
            r1, r2, dia, nsweeps=nsweeps, coarsest=coarsest,
            h2_half=h2_half, signs=signs, per_y=per_y, omega=omega,
            min_n=min_n)

    def launch(coarse, rhs, d, *, nsweeps, h2, signs, per_y, omega):
        return _prolong_relax_cuda(coarse, rhs, d, None, nsweeps, h2, signs,
                                   per_y, omega, 32, 64,
                                   "cascade.prolong_relax")

    LAUNCHES["cascade_prolong_relax"] += 1
    return _cascade(r1, r2, dia, nsweeps, coarsest, h2_half, signs, per_y,
                    omega, min_n, restrict2, launch)
