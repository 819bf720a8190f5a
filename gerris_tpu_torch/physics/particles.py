"""Lagrangian point particles (port of gerris_tpu/physics/particles.py).

The fork's particulate module (reference: modules/particulatecommon.c:
the force models compute_inertial_force:255, compute_addedmass_force:331,
compute_lift_force:423, compute_drag_force:519, compute_buoyancy_force:617;
the leapfrog update gfs_particulate_event:769-830; the two-way source
GfsSourceParticulate:2089-2177 and GfsParticulateField:1929).

A particle state is a dict of tensors of a fixed capacity: ``pos`` and
``vel`` (capacity, dim), ``vol`` and ``mass`` (capacity,), and ``alive``,
a bool mask; dead slots keep the reference's 1e-12 fills.  The fluid at
the particles is one gather of every padded field over all 2^dim corners
(``gather_at``), and the two-way coupling one ``index_add_`` over all
pairs of particle and stencil offset (``deposit``).  Nothing here reads a
value back to the host.

Buoyancy: ``step_particles`` returns the force on each particle with and
without buoyancy.  The reference C excludes buoyancy from the force it
gives the fluid (compute_forces_onfluid, particulatecommon.c:754-766);
gerris_tpu's ParticleSystem deposits the total, buoyancy included
(gerris_tpu/models/particle_system.py:56-62, ROADMAP Queue 3), where the
port's deposits the force without it.

The 1e-300 guards of the reference are the dtype's smallest normal
number here: 1e-300 is 0 in float32.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

from ..core import bc as bcs
from ..core.device import default_device
from ..core.grid import Grid
from ..ops.stencils import center_gradient


@dataclasses.dataclass(frozen=True)
class ParticleConfig:
    """The force objects of a particle list (e.g. 'GfsParticleList { ... }
    { ForceDrag ForceLift ForceBuoy }'), gerris_tpu's fields and
    defaults."""
    capacity: int
    forces: tuple = ("drag", "lift", "buoy", "inertial", "added_mass")
    cd: Optional[float] = None       # None: the Cd(Re) law (the default)
    cl: float = 0.5                  # lift coefficient (ref :468)
    cm: float = 0.5                  # added-mass coefficient (ref :357)
    gravity: tuple = (0.0, 0.0, 0.0)
    fluid_rho: float = 1.0
    two_way: bool = False
    rkernel: float = 0.0             # Gaussian radius (0: bilinear deposit)
    kernel_cells: int = 3            # half-width of the Gaussian stencil


def make_particles(capacity: int, dim: int, pos=None, vel=None, vol=None,
                   mass=None, n: int = 0, device=None,
                   dtype=torch.float64) -> dict:
    """A particle state of ``capacity`` slots, the first ones from ``pos``
    (and ``vel``, ``vol``, ``mass``; arrays or tensors) or the first
    ``n`` at zero; on ``device``, the CUDA card by default."""
    device = default_device(device)

    def full(src, shape, fill=0.0):
        out = torch.full(shape, fill, dtype=dtype, device=device)
        if src is not None:
            src = torch.as_tensor(src, dtype=dtype).to(device)
            out[: src.shape[0]] = src
        return out

    npart = n if pos is None else len(pos)
    return {
        "pos": full(pos, (capacity, dim)),
        "vel": full(vel, (capacity, dim)),
        "vol": full(vol, (capacity,), 1e-12),
        "mass": full(mass, (capacity,), 1e-12),
        "alive": torch.arange(capacity, device=device) < npart,
    }


@functools.lru_cache(maxsize=64)
def constant(values: tuple, device, dtype=torch.int64) -> torch.Tensor:
    """A small constant tensor (nested tuples) on ``device``, copied from
    the host once per device and dtype: a copy from the host's memory in
    every step would make the card wait."""
    return torch.tensor(values, dtype=dtype, device=device)


def corners(dim: int, device) -> torch.Tensor:
    """The 2^dim corner offsets {0, 1}^dim, (2^dim, dim), corner c's
    offset along axis a its bit a."""
    return constant(tuple(tuple((c >> a) & 1 for a in range(dim))
                          for c in range(1 << dim)), device)


def tiny(t: torch.Tensor) -> float:
    """The smallest normal number of ``t``'s dtype (the reference's
    1e-300 guards)."""
    return torch.finfo(t.dtype).tiny


# ---------------------------------------------------------------------------
# The fluid at the particles
# ---------------------------------------------------------------------------

def gather_at(pads: list, grid: Grid, pos: torch.Tensor) -> list:
    """Bilinear (trilinear) interpolation of each 1-ghost padded cell
    field of ``pads`` at the particle positions ``pos`` (N, dim), in one
    indexing of the stacked fields over all 2^dim corners (reference:
    gfs_interpolate src/fluid.c:2697).  The corners are summed in the
    reference's order."""
    dim = grid.dim
    ncorner = 1 << dim
    bits = corners(dim, pos.device)
    padded = pads[0].shape
    flat = 0
    w = None
    for a in range(dim):
        x = (pos[:, a] - grid.origin[a]) / grid.h + 0.5
        i0 = torch.floor(x).to(torch.int64).clamp(0, grid.shape[a])
        fr = (x - i0)[:, None]
        b = bits[:, a][None, :]
        wa = torch.where(b == 1, fr, 1.0 - fr)
        w = wa if w is None else w * wa
        stride = math.prod(padded[a + 1:])
        flat = flat + (i0[:, None] + b).clamp(0, grid.shape[a] + 1) * stride
    vals = torch.stack([p.reshape(-1) for p in pads])[:, flat]   # (F, N, M)
    out = []
    for f in vals:
        acc = w[:, 0] * f[:, 0]
        for m in range(1, ncorner):
            acc = acc + w[:, m] * f[:, m]
        out.append(acc)
    return out


def interpolate_at(field: torch.Tensor, grid: Grid, fbc: bcs.FieldBC,
                   pos: torch.Tensor, t: float = 0.0) -> torch.Tensor:
    """A cell field at the particle positions, padded with its BC ghosts
    at time ``t`` so that particles near a wall see the BC (gerris_tpu
    particles.py:78-101)."""
    return gather_at([bcs.apply_bc(field, grid, fbc, 1, t=t)], grid, pos)[0]


def vorticity_field(U: list, grid: Grid, u_bcs: list, t: float = 0.0):
    """Cell-centred vorticity: w_z in 2D, (w_x, w_y, w_z) in 3D, centred
    differences on the velocities padded with their BCs at time ``t``
    (gfs_vorticity, src/fluid.c; modules/particulatecommon.c:115-167)."""
    pads = [bcs.apply_bc(U[c], grid, u_bcs[c], 1, t=t)
            for c in range(grid.dim)]

    def d(c, a):
        return center_gradient(pads[c], grid, a)

    if grid.dim == 2:
        return d(1, 0) - d(0, 1)
    return d(2, 1) - d(1, 2), d(0, 2) - d(2, 0), d(1, 0) - d(0, 1)


# ---------------------------------------------------------------------------
# Forces: densities per unit particle volume (the total is density * vol,
# compute_forces particulatecommon.c:737-751)
# ---------------------------------------------------------------------------

def particle_diameter(vol: torch.Tensor) -> torch.Tensor:
    return 2.0 * torch.pow(3.0 * vol / (4.0 * math.pi), 1.0 / 3.0)


def buoyancy_density(p: dict, cfg: ParticleConfig, dim: int) -> torch.Tensor:
    """(rho_p - rho_f) g per particle (compute_buoyancy_force, ref
    :617-680)."""
    g = constant(tuple(cfg.gravity[:dim]), p["vol"].device, p["vol"].dtype)
    rho_p = p["mass"] / torch.clamp(p["vol"], min=tiny(p["vol"]))
    return (rho_p - cfg.fluid_rho)[:, None] * g[None, :]


def compute_forces(p: dict, u_at_p, uold_at_p, conv_at_p, vort_at_p,
                   cfg: ParticleConfig, nu: float, dt: float):
    """The sum of the selected force models per unit volume, (N, dim), and
    the effective mass m + cm rho_f vol with added mass (gerris_tpu
    particles.py:129-179)."""
    dim = u_at_p.shape[1]
    rho_f = cfg.fluid_rho
    urel = u_at_p - p["vel"]
    norm_urel = torch.sqrt(torch.sum(urel * urel, dim=1))
    dia = particle_diameter(p["vol"])
    visc = nu if nu > 0.0 else 1e-3  # ref fallback, particulatecommon.c:373
    Re = norm_urel * dia * rho_f / visc

    force = torch.zeros_like(u_at_p)
    inertial = None
    if "inertial" in cfg.forces or "added_mass" in cfg.forces:
        # rho_f Du/Dt = rho_f ((u - u_old)/dt + (u.grad)u)   (ref :255-303)
        inertial = rho_f * ((u_at_p - uold_at_p)
                            / max(dt, tiny(u_at_p)) + conv_at_p)
    if "inertial" in cfg.forces:
        force = force + inertial
    m_eff = p["mass"]
    if "added_mass" in cfg.forces:
        force = force + cfg.cm * inertial          # (ref :331-396)
        m_eff = m_eff + cfg.cm * rho_f * p["vol"]
    if "lift" in cfg.forces:
        # rho_f cl (u_rel x omega)                  (ref :423-500)
        if dim == 2:
            fx = rho_f * cfg.cl * urel[:, 1] * vort_at_p
            fy = -rho_f * cfg.cl * urel[:, 0] * vort_at_p
            force = force + torch.stack([fx, fy], dim=1)
        else:
            force = force + rho_f * cfg.cl * torch.linalg.cross(
                urel, vort_at_p, dim=1)
    if "drag" in cfg.forces:
        if cfg.cd is not None:
            cd = cfg.cd
        else:
            # the Cd(Re) law, particulatecommon.c:584-590
            re = torch.clamp(Re, min=1e-8)
            cd_lo = 16.0 * (1.0 + 0.15 * torch.sqrt(Re)) / re
            cd_hi = 48.0 * (1.0 - 2.21 / torch.sqrt(re)) / re
            cd = torch.where(Re < 1e-8, 0.0,
                             torch.where(Re < 50.0, cd_lo, cd_hi))
        fd = (3.0 / (4.0 * dia) * cd * norm_urel * rho_f)[:, None] * urel
        force = force + fd
    if "buoy" in cfg.forces:
        force = force + buoyancy_density(p, cfg, dim)
    return force, m_eff


def fluid_at(p: dict, U: list, U_old: list, grid: Grid, u_bcs: list,
             t: float = 0.0):
    """u, u_old, (u.grad)u and the vorticity at the particles, (N, dim)
    each (the vorticity (N,) in 2D), in one gather."""
    dim = grid.dim
    pads = [bcs.apply_bc(U[c], grid, u_bcs[c], 1, t=t) for c in range(dim)]
    old = [bcs.apply_bc(U_old[c], grid, u_bcs[c], 1, t=t)
           for c in range(dim)]
    gb = bcs.default_scalar_bc(dim)
    conv = []
    for c in range(dim):
        s = 0.0
        for c2 in range(dim):
            s = s + U[c2] * center_gradient(pads[c], grid, c2)
        conv.append(s)
    vort = vorticity_field(U, grid, u_bcs, t)
    vort = [vort] if dim == 2 else list(vort)
    extra = [bcs.apply_bc(f, grid, gb, 1, t=t) for f in conv + vort]
    at = gather_at(pads + old + extra, grid, p["pos"])
    u_at = torch.stack(at[:dim], dim=1)
    uo_at = torch.stack(at[dim:2 * dim], dim=1)
    conv_at = torch.stack(at[2 * dim:3 * dim], dim=1)
    vort_at = at[3 * dim] if dim == 2 else torch.stack(at[3 * dim:], dim=1)
    return u_at, uo_at, conv_at, vort_at


def step_particles(p: dict, U: list, U_old: list, grid: Grid, u_bcs: list,
                   cfg: ParticleConfig, nu: float, dt: float,
                   t: float = 0.0):
    """One particle step: the forces, then the reference's split update
    pos += v dt/2; v += F vol dt / m_eff; pos += v dt/2
    (gfs_particulate_event, particulatecommon.c:805-830), then the
    periodic wrap and the deactivation of particles outside the box
    (gfs_particle_bc :3375).  Returns (the new state, the force on each
    particle, the force without buoyancy), forces (N, dim) totals."""
    dim = grid.dim
    u_at, uo_at, conv_at, vort_at = fluid_at(p, U, U_old, grid, u_bcs, t)
    # the force the fluid feels: the models but buoyancy, summed first
    # (buoyancy is the last term of compute_forces' sum)
    fluid = dataclasses.replace(
        cfg, forces=tuple(f for f in cfg.forces if f != "buoy"))
    hydro, m_eff = compute_forces(p, u_at, uo_at, conv_at, vort_at, fluid,
                                  nu, dt)
    force = hydro + buoyancy_density(p, cfg, dim) \
        if "buoy" in cfg.forces else hydro
    vol = p["vol"][:, None]
    total = force * vol

    pos = p["pos"] + p["vel"] * dt / 2.0
    vel = p["vel"] + total * dt / m_eff[:, None]
    pos = pos + vel * dt / 2.0

    alive = p["alive"]
    cols = []
    for a in range(dim):
        x = pos[:, a]
        L = grid.length(a)
        if u_bcs[0].is_periodic(a):
            x = grid.origin[a] + torch.remainder(x - grid.origin[a], L)
        else:
            alive = alive & (x >= grid.origin[a]) & \
                (x <= grid.origin[a] + L)
        cols.append(x)
    pos = torch.stack(cols, dim=1)
    live = alive[:, None]
    return {
        "pos": torch.where(live, pos, p["pos"]),
        "vel": torch.where(live, vel, 0.0),
        "vol": p["vol"],
        "mass": p["mass"],
        "alive": alive,
    }, total, hydro * vol


# ---------------------------------------------------------------------------
# Two-way coupling: deposition onto the cells
# ---------------------------------------------------------------------------

def _offsets(dim: int, K: int) -> list:
    r = range(-K, K + 1)
    if dim == 2:
        return [(i, j) for i in r for j in r]
    return [(i, j, k) for i in r for j in r for k in r]


def deposit_stencil(p: dict, grid: Grid, cfg: ParticleConfig):
    """The flat cell index (N, M) of every pair of particle and stencil
    offset, and the weight factors whose product is each pair's weight
    (bilinear: one per axis; Gaussian: the normalized kernel), as
    gerris_tpu's deposit forms them (particles.py:245-306)."""
    dim = grid.dim
    pos = p["pos"]
    dev = pos.device
    strides = [math.prod(grid.shape[a + 1:]) for a in range(dim)]
    idx0, fr = [], []
    for a in range(dim):
        x = (pos[:, a] - grid.origin[a]) / grid.h - 0.5
        i0 = torch.floor(x).to(torch.int64)
        idx0.append(i0)
        fr.append(x - i0)
    flat = 0
    if cfg.rkernel <= 0.0:
        # bilinear (cloud in cell): the 2^dim corners
        bits = corners(dim, dev)
        factors = []
        for a in range(dim):
            b = bits[:, a][None, :]
            factors.append(torch.where(b == 1, fr[a][:, None],
                                       1.0 - fr[a][:, None]))
            ic = (idx0[a][:, None] + b).clamp(0, grid.shape[a] - 1)
            flat = flat + ic * strides[a]
        return flat, factors
    # Gaussian over the (2K+1)^dim cells idx0 + 1 - K .. idx0 + 1 + K
    offs = constant(tuple(_offsets(dim, cfg.kernel_cells)), dev)
    w = 0.0
    for a in range(dim):
        ic = (idx0[a][:, None] + offs[:, a][None, :] + 1) \
            .clamp(0, grid.shape[a] - 1)
        cc = grid.origin[a] + (ic + 0.5) * grid.h
        w = w + (cc - pos[:, a][:, None]) ** 2
        flat = flat + ic * strides[a]
    w = torch.exp(-w / (2.0 * cfg.rkernel ** 2))
    w = w / torch.clamp(torch.sum(w, dim=1, keepdim=True), min=tiny(w))
    return flat, [w]


def deposit(values: torch.Tensor, p: dict, grid: Grid, cfg: ParticleConfig,
            stencil=None) -> torch.Tensor:
    """Scatter per-particle ``values`` onto the cells as a density (value
    / cell volume): bilinear with rkernel = 0 (GfsParticulateField
    voidfraction_from_particles :1929), else the normalized Gaussian of
    radius rkernel over the (2 kernel_cells + 1)^dim cells around each
    particle (GfsSourceParticulate :2089-2177); one index_add_.  Dead
    particles add nothing.  ``stencil``: deposit_stencil's result, to
    share it between deposits."""
    flat, factors = stencil if stencil is not None else \
        deposit_stencil(p, grid, cfg)
    w = torch.where(p["alive"], values, 0.0)[:, None]
    for f in factors:
        w = w * f
    out = torch.zeros(math.prod(grid.shape), dtype=w.dtype,
                      device=w.device)
    out.index_add_(0, flat.reshape(-1), w.reshape(-1))
    return out.reshape(grid.shape) / grid.cell_volume


def volume_fraction_field(p: dict, grid: Grid, cfg: ParticleConfig):
    """The particles' volume fraction per cell (GfsParticulateField,
    particulatecommon.c:1929-2005; GfsBubbleFraction, bubbles.c:538)."""
    return deposit(p["vol"], p, grid, cfg)


def reaction_force_fields(force: torch.Tensor, p: dict, grid: Grid,
                          cfg: ParticleConfig) -> list:
    """The momentum source on the fluid, minus each particle's force,
    spread per component (GfsSourceParticulate, :2089-2177), the stencil
    formed once.  The caller passes the force without buoyancy, as the
    reference's compute_forces_onfluid (:754-766) does."""
    st = deposit_stencil(p, grid, cfg)
    return [deposit(-force[:, c], p, grid, cfg, stencil=st)
            for c in range(grid.dim)]


def feed_particles(p: dict, pos, vel=None, vol=1e-6, mass=None,
                   rho_p: float = 1.0) -> dict:
    """Particles put into the first free slots (GfsFeedParticle,
    particulatecommon.c:2377-2640), the slots found on the device; those
    beyond the free slots are dropped (the reference grows its list).
    A dropped injection writes to a scratch slot past the capacity:
    gerris_tpu's writes slot 0's old values back to slot 0, so that with
    slot 0 free its new particle is lost (ROADMAP Queue 3)."""
    dt, dev = p["pos"].dtype, p["pos"].device
    pos = torch.as_tensor(pos, dtype=dt).to(dev)
    pos = pos.reshape(-1, p["pos"].shape[1])
    k = pos.shape[0]
    vel = torch.zeros_like(pos) if vel is None else \
        torch.as_tensor(vel, dtype=dt).to(dev).reshape(k, -1)
    vol = torch.as_tensor(vol, dtype=dt).to(dev).expand(k)
    mass = rho_p * vol if mass is None else \
        torch.as_tensor(mass, dtype=dt).to(dev).expand(k)
    cap = p["alive"].shape[0]
    ar = torch.arange(cap, device=dev)
    free = torch.sort(torch.where(p["alive"], cap, ar)).values
    sel = torch.arange(k, device=dev)
    order = torch.where(sel < cap, free[sel.clamp(max=cap - 1)], cap)
    new = dict(p)
    for key, v in (("pos", pos), ("vel", vel), ("vol", vol), ("mass", mass),
                   ("alive", torch.ones(k, dtype=torch.bool, device=dev))):
        buf = torch.cat([p[key], p[key][:1]])
        new[key] = buf.index_copy(0, order, v)[:cap]
    return new
