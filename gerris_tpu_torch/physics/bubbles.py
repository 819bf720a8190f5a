"""Bubbles: particles with a Rayleigh-Plesset radius (port of
gerris_tpu/physics/bubbles.py).

Reference: modules/bubbles.c: the polytropic gas p_state_ec:87, the
incompressible Rayleigh-Plesset RPeq:95-101, Keller-Miksis RPKMeq:103-111,
the fixed radius NORPeq:113, the coupled system func:118-155 integrated by
GSL in gfs_bubble_event:186-276, GfsBubbleFraction:538-744 and the
interactions GfsBubbleInteractions:815-1130.

The (R, Rdot) system of every bubble is integrated together by RK4 over
a fixed number of substeps, a Python loop of tensor operations (the
reference steps each bubble with an adaptive GSL integrator); the
translation is the particles' leapfrog (physics/particles.py).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..core.device import default_device
from ..core.grid import Grid
from . import particles as parts


@dataclasses.dataclass(frozen=True)
class BubbleConfig:
    """GfsBubbleParams (modules/bubbles.c): the model, the polytropic
    exponent, surface tension, the liquid's viscosity and sound speed;
    gerris_tpu's fields and defaults."""
    model: str = "rp"        # rp | keller_miksis | const
    gamma: float = 1.4
    sigma: float = 0.0
    visc: float = 0.0        # liquid dynamic viscosity
    cl: float = 1500.0       # liquid sound speed (Keller-Miksis)
    substeps: int = 16       # RK4 substeps per flow step
    # the radiated-pressure coupling between bubbles (GfsBubbleInteractions,
    # bubbles.c:815-1130), a dense n x n solve per RK stage
    interactions: bool = False


def gas_pressure(p0, R0, R, gamma):
    """The polytropic p0 (R0/R)^(3 gamma), the radius clamped as the
    reference clamps it (bubbles.c:87-93)."""
    Rc = torch.where(R <= 1e-3 * R0, 1e-2 * R0, R)
    return p0 * torch.pow(R0 / Rc, 3.0 * gamma)


def _pdiff(R, Rdot, p0, R0, p_liq, cfg: BubbleConfig):
    pb = gas_pressure(p0, R0, R, cfg.gamma)
    return pb - 2.0 * cfg.sigma / R + 4.0 * cfg.visc * Rdot / R - p_liq


def radius_rhs(R, Rdot, p0, R0, p_liq, rho_liq, cfg: BubbleConfig):
    """d(Rdot)/dt of each model (RPeq:95, RPKMeq:103, NORPeq:113)."""
    pdiff = _pdiff(R, Rdot, p0, R0, p_liq, cfg)
    if cfg.model == "const":
        return torch.zeros_like(R)
    if cfg.model == "rp":
        return (pdiff / rho_liq - 1.5 * Rdot * Rdot) / R
    if cfg.model == "keller_miksis":
        f = pdiff / rho_liq
        f = f * (1.0 + Rdot / cfg.cl)
        f = f - 1.5 * Rdot * Rdot * (1.0 - Rdot / (3.0 * cfg.cl))
        return f / (R * (1.0 - Rdot / cfg.cl))
    raise ValueError(cfg.model)


def coupled_radius_rhs(R, Rdot, p0, R0, p_liq, rho_liq, pos, alive,
                       cfg: BubbleConfig):
    """The accelerations of interacting bubbles (GfsBubbleInteractions,
    bubbles.c:815-1130): each wall's motion radiates p'(d) = rho (R^2
    Rddot + 2 R Rdot^2) / d into its neighbours, so that
        R_i Rddot_i + sum_j (R_j^2 / d_ij) Rddot_j = b_i,
        b_i = pdiff_i / rho - 1.5 Rdot_i^2 - sum_j 2 R_j Rdot_j^2 / d_ij,
    solved densely (torch.linalg.solve_ex: LU as torch.linalg.solve, with
    no singularity check read back to the host); no self-coupling, the distance
    floored at the sum of the radii, a dead bubble's row Rddot = 0."""
    pdiff = _pdiff(R, Rdot, p0, R0, p_liq, cfg)
    n = R.shape[0]
    diff = pos[:, None, :] - pos[None, :, :]
    d = torch.sqrt(torch.sum(diff * diff, dim=-1))
    eye = torch.eye(n, dtype=torch.bool, device=R.device)
    d = torch.maximum(d, R[:, None] + R[None, :])
    pair = alive[:, None] & alive[None, :]
    inv_d = torch.where(eye | ~pair, 0.0, 1.0 / d)
    A = torch.diag(R) + (R[None, :] ** 2) * inv_d
    b = (pdiff / rho_liq - 1.5 * Rdot * Rdot
         - torch.sum(2.0 * (R * Rdot * Rdot)[None, :] * inv_d, dim=1))
    A = torch.where(pair, A, eye.to(A.dtype))
    b = torch.where(alive, b, 0.0)
    return torch.linalg.solve_ex(A, b)[0]


def _rk4(R, Rdot, rhs, dt, substeps, R0):
    """``substeps`` RK4 steps of (R, Rdot)' = (Rdot, rhs(R, Rdot)) over
    ``dt``, then the reference's radius clamp (bubbles.c:262)."""
    h = dt / substeps
    for _ in range(substeps):
        a1, b1 = Rdot, rhs(R, Rdot)
        a2 = Rdot + 0.5 * h * b1
        b2 = rhs(R + 0.5 * h * a1, a2)
        a3 = Rdot + 0.5 * h * b2
        b3 = rhs(R + 0.5 * h * a2, a3)
        a4 = Rdot + h * b3
        b4 = rhs(R + h * a3, a4)
        R, Rdot = (R + h / 6.0 * (a1 + 2 * a2 + 2 * a3 + a4),
                   Rdot + h / 6.0 * (b1 + 2 * b2 + 2 * b3 + b4))
    return torch.where(R <= 1e-3 * R0, 1e-2 * R0, R), Rdot


def integrate_radius(R, Rdot, p0, R0, p_liq, rho_liq, dt,
                     cfg: BubbleConfig):
    """(R, Rdot) of every bubble over one flow step ``dt`` (RK4 in
    cfg.substeps; gsl_odeiv_evolve in bubbles.c:232-258)."""
    return _rk4(R, Rdot, lambda r, rd: radius_rhs(r, rd, p0, R0, p_liq,
                                                   rho_liq, cfg),
                dt, cfg.substeps, R0)


def integrate_radius_coupled(R, Rdot, p0, R0, p_liq, rho_liq, pos, alive,
                             dt, cfg: BubbleConfig):
    """integrate_radius with the interactions (coupled_radius_rhs)."""
    return _rk4(R, Rdot, lambda r, rd: coupled_radius_rhs(
        r, rd, p0, R0, p_liq, rho_liq, pos, alive, cfg),
        dt, cfg.substeps, R0)


def make_bubbles(capacity: int, dim: int, pos, vel=None, R=None, p0=None,
                 rho_gas: float = 1e-3, device=None,
                 dtype=torch.float64) -> dict:
    """A bubble state: a particle state (make_particles) and R, Rdot, R0,
    p0 per slot; R 0.01 and p0 1 unless given, dead slots R = R0 = 1e-6.
    On ``device``, the CUDA card by default."""
    device = default_device(device)
    npart = len(pos)
    R = torch.full((npart,), 0.01, dtype=dtype, device=device) \
        if R is None else torch.as_tensor(R, dtype=dtype).to(device)
    vol = 4.0 / 3.0 * math.pi * R ** 3
    b = parts.make_particles(capacity, dim, pos=pos, vel=vel, vol=vol,
                             mass=rho_gas * vol, device=device, dtype=dtype)

    def fullv(src, fill):
        out = torch.full((capacity,), fill, dtype=dtype, device=device)
        if src is not None:
            out[: src.shape[0]] = src
        return out

    b["R"] = fullv(R, 1e-6)
    b["Rdot"] = torch.zeros(capacity, dtype=dtype, device=device)
    b["R0"] = fullv(R, 1e-6)
    b["p0"] = fullv(None if p0 is None else
                    torch.as_tensor(p0, dtype=dtype).to(device), 1.0)
    return b


def step_bubbles(b: dict, U: list, U_old: list, P: torch.Tensor, grid: Grid,
                 u_bcs: list, p_bc, pcfg: parts.ParticleConfig,
                 bcfg: BubbleConfig, nu: float, rho_liq: float, dt: float,
                 t: float = 0.0):
    """One bubble step (gfs_bubble_event, bubbles.c:186-276): the radius
    system driven by the liquid pressure at each bubble, then the
    particles' translation.  Returns step_particles' triple, the state
    with R, Rdot, R0 and p0."""
    p_at = parts.interpolate_at(P, grid, p_bc, b["pos"], t)
    if bcfg.interactions:
        R, Rdot = integrate_radius_coupled(
            b["R"], b["Rdot"], b["p0"], b["R0"], p_at, rho_liq,
            b["pos"], b["alive"], dt, bcfg)
    else:
        R, Rdot = integrate_radius(b["R"], b["Rdot"], b["p0"], b["R0"],
                                   p_at, rho_liq, dt, bcfg)
    b = dict(b, R=R, Rdot=Rdot, vol=4.0 / 3.0 * math.pi * R ** 3)
    new, total, hydro = parts.step_particles(b, U, U_old, grid, u_bcs, pcfg,
                                             nu, dt, t)
    for k in ("R", "Rdot", "R0", "p0"):
        new[k] = b[k]
    return new, total, hydro


def void_fraction_dt(b: dict, b_prev: dict, grid: Grid,
                     pcfg: parts.ParticleConfig, dt: float):
    """The spread d(void volume)/dt (GfsBubbleFractionDt,
    bubbles.c:758-790), a divergence source where bubbles are sub-grid
    cavitation nuclei."""
    return parts.deposit((b["vol"] - b_prev["vol"]) / dt, b, grid, pcfg)
