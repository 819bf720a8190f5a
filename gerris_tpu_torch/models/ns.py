"""Incompressible Navier-Stokes time step (port of gerris_tpu/models/ns.py,
the uniform-grid, solid-free, single-phase 2D step).

One step (reference: src/simulation.c:432-557):
  1. predicted face velocities (BCG from the centred field);
  2. MAC projection at dt/2 on Pmac -> divergence-free faces + gmac;
  3. centred velocity advection (BCG with the MAC faces and the gmac
     face correction) + implicit diffusion per component;
  4. approximate projection at dt on P, with the gc gradient re-add.
Every solve goes through poisson.solve -> fused_cycle -> the CUDA kernels
(on the CPU, their plain versions).  Tracers, VOF, variable density,
tension, body forces, solids and metrics are later slices.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.grid import Grid
from ..core import bc as bcs
from ..ops.stencils import face_average
from ..solvers import advection as adv
from ..solvers import diffusion as diff
from ..solvers import poisson
from ..solvers import projection as proj


def grad_bc(u_bc: bcs.FieldBC) -> bcs.FieldBC:
    """BC for pressure(-gradient) fields: periodic where the domain is
    periodic, symmetric (Neumann 0) otherwise."""
    return bcs.FieldBC(tuple(
        tuple(bcs.Periodic() if b.kind == bcs.PERIODIC else bcs.Neumann()
              for b in ax)
        for ax in u_bc.sides))


@dataclasses.dataclass(frozen=True)
class NSConfig:
    """Static configuration of the step (the slice's fields of the
    reference NSConfig).  The solver schedules are the port's fixed-cycle
    MultilevelParams; utils/convert.config_from_jax builds one from a JAX
    NSConfig and refuses fields outside this slice."""
    grid: Grid
    u_bcs: tuple                      # FieldBC per velocity component
    p_bc: bcs.FieldBC = None          # default: grad_bc(u_bcs[0])
    advection: adv.AdvectionParams = adv.AdvectionParams()
    projection: poisson.MultilevelParams = poisson.MultilevelParams()
    approx_projection: poisson.MultilevelParams = poisson.MultilevelParams()
    nu: float = 0.0                   # kinematic viscosity
    beta: float = 1.0                 # diffusion implicitness
    diffusion_params: poisson.MultilevelParams = poisson.MultilevelParams()

    def __post_init__(self):
        if self.grid.dim != 2:
            raise NotImplementedError("3D NS is slice 2 (ROADMAP Queue 1)")
        if self.p_bc is None:
            object.__setattr__(self, "p_bc", grad_bc(self.u_bcs[0]))

    @property
    def dim(self):
        return self.grid.dim


def velocity_names(dim):
    return ("U", "V", "W")[:dim]


def gradient_names(dim):
    return ("Gx", "Gy", "Gz")[:dim]


def predicted_face_velocities(U: list, grid: Grid, cfg: NSConfig, dt):
    """BCG predicted MAC velocities with centred upwinding (reference:
    src/timestep.c:681-717)."""
    uc_pad = [bcs.apply_bc(U[c], grid, cfg.u_bcs[c], 1, corners=False)
              for c in range(grid.dim)]
    uf = []
    for c in range(grid.dim):
        vp, vm = adv.advected_face_values(U[c], grid, cfg.u_bcs[c], dt,
                                          uc_pad, axes=(c,))[c]
        un = face_average(uc_pad[c], grid, c)
        uf.append(bcs.apply_face_bc(adv.upwind_face_value(vp, vm, un, c),
                                    grid, cfg.u_bcs[c], c))
    return uf


def velocity_advection_diffusion(U: list, uf: list, gmac: list, g_prev,
                                 grid: Grid, cfg: NSConfig, dt):
    """BCG advection of each component with the MAC faces, the gmac face
    correction and the -dt g_prev gc term, then its implicit diffusion
    (reference: src/timestep.c:976-1017; gerris_tpu ns.py:375-447)."""
    gbc = grad_bc(cfg.u_bcs[0])
    uc_pad = adv.mac_cell_mean(uf, grid)
    out = []
    for c in range(grid.dim):
        fvals = adv.advected_face_values(U[c], grid, cfg.u_bcs[c], dt, uc_pad)
        g_pad = bcs.apply_bc(gmac[c], grid, gbc, 1, corners=False)
        v_faces = []
        for a in range(grid.dim):
            vface = adv.upwind_face_value(fvals[a][0], fvals[a][1], uf[a], a)
            vface = vface - face_average(g_pad, grid, a) * dt / 2.0
            if a == c:
                vface = bcs.apply_face_bc(vface, grid, cfg.u_bcs[c], a)
            v_faces.append(vface)
        fv = adv.flux_divergence(v_faces, uf, grid, dt)
        if g_prev is not None:
            fv = fv - dt * g_prev[c]
        if cfg.nu > 0.0:
            v_new, _ = diff.diffuse(U[c], grid, cfg.u_bcs[c], dt, cfg.nu,
                                    rho=1.0, beta=cfg.beta,
                                    params=cfg.diffusion_params,
                                    extra_rhs=fv)
        else:
            v_new = U[c] + fv
        out.append(v_new)
    return out


def ns_step(state: dict, dt: float, t: float, cfg: NSConfig,
            first_step: bool = False) -> dict:
    """One full time step; ``state`` holds U, V, P, Pmac, Gx, Gy.  ``dt``
    is a host float (the Helmholtz dia = 1/(beta dt nu) is a kernel
    argument).  ``t`` is unused while BC values are constant; it is kept
    for the reference's signature.  Returns a new state dict."""
    grid = cfg.grid
    dim = grid.dim
    names = velocity_names(dim)
    U = [state[n] for n in names]
    g_prev = [state[n] for n in gradient_names(dim)]
    # 1-2. prediction, MAC projection at dt/2 (the reference swaps P and
    # Pmac around it, src/simulation.c:498-504)
    uf = predicted_face_velocities(U, grid, cfg, dt)
    uf, pmac, gmac, _ = proj.mac_projection(uf, state["Pmac"], grid,
                                            cfg.p_bc, dt / 2.0,
                                            cfg.projection)
    # 3. at i == 0 the gc gradient role is played by this step's gmac
    # (src/simulation.c:514-521)
    if first_step:
        g_prev = gmac
    U = velocity_advection_diffusion(U, uf, gmac, g_prev, grid, cfg, dt)
    # 4. approximate projection at dt with the gc re-add folded into the
    # face interpolation (src/simulation.c:520)
    uf2, U = proj.face_interpolated_velocity(U, grid, list(cfg.u_bcs),
                                             gp=g_prev, dtv=dt)
    _, p, g_cell, _, U = proj.mac_projection(uf2, state["P"], grid,
                                             cfg.p_bc, dt,
                                             cfg.approx_projection, cells=U)
    new = dict(state)
    for c, n in enumerate(names):
        new[n] = U[c]
    new["P"] = p
    new["Pmac"] = pmac
    for c, n in enumerate(gradient_names(dim)):
        new[n] = g_cell[c]
    return new


def initial_projection(state: dict, dt: float, t: float,
                       cfg: NSConfig) -> dict:
    """The i == 0 approximate projection that makes the initial field
    divergence-free and seeds the gc gradient (src/simulation.c:466-474)."""
    names = velocity_names(cfg.dim)
    U = [state[n] for n in names]
    uf = proj.face_interpolated_velocity(U, cfg.grid, list(cfg.u_bcs))
    _, p, g_cell, _ = proj.mac_projection(uf, state["P"], cfg.grid,
                                          cfg.p_bc, dt,
                                          cfg.approx_projection)
    new = dict(state)
    for c, n in enumerate(names):
        new[n] = U[c] - dt * g_cell[c]
    new["P"] = p
    for c, n in enumerate(gradient_names(cfg.dim)):
        new[n] = g_cell[c]
    return new


def timescale(state: dict, cfg: NSConfig) -> torch.Tensor:
    """min over components of h / max|u| (reference: gfs_domain_cfl,
    src/domain.c:2857-2906), a 0-d tensor on the state's device.  The
    reference guards with 1e-300, which is 0 in float32: the port uses
    the dtype's smallest normal number."""
    ts = None
    for n in velocity_names(cfg.dim):
        v = state[n]
        umax = torch.clamp(v.abs().max(), min=torch.finfo(v.dtype).tiny)
        t_c = cfg.grid.h / umax
        ts = t_c if ts is None else torch.minimum(ts, t_c)
    return ts
