"""Incompressible Navier-Stokes time step (port of gerris_tpu/models/ns.py,
the uniform-grid, solid-free, single-phase 2D step).

One step (reference: src/simulation.c:432-557):
  1. predicted face velocities (BCG from the centred field), K6
     ``predict_xy``;
  2. MAC projection at dt/2 on Pmac -> divergence-free faces + gmac
     (K4 ``divergence_mac``, the solve, K5 ``correct_project``);
  3. centred velocity advection per component (BCG with the MAC faces
     and the gmac face correction), K14 ``advect2d``, then its implicit
     diffusion solve;
  4. approximate projection at dt on P, with the gc gradient re-add
     folded into K9 ``interp_faces`` and the centred correction into K5.
Every solve goes through poisson.solve -> fused_cycle -> the CUDA kernels
K1-K3; the kernels run on CUDA tensors, their plain versions on the CPU.
Tracers, VOF, variable density, tension, body forces, solids and metrics
are later slices.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.grid import Grid
from ..core import bc as bcs
from ..ops.cuda import bcg, predict
from ..solvers import advection as adv
from ..solvers import diffusion as diff
from ..solvers import poisson
from ..solvers import projection as proj


@dataclasses.dataclass(frozen=True)
class NSConfig:
    """Static configuration of the step (the slice's fields of the
    reference NSConfig).  The solver schedules are the port's fixed-cycle
    MultilevelParams; utils/convert.config_from_jax builds one from a JAX
    NSConfig and refuses fields outside this slice."""
    grid: Grid
    u_bcs: tuple                      # FieldBC per velocity component
    p_bc: bcs.FieldBC = None          # default: bcs.grad_bc(u_bcs[0])
    advection: adv.AdvectionParams = adv.AdvectionParams()
    projection: poisson.MultilevelParams = poisson.MultilevelParams()
    approx_projection: poisson.MultilevelParams = poisson.MultilevelParams()
    nu: float = 0.0                   # kinematic viscosity
    beta: float = 1.0                 # diffusion implicitness
    diffusion_params: poisson.MultilevelParams = poisson.MultilevelParams()
    # fold each projection's divergence into the launch that builds its
    # faces (K6 / K9 with div_scale; gerris_tpu/models/ns.py:909-986)
    div_in_src: bool = False

    def __post_init__(self):
        if self.grid.dim != 2:
            raise NotImplementedError("3D NS is slice 2 (ROADMAP Queue 1)")
        if self.p_bc is None:
            object.__setattr__(self, "p_bc", bcs.grad_bc(self.u_bcs[0]))

    @property
    def dim(self):
        return self.grid.dim


def velocity_names(dim):
    return ("U", "V", "W")[:dim]


def gradient_names(dim):
    return ("Gx", "Gy", "Gz")[:dim]


def predicted_face_velocities(U: list, grid: Grid, cfg: NSConfig, dt,
                              div_scale=None):
    """BCG predicted MAC velocities with centred upwinding (reference:
    src/timestep.c:681-717): (faces, divp).  Through K6 where the BCs
    allow it (gerris_tpu/models/ns.py:190-196), else its plain version.
    ``div_scale``: ``divp`` is (div, total), the faces' divergence scaled
    by div_scale and its sum; else None."""
    kernel = (bcg.applicable(grid, cfg.advection)
              and bcg.face_specs(cfg.u_bcs) is not None)
    fn = predict.predict_xy if kernel else predict.predict_xy_plain
    out = fn(U[0], U[1], dt, grid, cfg.u_bcs, div_scale)
    return [out[0], out[1]], None if div_scale is None else (out[2], out[3])


def velocity_advection_diffusion(U: list, uf: list, gmac: list, g_prev,
                                 grid: Grid, cfg: NSConfig, dt):
    """BCG advection of each component with the MAC faces, the gmac face
    correction and the -dt g_prev gc term (K14 ``advect2d`` where the BCs
    allow it, else its plain version), then its implicit diffusion
    (reference: src/timestep.c:976-1017; gerris_tpu ns.py:257-374).  With
    beta = 1 the advection launch emits the diffusion system's rhs
    -dia (v + fv), dia = 1/(dt nu), as the reference's kernel route does
    (its oscale fold); the beta < 1 explicit term needs diffuse()."""
    fold = cfg.nu > 0.0 and cfg.beta == 1.0
    dia = 1.0 / (dt * cfg.nu) if fold else None
    kernel = bcg.applicable(grid, cfg.advection)
    out = []
    for c in range(grid.dim):
        fbc = cfg.u_bcs[c]
        advect = bcg.advect2d if kernel and bcg.advect_spec(fbc) is not None \
            else bcg.advect2d_plain
        fv = advect(U[c], c, uf[0], uf[1], dt, grid, fbc, g=gmac[c],
                    gp=None if g_prev is None else g_prev[c],
                    oscale=None if dia is None else -dia)
        if fold:
            v_new, _ = poisson.solve(U[c], fv, grid, fbc,
                                     cfg.diffusion_params, dia=dia)
        elif cfg.nu > 0.0:
            v_new, _ = diff.diffuse(U[c], grid, fbc, dt, cfg.nu, rho=1.0,
                                    beta=cfg.beta,
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
    # Pmac around it, src/simulation.c:498-504).  div_in_src: each
    # projection's divergence comes out of the launch that builds its faces
    uf, mac_divp = predicted_face_velocities(
        U, grid, cfg, dt,
        div_scale=1.0 / (grid.h * (dt / 2.0)) if cfg.div_in_src else None)
    uf, pmac, gmac, _, _ = proj.mac_projection(
        uf, state["Pmac"], grid, cfg.p_bc, dt / 2.0, cfg.projection,
        div_pre=mac_divp)
    # 3. at i == 0 the gc gradient role is played by this step's gmac
    # (src/simulation.c:514-521)
    if first_step:
        g_prev = gmac
    U = velocity_advection_diffusion(U, uf, gmac, g_prev, grid, cfg, dt)
    # 4. approximate projection at dt with the gc re-add folded into the
    # face interpolation (src/simulation.c:520) and the centred
    # correction into the projection's correction launch
    uf2, U, apx_divp = proj.face_interpolated_velocity(
        U, grid, list(cfg.u_bcs), gp=g_prev, dtv=dt,
        div_scale=1.0 / (grid.h * dt) if cfg.div_in_src else None)
    _, p, g_cell, _, U = proj.mac_projection(uf2, state["P"], grid,
                                             cfg.p_bc, dt,
                                             cfg.approx_projection, cells=U,
                                             div_pre=apx_divp)
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
    uf, _, _ = proj.face_interpolated_velocity(U, cfg.grid, list(cfg.u_bcs))
    _, p, g_cell, _, U = proj.mac_projection(uf, state["P"], cfg.grid,
                                             cfg.p_bc, dt,
                                             cfg.approx_projection, cells=U)
    new = dict(state)
    for c, n in enumerate(names):
        new[n] = U[c]
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
