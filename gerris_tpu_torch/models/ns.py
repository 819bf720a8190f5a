"""Incompressible Navier-Stokes time step (port of gerris_tpu/models/ns.py,
the uniform-grid, solid-free, single-phase step, 2D and 3D).

One step (reference: src/simulation.c:432-557):
  1. predicted face velocities (BCG from the centred field), K6
     ``predict_xy``;
  2. MAC projection at dt/2 on Pmac -> divergence-free faces + gmac
     (K4 ``divergence_mac``, the solve, K5 ``correct_project``);
  3. centred velocity advection (BCG with the MAC faces and the gmac
     face correction) and the implicit diffusion: both components in K7
     ``advect2d_pair`` (``pair_advect``) or one K14 ``advect2d`` each,
     then the U+V Helmholtz pair through K8a-c (``diffuse_pair``);
  4. approximate projection at dt on P, with the gc gradient re-add
     folded into K9 ``interp_faces`` and the centred correction into K5.
Every projection solve goes through poisson.solve: the fixed schedule's
fused cycle (K1-K3), or by default the reference's adaptive tolerance
loop (K11 per cycle, K12 and K3 in each correction).  With an adaptive
diffusion schedule (the default) the step takes the per-component route:
K14 with its rhs fold, then one adaptive solve per component.  The
kernels run on CUDA tensors, their plain versions on the CPU.
In 3D every phase but the multigrid's smoother takes the reference's
generic torch route (gerris_tpu/models/ns.py:208-223, :335-447;
solvers/projection.py), and each solve's upward levels run K13
``rbgs_relax_3d``; ``div_in_src``, ``pair_advect`` and ``rr_in_advect``
are 2D routes and are ignored in 3D, as the reference ignores them.
Tracers, VOF, variable density, tension, body forces, solids and metrics
are later slices.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.grid import Grid
from ..core import bc as bcs
from ..ops.cuda import bcg, predict
from ..ops.stencils import face_average
from ..solvers import advection as adv
from ..solvers import diffusion as diff
from ..solvers import poisson
from ..solvers import projection as proj


@dataclasses.dataclass(frozen=True)
class NSConfig:
    """Static configuration of the step (the slice's fields of the
    reference NSConfig, with its defaults: both projections adaptive to
    tolerance 1e-3 in at most 100 cycles, and diffusion_params None for
    diffuse's default).  utils/convert.config_from_jax builds one from a
    JAX NSConfig and refuses fields outside this slice."""
    grid: Grid
    u_bcs: tuple                      # FieldBC per velocity component
    p_bc: bcs.FieldBC = None          # default: bcs.grad_bc(u_bcs[0])
    advection: adv.AdvectionParams = adv.AdvectionParams()
    projection: poisson.MultilevelParams = poisson.MultilevelParams(
        tolerance=1e-3, nitermax=100)
    approx_projection: poisson.MultilevelParams = poisson.MultilevelParams(
        tolerance=1e-3, nitermax=100)
    nu: float = 0.0                   # kinematic viscosity
    beta: float = 1.0                 # diffusion implicitness
    # None: diffusion.DEFAULT_PARAMS (adaptive, at most 10 cycles)
    diffusion_params: poisson.MultilevelParams = None
    # fold each projection's divergence into the launch that builds its
    # faces (K6 / K9 with div_scale; gerris_tpu/models/ns.py:909-986)
    div_in_src: bool = False
    # both components' BCG advections in one K7 launch (the bench's
    # route, gerris_tpu/models/ns.py:132-136)
    pair_advect: bool = False
    # with pair_advect and a one-cycle multigrid diffusion schedule: K7
    # also gives the diffusion pair's first residual pyramid, replacing
    # its K8a launch (gerris_tpu/models/ns.py:144-149)
    rr_in_advect: bool = False

    def __post_init__(self):
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
    by div_scale and its sum; else None (always in 3D, where the faces
    take the reference's generic route, gerris_tpu/models/ns.py:208-223)."""
    if grid.dim == 3:
        uc_pad = [bcs.apply_bc(U[c], grid, cfg.u_bcs[c], 1, corners=False)
                  for c in range(3)]
        uf = []
        for c in range(3):
            vp, vm = adv.advected_face_values(U[c], grid, cfg.u_bcs[c], dt,
                                              uc_pad, axes=(c,))[c]
            un = face_average(uc_pad[c], grid, c)
            uf.append(bcs.apply_face_bc(adv.upwind_face_value(vp, vm, un, c),
                                        grid, cfg.u_bcs[c], c))
        return uf, None
    kernel = (bcg.applicable(grid, cfg.advection)
              and bcg.face_specs(cfg.u_bcs) is not None)
    fn = predict.predict_xy if kernel else predict.predict_xy_plain
    out = fn(U[0], U[1], dt, grid, cfg.u_bcs, div_scale)
    return [out[0], out[1]], None if div_scale is None else (out[2], out[3])


def _pair_route(grid: Grid, cfg: NSConfig) -> bool:
    """The reference's batched U+V route (gerris_tpu/models/ns.py:257-264):
    2D, fully implicit diffusion on a fixed schedule, the kernel route,
    and K14's BCs (periodic y refused) for both components."""
    return (cfg.nu > 0.0 and cfg.beta == 1.0
            and cfg.diffusion_params is not None
            and cfg.diffusion_params.ncycles > 0
            and bcg.applicable(grid, cfg.advection)
            and all(bcg.advect_spec(f) is not None for f in cfg.u_bcs))


def velocity_advection_diffusion(U: list, uf: list, gmac: list, g_prev,
                                 grid: Grid, cfg: NSConfig, dt):
    """BCG advection of each component with the MAC faces, the gmac face
    correction and the -dt g_prev gc term, then its implicit diffusion
    (reference: src/timestep.c:976-1017; gerris_tpu ns.py:257-374).  With
    beta = 1 the advection launch emits the diffusion system's rhs
    -dia (v + fv), dia = 1/(dt nu) (its oscale fold; the beta < 1
    explicit term needs diffuse()).

    On the pair route (_pair_route) both components go through K7
    ``advect2d_pair`` (``pair_advect``) or one K14 ``advect2d`` each,
    and the two diffusion systems through diffuse_pair (K8a-c); with
    ``rr_in_advect`` K7 also gives the pair's first residual pyramid.
    Otherwise (an adaptive diffusion schedule among them, as in the
    reference, gerris_tpu/models/ns.py:257-262, 347-372) each component
    takes K14 where its BCs allow it, else its plain version, and its own
    solve.  3D: the reference's generic route, advection_diffusion_3d."""
    if grid.dim == 3:
        return advection_diffusion_3d(U, uf, gmac, g_prev, grid, cfg, dt)
    fold = cfg.nu > 0.0 and cfg.beta == 1.0
    dia = 1.0 / (dt * cfg.nu) if fold else None
    gp = None if g_prev is None else list(g_prev)
    if _pair_route(grid, cfg):
        bcs_ = list(cfg.u_bcs)
        dp = cfg.diffusion_params
        kw = dict(g=gmac, gp=gp, oscale=-dia)
        if cfg.pair_advect:
            if (cfg.rr_in_advect and dp.ncycles == 1
                    and dp.solver != "relax"
                    and poisson.batched_fixed_eligible(U, grid, bcs_,
                                                       [dia, dia])):
                rr = bcg.advect2d_pair(U[0], U[1], uf[0], uf[1], dt, grid,
                                       bcs_, rr_dia=dia, **kw)
                return diff.diffuse_pair(U, grid, bcs_, dt, cfg.nu,
                                         cfg.beta, dp, rr_pre=rr)[0]
            rhss = bcg.advect2d_pair(U[0], U[1], uf[0], uf[1], dt, grid,
                                     bcs_, **kw)
        else:
            rhss = [bcg.advect2d(U[c], c, uf[0], uf[1], dt, grid, bcs_[c],
                                 g=gmac[c], gp=None if gp is None else gp[c],
                                 oscale=-dia) for c in range(2)]
        return diff.diffuse_pair(U, grid, bcs_, dt, cfg.nu, cfg.beta, dp,
                                 rhss=rhss)[0]
    kernel = bcg.applicable(grid, cfg.advection)
    out = []
    for c in range(grid.dim):
        fbc = cfg.u_bcs[c]
        advect = bcg.advect2d if kernel and bcg.advect_spec(fbc) is not None \
            else bcg.advect2d_plain
        fv = advect(U[c], c, uf[0], uf[1], dt, grid, fbc, g=gmac[c],
                    gp=None if gp is None else gp[c],
                    oscale=None if dia is None else -dia)
        if fold:
            v_new, _ = poisson.solve(
                U[c], fv, grid, fbc,
                diff.params_or_default(cfg.diffusion_params), dia=dia)
        elif cfg.nu > 0.0:
            v_new, _ = diff.diffuse(U[c], grid, fbc, dt, cfg.nu, rho=1.0,
                                    beta=cfg.beta,
                                    params=cfg.diffusion_params,
                                    extra_rhs=fv)
        else:
            v_new = U[c] + fv
        out.append(v_new)
    return out


def advection_diffusion_3d(U: list, uf: list, gmac: list, g_prev,
                           grid: Grid, cfg: NSConfig, dt):
    """Per component: the BCG face values with the MAC faces' cell means
    as the advecting velocity, upwinded by the MAC faces, minus the face
    mean of gmac times dt/2 (the component's own faces then take its
    Dirichlet value), the flux divergence, minus dt g_prev, then the
    implicit diffusion solve (reference gerris_tpu/models/ns.py:375-447,
    src/advection.c:419)."""
    uc_pad = adv.mac_cell_mean(uf, grid)
    gbc = bcs.grad_bc(cfg.u_bcs[0])
    out = []
    for c in range(3):
        fbc = cfg.u_bcs[c]
        fvals = adv.advected_face_values(U[c], grid, fbc, dt, uc_pad)
        g_pad = bcs.apply_bc(gmac[c], grid, gbc, 1, corners=False)
        v_faces = []
        for a in range(3):
            vface = adv.upwind_face_value(fvals[a][0], fvals[a][1], uf[a], a)
            vface = vface - face_average(g_pad, grid, a) * dt / 2.0
            if a == c:
                vface = bcs.apply_face_bc(vface, grid, fbc, a)
            v_faces.append(vface)
        fv = adv.flux_divergence(v_faces, uf, grid, dt)
        if g_prev is not None:
            fv = fv - dt * g_prev[c]
        if cfg.nu > 0.0:
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
    """One full time step; ``state`` holds U, V[, W], P, Pmac, Gx, Gy[,
    Gz].  ``dt`` is a host float (the Helmholtz dia = 1/(beta dt nu) is a
    kernel argument).  ``t`` is unused while BC values are constant; it is kept
    for the reference's signature.  Returns a new state dict."""
    grid = cfg.grid
    dim = grid.dim
    names = velocity_names(dim)
    U = [state[n] for n in names]
    g_prev = [state[n] for n in gradient_names(dim)]
    # 1-2. prediction, MAC projection at dt/2 (the reference swaps P and
    # Pmac around it, src/simulation.c:498-504).  div_in_src (2D): each
    # projection's divergence comes out of the launch that builds its faces
    fold = cfg.div_in_src and dim == 2
    uf, mac_divp = predicted_face_velocities(
        U, grid, cfg, dt,
        div_scale=1.0 / (grid.h * (dt / 2.0)) if fold else None)
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
        div_scale=1.0 / (grid.h * dt) if fold else None)
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
