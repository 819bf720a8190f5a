"""Incompressible Navier-Stokes on the adaptive composite mesh (port of
gerris_tpu/models/amr_ns.py).

The reference's run loop on adaptive trees (src/simulation.c:432-557,
gfs_simulation_adapt every step :528-533 -> src/adaptive.c:1445; the
fine-coarse face stencils src/fluid.c:905; the VOF fine/coarse fluxes
src/vof.c:1214-1272).  The state is {name: {level: dense tensor}} with
runtime leaf masks (solvers/amr.py): each phase runs the uniform
functions per level, so their kernels run where the port's dispatch
takes them (K6 for the predicted faces and K9 for the face interpolation
per level, K11 / K10 / K15 in the solves), ``sync`` supplies the
restricted and prolonged cells, and the composite multigrid (dense mask
engine, or the block engine of solvers/blockrt.py on a 2D unit box)
does the projections and the implicit diffusion.

The driver ``AMRSimulation`` keeps the depth map on the host: an
adaptation reads the criterion's cost fields once, builds the masks and
the block tables in numpy and uploads them once.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..core.device import default_device
from ..core.grid import Grid
from ..core import bc as bcs
from ..ops.stencils import (center_gradient, divergence, face_average,
                            laplacian)
from ..solvers import advection as adv
from ..solvers import amr, blockadv, poisson
from ..solvers import projection as proj
from ..solvers.amr import Topo
from ..solvers.composite import (CompositeGrid, _pool_reduce_np,
                                  grade_depth_map)
from . import ns


def sync_all(state: dict, leaf, cfg: ns.NSConfig, topo: Topo, t, cov=None):
    """Every field of the state synced with its own BCs; VOF fractions by
    ``amr.sync_vof`` under ``composite_vof`` (geometric slaves), else
    linearly (the pinned mode's curvature is calibrated on smooth coarse
    bands, reference amr_ns.py:69-79)."""
    if cov is None:
        cov = amr.covered_masks(leaf, topo)
    names = ns.velocity_names(topo.dim)
    out = {}
    for c, n in enumerate(names):
        out[n] = amr.sync(state[n], topo, leaf, cfg.u_bcs[c], t=t, cov=cov)
    for n in ("P", "Pmac"):
        out[n] = amr.sync(state[n], topo, leaf, cfg.p_bc, t=t, cov=cov)
    if cfg.advection.gc:
        gbc = bcs.grad_bc(cfg.u_bcs[0])
        for n in ns.gradient_names(topo.dim):
            out[n] = amr.sync(state[n], topo, leaf, gbc, t=t, cov=cov)
    s = amr.sync_vof if cfg.composite_vof else amr.sync
    for name, fbc in cfg.vof_tracers:
        out[name] = s(state[name], topo, leaf, fbc, t=t, cov=cov)
    for tr in cfg.tracers:
        out[tr[0]] = amr.sync(state[tr[0]], topo, leaf, tr[1], t=t, cov=cov)
    return out


def mac_projection_amr(uf, p, topo: Topo, leaf, cov, p_bc, dt,
                       params: poisson.MultilevelParams, alpha=None,
                       face_sources=None, t=0.0, brt=None, btables=None):
    """The composite MAC projection (mac_projection, src/timestep.c:356-432
    on the tree): per-level divergence, the composite solve (the block
    engine with ``brt``), the face correction, sync_faces.  Returns (uf,
    p, g_cell [c][l], stats)."""
    dim = topo.dim
    if face_sources is not None:
        uf = {l: [uf[l][c] + dt * face_sources[l][c] for c in range(dim)]
              for l in topo.levels}
        uf = amr.sync_faces(uf, topo, leaf, cov)
    div = {l: divergence(uf[l], topo.grid(l)) / dt for l in topo.levels}
    if brt is not None:
        p, stats = amr.solve_block(div, topo, leaf, p_bc, params, brt,
                                   btables, u0=p, t=t, alpha=alpha)
    else:
        p, stats = amr.solve(div, topo, leaf, p_bc, params, alpha=alpha,
                             u0=p, t=t)
    gf = {l: proj.face_gradients(p[l], topo.grid(l), p_bc,
                                 None if alpha is None else alpha[l], t=t)
          for l in topo.levels}
    uf = amr.sync_faces({l: [uf[l][c] - dt * gf[l][c] for c in range(dim)]
                         for l in topo.levels}, topo, leaf, cov)
    if face_sources is not None:
        gf = {l: [gf[l][c] - face_sources[l][c] for c in range(dim)]
              for l in topo.levels}
    gc_l = {l: proj.cell_gradient_from_faces(gf[l]) for l in topo.levels}
    g_cell = [{l: gc_l[l][c] for l in topo.levels} for c in range(dim)]
    return uf, p, g_cell, stats


def amr_diffuse(v, fv, topo: Topo, leaf, fbc, dt, D, rho=None,
                beta: float = 1.0, params=None, t=0.0, brt=None,
                btables=None, mu=None):
    """The composite implicit diffusion rho u - beta dt div(D grad u) =
    rho u_old + extra (gfs_diffusion, src/timestep.c:735).  ``v`` / ``fv``:
    per-level value and advection increment; ``rho``: per-level densities
    or None; ``mu``: per-level face viscosities (overrides D).  Unit
    density divides through by beta dt D (unit coefficients, scalar dia:
    K11 / K10); on the block engine a density becomes a cell dia."""
    params = params or poisson.MultilevelParams(tolerance=1e-3, nitermax=10)
    if rho is None and mu is None:
        scale = beta * dt * D
        rhs, dia = {}, {}
        for l in topo.levels:
            r = v[l] + fv[l]
            if beta < 1.0:
                v_pad = bcs.apply_bc(v[l], topo.grid(l), fbc, 1, t=t)
                r = r + (1.0 - beta) * dt * D * laplacian(v_pad, topo.grid(l))
            rhs[l] = -r / scale
            dia[l] = 1.0 / scale
        if brt is not None:
            return amr.solve_block(rhs, topo, leaf, fbc, params, brt,
                                   btables, dia=dia, u0=v, t=t)[0]
        return amr.solve(rhs, topo, leaf, fbc, params, dia=dia, u0=v,
                         t=t)[0]
    if brt is not None and mu is None:
        scale = beta * dt * D
        rhs = {l: -(rho[l] * (v[l] + fv[l])) / scale for l in topo.levels}
        dia = {l: rho[l] / scale for l in topo.levels}
        return amr.solve_block(rhs, topo, leaf, fbc, params, brt, btables,
                               dia=dia, u0=v, t=t)[0]
    rhs, dia, alpha = {}, {}, {}
    for l in topo.levels:
        grid = topo.grid(l)
        if mu is not None:
            alpha[l] = tuple(beta * dt * mu[l][c] for c in range(topo.dim))
        else:
            alpha[l] = tuple(torch.full(grid.face_shape(c), beta * dt * D,
                                        dtype=v[l].dtype, device=v[l].device)
                             for c in range(topo.dim))
        rl = rho[l] if rho is not None else 1.0
        dia[l] = rl
        rhs[l] = -(rl * (v[l] + fv[l]))
    return amr.solve(rhs, topo, leaf, fbc, params, alpha=alpha, dia=dia,
                     u0=v, t=t)[0]


def amr_advect_vof(T, uf, topo: Topo, leaf, cov, fbc, dt, cstart: int,
                   t=0.0):
    """Geometric VOF advection on every level with fine-coarse flux
    matching: at a face bordering a refined region the coarse flux is the
    volume-weighted restriction of the fine ones (src/vof.c:1214-1272),
    so mass is conserved across levels and the interface may live at any
    level.  ``uf`` must be sync_faces-consistent.  Fraction residues
    below 1e-6 (and above 1 - 1e-6) are clamped after the sweeps
    (reference amr_ns.py:549-564)."""
    from ..physics import vof as vofm
    dim = topo.dim
    T = dict(T)
    dV = {l: torch.ones_like(T[l]) for l in topo.levels}
    for k in range(dim):
        c = (cstart + k) % dim
        T = amr.sync_vof(T, topo, leaf, fbc, t=t, cov=cov)
        fluxes = {l: vofm.sweep_flux(T[l], uf[l], topo.grid(l), fbc, c, dt,
                                     t=t) for l in topo.levels}
        for l in range(topo.lmax - 1, topo.lmin - 1, -1):
            flux_l, un_l = fluxes[l]
            # two fine-face volumes over the coarse face's: 0.5 * mean
            rf = 0.5 * amr._face_restrict(fluxes[l + 1][0], c, dim)
            fluxes[l] = (torch.where(amr.face_mask(cov[l], c), rf, flux_l),
                         un_l)
        for l in topo.levels:
            T[l], dV[l] = vofm.sweep_update(T[l], dV[l], fluxes[l][0],
                                            fluxes[l][1], c)
    T = amr.sync_vof(T, topo, leaf, fbc, t=t, cov=cov)
    DUST = 1e-6
    return {l: torch.where(T[l] < DUST, 0.0,
                           torch.where(T[l] > 1.0 - DUST, 1.0, T[l]))
            for l in topo.levels}


def _level_density(st, cfg, topo: Topo, t):
    """(rho, alpha) per level: evaluated at the finest level and coarsened
    down the stack (face coefficients by coarsen_face_coeff, rho by the
    mean), the hierarchy the uniform multigrid uses; re-evaluating alpha
    per level diverges at 1000x density jumps (reference amr_ns.py:
    266-275)."""
    if cfg.density is None:
        return None, None
    lvf = {name: st[name][topo.lmax] for name, _ in cfg.vof_tracers}
    rho_f, alpha_f = ns.density_fields(lvf, cfg, t, grid=topo.grid(topo.lmax))
    rho, alpha = {topo.lmax: rho_f}, {topo.lmax: alpha_f}
    for l in range(topo.lmax - 1, topo.lmin - 1, -1):
        alpha[l] = poisson.coarsen_face_coeff(alpha[l + 1], topo.dim)
        rho[l] = poisson.restrict(rho[l + 1])
    return rho, alpha


def amr_step(state: dict, leaf: dict, dt, t, cfg: ns.NSConfig, topo: Topo,
             cstart: int = 0, first_step: bool = False, brt=None,
             btables=None) -> dict:
    """One NS step on the composite mesh (simulation_run,
    src/simulation.c:479-548, phase by phase as ns.ns_step): ``state``
    {name: {level: tensor}}, ``leaf`` {level: bool tensor}; ``brt`` /
    ``btables``: the block engine's descriptor and tables, or None for the
    dense mask engine."""
    dim = topo.dim
    names = ns.velocity_names(dim)
    gnames = ns.gradient_names(dim)
    cov = amr.covered_masks(leaf, topo)
    st = sync_all(state, leaf, cfg, topo, t, cov=cov)
    gc = cfg.advection.gc
    gbc = bcs.grad_bc(cfg.u_bcs[0])
    rho, alpha = _level_density(st, cfg, topo, t)
    fs = None
    if cfg.tension:
        # per level: restricting the finest level's sources instead breaks
        # the spurious-currents equilibrium (reference amr_ns.py:278-285)
        fs = {l: ns.tension_sources(
            {name: st[name][l] for name, _ in cfg.vof_tracers}, cfg,
            alpha=None if alpha is None else alpha[l], off_max=0, t=t,
            grid=topo.grid(l)) for l in topo.levels}
    mu_l = tsrc = None
    if cfg.nu_var is not None:
        mu_l, tsrc = {}, {}
        for l in topo.levels:
            grid_l = topo.grid(l)
            lv = {}
            for nm, parent, _np in cfg.nu_var_fields:
                src_name = parent if parent is not None else nm
                if src_name in st:
                    lv[src_name] = st[src_name][l]
            lv[names[0]] = st[names[0]][l]
            mu_c = ns.viscosity_field(lv, cfg, t, grid=grid_l)
            mu_pad = bcs.apply_bc(mu_c, grid_l, bcs.default_scalar_bc(dim),
                                  1, t=t)
            mu_l[l] = tuple(face_average(mu_pad, grid_l, a)
                            for a in range(dim))
            tsrc[l] = ns.viscous_transpose_sources(
                [st[n][l] for n in names], mu_c, grid_l, cfg,
                None if rho is None else 1.0 / rho[l], t)

    # 1. the predicted faces (BCG; K6 where it applies) per level
    uf = {l: ns.predicted_face_velocities([st[n][l] for n in names],
                                          topo.grid(l), cfg, dt, t=t)[0]
          for l in topo.levels}
    uf = amr.sync_faces(uf, topo, leaf, cov)
    # 2. the composite MAC projection at dt/2 on Pmac
    uf, pmac, gmac, _ = mac_projection_amr(
        uf, st["Pmac"], topo, leaf, cov, cfg.p_bc, dt / 2.0, cfg.projection,
        alpha=alpha, face_sources=fs, t=t, brt=brt, btables=btables)
    # 3. the centred advection and the implicit diffusion per component
    g_prev = None
    if gc:
        g_prev = gmac if first_step else [st[n] for n in gnames]
    use_badv = (cfg.block_advect and btables is not None and mu_l is None
                and dim == 2
                and blockadv.applicable(topo.base, cfg.advection,
                                        cfg.u_bcs[0]))
    U_new = []
    for c in range(dim):
        fv = {}
        for l in topo.levels:
            grid = topo.grid(l)
            if use_badv:
                f = blockadv.advect_level(st[names[c]][l], uf[l], gmac[c][l],
                                          grid, cfg.u_bcs[c], gbc, dt,
                                          cfg.advection, btables[l], brt.B,
                                          c, tval=t)
            else:
                f = adv.advection_increment(
                    st[names[c]][l], uf[l], adv.mac_cell_mean(uf[l], grid),
                    grid, cfg.u_bcs[c], dt, cfg.advection, c=c,
                    g_pad=bcs.apply_bc(gmac[c][l], grid, gbc, 1, t=t), t=t)
            if g_prev is not None:
                f = f - dt * g_prev[c][l]
            if tsrc is not None:
                f = f + dt * tsrc[l][c]
            fv[l] = f
        if cfg.nu > 0.0 or mu_l is not None:
            U_c = amr_diffuse({l: st[names[c]][l] for l in topo.levels}, fv,
                              topo, leaf, cfg.u_bcs[c], dt, cfg.nu, rho=rho,
                              beta=cfg.beta, params=cfg.diffusion_params,
                              t=t, brt=brt, btables=btables, mu=mu_l)
        else:
            U_c = {l: st[names[c]][l] + fv[l] for l in topo.levels}
            if use_badv:
                # the block advection leaves 0 off the active blocks:
                # refresh the slaves that phase 4 reads
                U_c = amr.fill_slaves(U_c, topo, leaf, cfg.u_bcs[c], t=t,
                                      cov=cov)
        if gc:
            U_c = {l: U_c[l] + dt * g_prev[c][l] for l in topo.levels}
        U_new.append(U_c)
    # 4. the composite approximate projection at dt (K9 per level where it
    # applies)
    uf2 = {l: proj.face_interpolated_velocity(
        [U_new[c][l] for c in range(dim)], topo.grid(l), list(cfg.u_bcs),
        t=t)[0] for l in topo.levels}
    uf2 = amr.sync_faces(uf2, topo, leaf, cov)
    uf2, p, g_cell, _ = mac_projection_amr(
        uf2, st["P"], topo, leaf, cov, cfg.p_bc, dt, cfg.approx_projection,
        alpha=alpha, face_sources=fs, t=t, brt=brt, btables=btables)
    new = dict(state)
    for c, n in enumerate(names):
        new[n] = amr.sync({l: U_new[c][l] - dt * g_cell[c][l]
                           for l in topo.levels}, topo, leaf, cfg.u_bcs[c],
                          t=t, cov=cov)
    new["P"] = p
    new["Pmac"] = pmac
    if gc:
        for c, n in enumerate(gnames):
            new[n] = amr.sync(g_cell[c], topo, leaf, gbc, t=t, cov=cov)
    # 5. the tracers with the projected faces
    for tr in cfg.tracers:
        Tl = {l: ns.advect_tracer(st[tr[0]][l], tr, uf2[l], topo.grid(l),
                                  cfg, dt, t) for l in topo.levels}
        new[tr[0]] = amr.sync(Tl, topo, leaf, tr[1], t=t, cov=cov)
    from ..physics import vof as vofm
    for name, fbc in cfg.vof_tracers:
        if cfg.composite_vof:
            new[name] = amr_advect_vof(st[name], uf2, topo, leaf, cov, fbc,
                                       dt, cstart, t=t)
        else:
            # the interface pinned to lmax by the criterion: advect the
            # finest level, restrict downward
            stack = dict(st[name])
            stack[topo.lmax] = vofm.advect(st[name][topo.lmax],
                                           uf2[topo.lmax],
                                           topo.grid(topo.lmax), fbc, dt,
                                           cstart=cstart, t=t)
            new[name] = amr.sync(stack, topo, leaf, fbc, t=t, cov=cov)
    return new


def amr_initial_projection(state: dict, leaf: dict, dt, t,
                           cfg: ns.NSConfig, topo: Topo) -> dict:
    """The i == 0 composite approximate projection (src/simulation.c:
    466-474) on the dense engine, with the density's coefficients and no
    face sources (ns.initial_projection)."""
    dim = topo.dim
    names = ns.velocity_names(dim)
    cov = amr.covered_masks(leaf, topo)
    st = sync_all(state, leaf, cfg, topo, t, cov=cov)
    _, alpha = _level_density(st, cfg, topo, t)
    uf = {l: proj.face_interpolated_velocity(
        [st[n][l] for n in names], topo.grid(l), list(cfg.u_bcs), t=t)[0]
        for l in topo.levels}
    uf = amr.sync_faces(uf, topo, leaf, cov)
    _, p, g_cell, _ = mac_projection_amr(
        uf, st["P"], topo, leaf, cov, cfg.p_bc, dt, cfg.approx_projection,
        alpha=alpha, t=t)
    new = dict(st)
    for c, n in enumerate(names):
        new[n] = amr.sync({l: st[n][l] - dt * g_cell[c][l]
                           for l in topo.levels}, topo, leaf, cfg.u_bcs[c],
                          t=t, cov=cov)
    new["P"] = p
    if cfg.advection.gc:
        gbc = bcs.grad_bc(cfg.u_bcs[0])
        for c, n in enumerate(ns.gradient_names(dim)):
            new[n] = amr.sync(g_cell[c], topo, leaf, gbc, t=t, cov=cov)
    return new


# ---------------------------------------------------------------------------
# dynamic adaptation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AdaptSpec:
    """Adaptation every ``istep`` steps (AdaptFunction {istep = 1} {cmax
    maxlevel}, test/oscillation/oscillation.gfs:87-91).  ``criterion(sim)
    -> (c0, c1[, c2])``: cost fields at the finest resolution, c0
    scale-free, c1 per length (times h(l)), c2 per length squared (times
    h(l)^2); any may be None.  A leaf at level l is refined while its
    max-pooled cost exceeds cmax, kept refined while it exceeds cmax /
    cfactor (adaptive.c:1351-1381).  ``maxcells``: a leaf budget
    (adapt_global, adaptive.c:1198-1290), met by raising the threshold."""
    criterion: Callable
    cmax: float = 0.01
    cfactor: float = 4.0
    minlevel: int = 3
    maxlevel: int = 8
    istep: int = 1
    maxcells: Optional[int] = None


def depth_map_from_cost(c0, c1, spec: AdaptSpec, topo: Topo,
                        prev: Optional[np.ndarray] = None,
                        c2=None) -> np.ndarray:
    """The target depth of every finest cell from the cost fields (host
    numpy); with ``maxcells`` a bisection on the threshold's multiplier
    (the heap order of adapt_global: the costliest cells refine first)."""
    c0 = None if c0 is None else np.asarray(c0)
    c1 = None if c1 is None else np.asarray(c1)
    c2 = None if c2 is None else np.asarray(c2)

    def depth(mult):
        return _depth_unconstrained(c0, c1, c2, spec, topo, prev, mult)

    D = depth(1.0)
    if spec.maxcells is not None and _leaf_count(D, spec) > spec.maxcells:
        lo, hi = 1.0, 2.0
        while _leaf_count(depth(hi), spec) > spec.maxcells:
            lo, hi = hi, hi * 4.0
            if hi > 1e12:
                break
        for _ in range(30):
            mid = math.sqrt(lo * hi)
            if _leaf_count(depth(mid), spec) > spec.maxcells:
                lo = mid
            else:
                hi = mid
        D = depth(hi)
    return D


def _depth_unconstrained(c0, c1, c2, spec: AdaptSpec, topo: Topo, prev,
                         thresh_mult: float) -> np.ndarray:
    shape = topo.grid(spec.maxlevel).shape
    dim = topo.dim
    cmax = spec.cmax * thresh_mult

    def rep_up(a, rep):
        for ax in range(dim):
            a = a.repeat(rep, axis=ax)
        return a

    D = np.full(shape, spec.minlevel, np.int32)
    for l in range(spec.minlevel, spec.maxlevel):
        rep = 1 << (spec.maxlevel - l)
        h_l = topo.base.size / (1 << l)
        def pool(a):
            return _pool_reduce_np(a, rep, dim, np.max)

        cost = np.zeros(tuple(s // rep for s in shape))
        if c0 is not None:
            cost = np.maximum(cost, pool(c0))
        if c1 is not None:
            cost = np.maximum(cost, pool(c1) * h_l)
        if c2 is not None:
            cost = np.maximum(cost, pool(c2) * h_l * h_l)
        want = cost > cmax
        if prev is not None:
            want |= (pool(prev) > l) \
                & (cost > cmax / spec.cfactor)
        D = np.maximum(D, np.where(rep_up(want, rep), l + 1, spec.minlevel))
    return grade_depth_map(D)


def _leaf_count(D: np.ndarray, spec: AdaptSpec) -> float:
    """The leaves of a finest-resolution depth map."""
    w = (0.25 if D.ndim == 2 else 0.125) ** (spec.maxlevel - D)
    return float(w.sum())


def hessian_cost(v, grid: Grid, fbc: bcs.FieldBC, t=0.0):
    """max(|v_xx|, |v_yy|, |v_xy|), the per-length^2 channel: the
    truncation-error estimate behind GfsAdaptError (adaptive.c:594).  At
    walls (no periodic axis) the nearest interior estimate is extended,
    as the mirror ghosts would make a linear field look curved."""
    p = bcs.apply_bc(v, grid, fbc, 1, t=t)
    h2 = grid.h * grid.h
    vxx = (p[2:, 1:-1] - 2 * p[1:-1, 1:-1] + p[:-2, 1:-1]) / h2
    vyy = (p[1:-1, 2:] - 2 * p[1:-1, 1:-1] + p[1:-1, :-2]) / h2
    vxy = (p[2:, 2:] - p[2:, :-2] - p[:-2, 2:] + p[:-2, :-2]) / (4 * h2)
    c = torch.maximum(vxx.abs(), torch.maximum(vyy.abs(), vxy.abs()))
    if not (fbc.is_periodic(0) or fbc.is_periodic(1)):
        c = c.clone()
        c[0, :] = c[1, :]
        c[-1, :] = c[-2, :]
        c[:, 0] = c[:, 1]
        c[:, -1] = c[:, -2]
    return c


def dilate(m, r: int):
    """Max-dilation by r cells over the 4-neighbourhood, r times (a
    Chebyshev ball after two passes), edges replicated."""
    for _ in range(r):
        p = bcs.edge_extend(bcs.edge_extend(m, 0, 1), 1, 1)
        m = torch.maximum(m, torch.maximum(
            torch.maximum(p[:-2, 1:-1], p[2:, 1:-1]),
            torch.maximum(p[1:-1, :-2], p[1:-1, 2:])))
    return m


def interface_vorticity_criterion(sim: "AMRSimulation", vof_name="T"):
    """test/oscillation's criterion (T > 0 && T < 1 ? 1 :
    |Vorticity|*dL, oscillation.gfs:87-91): c0 the interface indicator
    dilated by 4 cells (the curvature's 7-cell columns read finest data,
    the analogue of fix_too_coarse, src/vof.c:1431), c1 |vorticity|."""
    topo = sim.topo
    T = sim.fine(vof_name)
    c0 = dilate(((T > 1e-6) & (T < 1.0 - 1e-6)).to(T.dtype), 4)
    grid = topo.grid(topo.lmax)
    names = ns.velocity_names(topo.dim)
    up = bcs.apply_bc(sim.fine(names[0]), grid, sim.cfg.u_bcs[0], 1,
                      t=sim.time.t)
    vp = bcs.apply_bc(sim.fine(names[1]), grid, sim.cfg.u_bcs[1], 1,
                      t=sim.time.t)
    w = ((vp[2:, 1:-1] - vp[:-2, 1:-1]) - (up[1:-1, 2:] - up[1:-1, :-2])) \
        / (2.0 * grid.h)
    return c0, w.abs()


def streamline_curvature_cost(sim: "AMRSimulation"):
    """|(u.grad)u| h / |u|^2, a c0 channel (GfsAdaptStreamlineCurvature,
    src/adaptive.c:390-412, src/fluid.c:2785-2811)."""
    topo = sim.topo
    grid = topo.grid(topo.lmax)
    names = ns.velocity_names(topo.dim)
    t = sim.time.t
    U = [sim.fine(n) for n in names]
    pads = [bcs.apply_bc(U[j], grid, sim.cfg.u_bcs[j], 1, t=t,
                         corners=False) for j in range(topo.dim)]
    u2 = sum(u * u for u in U)
    ugu2 = 0.0
    for i in range(topo.dim):
        gi = sum(U[j] * center_gradient(pads[i], grid, j)
                 for j in range(topo.dim))
        ugu2 = ugu2 + gi * gi
    return torch.where(u2 > 0.0, torch.sqrt(ugu2) * grid.h
                       / torch.clamp(u2, min=torch.finfo(u2.dtype).tiny),
                       0.0)


def thickness_cost(sim: "AMRSimulation", vof_name="T"):
    """1 / the interface sheet's thickness in cells (GfsAdaptThickness,
    src/adaptive.c:665-790): the fluid column sum (vof.height_fields) of
    a (2R+1)-column empty at both ends, so a sheet the column crosses;
    0 off the interface."""
    from ..physics import vof as vofm
    topo = sim.topo
    grid = topo.grid(topo.lmax)
    fbc = dict(sim.cfg.vof_tracers)[vof_name]
    T = sim.fine(vof_name)
    t = sim.time.t
    R = 3
    P = R + 1
    f_pad = bcs.apply_bc(T, grid, fbc, P, t=t)
    H = vofm.height_fields(T, grid, fbc, t=t, R=R)
    n0, n1 = grid.shape
    thick = None
    for axis in (0, 1):
        if axis == 0:
            lo = f_pad[0:n0, P:P + n1]
            hi = f_pad[2 * P:2 * P + n0, P:P + n1]
        else:
            lo = f_pad[P:P + n0, 0:n1]
            hi = f_pad[P:P + n0, 2 * P:2 * P + n1]
        ta = torch.where((lo < 1e-6) & (hi < 1e-6), H[axis], 1e30)
        thick = ta if thick is None else torch.minimum(thick, ta)
    interfacial = (T > 1e-6) & (T < 1.0 - 1e-6)
    return torch.where(interfacial, 1.0 / torch.clamp(thick, min=1e-3), 0.0)


class AMRSimulation:
    """The adaptive composite NS driver (Simulation's loop with per-level
    state and an adapt phase every ``adapt.istep`` steps, simulation_run
    src/simulation.c:483, :528-533).  Either a static CompositeGrid
    (``mesh=``, e.g. test/capwave's Refine) or an AdaptSpec (``adapt=``,
    dynamic).  ``device`` defaults to the CUDA card and raises without
    one; ``device="cpu"`` runs the kernels' plain versions on the CPU.

    On a 2D unit box whose BC values are all constant the solves run on
    the block engine (solvers/blockrt.py); if its tables cannot be built
    the step warns (RuntimeWarning) and falls back to the dense mask
    engine, and ``_use_blocks`` turns False.  The depth map stays on the
    host (``depth``), so the leaf count costs no device read."""

    def __init__(self, cfg: ns.NSConfig, mesh: CompositeGrid = None,
                 adapt: AdaptSpec = None, time=None, events=None,
                 device=None, dtype=torch.float64):
        from .simulation import Time
        if mesh is None and adapt is None:
            raise ValueError("AMRSimulation needs a mesh or an AdaptSpec")
        if cfg.solid_phi is not None or cfg.moving_solid:
            raise NotImplementedError(
                "AMRSimulation does not support embedded solids (the "
                "reference's amr_step has no cut-cell phase)")
        dropped = [f for f in ("body_force", "tension_css", "metric",
                               "particle_coupling")
                   if getattr(cfg, f)] + (["axi"] if cfg.axi else [])
        if dropped:
            raise NotImplementedError(
                f"the composite step has no {', '.join(dropped)} (the "
                "reference's amr_step does not read them)")
        self.cfg = cfg
        self.device = default_device(device)
        self.dtype = dtype
        if mesh is not None:
            if not mesh.leaf_np(mesh.lmax).any():
                raise ValueError("the static mesh has no leaf at its finest "
                                 "level (the VOF tracer advances there)")
            self.topo = mesh.topo
            self.depth = mesh.depth_map()
        else:
            base = dataclasses.replace(cfg.grid, level=adapt.minlevel)
            self.topo = Topo(base=base, lmin=adapt.minlevel,
                             lmax=adapt.maxlevel)
            # uniform at maxlevel (the reference's Refine LEVEL); the
            # first adaptation coarsens
            self.depth = np.full(self.topo.grid(adapt.maxlevel).shape,
                                 adapt.maxlevel, np.int32)
        self.adapt = adapt
        self._set_masks()
        self._brt = None
        self._btables = None
        self._use_blocks = (
            cfg.grid.dim == 2 and tuple(cfg.grid.extents) == (1, 1)
            and not any(callable(b.value)
                        for fbc in (cfg.p_bc, *cfg.u_bcs)
                        for ax in fbc.sides for b in ax)
            and self.topo.base.shape[0] % 8 == 0)
        if self._use_blocks:
            self._rebuild_blocks()
        self.time = time or Time()
        self.events = list(events or [])
        self.state: Dict[str, Dict[int, torch.Tensor]] = {}
        self.stop = False
        self.dt = None
        self._tnext = None
        self.leaf_history = []
        self.host_syncs = 0

    def _set_masks(self):
        """The leaf masks of the host depth map, built in numpy and
        uploaded once."""
        cg = CompositeGrid.from_depth_map(self.topo.base, self.topo.lmax,
                                          self.depth, graded=True)
        self._n_leaves = cg.n_leaves()
        self.leaf = cg.leaf_arrays(self.device)

    def _rebuild_blocks(self):
        """The block tables of the current depth map (host numpy, one
        upload), keeping the previous capacities where they fit."""
        from ..solvers import blockrt
        caps = self._brt.caps_dict if self._brt is not None else None
        try:
            rt, tables, _ = blockrt.make_blockrt(
                self.topo.base, self.topo.lmax, self.depth, B=8, caps=caps,
                device=self.device)
        except Exception as e:
            warnings.warn(
                f"blockrt disabled: {type(e).__name__}: {e} -- AMR solves "
                f"fall back to the dense mask engine (cost no longer "
                f"proportional to leaves)", RuntimeWarning, stacklevel=2)
            self._use_blocks = False
            self._block_disable_reason = f"{type(e).__name__}: {e}"
            self._brt = None
            self._btables = None
            return
        self._brt = rt
        self._btables = tables

    def n_leaves(self) -> int:
        return self._n_leaves

    def adapt_now(self):
        """The depth map from the criterion's cost fields (read to the host
        in one transfer), then the masks and block tables rebuilt; the
        state is resampled by the next step's sync."""
        cs = self.adapt.criterion(self)
        chans = [c for c in cs if c is not None]
        host = torch.stack([c.to(torch.float64) for c in chans]).cpu() \
            .numpy() if chans else []
        self.host_syncs += 1
        it = iter(host)
        c0, c1, c2 = (None if c is None else next(it)
                      for c in (list(cs) + [None])[:3])
        self.depth = depth_map_from_cost(c0, c1, self.adapt, self.topo,
                                         prev=self.depth, c2=c2)
        self._set_masks()
        if self._use_blocks:
            self._rebuild_blocks()

    def init(self, **fields):
        """Fields at the finest resolution (a scalar, an array or tensor of
        its shape, or a callable of the numpy cell centres); coarser levels
        by restriction."""
        topo = self.topo
        gf = topo.grid(topo.lmax)
        names = list(ns.velocity_names(topo.dim)) + ["P", "Pmac"] + \
            [tr[0] for tr in self.cfg.tracers] + \
            [v[0] for v in self.cfg.vof_tracers]
        if self.cfg.advection.gc:
            names += list(ns.gradient_names(topo.dim))
        for n in names:
            v = fields.get(n, 0.0)
            if callable(v):
                v = v(*gf.centers)
            v = torch.broadcast_to(torch.as_tensor(
                v, dtype=self.dtype, device=self.device), gf.shape) \
                .contiguous()
            stack = {topo.lmax: v}
            for l in range(topo.lmax - 1, topo.lmin - 1, -1):
                stack[l] = poisson.restrict(stack[l + 1])
            self.state[n] = stack
        return self

    def fine(self, name: str) -> torch.Tensor:
        return self.state[name][self.topo.lmax]

    def set_timestep(self):
        """The CFL step at the finest level, snapped to the next event (one
        read of max|u| to the host)."""
        grid = self.topo.grid(self.topo.lmax)
        umax = float(torch.stack([self.fine(n).abs().max() for n in
                                  ns.velocity_names(self.topo.dim)]).max())
        self.host_syncs += 1
        umax = max(umax, 1e-300)
        cfl = self.cfg.advection.cfl
        if self.cfg.vof_tracers:
            cfl = min(cfl, 0.45)
        dt = min(cfl * grid.h / umax, self.time.dtmax)
        for _, sigma in self.cfg.tension:
            from ..physics.tension import stability_dt
            r1, r2 = (1.0, 1.0) if self.cfg.density is None else \
                (self.cfg.density[1], self.cfg.density[2])
            dt = min(dt, stability_dt(grid, sigma, r1, r2))
        t = self.time.t
        tnext = min((e.next_time(t) for e in self.events), default=math.inf)
        if tnext < math.inf:
            tnext += 1e-9
        if self.time.end < tnext:
            tnext = self.time.end
        if tnext < math.inf:
            n = max(1.0, math.ceil((tnext - t) / dt))
            if n < 2 ** 31:
                dt = (tnext - t) / n
                self._tnext = tnext if n == 1 else t + dt
            else:
                self._tnext = t + dt
        else:
            self._tnext = t + dt
        self.dt = max(dt, 1e-9)

    def do_events(self):
        for e in self.events:
            if e.should_fire(self.time.t, self.time.i):
                e.fire(self, self.time.t, self.time.i)

    def run(self, max_steps: Optional[int] = None):
        """simulation_run (src/simulation.c:432-557) with the adapt phase
        before each step's events."""
        cfg, topo = self.cfg, self.topo
        self.set_timestep()
        if self.time.i == 0:
            self.state = amr_initial_projection(self.state, self.leaf,
                                                self.dt, self.time.t, cfg,
                                                topo)
            self.set_timestep()
        steps = 0
        while (self.time.t < self.time.end and self.time.i < self.time.iend
               and not self.stop):
            if self.adapt is not None and \
                    self.time.i % self.adapt.istep == 0:
                self.adapt_now()
                self.leaf_history.append(self.n_leaves())
            self.do_events()
            if self.stop:
                break
            self.state = amr_step(self.state, self.leaf, self.dt,
                                  self.time.t, cfg, topo,
                                  cstart=self.time.i % topo.dim,
                                  first_step=self.time.i == 0,
                                  brt=self._brt, btables=self._btables)
            self.time.t = self._tnext
            self.time.i += 1
            self.set_timestep()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        self.do_events()
        for e in self.events:
            if getattr(e, "at_end", False):
                e.fire(self, self.time.t, self.time.i)
        return self
