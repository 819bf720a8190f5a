"""Incompressible Navier-Stokes time step (port of gerris_tpu/models/ns.py:
the uniform-grid step in 2D and 3D, with the two-phase physics and a
static embedded solid).

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

The two-phase step (2D and 3D; reference ns.py:822-1011): ``density``
names a VOF tracer whose filtered fraction gives the cell densities rho
and the face coefficients alpha = 1/rho (``density_fields``);
``tension`` gives well-balanced face sources from the height-function
curvature (``tension_sources``), and ``body_force`` (gravity) face
sources beside them (``body_force_sources``).  Both projections then
solve div(alpha grad p) with the face sources (K4, K15, a torch
correction), each velocity component takes K14 and a rho-weighted
diffusion solve (face coefficients dt nu, cell dia rho: K15), and step 5
advects each VOF tracer with the projected faces.  In 3D the same step
runs on the generic torch routes: the projections and the diffusion
solves with face coefficients or a cell dia take the torch correction
and smoother (no K13: its dia is a scalar, and it takes no faces), and
the VOF, curvature and tension are physics/vof.py's 3D branches; with
unit density and scalar viscosity the solves still run K13.  A variable
viscosity ``nu_var`` (``viscosity_field``) gives the diffusion face
coefficients dt mu_face and the explicit transpose-stress sources
(``viscous_transpose_sources``).
Callable BC values are evaluated at the step's time ``t`` on every
torch route; the kernels take constant values only, so such a
configuration takes the plain versions where its callables are.

Passive ``tracers`` (reference ns.py:450-483, :999-1004) advance after
the approximate projection with its faces: K14 where it takes the
tracer's BCs under the centred Godunov scheme, else the generic route,
then a source and an implicit diffusion.  ``tension_css`` (2D) adds the
CSS tension's cell accelerations to the momentum increments (beside
the transpose sources).  A limited slope (van Leer, minmod) or
``scheme="none"`` takes the reference's generic torch route for the
predictor and the advections (``bcg.applicable`` is False; the kernels
and their plain versions compute the centred Godunov scheme only), and
``gc=False`` drops the gc gradient: no g_prev in the momentum rhs, K9
without its gp term, no Gx/Gy written back.  ``tension_css`` and
contact-angle sides are 2D, as the reference's are.

A static embedded solid (``solid_phi``, 2D; reference ns.py:615-639,
:770-818, :375-445, :901-988): its geometry (fractions, Dirichlet surface,
merge groups) is built once per configuration, device and dtype
(_static_weights).  The predictor and the face interpolation ignore it
and its closed faces are zeroed after them; both projections solve
div(s grad p) with the s-weighted divergence (K15 in every correction);
each velocity component takes the generic advection with s-weighted
fluxes, the merged-cell update (physics/solid.py) and a viscous solve with the
no-slip or ``surface_u`` Dirichlet surface, deferred-corrected (K15 with
the cell dia); the velocities are zero in the solid.

The axisymmetric metric (``axi``) and a general one (``metric``,
core/metric.py) multiply their cell and face factors into the same
weights (_weights, Weights; reference ns.py:599-639), so their step is
the solid's, with no Dirichlet surface and no merging where no solid cuts
a cell; ``axi`` adds the radial term a / r^2 to component 1's viscous
solve (ns.py:423-432).  A moving solid (``moving_solid``, orders 1 and 2;
reference ns.py:674-766, :896-935) re-cuts its fractions, Dirichlet
surface and merge groups every step on the device (_moving_weights,
solid.merge_groups in a fixed number of host reads), fills the uncovered cells, and gives both projections
its volume displacement as divergence sources.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..core.grid import Grid
from ..core import bc as bcs
from ..ops.cuda import bcg, predict
from ..ops.stencils import center_gradient, face_average
from ..solvers import advection as adv
from ..solvers import diffusion as diff
from ..solvers import poisson
from ..solvers import projection as proj
from ..physics import solid as solid_mod
from ..physics import tension as tens
from ..physics import vof


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
    # VOF interface tracking (GfsVariableTracerVOF, src/vof.c): (name,
    # FieldBC) pairs
    vof_tracers: tuple = ()
    # surface tension (GfsSourceTension, src/tension.c): (vof_name,
    # sigma) pairs
    tension: tuple = ()
    # variable density from a VOF tracer (PhysicalParams alpha =
    # 1/RHO(T1), test/oscillation): (tracer, rho1, rho2, filter_passes)
    density: tuple = None
    # a body force per component (GfsSource on a velocity component,
    # src/source.c: gravity): None, or per component None, a float or a
    # function f(x, y[, z], t=...) of torch tensors; it enters both
    # projections as well-balanced face sources beside tension
    body_force: tuple = None
    # variable dynamic viscosity (GfsSourceViscosity with a GfsFunction,
    # src/source.c; MU(T1) in test/capwave/air-water): a function
    # f(x, y[, z], t=..., **fields) of torch tensors giving the viscosity per
    # cell; nu_var_fields: the (name, parent, npass) fields it reads, a
    # field not in the state being ``npass`` filter passes of its parent
    # VOF tracer
    nu_var: object = None
    nu_var_fields: tuple = ()
    # passive tracers (GfsVariableTracer, src/timestep.c:1028): (name,
    # FieldBC, diffusivity[, source]) tuples, the source dT/dt a constant
    # or a function f(x, y[, z], t) of torch tensors (e.g. the unit source
    # of GfsVariableAge)
    tracers: tuple = ()
    # CSS surface tension (GfsSourceTensionCSS, src/tension.c:181-305),
    # 2D: (vof_name, sigma) pairs giving cell accelerations
    tension_css: tuple = ()
    # a static embedded solid (Solid in .gfs, src/solid.c), 2D: a level set
    # phi(x, y) of torch tensors, the fluid {phi > 0}
    solid_phi: object = None
    # the solid surface's velocity (SurfaceBc Dirichlet, src/timestep.c:
    # 1062-1229): per component a constant or a function f(x, y) of torch
    # tensors (a moving solid's: f(x, y, t[, *solid_args])); None is a
    # no-slip wall at rest (0 on every component)
    surface_u: tuple = None
    # a moving solid (GfsSimulationMoving, src/moving.c), 2D: solid_phi
    # takes (x, y, t[, *solid_args]) and the fractions, the Dirichlet
    # surface and the merge groups are re-cut every step at t + dt
    moving_solid: bool = False
    # its scheme's order (AdvectionParams moving_order, src/advection.h:60,
    # src/moving2.c): 2 takes the time-centred face fractions and fills
    # the uncovered cells from their fluid neighbours
    moving_order: int = 1
    # the axisymmetric metric (GfsAxi), 2D: y is the radius, and the cell
    # and face factors r enter the weights as a solid's fractions do
    axi: bool = False
    # a general orthogonal metric (core/metric.py: MetricStretch,
    # MetricLonLat, MetricCubed), 2D, composed into the weights as axi is
    metric: object = None
    # the composite (AMR) step only (models/amr_ns.py): the corrector
    # advection on the block engine's active blocks
    # (solvers/blockadv.py), and the VOF sweeps on every level with
    # fine-to-coarse flux matching instead of the finest level's alone
    block_advect: bool = False
    composite_vof: bool = False
    # two-way particle coupling (GfsSourceParticulate, modules/
    # particulatecommon.c:2089): the state's reaction-force densities PFx,
    # PFy[, PFz], written by models/particle_system.ParticleSystem, are
    # sources of the velocity advection-diffusion
    particle_coupling: bool = False

    def __post_init__(self):
        if self.p_bc is None:
            object.__setattr__(self, "p_bc", bcs.grad_bc(self.u_bcs[0]))
        if self.solid_phi is not None:
            if self.grid.dim == 3:
                raise NotImplementedError(
                    "a solid in the 3D step: the reference's Dirichlet "
                    "surface is 2D (gerris_tpu/physics/solid.py:105)")
            if self.nu_var is not None:
                raise NotImplementedError(
                    "a variable viscosity with a solid: the reference does "
                    "not compose them (gerris_tpu/models/ns.py:894-895)")
        if self.moving_solid:
            if self.solid_phi is None:
                raise ValueError("a moving solid needs its solid_phi")
            if self.axi:
                raise NotImplementedError(
                    "a moving solid with the axisymmetric metric: the "
                    "reference does not compose them "
                    "(gerris_tpu/models/ns.py:897)")
            if self.metric is not None:
                raise NotImplementedError(
                    "a moving solid with a metric: the reference's moving "
                    "step drops the metric (gerris_tpu/models/ns.py:"
                    "896-903)")
        if self.axi or self.metric is not None:
            if self.grid.dim == 3:
                raise NotImplementedError(
                    "a metric in the 3D step: the reference's metric "
                    "factors are 2D (gerris_tpu/models/ns.py:600-612, "
                    "core/metric.py)")
            if self.nu_var is not None:
                raise NotImplementedError(
                    "a variable viscosity with a metric: the reference's "
                    "weighted viscous solve takes the scalar nu "
                    "(gerris_tpu/models/ns.py:418-432)")
        if self.grid.dim == 3:
            if self.tension_css:
                raise NotImplementedError("CSS tension is 2D, as the "
                                          "reference's is")
            fbcs = (*self.u_bcs, self.p_bc,
                    *(v[1] for v in self.vof_tracers),
                    *(tr[1] for tr in self.tracers))
            if any(bcs.has_kind(f, bcs.CONTACT) for f in fbcs):
                raise NotImplementedError("contact angles are 2D, as the "
                                          "reference's contact_fill is")

    @property
    def dim(self):
        return self.grid.dim


def velocity_names(dim):
    return ("U", "V", "W")[:dim]


def gradient_names(dim):
    return ("Gx", "Gy", "Gz")[:dim]


def predicted_face_velocities(U: list, grid: Grid, cfg: NSConfig, dt,
                              div_scale=None, t: float = 0.0):
    """BCG predicted MAC velocities with centred upwinding (reference:
    src/timestep.c:681-717): (faces, divp).  Through K6 where the BCs
    allow it (gerris_tpu/models/ns.py:190-196), else its plain version,
    with callable BC values at time ``t``.  ``div_scale``: ``divp`` is
    (div, total), the faces' divergence scaled by div_scale and its sum;
    else None (always in 3D and under a limiter or ``scheme="none"``,
    where the faces take the reference's generic route,
    gerris_tpu/models/ns.py:208-223)."""
    if grid.dim == 3 or not bcg.applicable(grid, cfg.advection):
        uc_pad = [bcs.apply_bc(U[c], grid, cfg.u_bcs[c], 1, corners=False,
                               t=t) for c in range(grid.dim)]
        uf = []
        for c in range(grid.dim):
            vp, vm = adv.advected_face_values(U[c], grid, cfg.u_bcs[c], dt,
                                              uc_pad, axes=(c,), t=t,
                                              par=cfg.advection)[c]
            un = face_average(uc_pad[c], grid, c)
            uf.append(bcs.apply_face_bc(adv.upwind_face_value(vp, vm, un, c),
                                        grid, cfg.u_bcs[c], c, t=t))
        return uf, None
    if bcg.face_specs(cfg.u_bcs) is not None:
        out = predict.predict_xy(U[0], U[1], dt, grid, cfg.u_bcs, div_scale)
    else:
        out = predict.predict_xy_plain(U[0], U[1], dt, grid, cfg.u_bcs,
                                       div_scale, t=t)
    return [out[0], out[1]], None if div_scale is None else (out[2], out[3])


def _pair_route(grid: Grid, cfg: NSConfig, rho=None, mu=None) -> bool:
    """The reference's batched U+V route (gerris_tpu/models/ns.py:257-264):
    2D, unit density, a constant viscosity, fully implicit diffusion on a
    fixed schedule, the kernel route, and K14's BCs (periodic y refused)
    for both components."""
    return (rho is None and mu is None and cfg.nu > 0.0 and cfg.beta == 1.0
            and cfg.diffusion_params is not None
            and cfg.diffusion_params.ncycles > 0
            and bcg.applicable(grid, cfg.advection)
            and all(bcg.advect_spec(f) is not None for f in cfg.u_bcs))


@dataclasses.dataclass
class Weights:
    """The step's cell and face weights on one device and dtype (reference
    ns.py:615-639, :764-765): the cell weights ``a`` and per-axis face
    weights ``s`` (a solid's fractions, a metric's factors, or their
    products), the solid's Dirichlet surface ``ds`` (a
    solid.DirichletSurface) and its merge groups (solid.MergeGroups), or
    None without a solid.  A moving solid's order 2 adds the time-centred
    face fractions ``s_half`` (the advection's fluxes and the MAC
    projection's faces) and the old cell fractions ``a_old`` (the MAC
    projection's)."""
    a: torch.Tensor
    s: tuple
    ds: solid_mod.DirichletSurface = None
    groups: solid_mod.MergeGroups = None
    s_half: tuple = None
    a_old: torch.Tensor = None


def _axi_metric(grid: Grid, device, dtype) -> tuple:
    """(cm, (fmx, fmy)): the axisymmetric metric's cell and face factors,
    r = y at the cell centres and at the y faces (GfsAxi; reference
    ns.py:599-612, src/metric.c)."""
    yc = torch.as_tensor(grid.axis_centers(1), dtype=torch.float64,
                         device=device).to(dtype)[None, :]
    yf = torch.as_tensor(grid.axis_faces(1), dtype=torch.float64,
                         device=device).to(dtype)[None, :]
    return (yc.expand(grid.shape).contiguous(),
            (yc.expand(grid.face_shape(0)).contiguous(),
             yf.expand(grid.face_shape(1)).contiguous()))


# two entries: a configuration runs on one device in one dtype, and at
# most once more in float64 for a check; each entry holds about nine
# full-grid tensors on its device
@functools.lru_cache(maxsize=2)
def _static_weights(grid: Grid, solid_phi, axi: bool, metric, device,
                    dtype) -> Weights:
    """The weights of a static solid, the axisymmetric or general metric,
    or both, built once per configuration, device and dtype (reference
    ns.py:615-639, :770-780, which caches the fractions and the Dirichlet
    surface per (grid, phi)): the solid's fractions (if any) times the
    metrics' factors, as the reference multiplies them, with the solid's
    Dirichlet surface and the merge groups of the products.  The groups
    take only the cells the solid cuts: the reference's merged-cell
    update also merges cells a metric's weights make small (trap in
    ROADMAP Queue 3); without a solid there are none."""
    a = s = ds = None
    if solid_phi is not None:
        ds = solid_mod.DirichletSurface(grid, solid_phi, device=device,
                                        dtype=dtype)
        a, s = ds.a, ds.s
    for on, factors in ((axi, lambda: _axi_metric(grid, device, dtype)),
                        (metric is not None,
                         lambda: metric.weights(grid, device, dtype))):
        if on:
            cm, fm = factors()
            a = cm if a is None else a * cm
            s = fm if s is None else tuple(f * m for f, m in zip(s, fm))
    if ds is None:
        return Weights(a, s)
    cut = (ds.a > 0.0) & (ds.a < 1.0)
    return Weights(a, s, ds, solid_mod.merge_groups(a, s, cut))


def _weights(cfg: NSConfig, like):
    """The step's weights (Weights) on ``like``'s device and dtype, or
    None without a solid or a metric (reference ns.py:615-639): a static
    solid's fractions, the axisymmetric metric's and ``metric``'s factors,
    or their products."""
    if cfg.solid_phi is None and not cfg.axi and cfg.metric is None:
        return None
    return _static_weights(cfg.grid, cfg.solid_phi, cfg.axi, cfg.metric,
                           like.device, like.dtype)


def _eval_surface_u(us, x, y, t):
    """A surface velocity's value: a constant, or f(x, y, t), or failing
    that f(x, y) (reference ns.py:642-649)."""
    if callable(us):
        try:
            return us(x, y, t)
        except TypeError:
            return us(x, y)
    return us


def _redistribute_small(src, a, s):
    """The divergence source of the small cut cells (0 < a < 1/2) moved
    into the neighbour across each one's largest face fraction (the first
    of x lo, x hi, y lo, y hi among equals), the dense stand-in for the
    reference's merged-cell distribution (reference ns.py:652-671,
    src/moving.c:1000-1025).  As the reference, it moves them by a
    periodic roll: a small cell whose largest face is a box side sends its
    source across the box (ROADMAP Queue 3)."""
    sx, sy = s
    fr = torch.stack([sx[:-1, :], sx[1:, :], sy[:, :-1], sy[:, 1:]])
    small = (a < 0.5) & (a > 0.0)
    d = torch.argmax(fr, dim=0)
    moved = torch.where(small, src, 0.0)
    out = src - moved
    for k, (axis, shift) in enumerate(((0, -1), (0, 1), (1, -1), (1, 1))):
        out = out + torch.roll(torch.where(d == k, moved, 0.0), shift, axis)
    return out


def _fill_order2(u, a, a_old, us):
    """Order 2's fill (reference ns.py:714-735, moving2.c:488-560): each
    freshly uncovered cell takes the mean of its neighbours that held
    fluid at both times, in two rings (a cell filled in the first ring
    counts in the second), else the surface velocity ``us``; the solid
    keeps ``us``."""
    valid = (a > 0.0) & (a_old > 0.0)
    vmask = valid
    for _ in range(2):
        up = torch.nn.functional.pad(torch.where(vmask, u, 0.0),
                                     (1, 1, 1, 1))
        vp = torch.nn.functional.pad(vmask.to(u.dtype), (1, 1, 1, 1))
        ssum = up[:-2, 1:-1] + up[2:, 1:-1] + up[1:-1, :-2] + up[1:-1, 2:]
        cnt = vp[:-2, 1:-1] + vp[2:, 1:-1] + vp[1:-1, :-2] + vp[1:-1, 2:]
        fill = torch.where(cnt > 0.0, ssum / torch.clamp(cnt, min=1.0), us)
        fresh = (a > 0.0) & ~vmask
        u = torch.where(fresh, fill, u)
        vmask = vmask | (fresh & (cnt > 0.0))
    return torch.where(a > 0.0, u, us)


def _moving_weights(cfg: NSConfig, U: list, dt, t, solid_args=None):
    """A moving solid's step context (reference ns.py:674-766): (Weights,
    the filled velocities, the MAC projection's divergence source, the
    approximate projection's).  The fractions at t (a_old, s_old); the
    Dirichlet surface, the fractions (a, s) and the merge groups at t + dt
    (move_solids before the step, src/moving.c:949-990); the surface
    velocity at the cell centres at t + dt, ``solid_args`` passed on to
    ``solid_phi`` and ``surface_u`` after (x, y, t).  Order 1: the cells
    uncovered since t and the solid take the surface velocity
    (init_new_cell_velocity_from_solid, moving.c:135-140); order 2: the
    fill of _fill_order2, and s_half = (s_old + s) / 2.  The MAC source
    2 (a - a_old) / dt^2, redistributed with (a, s), or with (a_old,
    s_half) at order 2 (moving.c:1043-1068, moving2.c:744-780); the
    approximate source -u_s . (s_hi - s_lo) / (h dt) on the fluid cells,
    redistributed with (a, s) (moving.c:993-998)."""
    grid = cfg.grid
    like = U[0]
    dev, dtype = like.device, like.dtype
    extra = tuple(solid_args) if solid_args is not None else ()
    a_old, s_old = solid_mod.solid_fractions(
        grid, lambda x, y: cfg.solid_phi(x, y, t, *extra), dev, dtype)
    ds = solid_mod.DirichletSurface(
        grid, lambda x, y: cfg.solid_phi(x, y, t + dt, *extra), device=dev,
        dtype=dtype)
    a, s = ds.a, ds.s
    x, y = cell_centers(grid, dev, dtype)
    if solid_args is not None and cfg.surface_u is not None:
        us = [f(x, y, t + dt, *extra) if callable(f) else f
              for f in cfg.surface_u]
    else:
        us = [_eval_surface_u(cfg.surface_u[c] if cfg.surface_u else 0.0,
                              x, y, t + dt) for c in range(2)]
    us = [u.to(dtype) if isinstance(u, torch.Tensor) else u for u in us]
    s_half = a_mac = None
    if cfg.moving_order >= 2:
        U = [_fill_order2(U[c], a, a_old, us[c]) for c in range(2)]
        s_half = tuple(0.5 * (s_old[c] + s[c]) for c in range(2))
        mac_div = _redistribute_small(2.0 * (a - a_old) / (dt * dt), a_old,
                                      s_half)
        a_mac = a_old
    else:
        keep = (a > 0.0) & (a_old > 0.0)
        U = [torch.where(keep, U[c], us[c]) for c in range(2)]
        mac_div = _redistribute_small(2.0 * (a - a_old) / (dt * dt), a, s)
    approx_div = -(us[0] * (s[0][1:, :] - s[0][:-1, :])
                   + us[1] * (s[1][:, 1:] - s[1][:, :-1])) / (grid.h * dt)
    approx_div = _redistribute_small(torch.where(a > 0.0, approx_div, 0.0),
                                     a, s)
    w = Weights(a, s, ds, solid_mod.merge_groups(a, s), s_half, a_mac)
    return w, U, mac_div, approx_div


def solid_velocity_diffusion(v, ds, us_v, grid: Grid, fbc: bcs.FieldBC, dt,
                             nu, a, s, beta, params, extra_rhs,
                             t: float = 0.0, extra_dia=None):
    """The implicit viscous solve with cell weights ``a`` and face weights
    ``s`` (cut cells and metric factors; reference ns.py:783-818, GfsSurfaceBc
    src/timestep.c:1062-1229, src/poisson.c:561-586): a u - beta dt
    [div(nu s grad u) + nu ell (u_s - u_probe) / (d_p h^2)] + beta dt nu
    extra_dia u = a v + extra, as div(beta dt nu s grad u) - (a + beta dt
    nu (dia_s + extra_dia)) u = -(a v + extra + beta dt nu dia_s u_s),
    with the Dirichlet velocity ``us_v`` on the embedded surface ``ds``
    (a DirichletSurface) and its probe term deferred-corrected in two
    solves; without a surface (a metric alone) one solve.  ``extra_dia``:
    the axisymmetric radial term a / r^2 of component 1, or None.  Face
    coefficients and a cell dia: K15 in every correction.  A callable
    ``us_v`` is called f(x, y) at the surface points, as the reference
    calls it (gerris_tpu/physics/solid.py:233-236): one that takes more
    arguments raises NotImplementedError, where the reference fails."""
    scale = beta * dt * nu
    alpha = tuple(scale * f for f in s)
    dia = a if extra_dia is None else a + scale * extra_dia
    params = diff.params_or_default(params)
    if ds is None:
        return poisson.solve(v, -(a * v + extra_rhs), grid, fbc, params,
                             alpha=alpha, dia=dia, t=t)[0]
    try:
        usv = ds.surface_value(us_v, t)
    except TypeError as err:
        raise NotImplementedError(
            "a surface velocity that is not a constant or f(x, y) in a "
            "viscous step: the reference calls it f(x, y) at the surface "
            "points (gerris_tpu/physics/solid.py:233-236) and fails") \
            from err
    dia = dia + scale * ds.dia
    base = -(a * v + extra_rhs + scale * ds.dia * usv)
    u = v
    for _ in range(2):
        u, _ = poisson.solve(u, base + ds.correction(u, scale), grid, fbc,
                             params, alpha=alpha, dia=dia, t=t)
    return u


def _solid_component(v, c: int, uf: list, uc_pad: list, gmac, gp, grid: Grid,
                     cfg: NSConfig, dt, w: Weights, rho, source,
                     t: float):
    """One velocity component's advection and diffusion with weights
    (reference ns.py:375-445): the generic route's face values with fluxes
    through the face weights (``s_half`` at a moving solid's order 2),
    the merged-cell update where a solid cuts cells (the plain (a v + fv)
    / a elsewhere and without one), the gc and source terms, the viscous
    solve (solid_velocity_diffusion: the Dirichlet surface with u_s from
    ``surface_u``, 0 without it; the axisymmetric a / r^2 term on
    component 1), and zero where a = 0."""
    fbc = cfg.u_bcs[c]
    fv_acc = adv.advection_increment(
        v, uf, uc_pad, grid, fbc, dt, cfg.advection, c=c,
        g_pad=bcs.apply_bc(gmac, grid, bcs.grad_bc(cfg.u_bcs[0]), 1,
                           corners=False),
        t=t, face_frac=w.s if w.s_half is None else w.s_half)
    if w.groups is None:
        merged = solid_mod.cell_update(v, fv_acc, w.a)
    else:
        merged = solid_mod.merged_cell_update(v, fv_acc, w.a, w.s, w.groups)
    fv = torch.where(w.a > 0.0, merged - v, 0.0)
    if gp is not None:
        fv = fv - dt * gp
    if source is not None:
        fv = fv + dt * source
    if cfg.nu > 0.0:
        a_w = w.a if rho is None else rho * w.a
        us = 0.0 if cfg.surface_u is None else cfg.surface_u[c]
        extra_dia = None
        if cfg.axi and c == 1:
            yc = cell_centers(grid, v.device, v.dtype)[1][:1]
            extra_dia = w.a / (yc * yc)
        v_new = solid_velocity_diffusion(v, w.ds, us, grid, fbc, dt, cfg.nu,
                                         a_w, w.s, cfg.beta,
                                         cfg.diffusion_params, a_w * fv, t,
                                         extra_dia=extra_dia)
    else:
        v_new = v + fv
    return torch.where(w.a > 0.0, v_new, 0.0)


def velocity_advection_diffusion(U: list, uf: list, gmac: list, g_prev,
                                 grid: Grid, cfg: NSConfig, dt, rho=None,
                                 mu=None, sources=None, t: float = 0.0,
                                 solid: Weights = None):
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
    solve.  With the cell densities ``rho`` (two-phase) each component's
    K14 gives fv - dt g_prev and its diffusion solves rho u - dt div(nu
    grad u) = rho (u + fv) (face coefficients dt nu, cell dia rho: K15;
    reference ns.py:339-373).  With a variable viscosity ``mu`` (cells)
    the diffusion's face coefficients are dt times its face means, and
    ``sources`` (per component, e.g. viscous_transpose_sources) add dt
    sources to each component's increment (reference ns.py:247-252,
    :418-437).  In 3D, and under a limiter or ``scheme="none"``, each
    component's increment takes the reference's generic route (ns.py:
    335-347, 375-447, adv.advection_increment: the BCG face values with
    the MAC faces' cell means as the advecting velocity, upwinded by the
    MAC faces, minus the face mean of gmac times dt/2), then diffuse.
    With weights ``solid`` (a solid, a metric) every component takes that
    generic route too, with the update of _solid_component (no K7 or K14,
    ns.py:257, :342).  Callable BC values are evaluated at time ``t``."""
    fold = cfg.nu > 0.0 and cfg.beta == 1.0 and rho is None and mu is None \
        and sources is None
    dia = 1.0 / (dt * cfg.nu) if fold else None
    gp = None if g_prev is None else list(g_prev)
    if solid is not None:
        uc_pad = adv.mac_cell_mean(uf, grid)
        return [_solid_component(U[c], c, uf, uc_pad, gmac[c],
                                 None if gp is None else gp[c], grid, cfg, dt,
                                 solid, rho,
                                 None if sources is None else sources[c], t)
                for c in range(grid.dim)]
    if sources is None and _pair_route(grid, cfg, rho, mu):
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
    D = cfg.nu
    if mu is not None:
        # the face viscosity of the implicit solve (reference ns.py:247-252)
        mu_pad = bcs.apply_bc(mu, grid, bcs.default_scalar_bc(grid.dim), 1,
                              t=t)
        D = tuple(face_average(mu_pad, grid, a) for a in range(grid.dim))
    kernel = bcg.applicable(grid, cfg.advection)
    uc_pad = None if kernel else adv.mac_cell_mean(uf, grid)
    gbc = bcs.grad_bc(cfg.u_bcs[0])
    out = []
    for c in range(grid.dim):
        fbc = cfg.u_bcs[c]
        kw = dict(g=gmac[c], gp=None if gp is None else gp[c],
                  oscale=None if dia is None else -dia)
        if not kernel:
            fv = adv.advection_increment(
                U[c], uf, uc_pad, grid, fbc, dt, cfg.advection, c=c,
                g_pad=bcs.apply_bc(gmac[c], grid, gbc, 1, corners=False),
                t=t)
            if gp is not None:
                fv = fv - dt * gp[c]
        elif bcg.advect_spec(fbc) is not None:
            fv = bcg.advect2d(U[c], c, uf[0], uf[1], dt, grid, fbc, **kw)
        else:
            fv = bcg.advect2d_plain(U[c], c, uf[0], uf[1], dt, grid, fbc,
                                    t=t, **kw)
        if sources is not None:
            fv = fv + dt * sources[c]
        if fold and kernel:
            v_new, _ = poisson.solve(
                U[c], fv, grid, fbc,
                diff.params_or_default(cfg.diffusion_params), dia=dia, t=t)
        elif cfg.nu > 0.0 or mu is not None:
            v_new, _ = diff.diffuse(U[c], grid, fbc, dt, D,
                                    rho=1.0 if rho is None else rho,
                                    beta=cfg.beta,
                                    params=cfg.diffusion_params,
                                    extra_rhs=fv if rho is None
                                    else rho * fv, t=t)
        else:
            v_new = U[c] + fv
        out.append(v_new)
    return out


def advect_tracer(T, tracer: tuple, uf: list, grid: Grid, cfg: NSConfig,
                  dt, t: float = 0.0):
    """One passive tracer's advection-diffusion with the projected faces
    ``uf`` (gfs_tracer_advection_diffusion, src/timestep.c:1028;
    gerris_tpu ns.py:450-483): K14 where it takes the tracer's BCs under
    the centred Godunov scheme (no face forced, no gmac), else the
    generic route; then dt times the source (a constant, or a function of
    the cell centres and ``t``) and, with D > 0, the implicit diffusion
    solve with the increment as its extra rhs."""
    _, fbc, D = tracer[:3]
    src = tracer[3] if len(tracer) > 3 else None
    if bcg.applicable(grid, cfg.advection) \
            and bcg.advect_spec(fbc) is not None:
        fv = bcg.advect2d(T, None, uf[0], uf[1], dt, grid, fbc)
    else:
        fv = adv.advection_increment(T, uf, adv.mac_cell_mean(uf, grid),
                                     grid, fbc, dt, cfg.advection, t=t)
    if src is not None:
        sv = src(*cell_centers(grid, T.device, T.dtype), t) \
            if callable(src) else src
        fv = fv + dt * sv
    if D and D > 0.0:
        T_new, _ = diff.diffuse(T, grid, fbc, dt, D, beta=cfg.beta,
                                params=cfg.diffusion_params, extra_rhs=fv,
                                t=t)
        return T_new
    return T + fv


def _vof_bc(cfg: NSConfig, name: str) -> bcs.FieldBC:
    return dict((v[0], v[1]) for v in cfg.vof_tracers)[name]


def filtered(T, grid: Grid, fbc: bcs.FieldBC, npass: int = 1,
             t: float = 0.0):
    """The tracer smoothed by ``npass`` passes of the separable (1,2,1)/4
    kernel (GfsVariableFiltered, src/variable.c; gerris_tpu
    ns.py:489-505), on its padding with BC values at time ``t``."""
    for _ in range(npass):
        p = bcs.apply_bc(T, grid, fbc, 1, t=t)
        for ax in range(grid.dim):
            n = p.shape[ax]
            p = 0.25 * (p.narrow(ax, 0, n - 2) + 2.0 * p.narrow(ax, 1, n - 2)
                        + p.narrow(ax, 2, n - 2))
        T = p
    return T


def density_fields(state: dict, cfg: NSConfig, t: float = 0.0,
                   grid: Grid = None):
    """(rho_cell, alpha_faces) from the VOF tracer: rho = rho2 + T1 (rho1 -
    rho2) with T1 the filtered fraction clipped to [0, 1], alpha = 1 /
    rho(T1 on the face) (gfs_poisson_coefficients src/poisson.c:868;
    gerris_tpu ns.py:507-527), or (None, None) at unit density.  ``grid``
    (default cfg.grid): the level the state lies on (the composite
    step's per-level evaluation)."""
    if cfg.density is None:
        return None, None
    name, rho1, rho2, npass = cfg.density
    fbc = _vof_bc(cfg, name)
    grid = grid or cfg.grid
    T1 = filtered(state[name], grid, fbc, npass, t)
    rho_c = rho2 + torch.clamp(T1, 0.0, 1.0) * (rho1 - rho2)
    T1p = bcs.apply_bc(T1, grid, fbc, 1, t=t)
    alpha = tuple(
        1.0 / (rho2 + torch.clamp(face_average(T1p, grid, ax), 0.0, 1.0)
               * (rho1 - rho2))
        for ax in range(grid.dim))
    return rho_c, alpha


def tension_sources(state: dict, cfg: NSConfig, alpha=None,
                    off_max: int = 2, t: float = 0.0, grid: Grid = None):
    """The well-balanced tension face sources of every (vof_name, sigma)
    in ``cfg.tension``, summed: height-function curvature, filled twice
    into the neighbouring cells, times sigma grad(T) on the faces (and
    alpha; gerris_tpu ns.py:575-597), or None without tension.  ``grid``
    (default cfg.grid): the level the state lies on."""
    grid = grid or cfg.grid
    srcs = None
    for name, sigma in cfg.tension:
        fbc = _vof_bc(cfg, name)
        T = state[name]
        kap = vof.curvature(T, grid, fbc, off_max=off_max, t=t)
        kap = vof.fill_curvature(kap, None, niter=2)
        dp = tens.tension_face_sources(T, kap, sigma, grid, fbc,
                                       alpha=alpha, t=t)
        srcs = dp if srcs is None else [a + b for a, b in zip(srcs, dp)]
    return srcs


@functools.lru_cache(maxsize=16)
def cell_centers(grid: Grid, device, dtype) -> tuple:
    """The cell-centre coordinates per axis as broadcast (meshgrid,
    indexing 'ij') tensors on ``device``, formed there from the axis
    coordinates in float64 and cast (grid.centers' values), once per
    grid, device and dtype."""
    axes = [torch.as_tensor(grid.axis_centers(a), dtype=torch.float64,
                            device=device).to(dtype)
            for a in range(grid.dim)]
    return tuple(torch.meshgrid(*axes, indexing="ij"))


def viscosity_field(state: dict, cfg: NSConfig, t: float = 0.0,
                    grid: Grid = None):
    """The dynamic viscosity per cell from ``cfg.nu_var`` at time ``t``
    (GfsSourceViscosity with a GfsFunction, src/source.c; gerris_tpu
    ns.py:530-548), or None without one.  A field of ``nu_var_fields``
    that the state lacks is ``npass`` filter passes of its parent tracer
    on the parent's BCs (a VOF tracer's, a tracer's, else the default
    scalar BCs).  ``grid`` (default cfg.grid): the level the state lies
    on."""
    if cfg.nu_var is None:
        return None
    grid = grid or cfg.grid
    like = state[velocity_names(grid.dim)[0]]
    vof_bc = dict((v[0], v[1]) for v in cfg.vof_tracers)
    tr_bc = dict((tr[0], tr[1]) for tr in cfg.tracers)
    fields = {}
    for name, parent, npass in cfg.nu_var_fields:
        if parent is None or name in state:
            fields[name] = state[name]
        else:
            fbc = vof_bc.get(parent) or tr_bc.get(parent) \
                or bcs.default_scalar_bc(grid.dim)
            fields[name] = filtered(state[parent], grid, fbc, npass, t)
    mu = cfg.nu_var(*cell_centers(grid, like.device, like.dtype), t=t,
                    **fields)
    return torch.broadcast_to(torch.as_tensor(mu, dtype=like.dtype,
                                              device=like.device),
                              grid.shape)


def viscous_transpose_sources(U: list, mu, grid: Grid, cfg: NSConfig,
                              alpha_cell=None, t: float = 0.0) -> list:
    """The explicit remainder of the variable-viscosity stress divergence,
    per component c: (1/rho) sum_j (d_c u_j)(d_j mu), the div(mu grad(u)^T)
    part that the implicit div(mu grad u_c) solve does not see, in
    centred gradients (source_viscosity_non_diffusion_value,
    src/source.c:1412-1438; gerris_tpu ns.py:551-573).  ``alpha_cell``:
    1/rho per cell, or None for unit density."""
    dim = grid.dim
    mu_pad = bcs.apply_bc(mu, grid, bcs.default_scalar_bc(dim), 1, t=t)
    dmu = [center_gradient(mu_pad, grid, j) for j in range(dim)]
    u_pads = [bcs.apply_bc(U[j], grid, cfg.u_bcs[j], 1, corners=False, t=t)
              for j in range(dim)]
    srcs = []
    for c in range(dim):
        s = 0.0
        for j in range(dim):
            s = s + center_gradient(u_pads[j], grid, c) * dmu[j]
        srcs.append(s if alpha_cell is None else s * alpha_cell)
    return srcs


def _face_coords(grid: Grid, axis: int, like) -> list:
    """The centres of the faces of ``axis``, per axis broadcastable
    tensors of ``like``'s dtype and device (face coordinates along
    ``axis``, cell centres along the others)."""
    coords = []
    for a in range(grid.dim):
        x = grid.axis_faces(a) if a == axis else grid.axis_centers(a)
        sh = [1] * grid.dim
        sh[a] = len(x)
        coords.append(torch.as_tensor(x, dtype=torch.float64,
                                      device=like.device)
                      .to(like.dtype).reshape(sh))
    return coords


def body_force_sources(cfg: NSConfig, like, t: float = 0.0) -> list:
    """The body force as per-axis face sources (gerris_tpu ns.py:846-891,
    src/timestep.c:245-290): component c's value at the centres of the
    faces of axis c (a None component: zero faces; a callable one
    evaluated at time ``t``), on the same well-balanced path as tension,
    so that a hydrostatic state stays at rest to rounding.  A boundary
    face whose normal velocity is Dirichlet (prescribed) carries no
    force.  The reference zeroes the force on every non-periodic
    boundary face instead, where the normal velocity is prescribed or not
    (ROADMAP Queue 3): on walls the two agree."""
    grid = cfg.grid
    out = []
    for c in range(grid.dim):
        shp = grid.face_shape(c)
        bf = cfg.body_force[c]
        if bf is None:
            out.append(torch.zeros(shp, dtype=like.dtype, device=like.device))
            continue
        if callable(bf):
            f = torch.broadcast_to(torch.as_tensor(
                bf(*_face_coords(grid, c, like), t=t), dtype=like.dtype,
                device=like.device), shp).clone()
        else:
            f = torch.full(shp, float(bf), dtype=like.dtype,
                           device=like.device)
        for side in (0, 1):
            if cfg.u_bcs[c].sides[c][side].kind == bcs.DIRICHLET:
                f.narrow(c, 0 if side == 0 else shp[c] - 1, 1).zero_()
        out.append(f)
    return out


def css_sources(state: dict, cfg: NSConfig, rho_c=None,
                t: float = 0.0):
    """The CSS tension's cell accelerations of every (vof_name, sigma) in
    ``cfg.tension_css``, summed in the reference's order, alpha_cell =
    1/rho_c under a density (gerris_tpu ns.py:837-845), or None."""
    srcs = None
    for name, sigma in cfg.tension_css:
        css = tens.css_tension_sources(
            state[name], sigma, cfg.grid, _vof_bc(cfg, name),
            alpha_cell=None if rho_c is None else 1.0 / rho_c, t=t)
        srcs = css if srcs is None else [a + b for a, b in zip(css, srcs)]
    return srcs


def _close_faces(uf: list, sfrac) -> list:
    """The faces with the solid's closed ones (s = 0) zeroed."""
    if sfrac is None:
        return uf
    return [torch.where(s > 0.0, u, 0.0) for u, s in zip(uf, sfrac)]


def ns_step(state: dict, dt: float, t: float, cfg: NSConfig,
            first_step: bool = False, cstart: int = 0,
            solid_args=None) -> dict:
    """One full time step from time ``t``; ``state`` holds U, V[, W], P,
    Pmac, the VOF and passive tracers, and with gc (the default) Gx,
    Gy[, Gz].  ``dt`` is a host float (the
    Helmholtz dia = 1/(beta dt nu) is a kernel argument).  Callable BC
    values, a callable body force and ``nu_var`` are evaluated at ``t``
    throughout the step, as the reference does.  ``cstart``: the VOF
    advection's first sweep direction (Simulation rotates it,
    src/vof.c:1648,1721).  ``solid_args``: a moving solid's extra
    arguments of ``solid_phi`` and ``surface_u`` after (x, y, t), e.g. a
    rigid body's state as 0-d tensors (models/rigid.py).  Returns a new
    state dict."""
    grid = cfg.grid
    dim = grid.dim
    names = velocity_names(dim)
    U = [state[n] for n in names]
    gc = cfg.advection.gc
    g_prev = [state[n] for n in gradient_names(dim)] if gc else None
    rho_c, alpha = density_fields(state, cfg, t)
    fs = tension_sources(state, cfg, alpha=alpha, t=t)
    if cfg.body_force is not None:
        fg = body_force_sources(cfg, U[0], t)
        fs = fg if fs is None else [a + b for a, b in zip(fs, fg)]
    sources = css_sources(state, cfg, rho_c, t)
    mu = viscosity_field(state, cfg, t)
    if mu is not None:
        ts = viscous_transpose_sources(
            U, mu, grid, cfg, None if rho_c is None else 1.0 / rho_c, t)
        sources = ts if sources is None else \
            [a + b for a, b in zip(ts, sources)]
    if cfg.particle_coupling:
        ps = [state["PF" + ax] for ax in "xyz"[:dim]]
        sources = ps if sources is None else \
            [a + b for a, b in zip(ps, sources)]
    mac_src = apx_src = None
    if cfg.moving_solid:
        solid, U, mac_src, apx_src = _moving_weights(cfg, U, dt, t,
                                                     solid_args)
    else:
        solid = _weights(cfg, U[0])
    sfrac = vfrac = None
    if solid is not None:
        sfrac, vfrac = solid.s, solid.a
    # a moving solid's order 2 projects the MAC faces with the time-centred
    # face fractions and the old cell fractions (ns.py:926-935)
    mac_s, mac_a = sfrac, vfrac
    if solid is not None and solid.s_half is not None:
        mac_s, mac_a = solid.s_half, solid.a_old
    # 1-2. prediction, MAC projection at dt/2 (the reference swaps P and
    # Pmac around it, src/simulation.c:498-504).  div_in_src (2D): each
    # projection's divergence comes out of the launch that builds its
    # faces, unless face sources, coefficients or weights touch the faces
    # first.  The predictor and the face interpolation ignore the weights;
    # the closed faces are zeroed after them (reference ns.py:931-934,
    # :979)
    fold = cfg.div_in_src and dim == 2 and fs is None and alpha is None \
        and solid is None
    uf, mac_divp = predicted_face_velocities(
        U, grid, cfg, dt,
        div_scale=1.0 / (grid.h * (dt / 2.0)) if fold else None, t=t)
    uf = _close_faces(uf, mac_s)
    uf, pmac, gmac, _, _ = proj.mac_projection(
        uf, state["Pmac"], grid, cfg.p_bc, dt / 2.0, cfg.projection,
        div_pre=mac_divp, alpha=alpha, face_sources=fs, div_source=mac_src,
        face_frac=mac_s, vol_frac=mac_a, t=t)
    # 3. at i == 0 the gc gradient role is played by this step's gmac
    # (src/simulation.c:514-521)
    if gc and first_step:
        g_prev = gmac
    U = velocity_advection_diffusion(U, uf, gmac, g_prev, grid, cfg, dt,
                                     rho=rho_c, mu=mu, sources=sources, t=t,
                                     solid=solid)
    # 4. approximate projection at dt with the gc re-add folded into the
    # face interpolation (src/simulation.c:520) and the centred
    # correction into the projection's correction launch
    uf2, U, apx_divp = proj.face_interpolated_velocity(
        U, grid, list(cfg.u_bcs), gp=g_prev, dtv=dt,
        div_scale=1.0 / (grid.h * dt) if fold else None, t=t)
    uf2, p, g_cell, _, U = proj.mac_projection(
        _close_faces(uf2, sfrac), state["P"], grid, cfg.p_bc, dt,
        cfg.approx_projection, cells=U, div_pre=apx_divp, alpha=alpha,
        face_sources=fs, div_source=apx_src, face_frac=sfrac,
        vol_frac=vfrac, t=t)
    if solid is not None:
        U = [torch.where(solid.a > 0.0, u, 0.0) for u in U]
    new = dict(state)
    for c, n in enumerate(names):
        new[n] = U[c]
    new["P"] = p
    new["Pmac"] = pmac
    if gc:
        for c, n in enumerate(gradient_names(dim)):
            new[n] = g_cell[c]
    # 5. the tracers, then the VOF tracers, with the projected faces
    # (gfs_advance_tracers)
    for tr in cfg.tracers:
        new[tr[0]] = advect_tracer(state[tr[0]], tr, uf2, grid, cfg, dt, t)
    for name, fbc in cfg.vof_tracers:
        new[name] = vof.advect(state[name], uf2, grid, fbc, dt,
                               cstart=cstart, t=t)
    return new


def initial_projection(state: dict, dt: float, t: float,
                       cfg: NSConfig, solid_args=None) -> dict:
    """The i == 0 approximate projection that makes the initial field
    divergence-free and seeds the gc gradient (src/simulation.c:466-474),
    with the density's face coefficients and no face sources: the
    reference's curvature is not evaluated yet at that time, and its body
    force is not applied there either (gerris_tpu ns.py:1014-1044,
    src/poisson.c:929-936).  A moving solid takes its fractions at ``t``
    (reference ns.py:1026-1029), ``solid_args`` passed on to
    ``solid_phi`` after (x, y, t)."""
    names = velocity_names(cfg.dim)
    U = [state[n] for n in names]
    _, alpha = density_fields(state, cfg, t)
    sfrac = vfrac = None
    if cfg.moving_solid:
        extra = tuple(solid_args) if solid_args is not None else ()
        vfrac, sfrac = solid_mod.solid_fractions(
            cfg.grid, lambda x, y: cfg.solid_phi(x, y, t, *extra),
            U[0].device, U[0].dtype)
    elif (solid := _weights(cfg, U[0])) is not None:
        sfrac, vfrac = solid.s, solid.a
    uf, _, _ = proj.face_interpolated_velocity(U, cfg.grid, list(cfg.u_bcs),
                                               t=t)
    _, p, g_cell, _, U = proj.mac_projection(
        _close_faces(uf, sfrac), state["P"], cfg.grid, cfg.p_bc, dt,
        cfg.approx_projection, cells=U, alpha=alpha, face_frac=sfrac,
        vol_frac=vfrac, t=t)
    new = dict(state)
    for c, n in enumerate(names):
        new[n] = U[c]
    new["P"] = p
    if cfg.advection.gc:
        for c, n in enumerate(gradient_names(cfg.dim)):
            new[n] = g_cell[c]
    return new


def timescale(state: dict, cfg: NSConfig) -> torch.Tensor:
    """min over components of h / max|u| (reference: gfs_domain_cfl,
    src/domain.c:2857-2906), and of each component's acceleration bound
    sqrt(2 h / max|a|), max|a| the sum of the body force's (a callable
    force evaluated at the cell centres at t = 0, as the reference does)
    and, with particle coupling, max|PF| of that component (gerris_tpu
    ns.py:1061-1080); a 0-d tensor on the state's device.  The reference
    guards with 1e-300, which is 0 in float32: the port uses the dtype's
    smallest normal number."""
    ts = None
    h = cfg.grid.h
    for n in velocity_names(cfg.dim):
        v = state[n]
        umax = torch.clamp(v.abs().max(), min=torch.finfo(v.dtype).tiny)
        t_c = h / umax
        ts = t_c if ts is None else torch.minimum(ts, t_c)
    tiny = torch.finfo(ts.dtype).tiny
    for c in range(cfg.dim):
        bf = None if cfg.body_force is None else cfg.body_force[c]
        amax = None
        if bf is not None:
            if callable(bf):
                bf = bf(*cell_centers(cfg.grid, ts.device, ts.dtype), 0.0)
            amax = torch.as_tensor(bf, dtype=ts.dtype, device=ts.device) \
                .abs().max()
        if cfg.particle_coupling:
            pf = state["PF" + "xyz"[c]].abs().max()
            amax = pf if amax is None else amax + pf
        if amax is not None:
            ts = torch.minimum(ts, torch.sqrt(
                2.0 * h / torch.clamp(amax, min=tiny)))
    return ts
