"""Carry-over from the JAX package: state and configuration.

The JAX objects are read by attribute only, so this module imports
neither jax nor gerris_tpu: it converts whatever it is given (a JAX
``NSConfig``, ``FieldBC``, ``MultilevelParams`` or ``Grid``, a state dict
of numpy arrays, or an ``.npz`` checkpoint opened with ``numpy.load``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import bc as bcs
from ..core import metric as metric_mod
from ..core.device import default_device
from ..core.grid import Grid
from ..models import ns
from ..solvers.advection import AdvectionParams
from ..solvers.diffusion import DEFAULT_PARAMS
from ..solvers.composite import CompositeGrid
from ..solvers.poisson import COARSEST_FLOOR, MultilevelParams

# the reference's MultilevelParams.tpu_nrelax default, the floor its
# diffusion default takes on the TPU (gerris_tpu poisson.py:70)
TPU_NRELAX = 8

_SLICE_FIELDS = {"grid", "u_bcs", "p_bc", "advection", "projection",
                 "approx_projection", "nu", "beta", "diffusion_params",
                 "div_in_src", "pair_advect", "rr_in_advect", "vof_tracers",
                 "tension", "density", "body_force", "nu_var",
                 "nu_var_fields", "tracers", "tension_css", "solid_phi",
                 "surface_u", "moving_solid", "moving_order", "axi",
                 "metric", "block_advect", "composite_vof"}
# the later slices of the fields outside this one (ROADMAP Queue 1)
_LATER = {"particle_coupling": "slice 6"}


def state_from_numpy(d, device=None, dtype=torch.float64) -> dict:
    """{name: array} (e.g. ``{k: np.asarray(v)}`` of a JAX state, or an
    opened ``.npz``) -> {name: contiguous tensor on ``device``}, the CUDA
    card by default (core/device.default_device)."""
    device = default_device(device)
    return {k: torch.as_tensor(np.asarray(d[k])).to(
                device=device, dtype=dtype).contiguous()
            for k in d.keys()}


def grid_from_jax(g) -> Grid:
    return Grid(level=g.level, dim=g.dim, origin=tuple(g.origin),
                size=g.size, extents=tuple(g.extents))


def fieldbc_from_jax(fbc, values=None) -> bcs.FieldBC:
    """BC kinds (Navier and contact angles among them) and constant
    values.  A callable value cannot be carried over: a JAX callable
    computes on jnp arrays, where the port's take torch tensors.  Give
    its torch counterpart in ``values``, a dict {(axis, side): value};
    a callable without one raises NotImplementedError."""
    values = values or {}

    def value(ax, sd, b):
        if not callable(b.value):
            return b.value
        if (ax, sd) not in values:
            raise NotImplementedError(
                f"a JAX callable BC value on (axis {ax}, side {sd}): give "
                "the port a function of torch tensors (values=...)")
        return values[(ax, sd)]

    return bcs.FieldBC(tuple(tuple(bcs.BC(b.kind, value(ax, sd, b))
                                   for sd, b in enumerate(pair))
                             for ax, pair in enumerate(fbc.sides)))


def params_from_jax(p, dim: int = 2) -> MultilevelParams:
    """The schedule the TPU runs for the JAX params ``p`` on a ``dim``-D
    grid, route by route (gerris_tpu poisson.py:1090-1162): every field
    carried over, and in 2D
    * fixed multigrid (ncycles > 0): nrelax raised to ``tpu_nrelax`` and
      the coarsest sweeps to max(coarsest_relax, 2 * tpu_nrelax, 40)
      (:1105-1110, and the fused cycle's :683);
    * adaptive multigrid: nrelax raised to ``tpu_nrelax`` and the
      coarsest sweeps to max(coarsest_relax, 2 * tpu_nrelax)
      (:1139-1143); K12's floor of 40 is applied at its call (:568);
    * a registry solver ("relax", ...): as given, with no floor.
    The TPU applies the floors on its Pallas path (2D, float32, levels of
    at least 128); the port's schedule does not depend on the device.  In
    3D the TPU applies none (``_pallas_relax_applicable`` is False for dim
    != 2, poisson.py:191), so the params carry over as given.
    ``p=None`` (a diffusion's reference default) gives diffuse's default
    with the same floors in 2D: the reference's ``solve`` raises it on
    the TPU like any adaptive schedule (poisson.py:1139-1143, reached
    from diffusion.py:40-46) with the reference's default tpu_nrelax, so
    nrelax 8 and 16 coarsest sweeps in 2D, and diffuse's default as it is
    in 3D.  ``fold_div`` and ``fold_correct`` (the bench's
    GERRIS_FOLD_DIV / GERRIS_FOLD_CORRECT, bench.py:142-150) carry over:
    a MAC projection then takes the K16/K17 fold route where
    poisson.fold_div_eligible holds."""
    tpu = TPU_NRELAX if p is None else p.tpu_nrelax
    if p is None:
        p = DEFAULT_PARAMS
    fields = {f.name: getattr(p, f.name)
              for f in dataclasses.fields(MultilevelParams)}
    if p.solver == "multigrid" and dim == 2:
        fields["nrelax"] = max(p.nrelax, tpu)
        fields["coarsest_relax"] = max(p.coarsest_relax, 2 * tpu)
        if p.ncycles > 0:
            fields["coarsest_relax"] = max(fields["coarsest_relax"],
                                           COARSEST_FLOOR)
    fields["omega"] = float(fields["omega"])
    fields["tolerance"] = float(fields["tolerance"])
    return MultilevelParams(**fields)


def _counterpart(field: str, given):
    """The port's torch function for a JAX callable in ``field``, which
    cannot be carried over (it computes on jnp arrays)."""
    if not callable(given):
        raise NotImplementedError(
            f"NSConfig.{field} holds a JAX callable: give config_from_jax "
            f"its torch counterpart ({field}=...)")
    return given


def _body_force(bf, given):
    """Per component: None, a constant, or for a JAX callable the torch
    counterpart ``given[c]``."""
    if bf is None:
        return None
    out = []
    for c, v in enumerate(bf):
        if callable(v):
            v = _counterpart(f"body_force[{c}]",
                             None if given is None else given[c])
        elif v is not None:
            v = float(v)
        out.append(v)
    return tuple(out)


def _surface_u(su, given):
    """Per component: a constant carried over, or for a JAX callable the
    torch counterpart ``given[c]``."""
    if su is None:
        return None
    return tuple(
        _counterpart(f"surface_u[{c}]", None if given is None else given[c])
        if callable(v) else float(v) for c, v in enumerate(su))


# the metrics of core/metric.py by class name, and their fields
_METRICS = {"MetricStretch": (metric_mod.MetricStretch, ("sx", "sy")),
            "MetricLonLat": (metric_mod.MetricLonLat, ("scale",)),
            "MetricCubed": (metric_mod.MetricCubed, ("a",)),
            "MapTransform": (metric_mod.MapTransform, ("tx", "ty", "angle")),
            "MapProjection": (metric_mod.MapProjection,
                              ("kind", "L", "lon0"))}


def metric_from_jax(m):
    """A JAX metric or mapping of gerris_tpu/core/metric.py -> the port's,
    read by its class name and fields (None stays None); another class
    raises NotImplementedError."""
    if m is None:
        return None
    name = type(m).__name__
    if name not in _METRICS:
        raise NotImplementedError(f"a metric of class {name}: the port has "
                                  f"{sorted(_METRICS)}")
    cls, fields = _METRICS[name]
    return cls(**{f: (getattr(m, f) if f == "kind"
                      else float(getattr(m, f))) for f in fields})


def rigid_body_from_jax(b):
    """A JAX models/rigid.RigidBody -> the port's, its mass, position,
    velocity and gravity as floats (numpy)."""
    from ..models import rigid

    def pair(v):
        return tuple(float(x) for x in np.asarray(v, dtype=np.float64))
    return rigid.RigidBody(mass=float(b.mass), pos=pair(b.pos),
                           vel=pair(b.vel), gravity=pair(b.gravity))


def _tracer(tr, sources, values):
    """A JAX tracer (name, FieldBC, D[, source]); a callable source takes
    its torch counterpart ``sources[name]``, callable BC values
    ``values``."""
    out = (tr[0], fieldbc_from_jax(tr[1], values), float(tr[2]))
    if len(tr) < 4 or tr[3] is None:
        return out
    src = tr[3]
    if callable(src):
        src = _counterpart(f"tracers[{tr[0]!r}] source",
                           (sources or {}).get(tr[0]))
    else:
        src = float(src)
    return out + (src,)


def config_from_jax(cfg, nu_var=None, body_force=None,
                    tracer_sources=None, bc_values=None, solid_phi=None,
                    surface_u=None) -> ns.NSConfig:
    """A JAX ``NSConfig`` -> the port's.  A field outside the slice that
    differs from its default raises NotImplementedError.  A JAX callable
    is carried over only through the torch counterpart given here:
    ``nu_var``, a function f(x, y, t=..., **fields) of torch tensors, for
    the config's ``nu_var``; ``body_force``, one entry per component, for
    its callable components (constant ones carry over as they are);
    ``tracer_sources``, {tracer name: f(x, y, t)}, for a tracer's callable
    source; ``bc_values``, {vof or tracer name: {(axis, side): value}},
    for a callable BC value of that field's (a contact angle f(x, y, t)
    among them); ``solid_phi``, a level set f(x, y) of torch tensors (a
    moving solid's f(x, y, t[, *solid_args])), for the config's solid;
    ``surface_u``, one entry per component, for its callable components
    (constant ones carry over as they are).  A callable with no
    counterpart raises NotImplementedError naming the field.  The metric
    carries over by metric_from_jax, ``moving_solid``, ``moving_order``
    and ``axi`` as they are."""
    bc_values = bc_values or {}
    for f in dataclasses.fields(type(cfg)):
        if f.name in _SLICE_FIELDS:
            continue
        if getattr(cfg, f.name) != f.default:
            raise NotImplementedError(
                f"NSConfig.{f.name} = {getattr(cfg, f.name)!r} is outside "
                f"the ported slice ({_LATER.get(f.name, 'ROADMAP Queue 1')})")
    a = cfg.advection
    dim = cfg.grid.dim
    return ns.NSConfig(
        grid=grid_from_jax(cfg.grid),
        u_bcs=tuple(fieldbc_from_jax(b) for b in cfg.u_bcs),
        p_bc=fieldbc_from_jax(cfg.p_bc),
        advection=AdvectionParams(cfl=a.cfl, gradient=a.gradient,
                                  scheme=a.scheme, gc=a.gc),
        projection=params_from_jax(cfg.projection, dim),
        approx_projection=params_from_jax(cfg.approx_projection, dim),
        nu=float(cfg.nu), beta=float(cfg.beta),
        diffusion_params=params_from_jax(cfg.diffusion_params, dim),
        div_in_src=bool(cfg.div_in_src),
        pair_advect=bool(cfg.pair_advect),
        rr_in_advect=bool(cfg.rr_in_advect),
        vof_tracers=tuple((name, fieldbc_from_jax(fbc, bc_values.get(name)))
                          for name, fbc in cfg.vof_tracers),
        tension=tuple((name, float(sigma)) for name, sigma in cfg.tension),
        tension_css=tuple((name, float(sigma))
                          for name, sigma in cfg.tension_css),
        tracers=tuple(_tracer(tr, tracer_sources, bc_values.get(tr[0]))
                      for tr in cfg.tracers),
        density=None if cfg.density is None else
        (cfg.density[0], float(cfg.density[1]), float(cfg.density[2]),
         int(cfg.density[3])),
        body_force=_body_force(cfg.body_force, body_force),
        nu_var=None if cfg.nu_var is None else
        _counterpart("nu_var", nu_var),
        nu_var_fields=tuple(tuple(f) for f in cfg.nu_var_fields),
        solid_phi=None if cfg.solid_phi is None else
        _counterpart("solid_phi", solid_phi),
        surface_u=_surface_u(cfg.surface_u, surface_u),
        moving_solid=bool(cfg.moving_solid),
        moving_order=int(cfg.moving_order), axi=bool(cfg.axi),
        metric=metric_from_jax(cfg.metric),
        block_advect=bool(cfg.block_advect),
        composite_vof=bool(cfg.composite_vof))


def composite_from_jax(cg) -> CompositeGrid:
    """A JAX ``CompositeGrid`` -> the port's, from its base grid and leaf
    masks (host numpy, bit for bit)."""
    base = grid_from_jax(cg.base)
    return CompositeGrid.build(base, {l: np.asarray(cg.leaf_np(l))
                                      for l in range(cg.lmin, cg.lmax + 1)})


def amr_state_from_numpy(d, device=None, dtype=torch.float64) -> dict:
    """{name: {level: array}} (a JAX AMRSimulation's state read with
    ``np.asarray``) -> {name: {level: contiguous tensor on ``device``}},
    the CUDA card by default."""
    device = default_device(device)
    return {k: {int(l): torch.as_tensor(np.asarray(a)).to(
        device=device, dtype=dtype).contiguous() for l, a in v.items()}
        for k, v in d.items()}


# the reference's named criteria (gerris_tpu/models/amr_ns.py) and their
# counterparts here
_CRITERIA = {"interface_vorticity_criterion",
             "streamline_curvature_cost", "thickness_cost"}


def adapt_spec_from_jax(spec) -> "amr_ns.AdaptSpec":
    """A JAX ``AdaptSpec`` -> the port's.  Its criterion must be one of the
    reference's named criteria (interface_vorticity_criterion,
    streamline_curvature_cost, thickness_cost), which map to the port's;
    a user callable computes on jnp arrays and raises
    NotImplementedError (give the port's AdaptSpec a torch criterion)."""
    from ..models import amr_ns
    crit = spec.criterion
    name = getattr(crit, "__name__", None)
    if name not in _CRITERIA or not getattr(crit, "__module__", "") \
            .endswith("models.amr_ns"):
        raise NotImplementedError(
            f"AdaptSpec.criterion {crit!r} is a user callable: give the "
            "port's AdaptSpec its torch counterpart")
    return amr_ns.AdaptSpec(
        criterion=getattr(amr_ns, name), cmax=float(spec.cmax),
        cfactor=float(spec.cfactor), minlevel=int(spec.minlevel),
        maxlevel=int(spec.maxlevel), istep=int(spec.istep),
        maxcells=None if spec.maxcells is None else int(spec.maxcells))
