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
from ..core.device import default_device
from ..core.grid import Grid
from ..models import ns
from ..solvers.advection import AdvectionParams
from ..solvers.diffusion import DEFAULT_PARAMS
from ..solvers.poisson import COARSEST_FLOOR, MultilevelParams

# the reference's MultilevelParams.tpu_nrelax default, the floor its
# diffusion default takes on the TPU (gerris_tpu poisson.py:70)
TPU_NRELAX = 8

_SLICE_FIELDS = {"grid", "u_bcs", "p_bc", "advection", "projection",
                 "approx_projection", "nu", "beta", "diffusion_params",
                 "div_in_src", "pair_advect", "rr_in_advect", "vof_tracers",
                 "tension", "density"}


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


def fieldbc_from_jax(fbc) -> bcs.FieldBC:
    """BC kinds and constant values.  Kinds outside the port raise (port
    BC), and so do callable values: a JAX callable computes on jnp
    arrays, where the port's take torch tensors."""
    for ax in fbc.sides:
        for b in ax:
            if callable(b.value):
                raise NotImplementedError(
                    "a JAX callable BC value: give the port a function of "
                    "torch tensors")
    return bcs.FieldBC(tuple(tuple(bcs.BC(b.kind, b.value) for b in ax)
                             for ax in fbc.sides))


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


def config_from_jax(cfg) -> ns.NSConfig:
    """A JAX ``NSConfig`` -> the port's.  A field outside the slice that
    differs from its default raises NotImplementedError."""
    for f in dataclasses.fields(type(cfg)):
        if f.name in _SLICE_FIELDS:
            continue
        if getattr(cfg, f.name) != f.default:
            raise NotImplementedError(
                f"NSConfig.{f.name} = {getattr(cfg, f.name)!r} is outside "
                "the ported slice (ROADMAP Queue 1)")
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
        vof_tracers=tuple((name, fieldbc_from_jax(fbc))
                          for name, fbc in cfg.vof_tracers),
        tension=tuple((name, float(sigma)) for name, sigma in cfg.tension),
        density=None if cfg.density is None else
        (cfg.density[0], float(cfg.density[1]), float(cfg.density[2]),
         int(cfg.density[3])))
