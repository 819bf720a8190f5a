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
from ..solvers.poisson import MultilevelParams

# the fused cycle's coarsest level always gets at least this many sweeps
# (gerris_tpu poisson.py:683, max(coarsest_relax, 40))
COARSEST_FLOOR = 40

_SLICE_FIELDS = {"grid", "u_bcs", "p_bc", "advection", "projection",
                 "approx_projection", "nu", "beta", "diffusion_params",
                 "div_in_src"}


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
    """BC kinds and constant values; other kinds or callable values raise
    (port BC)."""
    return bcs.FieldBC(tuple(tuple(bcs.BC(b.kind, b.value) for b in ax)
                             for ax in fbc.sides))


def params_from_jax(p) -> MultilevelParams:
    """The schedule the TPU's fused path runs for ``p``: nrelax raised to
    ``tpu_nrelax`` and the coarsest sweeps to max(coarsest_relax,
    2*tpu_nrelax, 40) (gerris_tpu poisson.py:1105-1118, :683).
    ``p=None`` (the reference's adaptive default) gives ncycles=0.  The
    adaptive-loop and dense-coarse knobs (tolerance, nitermax, nitermin,
    minlevel, erelax, coarse_top, dense_coarse_max) have no counterpart in
    the fixed cycle; the K16/K17 folds are not ported and raise."""
    if p is None:
        return MultilevelParams(ncycles=0)
    if getattr(p, "fold_div", False) or getattr(p, "fold_correct", False):
        raise NotImplementedError("fold_div/fold_correct (K16/K17) are not "
                                  "ported yet (ROADMAP Queue 2)")
    tpu = p.tpu_nrelax
    return MultilevelParams(
        nrelax=max(p.nrelax, tpu), omega=float(p.omega),
        coarsest_relax=max(p.coarsest_relax, 2 * tpu, COARSEST_FLOOR),
        ncycles=p.ncycles, solver=p.solver)


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
    return ns.NSConfig(
        grid=grid_from_jax(cfg.grid),
        u_bcs=tuple(fieldbc_from_jax(b) for b in cfg.u_bcs),
        p_bc=fieldbc_from_jax(cfg.p_bc),
        advection=AdvectionParams(cfl=a.cfl, gradient=a.gradient,
                                  scheme=a.scheme, gc=a.gc),
        projection=params_from_jax(cfg.projection),
        approx_projection=params_from_jax(cfg.approx_projection),
        nu=float(cfg.nu), beta=float(cfg.beta),
        diffusion_params=params_from_jax(cfg.diffusion_params),
        div_in_src=bool(cfg.div_in_src))
