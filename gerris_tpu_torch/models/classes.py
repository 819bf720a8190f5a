"""The GfsPoisson and GfsAdvection simulation classes (port of
gerris_tpu/models/classes.py).

Reference: src/simulation.c -- GfsPoisson poisson_run:2213-2310 with the
compatibility correction correct_div:2156-2186; GfsAdvection
advection_run:2061-2121, which skips the projections and advects the
tracers with a prescribed velocity.  Both keep their fields on
``device`` (the CUDA card by default) in ``dtype``; the Poisson solve
runs the port's multigrid (K11, K12 and K3 on the card).
"""
from __future__ import annotations

import math

import torch

from ..core import bc as bcs
from ..core.device import default_device
from ..core.grid import Grid
from ..physics import solid as solidm
from ..physics import vof as vofm
from ..solvers import advection as adv
from ..solvers import poisson


def _field(v, grid: Grid, device, dtype) -> torch.Tensor:
    """A scalar, an array or tensor of the grid shape, or a callable of
    the numpy cell centres -> a contiguous tensor on ``device``."""
    if callable(v):
        v = v(*grid.centers)
    t = torch.as_tensor(v, dtype=dtype, device=device)
    return torch.broadcast_to(t, grid.shape).contiguous()


class PoissonSimulation:
    """GfsPoisson: solve div(alpha grad P) = Div once.

    ``solid_phi``: an optional fluid level set (fluid = {phi > 0}) for an
    embedded boundary (test/circle); ``surface_bc`` ("dirichlet" |
    "neumann", value) on its surface (SurfaceBc P ...,
    src/boundary.c surface_bc_read)."""

    def __init__(self, grid: Grid, p_bc: bcs.FieldBC = None,
                 params: poisson.MultilevelParams = None,
                 solid_phi=None, surface_bc=None, device=None,
                 dtype=torch.float64):
        self.grid = grid
        self.p_bc = p_bc or bcs.default_scalar_bc(grid.dim)
        self.params = params or poisson.MultilevelParams()
        self.solid_phi = solid_phi
        self.surface_bc = surface_bc
        self.device = default_device(device)
        self.dtype = dtype
        self.state = {}
        self.stats = None

    def init(self, Div):
        self.state["Div"] = _field(Div, self.grid, self.device, self.dtype)
        self.state["P"] = torch.zeros(self.grid.shape, dtype=self.dtype,
                                      device=self.device)
        return self

    def run(self):
        """Reference: poisson_run src/simulation.c:2213-2310."""
        grid = self.grid
        rhs = self.state["Div"]
        if self.solid_phi is not None:
            if self.surface_bc is not None and \
                    self.surface_bc[0] == "dirichlet":
                u, stats, a, _ = solidm.poisson_dirichlet_solve(
                    rhs, grid, self.solid_phi, self.surface_bc[1],
                    self.p_bc, self.params, u0=self.state["P"])
            else:
                u, stats, a, _ = solidm.poisson_solid_solve(
                    rhs, grid, self.solid_phi, self.p_bc, self.params,
                    u0=self.state["P"])
            self.state["A"] = a
        else:
            if not bcs.has_kind(self.p_bc, bcs.DIRICHLET):
                rhs = rhs - torch.mean(rhs)      # correct_div
            u, stats = poisson.solve(self.state["P"], rhs, grid, self.p_bc,
                                     self.params)
        self.state["P"] = u
        self.stats = stats
        return self


class AdvectionSimulation:
    """GfsAdvection: tracer advection with a prescribed velocity and no
    projection (reference: src/simulation.c:2061-2121).

    ``u_face``: the MAC velocities (a list of tensors), or a callable ``t
    -> list`` (a time-dependent stream function re-evaluated each step,
    src/variable.c GfsVariableStreamFunction).  ``tracers``: (name,
    FieldBC, is_vof) triples; ``gradients``: a per-tracer slope limiter
    over the van Leer default (VariableTracer { gradient = ... });
    ``breaks``: times where the velocity jumps, on which a step lands.
    Each step reads max|u| to the host once (its CFL dt)."""

    def __init__(self, grid: Grid, u_face, tracers, cfl: float = 0.5,
                 gradients=None, time=None, breaks=(), device=None,
                 dtype=torch.float64):
        self.grid = grid
        self.u_face = u_face
        self.tracers = tracers
        self.cfl = cfl
        self.gradients = dict(gradients or {})
        self.time = time
        self.breaks = sorted(breaks)
        self.device = default_device(device)
        self.dtype = dtype
        self.state = {}
        self.t = 0.0
        self.i = 0

    def init(self, **fields):
        for name, _, _ in self.tracers:
            self.state[name] = _field(fields.get(name, 0.0), self.grid,
                                      self.device, self.dtype)
        return self

    def _faces(self, t):
        return self.u_face(t) if callable(self.u_face) else self.u_face

    def _umax(self, uf) -> float:
        """max|u| over the faces, one read from the device."""
        return float(torch.stack([u.abs().max() for u in uf]).max())

    def run(self, t_end: float = None):
        if t_end is None:
            t_end = self.time.end
        for b in self.breaks:
            if self.t < b < t_end:
                self._run_segment(b)
        return self._run_segment(t_end)

    def _advance(self, uf, dt):
        grid = self.grid
        for name, fbc, is_vof in self.tracers:
            T = self.state[name]
            if is_vof:
                T = vofm.advect(T, uf, grid, fbc, dt,
                                cstart=self.i % grid.dim)
            else:
                uc_pad = adv.mac_cell_mean(uf, grid)
                par = adv.AdvectionParams(
                    gradient=self.gradients.get(name, "van_leer"))
                fvals = adv.advected_face_values(T, grid, fbc, dt, uc_pad,
                                                 par=par)
                vf = [adv.upwind_face_value(fvals[a][0], fvals[a][1],
                                            uf[a], a)
                      for a in range(grid.dim)]
                T = T + adv.flux_divergence(vf, uf, grid, dt)
            self.state[name] = T
        self.t += dt
        self.i += 1

    def _run_segment(self, t_end: float):
        grid = self.grid
        uf = self._faces(self.t)
        cfl = self.cfl
        if any(is_vof for _, _, is_vof in self.tracers):
            # the geometric VOF sweeps are stable to CFL 0.5; 0.45 as the
            # NS driver (gfs_vof_advect, src/vof.c)
            cfl = min(cfl, 0.45)
        dt = cfl * grid.h / max(self._umax(uf), 1e-300)
        nsteps = max(1, int(math.ceil((t_end - self.t) / dt)))
        dt = (t_end - self.t) / nsteps
        for _ in range(nsteps):
            uf = self._faces(self.t)
            # a time-dependent velocity can outgrow the segment's CFL
            # sizing: check each step and subdivide
            nsub = 1
            if callable(self.u_face):
                bound = cfl * grid.h / max(self._umax(uf), 1e-300)
                if dt > bound:
                    nsub = int(math.ceil(dt / bound))
            if nsub == 1:
                self._advance(uf, dt)
            else:
                t_sub_end = self.t + dt
                for _ in range(nsub):
                    self._advance(self._faces(self.t), dt / nsub)
                self.t = t_sub_end
        # land on the segment's end exactly: a break reached a few ulp
        # short would integrate the wrong branch for a whole step
        self.t = t_end
        return self
