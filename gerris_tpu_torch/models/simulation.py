"""Host-side simulation loop (port of gerris_tpu/models/simulation.py).

Owns time, events and the state dict of device tensors; the numerics are
models/ns.py.  Reference: src/simulation.c simulation_run:432-557 and
set_timestep:1569-1640.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..core import bc as bcs
from ..core.device import default_device
from ..physics.tension import stability_dt
from . import ns


@dataclasses.dataclass
class Time:
    """Reference: src/simulation.h GfsTime {t, i, end, iend, dtmax}."""
    t: float = 0.0
    i: int = 0
    end: float = math.inf
    iend: int = 2 ** 31
    dtmax: float = math.inf


class Simulation:
    """Incompressible NS simulation on a uniform grid.

        sim = Simulation(cfg, time=Time(end=300), events=[...],
                         dtype=torch.float32)
        sim.init(U=..., V=...)
        sim.run()

    ``device`` defaults to the CUDA card and raises without one; pass
    ``device="cpu"`` to run the kernels' plain versions on the CPU.
    ``particle_systems``: models/particle_system.ParticleSystem objects,
    each advanced in the event phase before every step (with
    cfg.particle_coupling their PF fields are the step's sources).
    """

    def __init__(self, cfg: ns.NSConfig, time: Time = None, events=None,
                 device=None, dtype=torch.float64, particle_systems=None):
        self.cfg = cfg
        self.time = time or Time()
        self.events = list(events or [])
        self.particle_systems = list(particle_systems or [])
        # the velocities before the last step (the particles' u_old)
        self.prev_state = None
        self.device = default_device(device)
        self.dtype = dtype
        self.state = {}
        self.stop = False
        self.dt = None
        self._tnext = None

    def init(self, **fields):
        """Fields by name (the velocities, P, Pmac, the tracers, the VOF
        tracers, e.g. ``T=vof.fraction_from_levelset(...)``, and with gc
        the gradients, with particle coupling PFx, PFy[, PFz]): a scalar,
        an array (numpy or torch) of the grid shape, or a callable of the
        cell-centre coordinates.  Missing fields start at zero."""
        grid = self.cfg.grid
        names = list(ns.velocity_names(grid.dim)) + ["P", "Pmac"] + \
            [tr[0] for tr in self.cfg.tracers] + \
            [v[0] for v in self.cfg.vof_tracers]
        if self.cfg.advection.gc:
            names += list(ns.gradient_names(grid.dim))
        if self.cfg.particle_coupling:
            names += ["PF" + ax for ax in "xyz"[:grid.dim]]
        for n in names:
            v = fields.get(n, 0.0)
            if callable(v):
                v = v(*grid.centers)
            t = torch.as_tensor(v, dtype=self.dtype, device=self.device)
            self.state[n] = torch.broadcast_to(t, grid.shape).contiguous()
        return self

    def set_timestep(self):
        """CFL timestep snapped to the next event time (reference:
        gfs_simulation_set_timestep src/simulation.c:1569; gerris_tpu
        simulation.py:91-105): with VOF tracers the CFL is at most 0.45
        (their sweeps need <= 0.5, src/vof.c:1654), then the capillary
        bound of each tension, CSS among them: both are the reference
        C's GfsSourceTensionGeneric, whose stability method gives it
        (src/tension.c:106-137; gerris_tpu's simulation.py:97-102 omits
        the CSS one, ROADMAP Queue 3).  Reads one number back from the
        device."""
        cfl = self.cfg.advection.cfl
        if self.cfg.vof_tracers:
            cfl = min(cfl, 0.45)
        dt = cfl * float(ns.timescale(self.state, self.cfg))
        dt = min(dt, self.time.dtmax)
        for _, sigma in self.cfg.tension + self.cfg.tension_css:
            r1, r2 = (1.0, 1.0) if self.cfg.density is None else \
                (self.cfg.density[1], self.cfg.density[2])
            dt = min(dt, stability_dt(self.cfg.grid, sigma, r1, r2))
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

    def do_end_events(self):
        for e in self.events:
            if e.at_end:
                e.fire(self, self.time.t, self.time.i)

    def run(self, max_steps: Optional[int] = None):
        """Reference: simulation_run src/simulation.c:432-557."""
        self.set_timestep()
        if self.time.i == 0:
            self.state = ns.initial_projection(self.state, self.dt,
                                               self.time.t, self.cfg)
            self.set_timestep()
        steps = 0
        while (self.time.t < self.time.end and self.time.i < self.time.iend
               and not self.stop):
            self.do_events()
            if self.stop:
                break
            # the particle and bubble systems advance in the event phase
            # with the current fields (the GfsParticleList event,
            # modules/particulatecommon.c:955-1010)
            for psys in self.particle_systems:
                psys.step(self)
            self.prev_state = {n: self.state[n]
                               for n in ns.velocity_names(self.cfg.dim)}
            self.state = ns.ns_step(self.state, self.dt, self.time.t,
                                    self.cfg, first_step=self.time.i == 0,
                                    cstart=self.time.i % self.cfg.dim)
            self.time.t = self._tnext
            self.time.i += 1
            self.set_timestep()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        self.do_events()
        self.do_end_events()
        return self

    def field_bc(self, name: str) -> bcs.FieldBC:
        names = ns.velocity_names(self.cfg.grid.dim)
        if name in names:
            return self.cfg.u_bcs[names.index(name)]
        if name in ("P", "Pmac"):
            return self.cfg.p_bc
        for tr in self.cfg.tracers:
            if tr[0] == name:
                return tr[1]
        return bcs.default_scalar_bc(self.cfg.grid.dim)

    def interpolate(self, name: str, points):
        """Bilinear interpolation of a cell field at physical points, on
        the field padded with its BC ghosts (reference: gfs_interpolate
        src/fluid.c:2697).  Runs on the host."""
        grid = self.cfg.grid
        f = bcs.apply_bc(self.state[name], grid, self.field_bc(name),
                         1).cpu().numpy()
        pts = np.atleast_2d(np.asarray(points, dtype=float))
        out = np.empty(pts.shape[0])
        for k, pt in enumerate(pts):
            idx, w = [], []
            for a in range(grid.dim):
                x = (pt[a] - grid.origin[a]) / grid.h + 0.5
                i0 = int(np.floor(x))
                idx.append((min(max(i0, 0), grid.shape[a] + 1),
                            min(max(i0 + 1, 0), grid.shape[a] + 1)))
                w.append(x - i0)
            val = 0.0
            for corner in range(2 ** grid.dim):
                wt = 1.0
                ii = []
                for a in range(grid.dim):
                    b = (corner >> a) & 1
                    wt *= w[a] if b else (1.0 - w[a])
                    ii.append(idx[a][b])
                val += wt * f[tuple(ii)]
            out[k] = val
        return out if out.size > 1 else float(out[0])
