"""Particle and bubble systems in the Simulation loop (port of
gerris_tpu/models/particle_system.py).

The reference's GfsParticleList event container (modules/
particulatecommon.c: particulatecommon.h:53-61, the list event :955-1010,
the two-way sources GfsSourceParticulate:2089 and GfsParticulateField:1929;
bubbles modules/bubbles.c).  The reference runs each particle's event in
the event phase of every iteration; here the whole array advances in one
call before each fluid step, with no read back to the host.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..physics import bubbles as bub
from ..physics import particles as parts
from . import ns


class ParticleSystem:
    """A particle (or, with ``bubble_cfg``, bubble) state that advances
    each step.  With ``pcfg.two_way`` it writes the reaction-force
    densities PFx, PFy[, PFz] into the simulation's state (read by ns_step
    when cfg.particle_coupling is on); the systems after the first add to
    the fields of those before.  The force deposited is the one without
    buoyancy, as the reference C gives the fluid (compute_forces_onfluid,
    particulatecommon.c:754-766); gerris_tpu deposits the total
    (ROADMAP Queue 3)."""

    def __init__(self, pcfg: parts.ParticleConfig, state: dict,
                 bubble_cfg: Optional[bub.BubbleConfig] = None,
                 rho_liq: float = 1.0, name: str = "particles"):
        self.pcfg = pcfg
        self.state = state
        self.bubble_cfg = bubble_cfg
        self.rho_liq = rho_liq
        self.name = name
        # the force on each particle in the last step, buoyancy included
        self.last_force = None

    def n_alive(self) -> int:
        """The live particles (one read from the device)."""
        return int(torch.sum(self.state["alive"]))

    def step(self, sim):
        cfg = sim.cfg
        grid = cfg.grid
        names = ns.velocity_names(grid.dim)
        U = [sim.state[n] for n in names]
        U_old = [sim.prev_state[n] for n in names] if sim.prev_state else U
        if self.bubble_cfg is not None:
            self.state, total, hydro = bub.step_bubbles(
                self.state, U, U_old, sim.state["P"], grid,
                list(cfg.u_bcs), cfg.p_bc, self.pcfg, self.bubble_cfg,
                cfg.nu, self.rho_liq, sim.dt, sim.time.t)
        else:
            self.state, total, hydro = parts.step_particles(
                self.state, U, U_old, grid, list(cfg.u_bcs), self.pcfg,
                cfg.nu, sim.dt, sim.time.t)
        self.last_force = total
        if self.pcfg.two_way:
            fields = parts.reaction_force_fields(hydro, self.state, grid,
                                                 self.pcfg)
            first = sim.particle_systems.index(self) == 0
            for c, ax in enumerate("xyz"[:grid.dim]):
                key = "PF" + ax
                acc = fields[c] / self.pcfg.fluid_rho
                sim.state[key] = acc if first or key not in sim.state \
                    else sim.state[key] + acc
