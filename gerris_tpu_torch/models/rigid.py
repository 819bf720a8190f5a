"""Rigid bodies moved by the fluid (port of gerris_tpu/models/rigid.py).

The reference's ode module (modules/ode.c, GfsSolidMovingOde) couples a
moving solid to a rigid body: the fluid's force on the body, the pressure
and viscous surface integrals of OutputSolidForce (gfs_domain_solid_force,
src/domain.c:3502-3545), drives the body, and the body's motion moves the
solid.  Here the body's position and velocity are 0-d tensors on the
device, passed to the moving-solid step as its ``solid_args``: a step
reads nothing back from the device for the force or the motion, and the
history holds tensors, read at the end (RigidBodyDriver.trajectory).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import bc as bcs
from ..core.device import default_device
from ..ops.stencils import center_gradient
from ..physics.solid import solid_fractions
from . import ns


@dataclasses.dataclass
class RigidBody:
    """A translating 2D rigid body: its mass, position and velocity
    (floats, or 0-d tensors once a RigidBodyDriver moves it) and the body
    force per unit mass on it (``gravity``; the buoyancy comes from the
    pressure integral)."""
    mass: float
    pos: tuple = (0.0, 0.0)
    vel: tuple = (0.0, 0.0)
    gravity: tuple = (0.0, 0.0)


def solid_force(state: dict, cfg: ns.NSConfig, t: float, solid_args=None):
    """(Fx, Fy), 0-d tensors: the fluid's force on the moving solid at time
    ``t`` (``solid_args`` passed on to its level set), the pressure times
    each cut cell's surface element (minus the face-fraction differences
    times h), and with nu > 0 the viscous stress 2 nu D of the centred
    velocity gradients on them (reference rigid.py:35-70,
    gfs_domain_solid_force src/domain.c:3502)."""
    grid = cfg.grid
    p = state["P"]
    extra = tuple(solid_args) if solid_args is not None else ()
    a, (sx, sy) = solid_fractions(
        grid, lambda x, y: cfg.solid_phi(x, y, t, *extra), p.device, p.dtype)
    h = grid.h
    nsx = -(sx[1:, :] - sx[:-1, :]) * h
    nsy = -(sy[:, 1:] - sy[:, :-1]) * h
    mixed = (a > 0.0) & (a < 1.0)
    fx = torch.where(mixed, p * nsx, 0.0).sum()
    fy = torch.where(mixed, p * nsy, 0.0).sum()
    if cfg.nu > 0.0:
        g = []
        for c, n in enumerate(ns.velocity_names(2)):
            pad = bcs.apply_bc(state[n], grid, cfg.u_bcs[c], 1, t=t)
            g.append([center_gradient(pad, grid, ax) for ax in range(2)])
        txx = 2.0 * cfg.nu * g[0][0]
        tyy = 2.0 * cfg.nu * g[1][1]
        txy = cfg.nu * (g[0][1] + g[1][0])
        fx = fx - torch.where(mixed, txx * nsx + txy * nsy, 0.0).sum()
        fy = fy - torch.where(mixed, txy * nsx + tyy * nsy, 0.0).sum()
    return fx, fy


class RigidBodyDriver:
    """One translating rigid body coupled to the moving-solid step.

    ``shape_phi(x, y, cx, cy)``: the body's level set about its centre
    (cx, cy), the fluid where it is positive.  The configuration's
    ``solid_phi`` and ``surface_u`` read the centre and the velocity from
    the step's ``solid_args`` (reference rigid.py:73-118; modules/ode.c
    re-cuts and re-integrates every step the same way).  The fluid starts
    at rest; ``cfg_kw`` go to the NSConfig.  A callable surface velocity
    in a viscous step is refused, as the reference cannot evaluate it
    there (models/ns.solid_velocity_diffusion): a body takes nu = 0, as
    the reference's tests do."""

    def __init__(self, grid, u_bcs, shape_phi, body: RigidBody, nu=0.0,
                 device=None, dtype=torch.float64, **cfg_kw):
        def phi(x, y, t, cx, cy, vx, vy):
            return shape_phi(x, y, cx, cy)

        def us_u(x, y, t, cx, cy, vx, vy):
            return vx

        def us_v(x, y, t, cx, cy, vx, vy):
            return vy

        self.cfg = ns.NSConfig(grid=grid, u_bcs=u_bcs, nu=nu,
                               solid_phi=phi, moving_solid=True,
                               surface_u=(us_u, us_v), **cfg_kw)
        device = default_device(device)

        def scalars(v):
            return tuple(torch.as_tensor(x, dtype=dtype, device=device)
                         for x in v)
        self.body = dataclasses.replace(body, pos=scalars(body.pos),
                                        vel=scalars(body.vel))
        z = torch.zeros(grid.shape, dtype=dtype, device=device)
        self.state = {n: z for n in ("U", "V", "P", "Pmac", "Gx", "Gy")}
        self.t = 0.0
        self.i = 0
        self.history = []

    def step(self, dt: float) -> dict:
        """One step of the fluid with the body's solid at its position and
        velocity, then the body moved by the force at t + dt (explicit
        Euler, as the reference's).  No read from the device."""
        b = self.body
        args = (*b.pos, *b.vel)
        self.state = ns.ns_step(self.state, dt, self.t, self.cfg,
                                first_step=(self.i == 0), solid_args=args)
        fx, fy = solid_force(self.state, self.cfg, self.t + dt, args)
        ax = fx / b.mass + b.gravity[0]
        ay = fy / b.mass + b.gravity[1]
        self.body = dataclasses.replace(
            b, pos=(b.pos[0] + dt * b.vel[0], b.pos[1] + dt * b.vel[1]),
            vel=(b.vel[0] + dt * ax, b.vel[1] + dt * ay))
        self.t += dt
        self.i += 1
        self.history.append((self.t, self.body.pos, self.body.vel,
                             (fx, fy)))
        return self.state

    def trajectory(self) -> np.ndarray:
        """The history as one (steps, 7) float64 array of t, x, y, u, v,
        Fx, Fy, read from the device at once."""
        if not self.history:
            return np.zeros((0, 7))
        rows = torch.stack([torch.stack([*pos, *vel, *f]).double()
                            for _, pos, vel, f in self.history])
        t = np.array([[h[0]] for h in self.history])
        return np.hstack([t, rows.cpu().numpy()])
