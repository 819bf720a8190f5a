#!/usr/bin/env python3
"""Two-way coupled particle and bubble runs on the JAX package, gerris_tpu,
on the CPU in float64: the reference values that
tests/test_torch_particle_system.py holds the port's to.

    python3 tools/particles_reference.py [OUT.json]

Two cases at level 5 (32^2) on a doubly periodic box, nu 1e-3, the
seeded velocity of ``initial_state``, dtmax 0.01, every solve adaptive to
1e-3 with its dense coarsest solve at 8^2 (``params``); the JAX
Simulation runs init + STEPS steps eagerly (jax.disable_jit) with one
ParticleSystem:
* "gaussian": 16 particles (``particles``), the five default forces at
  gravity 0, two-way, the Gaussian deposit of radius 1.5 h over 7^2 cells;
* "bubbles": 16 bubbles of radius 0.01-0.012 with gas pressure 1e-3
  (Rayleigh-Plesset, 8 substeps, with their interactions), two-way, the
  bilinear deposit, drag and added mass.
At gravity 0 the JAX package's reaction force (buoyancy included) and the
reference C's (without it, as the port's) agree.  For every field (P
and Pmac mean-free) and every array of the particle state it prints the
sums of the array times NPROJ fixed arrays of normal deviates
(numpy.random.default_rng(seed k)), as one JSON line, also written to
OUT.json when given.  About a minute on the CPU.  It imports jax and
gerris_tpu; the port and chip_smoke.py import neither.
"""
import json
import math
import os
import sys
import time

import numpy as np

LEVEL = 5
STEPS = 3
NPART = 16
NU = 1e-3
DTMAX = 0.01
NPROJ = 2
FIELDS = ("U", "V", "P", "Pmac", "Gx", "Gy", "PFx", "PFy")
CASES = ("gaussian", "bubbles")


def initial_state(x, y):
    """The seeded velocity: U and V of the cell centres (numpy)."""
    u = 0.3 + 0.1 * np.sin(2 * math.pi * y)
    v = 0.1 * np.cos(2 * math.pi * x)
    return u, v


def params():
    """The schedule of every solve: MultilevelParams' fields."""
    return dict(tolerance=1e-3, nitermax=100, nrelax=4, coarsest_relax=8,
                dense_coarse_max=64)


def particles(case):
    """The particles' numpy arrays and the ParticleConfig's and
    BubbleConfig's fields of ``case``."""
    rng = np.random.default_rng(7)
    pos = rng.uniform(-0.45, 0.45, (NPART, 2))
    vel = 0.05 * rng.standard_normal((NPART, 2))
    h = 1.0 / (1 << LEVEL)
    if case == "gaussian":
        vol = rng.uniform(1e-4, 3e-4, NPART)
        arrays = dict(pos=pos, vel=vel, vol=vol, mass=5.0 * vol)
        return arrays, dict(capacity=NPART, two_way=True, rkernel=1.5 * h,
                            kernel_cells=3), None
    R = rng.uniform(0.01, 0.012, NPART)
    arrays = dict(pos=pos, vel=vel, R=R, p0=np.full(NPART, 1e-3))
    return arrays, dict(capacity=NPART, two_way=True,
                        forces=("drag", "added_mass")), \
        dict(model="rp", substeps=8, interactions=True)


def weights(k, shape):
    """The k-th projection's array of normal deviates."""
    return np.random.default_rng(k).standard_normal(shape)


def projections(state, names):
    """{name: [sum(w_k a) for k < NPROJ]} of the arrays of ``state`` (numpy
    or CPU torch), P and Pmac mean-free, alive as 0/1."""
    out = {}
    for name in names:
        a = np.asarray(state[name], dtype=np.float64)
        if name in ("P", "Pmac"):
            a = a - a.mean()
        out[name] = [float(np.sum(weights(k, a.shape) * a))
                     for k in range(NPROJ)]
    return out


def mismatches(state, ref, rtol):
    """The (name, k) of ``ref`` (projections) whose projection of
    ``state`` lies further from it than rtol times its scale, the sum of
    the absolute products."""
    out = []
    for name in ref:
        a = np.asarray(state[name], dtype=np.float64)
        if name in ("P", "Pmac"):
            a = a - a.mean()
        for k in range(NPROJ):
            wa = weights(k, a.shape) * a
            if abs(np.sum(wa) - ref[name][k]) > rtol * max(
                    np.sum(np.abs(wa)), 1e-300):
                out.append((name, k))
    return out


def main():
    os.environ["JAX_PLATFORMS"] = "cpu"
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    sys.path.insert(0, root)
    import jax
    jax.config.update("jax_enable_x64", True)
    from gerris_tpu.core import bc
    from gerris_tpu.core.grid import Grid
    from gerris_tpu.models import ns
    from gerris_tpu.models.particle_system import ParticleSystem
    from gerris_tpu.models.simulation import Simulation, Time
    from gerris_tpu.physics import bubbles, particles as parts
    from gerris_tpu.solvers.poisson import MultilevelParams

    grid = Grid(LEVEL)
    per = bc.periodic_bc(2)
    mp = MultilevelParams(**params())
    cfg = ns.NSConfig(grid=grid, u_bcs=(per, per), nu=NU,
                      particle_coupling=True, projection=mp,
                      approx_projection=mp, diffusion_params=mp)
    x, y = (np.asarray(c) for c in grid.centers)
    u, v = initial_state(x, y)
    res = {"level": LEVEL, "steps": STEPS}
    t0 = time.perf_counter()
    for case in CASES:
        arrays, pkw, bkw = particles(case)
        pcfg = parts.ParticleConfig(**pkw)
        if bkw is None:
            state = parts.make_particles(NPART, 2, **arrays)
            psys = ParticleSystem(pcfg, state)
        else:
            state = bubbles.make_bubbles(NPART, 2, **arrays)
            psys = ParticleSystem(pcfg, state,
                                  bubble_cfg=bubbles.BubbleConfig(**bkw))
        with jax.disable_jit():
            sim = Simulation(cfg, time=Time(dtmax=DTMAX),
                             particle_systems=[psys])
            sim.init(U=u, V=v)
            sim.run(max_steps=STEPS)
        res[case] = {"fields": projections(sim.state, FIELDS),
                     "particles": projections(
                         psys.state, sorted(k for k in psys.state
                                            if k != "alive")),
                     "alive": int(np.sum(np.asarray(psys.state["alive"]))),
                     "t": float(sim.time.t)}
    res["seconds"] = time.perf_counter() - t0
    print(json.dumps(res))
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
