#!/usr/bin/env python3
"""Short adaptive runs of the JAX package, gerris_tpu, on the CPU in
float64: the reference values that tests/test_torch_amr_ns.py holds the
port's composite step (gerris_tpu_torch/models/amr_ns.py) to.

    python3 tools/amr_reference.py [CASE ...] [--out OUT.json]
    python3 tools/amr_reference.py --oscillation LEVEL [--port]

Each case builds the same configuration in both packages (``build``)
and runs the JAX AMRSimulation eagerly (jax.disable_jit): init, the
initial projection and STEPS[case] steps.
  osc_block  test/oscillation's droplet (tests/test_amr_ns.py:
             run_oscillation_amr) at maxlevel 5, adapting every step,
             composite_vof and block_advect on the block engine;
  osc_dense  the same with the interface pinned (composite_vof off) on
             the dense mask engine (the block engine switched off);
  lid_block  the lid cavity (nu 1e-2) adapting on the velocity's Hessian
             (istep 1, cmax 1, minlevel 3, maxlevel 5) from a seeded
             velocity, block_advect on: the unit-coefficient block solves
             and their scalar-dia diffusion;
  drop_block the interface-not-pinned droplet of tests/test_amr_ns.py:
             density 1/0.5, nu 5e-3, composite_vof, the Hessian
             criterion (cmax 0.05, cfactor 2, minlevel 3, maxlevel 5),
             from the seeded velocity: the block engine's cell-dia
             diffusion;
  capwave    test/capwave's graded static mesh (capwave_mesh) at level 5
             on its 1 x 3 box, periodic in x: the dense engine, a box,
             the scalar-dia diffusion;
  lid3d      a 3D lid cavity (nu 1e-2) on a static mesh refined around
             a sphere, levels 2-3, from a seeded velocity: the dense
             engine in 3D.
For each field and level of the final state it prints ``projections``,
the sums of the field times NPROJ fixed fields of normal deviates
(numpy.random.default_rng(seed k)), with the leaf counts after each
adaptation and the run's last dt, as one JSON line per case, also written
to OUT.json when given.  About 10 minutes on the CPU for every case.
With ``--oscillation LEVEL`` it runs tests/test_amr_ns.py's oscillation
(pinned and composite VOF) to t = 1 at that level instead, on the JAX
package (jitted, as the test runs it) or with ``--port`` on the port on
the CPU, and prints the fit's c and b and the mean leaf ratio (level 5:
~3 min each on the JAX package).  It imports jax and gerris_tpu; the port
and chip_smoke.py import neither.
"""
import dataclasses
import json
import math
import os
import sys
import time

import numpy as np

CASES = ("osc_block", "osc_dense", "lid_block", "drop_block", "capwave",
         "lid3d")
STEPS = {"osc_block": 2, "osc_dense": 2, "lid_block": 2, "drop_block": 2,
         "capwave": 2, "lid3d": 1}
NPROJ = 2
OSC_D, OSC_EPS = 0.2, 0.05


def weights(k, shape):
    """The k-th projection's field of normal deviates."""
    return np.random.default_rng(k).standard_normal(shape)


def projections(state):
    """{field: {level: [sum(w_k f) for k < NPROJ]}} of a state of numpy
    arrays {name: {level: array}}."""
    return {name: {str(l): [float(np.sum(weights(k, np.shape(a))
                                         * np.asarray(a, np.float64)))
                            for k in range(NPROJ)]
                   for l, a in lv.items()} for name, lv in state.items()}


def osc_phi(x, y, lib):
    """test/oscillation's perturbed droplet, fluid inside."""
    xx, yy = x + 0.5, y + 0.5
    r = OSC_D / 2.0 * (1.0 + OSC_EPS * lib.cos(2.0 * lib.arctan2(yy, xx)))
    return r * r - (xx * xx + yy * yy)


def seeded_velocity(x, y, lib):
    """The lid cases' seeded velocity of the cell centres."""
    u = 0.1 * lib.sin(2 * math.pi * x) * lib.cos(math.pi * y) + 0.05
    v = 0.1 * lib.cos(3 * math.pi * x) * lib.sin(math.pi * (y + 0.5))
    return u, v


def modules(pkg):
    """The (bc, ns, amr_ns, poisson, Grid, CompositeGrid, vof) modules of
    ``pkg``, "jax" (gerris_tpu) or "torch" (gerris_tpu_torch)."""
    import importlib
    root = "gerris_tpu" if pkg == "jax" else "gerris_tpu_torch"
    m = {k: importlib.import_module(f"{root}.{p}") for k, p in (
        ("bc", "core.bc"), ("ns", "models.ns"), ("amr_ns", "models.amr_ns"),
        ("poisson", "solvers.poisson"), ("grid", "core.grid"),
        ("composite", "solvers.composite"), ("vof", "physics.vof"))}
    return m


def hessian_criterion(pkg, channel="U"):
    """The Hessian-only criterion of tests/test_amr_ns.py (no interface
    indicator): c2 = hessian_cost of ``channel``."""
    amr_ns = modules(pkg)["amr_ns"]

    def criterion(s):
        g = s.topo.grid(s.topo.lmax)
        return None, None, amr_ns.hessian_cost(s.fine(channel), g,
                                               s.cfg.u_bcs[0], t=s.time.t)
    return criterion


def build(case, pkg, level=5):
    """(cfg, kwargs of AMRSimulation, the kinds of its initial fields,
    dense) of ``case`` in ``pkg`` at maxlevel ``level`` (the 2D cases;
    lid3d's levels are fixed); ``dense``: switch the block engine
    off."""
    m = modules(pkg)
    bc, ns, amr_ns, po = m["bc"], m["ns"], m["amr_ns"], m["poisson"]
    Grid, CG = m["grid"].Grid, m["composite"].CompositeGrid
    if case.startswith("osc"):
        tbc = bc.default_scalar_bc(2)
        proj = po.MultilevelParams(tolerance=1e-4, nitermax=100)
        composite = case == "osc_block"
        cfg = ns.NSConfig(
            grid=Grid(level=level, dim=2),
            u_bcs=(bc.velocity_bc(0, 2), bc.velocity_bc(1, 2)), nu=0.0,
            vof_tracers=(("T", tbc),), tension=(("T", 1.0),),
            density=("T", 1.0, 1e-3, 1), composite_vof=composite,
            block_advect=composite, projection=proj, approx_projection=proj)
        adapt = amr_ns.AdaptSpec(
            criterion=amr_ns.interface_vorticity_criterion, cmax=0.01,
            minlevel=3, maxlevel=level, istep=1)
        return cfg, dict(adapt=adapt), ("osc",), not composite
    if case in ("lid_block", "drop_block"):
        u_bc = bc.FieldBC.make(2, default=bc.Dirichlet(0.0),
                               top=bc.Dirichlet(1.0))
        v_bc = bc.FieldBC.uniform(bc.Dirichlet(0.0), 2)
        proj = po.MultilevelParams(tolerance=1e-6, nitermax=50)
        if case == "lid_block":
            cfg = ns.NSConfig(grid=Grid(level=level, dim=2),
                              u_bcs=(u_bc, v_bc), nu=1e-2, beta=1.0,
                              block_advect=True, projection=proj,
                              approx_projection=proj)
            adapt = amr_ns.AdaptSpec(criterion=hessian_criterion(pkg),
                                     cmax=1.0, minlevel=3, maxlevel=level,
                                     istep=1)
            return cfg, dict(adapt=adapt), ("seeded",), False
        cfg = ns.NSConfig(
            grid=Grid(level=level, dim=2), u_bcs=(u_bc, v_bc), nu=5e-3,
            beta=1.0, vof_tracers=(("T", bc.default_scalar_bc(2)),),
            composite_vof=True, density=("T", 1.0, 0.5, 1),
            projection=proj, approx_projection=proj)
        adapt = amr_ns.AdaptSpec(criterion=hessian_criterion(pkg), cmax=0.05,
                                 cfactor=2.0, minlevel=3, maxlevel=level,
                                 istep=1)
        return cfg, dict(adapt=adapt), ("drop", "seeded"), False
    if case == "capwave":
        per = (bc.Periodic(), bc.Periodic())
        nn = (bc.Neumann(), bc.Neumann())
        proj = po.MultilevelParams(tolerance=1e-6, nitermax=100)
        cfg = ns.NSConfig(
            grid=Grid(level=level, dim=2, origin=(-0.5, -1.5),
                      extents=(1, 3)),
            u_bcs=(bc.FieldBC((per, nn)),
                   bc.FieldBC((per, (bc.Dirichlet(0.0),
                                     bc.Dirichlet(0.0))))),
            nu=0.0182571749236, beta=1.0,
            vof_tracers=(("T", bc.FieldBC((per, nn))),),
            tension=(("T", 1.0),), projection=proj, approx_projection=proj,
            diffusion_params=po.MultilevelParams(tolerance=1e-6,
                                                 nitermax=20))
        base = Grid(level=3, dim=2, origin=(-0.5, -1.5), extents=(1, 3))
        mesh = CG.from_refine_fn(base, level, lambda x, y, l: np.floor(
            level + 1 - (level - 2) * np.abs(y) / 1.5) > l)
        return cfg, dict(mesh=mesh), ("capwave",), False
    if case == "lid3d":
        u_bc = bc.FieldBC.make(3, default=bc.Dirichlet(0.0),
                               top=bc.Dirichlet(1.0))
        w_bc = bc.FieldBC.uniform(bc.Dirichlet(0.0), 3)
        proj = po.MultilevelParams(tolerance=1e-6, nitermax=50)
        cfg = ns.NSConfig(grid=Grid(level=3, dim=3),
                          u_bcs=(u_bc, w_bc, w_bc), nu=1e-2, beta=1.0,
                          projection=proj, approx_projection=proj)
        mesh = CG.from_refine_fn(Grid(level=2, dim=3), 3,
                                 lambda x, y, z, l: x * x + y * y + z * z
                                 < 0.3 ** 2)
        return cfg, dict(mesh=mesh), ("seeded",), False
    raise ValueError(case)


def init_fields(cfg, spec, pkg):
    """The case's initial fields at the finest level, numpy."""
    m = modules(pkg)
    grid = cfg.grid
    x = np.asarray(grid.centers[0])
    y = np.asarray(grid.centers[1])
    out = {}
    if "seeded" in spec:
        u, v = seeded_velocity(x, y, np)
        out.update(U=u, V=v)
        if grid.dim == 3:
            out["W"] = 0.05 * np.sin(math.pi * np.asarray(grid.centers[2]))
    kind = spec[0]
    if kind == "seeded":
        return out
    vof = m["vof"]
    if pkg == "jax":
        import jax.numpy as lib
        kw = {}
    else:
        import torch as lib
        kw = {"device": "cpu", "dtype": lib.float64}
    if kind == "osc":
        phi = lambda xx, yy: osc_phi(xx, yy, lib)
    elif kind == "drop":
        phi = lambda xx, yy: 0.15 - lib.sqrt(xx ** 2 + (yy + 0.15) ** 2)
    else:
        phi = lambda xx, yy: yy - 0.01 * lib.cos(2 * math.pi * xx)
    T = vof.fraction_from_levelset(grid, phi, **kw)
    out["T"] = np.asarray(T) if pkg == "jax" else T.numpy()
    return out


def jax_run(case, steps, level=5):
    """The JAX AMRSimulation of ``case`` at ``level``, run eagerly
    (jax.disable_jit) through init, the initial projection and ``steps``
    steps: ({"blocks", "leaves", "dt"}, its state {name: {level: numpy
    array}})."""
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from gerris_tpu.models.amr_ns import AMRSimulation
    from gerris_tpu.models.simulation import Time
    cfg, kw, spec, dense = build(case, "jax", level)
    sim = AMRSimulation(cfg, time=Time(end=10.0), **kw)
    if dense:
        sim._use_blocks, sim._brt, sim._btables = False, None, None
    fields = {k: jnp.asarray(v)
              for k, v in init_fields(cfg, spec, "jax").items()}
    with jax.disable_jit():
        sim.init(**fields)
        sim.run(max_steps=steps)
    state = {n: {l: np.asarray(a) for l, a in lv.items()}
             for n, lv in sim.state.items()}
    return ({"blocks": bool(sim._use_blocks),
             "leaves": [int(n) for n in sim.leaf_history] or
             [int(sim.n_leaves())], "dt": float(sim.dt)}, state)


def run_jax(case):
    info, state = jax_run(case, STEPS[case])
    return {"case": case, **info, "projections": projections(state)}


def oscillation(level, composite, pkg="jax"):
    """tests/test_amr_ns.py:run_oscillation_amr at ``level`` to t = 1 in
    ``pkg`` (the JAX package jitted as the test runs it, or the port on
    the CPU), in float64: the kinetic energy every step fitted by a
    exp(-b t) (1 - cos c t).  Returns (c, b, mean leaves / uniform,
    steps)."""
    from scipy.optimize import curve_fit
    m = modules(pkg)
    amr_ns, vof = m["amr_ns"], m["vof"]
    from importlib import import_module
    root = "gerris_tpu" if pkg == "jax" else "gerris_tpu_torch"
    Time = import_module(f"{root}.models.simulation").Time
    Event = import_module(f"{root}.events.events").Event
    cfg, _, _, _ = build("osc_block" if composite else "osc_dense", pkg)
    cfg = dataclasses.replace(cfg, grid=m["grid"].Grid(level=level),
                              block_advect=False)
    adapt = amr_ns.AdaptSpec(criterion=amr_ns.interface_vorticity_criterion,
                             cmax=0.01, minlevel=3, maxlevel=level, istep=1)
    ke = []
    if pkg == "jax":
        import jax
        jax.config.update("jax_enable_x64", True)
        import jax.numpy as lib
        kw = {}
    else:
        import torch as lib
        kw = {"device": "cpu"}

    def record(sim):
        T, U, V = sim.fine("T"), sim.fine("U"), sim.fine("V")
        rho = 1e-3 + lib.clip(T, 0, 1) * (1.0 - 1e-3)
        ke.append((sim.time.t, float(lib.sum(rho * (U ** 2 + V ** 2)))
                   * cfg.grid.cell_volume))

    sim = amr_ns.AMRSimulation(cfg, adapt=adapt, time=Time(end=1.0),
                               events=[Event(action=record, istep=1)], **kw)
    T0 = vof.fraction_from_levelset(
        cfg.grid, lambda x, y: osc_phi(x, y, lib),
        **({} if pkg == "jax" else {"device": "cpu", "dtype": lib.float64}))
    sim.init(T=T0)
    sim.run()
    k = np.array(ke)
    omega0 = math.sqrt(6.0 / ((1.0 + 1e-3) * (OSC_D / 2) ** 3))
    (a, b, c), _ = curve_fit(
        lambda t, a, b, c: a * np.exp(-b * t) * (1.0 - np.cos(c * t)),
        k[:, 0], k[:, 1], p0=(3e-4, 1.5, 2 * omega0), maxfev=20000)
    return (float(c), float(b),
            float(np.mean(sim.leaf_history)) / (1 << level) ** 2,
            sim.time.i)


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    if "--oscillation" in sys.argv:
        level = int(sys.argv[sys.argv.index("--oscillation") + 1])
        pkg = "torch" if "--port" in sys.argv else "jax"
        for composite in (False, True):
            t0 = time.time()
            c, b, ratio, steps = oscillation(level, composite, pkg)
            print(json.dumps({"oscillation_level": level, "package": pkg,
                              "composite": composite, "c": c, "b": b,
                              "leaf_ratio": ratio, "steps": steps,
                              "seconds": time.time() - t0}))
        return
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    out_path = sys.argv[sys.argv.index("--out") + 1] \
        if "--out" in sys.argv else None
    cases = [a for a in args if a in CASES] or list(CASES)
    res = {}
    for case in cases:
        t0 = time.time()
        res[case] = run_jax(case)
        print(json.dumps(res[case]))
        print(f"{case}: {time.time() - t0:.1f} s", file=sys.stderr)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(res, f)


if __name__ == "__main__":
    main()
