#!/usr/bin/env python3
"""The float32 floor of the port's 2D routes, for one checkout of
gerris_tpu_torch on a card: how far each route's plain float32 run lies
from its plain float64 run.

    python3 tools/torch_f32_floor.py [ROOT] [ROUTE ...]
    python3 tools/torch_f32_floor.py --cpu LEVEL [LEVEL ...]

ROOT is the checkout to measure (default: the one holding this script);
its gerris_tpu_torch and chip_smoke.py are imported.  Each route runs
through the plain versions on the card (chip_smoke.plain_versions: no
kernel launches, so a checkout whose kernels do not take a route's
levels runs it all the same) for its chip_smoke check steps, once in
float32 and once in float64, from the same state at rest:
* ``twophase``: chip_smoke.twophase_cfg, 1024^2, 5 steps;
* ``bubble``: chip_smoke.bubble_cfg, 1024 x 2048, 5 steps;
* ``spurious``, ``spurious_css``: chip_smoke.spurious_cfg, 1024^2, 5
  steps;
* ``tracer``: the 2048^2 cavity with the tracer C (chip_smoke.tracer_sim),
  5 steps;
* ``capwave``: tests/test_capwave.py's configuration at 1024 x 3072
  (written out here, as chip_smoke.capwave_cfg gives it), 2 steps.
It prints one line per route with max|a - b| / max|b| of U, V, T (C for
the tracer) and the mean-free P, the float32 run against the float64
run: the quantity chip_smoke.check_against_plain calls the floor.  Run
it on the parent (git archive into a directory that .gitignore lists)
and on the change in one call to see what a change of the float32
arithmetic did to each route.  With ``--cpu`` it runs the capwave route
on the CPU at each LEVEL instead (2 steps; 7 to 9 take seconds to a
minute) and prints the same distances beside max|U|, max|V| and the
largest absolute difference of U and V: how the floor scales with the
level.
"""
import dataclasses
import json
import math
import sys
import time
from pathlib import Path

ROUTES = ("twophase", "bubble", "spurious", "spurious_css", "tracer",
          "capwave")


def capwave_cfg(level):
    """tests/test_capwave.py's configuration at 2^level x 3 2^level."""
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.models import ns
    from gerris_tpu_torch.solvers.poisson import MultilevelParams
    per = (bc.Periodic(), bc.Periodic())
    nn = (bc.Neumann(), bc.Neumann())
    proj = MultilevelParams(tolerance=1e-6, nitermax=100)
    return ns.NSConfig(
        grid=Grid(level=level, dim=2, origin=(-0.5, -1.5), extents=(1, 3)),
        u_bcs=(bc.FieldBC((per, nn)),
               bc.FieldBC((per, (bc.Dirichlet(0.0), bc.Dirichlet(0.0))))),
        nu=0.0182571749236, beta=1.0,
        vof_tracers=(("T", bc.FieldBC((per, nn))),), tension=(("T", 1.0),),
        projection=proj, approx_projection=proj,
        diffusion_params=MultilevelParams(tolerance=1e-6, nitermax=20))


def make(cs, route, dev, dtype):
    """(simulation at rest, steps, fields) of ``route`` in ``dtype``."""
    import torch
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.models.simulation import Simulation, Time
    from gerris_tpu_torch.physics import vof
    if route == "twophase":
        cfg = cs.twophase_cfg()
        T0 = vof.fraction_from_levelset(
            cfg.grid, lambda x, y: -(y - 0.01 * torch.cos(2 * torch.pi * x)),
            device=dev, dtype=dtype)
        return Simulation(cfg, time=Time(), device=dev,
                          dtype=dtype).init(T=T0), 5, "UVTP"
    if route == "bubble":
        return cs.bubble_sim(dev, dtype=dtype), 5, "UVTP"
    if route.startswith("spurious"):
        kind = "tension_css" if route.endswith("css") else "tension"
        return cs.spurious_sim(dev, kind, dtype=dtype), 5, "UVTP"
    if route == "tracer":
        cfg = dataclasses.replace(
            cs.lid_cfg(11), tracers=(("C", bc.default_scalar_bc(2), 1e-3),))
        return Simulation(cfg, time=Time(dtmax=0.8 * cfg.grid.h),
                          device=dev, dtype=dtype).init(
            C=lambda x, y: x + 0.5), 5, "UVCP"
    cfg = capwave_cfg(10)
    T0 = vof.fraction_from_levelset(
        cfg.grid, lambda x, y: y - 0.01 * torch.cos(2 * math.pi * x),
        device=dev, dtype=dtype)
    return Simulation(cfg, time=Time(), device=dev,
                      dtype=dtype).init(T=T0), 2, "UVTP"


def cpu_levels(levels):
    """The capwave route's floor on the CPU at each level."""
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    for level in levels:
        runs = {}
        for dtype in (torch.float32, torch.float64):
            runs[dtype] = cs.capwave_sim(torch.device("cpu"), level,
                                         dtype).run(max_steps=2).state
        out = {}
        for k in "UVTP":
            a, b = runs[torch.float32][k].double(), runs[torch.float64][k]
            if k == "P":
                a, b = a - a.mean(), b - b.mean()
            out[k] = float((a - b).abs().max() / b.abs().max())
            if k in "UV":
                out[f"max|{k}|"] = float(b.abs().max())
                out[f"abs {k}"] = float((a - b).abs().max())
        print(json.dumps({"capwave_cpu_level": level, **out}), flush=True)


def main():
    args = sys.argv[1:]
    if args and args[0] == "--cpu":
        cpu_levels([int(a) for a in args[1:]])
        return 0
    root = Path(args.pop(0) if args and args[0] not in ROUTES
                else Path(__file__).resolve().parents[1]).resolve()
    routes = args or ROUTES
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("torch_f32_floor: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out = {}
    for route in routes:
        t0 = time.perf_counter()
        runs = {}
        with cs.plain_versions():
            for dtype in (torch.float32, torch.float64):
                s, steps, keys = make(cs, route, dev, dtype)
                runs[dtype] = s.run(max_steps=steps).state
        rels = {}
        for k in keys:
            a, b = runs[torch.float32][k].double(), runs[torch.float64][k]
            if k == "P":
                a, b = a - a.mean(), b - b.mean()
            rels[k] = float((a - b).abs().max() / b.abs().max())
        out[route] = rels
        print(f"{root.name or root} {route} after {steps} steps: " +
              ", ".join(f"{k} {v:.3e}" for k, v in rels.items()) +
              f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(json.dumps({"root": str(root), "floors": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
