#!/usr/bin/env python3
"""Replay the twophase step at which the kernels' run and the plain run
part (tools/torch_twophase_sensitivity.py --save), on the CPU.

    python3 tools/twophase_flip_replay.py jax  FLIP.npz
    python3 tools/twophase_flip_replay.py port FLIP.npz
    python3 tools/twophase_flip_replay.py curvature FLIP.npz

FLIP.npz holds the plain run's state before the step (float32, 1024^2),
the step's t, dt and index, and U and T after the step from the card's
kernels' run and plain run.  ``jax`` runs the JAX package's step
(gerris_tpu.models.ns.ns_step, eager, float32: jax_enable_x64 off) on
that state with chip_smoke.twophase_cfg's configuration and schedule
(_dryrun_twophase's fields, the projections and diffusion at tolerance
1e-3 with nrelax 8 and 16 coarsest sweeps); ``port`` runs the port's
step (gerris_tpu_torch.models.ns.ns_step, its plain versions) in float32
and in float64 from the same state.  Each prints, for U and T, max|a - b|
/ max|b| of its result against the card's kernels' and plain results:
which side of the jump each lands on.  ``curvature`` compares the two
card runs' fractions after the step and their height-function
curvatures (the port's, float32).  The ``jax`` mode imports the JAX
package, the others the port; none imports both.
"""
import json
import sys
from pathlib import Path

import numpy as np

FIELDS = ("U", "V", "P", "Pmac", "T", "Gx", "Gy")


def side(name, got, flip):
    out = {}
    for k in ("U", "T"):
        for run in ("kernels", "plain"):
            ref = flip[f"{run}_{k}"].astype(np.float64)
            out[f"{k}_vs_{run}"] = float(np.max(np.abs(got[k] - ref))
                                         / np.max(np.abs(ref)))
    print(json.dumps({name: out}), flush=True)


def replay_jax(flip, state, dt, t, i):
    import os
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    from gerris_tpu.core import bc
    from gerris_tpu.core.grid import Grid
    from gerris_tpu.models import ns
    from gerris_tpu.solvers import poisson
    walls = bc.FieldBC.uniform(bc.Dirichlet(0.0), 2)
    mp = poisson.MultilevelParams(tolerance=1e-3, nitermax=100, nrelax=8,
                                  coarsest_relax=16)
    cfg = ns.NSConfig(
        grid=Grid(level=10), u_bcs=(walls, walls), nu=1e-3, beta=1.0,
        vof_tracers=(("T", bc.default_scalar_bc(2)),),
        tension=(("T", 0.5),), density=("T", 10.0, 1.0, 1),
        projection=mp, approx_projection=mp,
        diffusion_params=poisson.MultilevelParams(
            tolerance=1e-3, nitermax=10, nrelax=8, coarsest_relax=16))
    js = {k: jnp.asarray(v, jnp.float32) for k, v in state.items()}
    with jax.disable_jit():
        out = ns.ns_step(js, jnp.float32(dt), jnp.float32(t), cfg,
                         cstart=i % 2, first_step=i == 0)
    side("jax_float32", {k: np.asarray(out[k], np.float64)
                         for k in ("U", "T")}, flip)


def replay_port(flip, state, dt, t, i):
    import torch
    import chip_smoke
    from gerris_tpu_torch.models import ns
    cfg = chip_smoke.twophase_cfg()
    for dtype in (torch.float32, torch.float64):
        ts = {k: torch.from_numpy(v).to(dtype) for k, v in state.items()}
        out = ns.ns_step(ts, dt, t, cfg, first_step=i == 0, cstart=i % 2)
        side(f"port_{str(dtype)[6:]}", {k: out[k].double().numpy()
                                        for k in ("U", "T")}, flip)


def curvatures(flip):
    """The card's two runs' T after the step (float32) through the port's
    height-function curvature (gerris_tpu_torch physics/vof.py, float32,
    the twophase BCs): how far the fractions and the curvatures differ,
    and at how many cells the curvature is defined in one run only."""
    import torch
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.physics import vof
    grid = Grid(level=10)
    ts = [torch.from_numpy(flip[f"{run}_T"]) for run in ("kernels", "plain")]
    ks = [vof.curvature(t, grid, bc.default_scalar_bc(2)) for t in ts]
    ok = [torch.isfinite(k) for k in ks]
    both = ok[0] & ok[1]
    dk = (ks[0] - ks[1]).abs()
    print(json.dumps({"curvature": {
        "T_max_abs_diff": float((ts[0] - ts[1]).abs().max()),
        "T_cells_differing": int((ts[0] != ts[1]).sum()),
        "kappa_max_abs": float(ks[1][ok[1]].abs().max()),
        "kappa_max_abs_diff": float(dk[both].max()),
        "kappa_cells_diff_gt_1pct": int((dk[both] > 0.01 * ks[1][both].abs()
                                         ).sum()),
        "kappa_defined_in_one_run_only": int((ok[0] ^ ok[1]).sum())}}),
        flush=True)


def main():
    mode, path = sys.argv[1], sys.argv[2]
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    flip = dict(np.load(path))
    state = {k: flip[f"before_{k}"] for k in FIELDS if f"before_{k}" in flip}
    dt, t, i = float(flip["dt_plain"]), float(flip["t"]), int(flip["i"])
    print(json.dumps({"step": i + 1, "t": t, "dt": dt,
                      "kernels_vs_plain_U": float(
                          np.max(np.abs(flip["kernels_U"] - flip["plain_U"]))
                          / np.max(np.abs(flip["plain_U"])))}), flush=True)
    if mode == "curvature":
        curvatures(flip)
        return
    {"jax": replay_jax, "port": replay_port}[mode](flip, state, dt, t, i)


if __name__ == "__main__":
    main()
