#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gerris_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result):
  1. setup: the card's name and power limit, torch/CUDA versions, the
     kernels' build from gerris_tpu_torch/csrc (one nvcc per source, in
     parallel);
  2. kernel checks: every kernel wrapper against its plain version on the
     card, float64 and float32: the multigrid kernels K1-K3 at the 2048^2
     main-path shapes and their coarser levels, plus K3's tile invariance;
     the diffusion pair K8a-c (own offsets, subs and dias per system) at
     2048^2 and 64^2, plus K8c's tile invariance; the predictor,
     projection and advection kernels K6, K4, K5 (with and without the
     cells), K9 (with and without gp and div_scale), K14 (both
     components, with and without the gp/oscale folds) and K7 (both
     modes, also against two K14 launches) at 2048^2 and 64^2, plus K4's
     div bit-identical across two block shapes; the adaptive solve's K11
     (the lid's offsets, periodic rows, periodic columns; bit-identical
     to K1's r0), K10 (non-periodic, periodic rows, doubly periodic, plus
     its tile invariance) at 2048^2, and K12 at 512^2 (per_y off and on)
     with its 64^2 block kernel alone; the fold route's K16 and K17 at
     2048^2 and 64^2 (the lid's pressure ghosts, inhomogeneous Neumann
     offsets, periodic columns; K16 with and without a sub, K17 with and
     without the cells), plus K17's tile invariance; the 3D smoother K13
     at 128^3 with the projections' and the diffusion's settings, at
     32^3, 64^3 and (32, 64, 128) with mixed sides, and at 256^3
     (float32); the two-phase smoother K15 at 1024^2 (walls, periodic
     rows, doubly periodic; scalar and cell dia; omega 1 and 1.5; 8 and
     24 sweeps; zero-diagonal cells) and at every level down to 4^2,
     plus its tile invariance; then each kernel's time against its plain
     version's at the main-path shapes (K13 at 128^3, K15 at 1024^2),
     float32 (CUDA events);
  3. main path: Simulation.init() + 20 steps of the 2048^2 lid cavity under
     the bench's configuration (pair_advect: K7 and the K8 pair), float32,
     through the kernels: finite values, launch counts, agreement with the
     same steps through the plain versions on the card, the median step
     rate of five timed windows, and a torch.profiler split of the step's
     device time; then the other routes, init + 5 steps each, with their
     launch counts and agreement with the plain versions: the
     per-component route (pair_advect off: K14 per component, then the K8
     pair), the rr_in_advect route (K7's rr_dia mode in place of K8a)
     and the bench's fold routes, fold_div (per projection K16, K2, K3
     and K5) and fold_correct (K16, K2 and K17), and each against the
     main path's route after the same steps (the fold routes' P mean-free:
     they drop the compatibility mean); fold_correct's step timed in five
     windows beside the main path's, and profiled;
     then the adaptive routes at 2048^2, float32: ``adaptive`` (the
     bench's cfg_ada: both projections and the diffusion to tolerance
     1e-3; K11, K12 and K3 in every cycle) and ``adaptive_relax`` (the
     "relax" diffusion: K11 -> K10 -> K11), init + 5 steps each, their
     cycle counts printed and their launches gated as functions of them,
     held to the plain versions on a fixed-count run (nitermin = nitermax
     = 2) at the main path's bound and on the adaptive run at the
     tolerance's; ``adaptive``'s step timed in five windows with its host
     syncs and profiled; the bench's honesty check (one fixed and one
     adaptive step from the main path's state, fixed_vs_adaptive_rel <
     2e-3); and ``periodic_poisson``, a doubly periodic adaptive solve in
     float64 at 1024^2 and 2048^2 (K11, the dense 64^2 solve, prolong +
     K10), its second order gated and held to the plain route; then the
     3D path, ``lid3d``: Simulation.init() + 20 steps of the bench's 128^3
     lid cavity under its fixed 3D schedule (bench.py:271-312), float32,
     through K13 (every other phase of the 3D step is torch): finite
     values, K13's launches gated, agreement with the same steps through
     the plain versions, the median step rate of five timed windows as
     ``cups_3d_128`` and a profile; and ``poisson3d``, a Neumann box
     solved adaptively in float64 at 64^3 and 128^3 (the torch residual,
     the dense 16^3 solve, K13), its second order gated and held to the
     plain route; then ``twophase``, __graft_entry__._dryrun_twophase at
     1024^2 in float32 (VOF, height-function tension, density 10/1, the
     default adaptive solves on the TPU's floored schedule): init + 20
     steps through K6, K4, K15 in every correction of the four alpha
     solves per step, K14 per component and K9, launches gated from every
     solve's recorded cycle count, finite values, T's volume, the first 5
     steps held to the plain versions, five timed windows and a profile;
  4. physics: the 64^2 lid cavity under the bench's configuration to
     steady state (EventStop U 1e-4 every 10 steps, at most 20000 steps),
     float32, against Ghia, Ghia & Shin (1982) at the reference tolerances
     and by the reference's measure (tests/test_lid.py); and the
     reference's test/oscillation at level 6 in float32 to t = 1
     (tests/test_oscillation.py): the fitted frequency within 0.5% of the
     reference's 153.984, decaying.
The last two lines are the kernels' JSON record and the device line.
"""
import contextlib
import json
import subprocess
import sys
import time

import numpy as np

N_MAIN = 2048
N_SMALL = 64
MAIN_STEPS = 20
ROUTE_STEPS = 5
TIMED_STEPS = 20
TIMED_WINDOWS = 5
PROFILE_STEPS = 10
# main path, kernels vs plain versions after MAIN_STEPS float32 steps,
# max|a - b| / max|b| over U, V, P.  Each kernel agrees with its plain
# version to ~1e-7 of max|ref| (float32 rounding, FMA contraction); the
# solves carry that into P, measured at 3.4e-5 on an H100 with the
# diffusion rhs folded into K14 (PERF.md).  1e-4 stays far below what a
# wrong sweep, ghost or colour gives (1e-2 and up)
MAIN_PATH_RTOL = 1e-4
GHIA_LINF_U, GHIA_LINF_V = 2e-2, 1.7e-2
# kernels vs plain versions, of max|ref| (of sum|div| for a divergence's
# total): float64 agrees to rounding; float32 to a few ulps of the
# outputs (FMA contraction in the kernels, other sum orders)
BOUND = {"float64": 1e-12, "float32": 1e-5}
# the H100 SXM's published rates (NVIDIA's H100 datasheet): HBM3 bytes/s
# and float32 outside the tensor cores, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# Ghia, Ghia & Shin (1982), Re=1000, in the unit box centred at the
# origin: u on the vertical centreline (y, u) and v on the horizontal
# centreline (x, v) (the table of tests/test_lid.py)
GHIA_U = np.array([
    (-0.49933, -0.000882), (-0.444335, -0.181701), (-0.43629, -0.201989),
    (-0.428914, -0.222276), (-0.397406, -0.297251), (-0.327052, -0.383699),
    (-0.217948, -0.27788), (-0.046595, -0.106804), (0.001598, -0.060949),
    (0.118733, 0.057217), (0.235193, 0.186849), (0.352315, 0.333239),
    (0.45404, 0.466401), (0.461386, 0.511382), (0.469392, 0.574884),
    (0.476719, 0.659554), (0.5, 0.999118),
])
GHIA_V = np.array([
    (-0.500577, 0.00069404), (-0.43768, 0.275621), (-0.429602, 0.290847),
    (-0.421523, 0.303994), (-0.406521, 0.326826), (-0.343624, 0.371038),
    (-0.273803, 0.330015), (-0.265724, 0.32307), (-0.000289, 0.0252893),
    (0.304962, -0.318994), (0.359781, -0.427191), (0.40652, -0.515279),
    (0.445182, -0.392034), (0.45326, -0.336623), (0.461339, -0.277749),
    (0.46884, -0.214023), (0.5, -6.20706e-17),
])

# the adaptive routes: a run through the kernels and one through the plain
# versions stop their solves at max|r| <= 1e-3 max|rhs| each, and float32
# rounding can move a solve's last check by a cycle, so the two runs agree
# to the tolerance's order, not to rounding: twice the tolerance, the
# bound of the bench's own honesty check (tests/test_bench_schedule.py)
ADAPTIVE_RTOL = 2e-3
FIXED_VS_ADAPTIVE_MAX = 2e-3
ADA_STEPS = 5
ADA_TIMED_STEPS = 10
ADA_PROFILE_STEPS = 5
# periodic_poisson: second order, err(1024^2) / err(2048^2) in this range;
# kernels vs plain to well below the 1e-6 discretisation error it measures
# (poisson3d: err(64^3) / err(128^3), the same bounds)
POISSON_ORDER = (3.5, 4.5)
POISSON_PLAIN_RTOL = 1e-9
# lid3d: the bench's 3D figure at 128^3 (bench.py:271-312)
LEVEL_3D = 7
LID3D_STEPS = 20
LID3D_TIMED_STEPS = 10
LID3D_PROFILE_STEPS = 5
# K13 calls per correction at 128^3: the levels 32^3, 64^3 and 128^3
# above the dense 16^3 level; per step one correction per projection (4
# sweeps) and one per velocity component's diffusion (1 sweep)
K13_LEVELS = 3
K13_PER_STEP = K13_LEVELS * (2 + 3)
K13_HALF_SWEEPS_PER_STEP = K13_LEVELS * 2 * (2 * 4 + 3 * 1)

# twophase: __graft_entry__._dryrun_twophase at full width, 1024^2
# float32 (VOF, height-function tension, variable density 10 / 1)
LEVEL_TWOPHASE = 10
TWOPHASE_STEPS = 20
TWOPHASE_CHECK_STEPS = 5
TWOPHASE_TIMED_STEPS = 10
TWOPHASE_PROFILE_STEPS = 5
# K15 launches per correction at 1024^2: every level from 1024^2 down to
# minlevel 2 (4^2), 1 at the coarsest and 8 upward; the correction's
# residual restrictions (restrict2) between them
K15_LEVELS = LEVEL_TWOPHASE - 2 + 1
# |sum(T) - sum(T0)| / sum(T0) after init + TWOPHASE_STEPS steps in
# float32: the direction-split advection with its dilation bookkeeping
# conserves the volume to float32 rounding; the first run on an H100
# measured 3.1e-10, and the bound leaves 30x that for the rounding of
# other runs
TWOPHASE_VOLUME_RTOL = 1e-8
# the reference's test/oscillation (tests/test_oscillation.py): a
# quarter droplet D 0.2, mode-2 perturbation 0.05, sigma 1, rho 1 / 1e-3,
# nu 0, projections to 1e-4, level 6, to t = 1; the frequency of the fit
# within 0.5% of the reference's fit.ref column (L6 153.984)
OSC_LEVEL = 6
OSC_D, OSC_EPS, OSC_SIGMA, OSC_RHO_L, OSC_RHO_G = 0.2, 0.05, 1.0, 1.0, 1e-3
OSC_REF_C = 153.984
OSC_RTOL = 0.005

ERR_KEYS = ("max_abs_err", "max_rel_err")
CSRC = "gerris_tpu_torch/csrc/"
# wrapper -> (source, the TPU kernel it replaces)
KERNELS = {
    "residual_restrict": (CSRC + "rbgs.cu",
                          "gerris_tpu/ops/pallas/rbgs.py:1234"),
    "cascade_prolong_relax": (CSRC + "rbgs.cu",
                              "gerris_tpu/ops/pallas/rbgs.py:1446"),
    "restrict2": (CSRC + "rbgs.cu", "gerris_tpu/ops/pallas/rbgs.py:1446"),
    "prolong_relax": (CSRC + "rbgs.cu", "gerris_tpu/ops/pallas/rbgs.py:468"),
    "divergence_mac": (CSRC + "projops.cu",
                       "gerris_tpu/ops/pallas/projops.py:294"),
    "correct_project": (CSRC + "projops.cu",
                        "gerris_tpu/ops/pallas/projops.py:463"),
    "predict_xy": (CSRC + "predict.cu",
                   "gerris_tpu/ops/pallas/predict.py:217"),
    "interp_faces": (CSRC + "projops.cu",
                     "gerris_tpu/ops/pallas/projops.py:172"),
    "advect2d": (CSRC + "bcg.cu", "gerris_tpu/ops/pallas/bcg.py:461"),
    "advect2d_pair": (CSRC + "bcg.cu", "gerris_tpu/ops/pallas/bcg.py:319"),
    "residual_restrict_pair": (CSRC + "rbgs.cu",
                               "gerris_tpu/ops/pallas/rbgs.py:1194"),
    "cascade_prolong_relax_pair": (CSRC + "rbgs.cu",
                                   "gerris_tpu/ops/pallas/rbgs.py:1513"),
    "prolong_relax_pair": (CSRC + "rbgs.cu",
                           "gerris_tpu/ops/pallas/rbgs.py:421"),
    "residual": (CSRC + "rbgs.cu", "gerris_tpu/ops/pallas/rbgs.py:247"),
    "rbgs_relax": (CSRC + "rbgs.cu", "gerris_tpu/ops/pallas/rbgs.py:1560"),
    "coarse_vcycle": (CSRC + "rbgs.cu", "gerris_tpu/ops/pallas/rbgs.py:871"),
    "coarse_block": (CSRC + "rbgs.cu", "gerris_tpu/ops/pallas/rbgs.py:871"),
    "rbgs_relax_3d": (CSRC + "rbgs3d.cu",
                      "gerris_tpu/ops/pallas/rbgs3d.py:119"),
    "residual_restrict_div": (CSRC + "rbgs.cu",
                              "gerris_tpu/ops/pallas/rbgs.py:1111"),
    "prolong_relax_correct": (CSRC + "rbgs.cu",
                              "gerris_tpu/ops/pallas/rbgs.py:685"),
    "rbgs_relax_alpha": (CSRC + "rbgs.cu",
                         "gerris_tpu/ops/pallas/rbgs.py:1601"),
}
# the kernels of the adaptive routes, and the route whose run gives each
# one's launches
ADAPTIVE_KERNELS = {"residual": "adaptive", "coarse_vcycle": "adaptive",
                    "coarse_block": "adaptive",
                    "rbgs_relax": "adaptive_relax"}
# levels of a cascade at n/2 = 1024 with the 16^2 coarsest level: 5
# restrict2 launches (512 -> 16), then 7 prolong_relax (16 .. 1024)
CASCADE_POOLS, CASCADE_LEVELS = 5, 7
# the routes of the velocity advection and diffusion (models/ns.py), by
# their NSConfig flags
ROUTES = {"pair": dict(pair_advect=True),
          "per_component": dict(pair_advect=False),
          "rr": dict(pair_advect=True, rr_in_advect=True),
          "fold_div": dict(pair_advect=True, fold_div=True),
          "fold_correct": dict(pair_advect=True, fold_div=True,
                               fold_correct=True)}
# the fold route's kernels, and the route whose run gives each one's
# launches (bench.py's GERRIS_FOLD_CORRECT=1)
FOLD_KERNELS = {"residual_restrict_div": "fold_correct",
                "prolong_relax_correct": "fold_correct"}
# K12's levels at 512^2: 3 restrict2 down to 64^2 and 3 K3 up from it; the
# correction's restrictions 2048 -> 1024 -> 512 and its K3 launches at
# 1024^2 and 2048^2
K12_LEVELS, ADA_POOLS, ADA_PROLONGS = 3, 2, 2


def want_launches(route, steps):
    """Launches of init + ``steps`` steps at 2048^2.  Per step: the two
    projections' solves of K1-K3 (and the initial projection's); K6 once;
    K4 and K5 once per projection; K9 once; the U+V diffusion pair's
    K8a-c once (K7's rr_dia mode takes K8a's place on the rr route); K7
    once, or K14 once per component on the per-component route.  The
    fold routes: K16 in place of K4 + K1 in every projection, and on
    fold_correct K17 in place of K3 + K5."""
    solves = 2 * steps + 1
    pair = steps if route != "per_component" else 0
    fold = route in ("fold_div", "fold_correct")
    correct = route == "fold_correct"
    return {
        "residual_restrict": 0 if fold else solves,
        "residual_restrict_div": solves if fold else 0,
        "cascade_prolong_relax": solves,
        "prolong_relax": 0 if correct else solves,
        "prolong_relax_correct": solves if correct else 0,
        "restrict2": CASCADE_POOLS * solves,
        "cascade.prolong_relax": CASCADE_LEVELS * solves,
        "predict_xy": steps, "divergence_mac": 0 if fold else solves,
        "correct_project": 0 if correct else solves,
        "interp_faces": steps + 1,
        "advect2d": 2 * steps - 2 * pair, "advect2d_pair": pair,
        "residual_restrict_pair": steps if route != "rr" else 0,
        "cascade_prolong_relax_pair": steps,
        "restrict2_pair": CASCADE_POOLS * steps,
        "cascade_pair.prolong_relax": CASCADE_LEVELS * steps,
        "prolong_relax_pair": steps,
        "residual": 0, "rbgs_relax": 0, "coarse_vcycle": 0,
        "coarse_vcycle.restrict2": 0, "coarse_block": 0,
        "coarse_vcycle.prolong_relax": 0,
        "rbgs_relax_3d": 0, "rbgs_relax_3d.half_sweep": 0,
        "rbgs_relax_alpha": 0,
    }


def want_adaptive(steps, solves):
    """Launches of init + ``steps`` steps of an adaptive route at 2048^2
    from its solves' records (solver, niter, fixed count or not): per
    multigrid solve one K11 for r0, one per cycle (and one more after
    the cycles of a fixed count), and per cycle the correction's K12 at
    512^2 (its 3 + 1 + 3 launches), 2 restrict2 and 2 K3; per "relax"
    solve K11 twice and K10 once.  Per step K6 once, K4 and K5 once per
    projection, K9 once, K14 once per component (the per-component route:
    the pair route needs a fixed diffusion schedule); no K1, K2, K7 or
    K8."""
    w = {k: 0 for k in want_launches("pair", 0)}
    w.update(predict_xy=steps, divergence_mac=2 * steps + 1,
             correct_project=2 * steps + 1, interp_faces=steps + 1,
             advect2d=2 * steps)
    for solver, niter, fixed in solves:
        if solver == "relax":
            w["residual"] += 2
            w["rbgs_relax"] += 1
            continue
        w["residual"] += 1 + niter + int(fixed)
        w["coarse_vcycle"] += niter
        w["coarse_block"] += niter
        w["coarse_vcycle.restrict2"] += K12_LEVELS * niter
        w["coarse_vcycle.prolong_relax"] += K12_LEVELS * niter
        w["restrict2"] += ADA_POOLS * niter
        w["prolong_relax"] += ADA_PROLONGS * niter
    return w


# device kernels of the port, by a substring of their names.  The pairs
# K8a-c launch the K1, restrict2 and K3 kernels with a batch of two, so
# their names are K1's, restrict2's and K3's
OWN_KERNELS = ("residual_restrict_kernel", "restrict2_kernel",
               "prolong_relax_kernel", "divergence_mac_kernel",
               "correct_project_kernel", "interp_faces_kernel",
               "predict_xy_kernel", "advect2d_kernel", "advect2d_pair_kernel",
               "sum_partials_kernel", "residual_kernel", "rbgs_relax_kernel",
               "coarse_block_kernel", "rbgs3d_half_sweep_kernel",
               "prolong_relax_correct_kernel", "rbgs_relax_alpha_kernel")


def schedules():
    """The solver schedules of the routes, with the TPU floors applied as
    utils/convert.params_from_jax applies them:
    * "fixed": the bench's (bench.py:128-161), one cycle per solve,
      projections 5 sweeps/level at omega 1.5, diffusion 1 sweep, 40
      coarsest sweeps;
    * "adaptive": the bench's cfg_ada (bench.py:174-179), tolerance 1e-3
      in at most 100 cycles, tpu_nrelax 5: 5 sweeps per level at omega 1
      and 10 coarsest sweeps (K12 takes max(10, 40));
    * "adaptive_fixed": the same cycles, 2 per solve (nitermin =
      nitermax), with no tolerance decision;
    * "relax": the "relax" diffusion solver, max(nrelax, 4) sweeps."""
    import dataclasses
    from gerris_tpu_torch.solvers.poisson import MultilevelParams
    ada = MultilevelParams(tolerance=1e-3, nitermax=100, nrelax=5,
                           coarsest_relax=10)
    return {
        "fixed": (MultilevelParams(nrelax=5, omega=1.5, coarsest_relax=40,
                                   ncycles=1),
                  MultilevelParams(nrelax=1, omega=1.0, coarsest_relax=40,
                                   ncycles=1)),
        "adaptive": (ada, ada),
        "adaptive_fixed": (dataclasses.replace(ada, nitermin=2, nitermax=2),
                           dataclasses.replace(ada, nitermin=2, nitermax=2)),
        "relax": (ada, MultilevelParams(tolerance=1e-3, nitermax=100,
                                        solver="relax")),
        "relax_fixed": (dataclasses.replace(ada, nitermin=2, nitermax=2),
                        MultilevelParams(tolerance=1e-3, nitermax=100,
                                         solver="relax")),
    }


def lid_cfg(level, pair_advect=True, rr_in_advect=False, schedule="fixed",
            fold_div=False, fold_correct=False):
    """The bench's lid cavity (bench.py's defaults: GERRIS_PAIR_ADVECT=1,
    GERRIS_RR_ADVECT=0, GERRIS_DIV_SRC=0, GERRIS_FOLD_DIV=0,
    GERRIS_FOLD_CORRECT=0) at 2^level cells per side, with the solver
    schedule ``schedule`` (schedules()) and the projections' fold knobs."""
    import dataclasses
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.models import ns
    u_bc = bc.FieldBC.make(2, default=bc.Dirichlet(0.0), top=bc.Dirichlet(1.0))
    v_bc = bc.FieldBC.uniform(bc.Dirichlet(0.0), 2)
    proj, diff = schedules()[schedule]
    proj = dataclasses.replace(proj, fold_div=fold_div,
                               fold_correct=fold_correct)
    return ns.NSConfig(grid=Grid(level=level), u_bcs=(u_bc, v_bc), nu=1e-3,
                       beta=1.0, projection=proj, approx_projection=proj,
                       diffusion_params=diff, pair_advect=pair_advect,
                       rr_in_advect=rr_in_advect)


def launch_counts():
    from gerris_tpu_torch.ops.cuda import bcg, predict, projops, rbgs, rbgs3d
    return {**rbgs.LAUNCHES, **projops.LAUNCHES, **predict.LAUNCHES,
            **bcg.LAUNCHES, **rbgs3d.LAUNCHES}


def reset_launch_counts():
    from gerris_tpu_torch.ops.cuda import bcg, predict, projops, rbgs, rbgs3d
    for mod in (rbgs, projops, predict, bcg, rbgs3d):
        mod.reset_launch_counts()


def cuda_ms(fn, iters=10, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(name, got, ref, bound):
    """max|got - ref| against bound * max|ref|; returns the largest
    (max|got - ref|, max|got - ref| / max|ref|) over the outputs."""
    got = got if isinstance(got, (tuple, list)) else (got,)
    ref = ref if isinstance(ref, (tuple, list)) else (ref,)
    if len(got) != len(ref):
        raise AssertionError(f"{name}: {len(got)} outputs, want {len(ref)}")
    worst = worst_rel = 0.0
    for g, r in zip(got, ref):
        if g.shape != r.shape:
            raise AssertionError(f"{name}: shape {tuple(g.shape)}, want "
                                 f"{tuple(r.shape)}")
        err = float((g - r).abs().max())
        scale = float(r.abs().max())
        rel = err / scale
        print(f"  {name}: max_abs_err={err:.3e} max|ref|={scale:.3e} "
              f"rel={rel:.3e} bound={bound:.0e}")
        if not rel <= bound:
            raise AssertionError(f"{name}: rel {rel:.3e} > {bound:.0e}")
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
    return worst, worst_rel


def compare_div(name, got, ref, bound):
    """A (div, total) pair: div as compare(); the total against bound *
    sum|div|."""
    e = compare(f"{name} div", got[0], ref[0], bound)
    scale = float(ref[0].abs().sum())
    err = float((got[1] - ref[1]).abs().max())
    print(f"  {name} total: {float(got[1][0]):.9e} vs {float(ref[1][0]):.9e}"
          f", |diff|/sum|div|={err / scale:.3e} bound={bound:.0e}")
    if not err <= bound * scale:
        raise AssertionError(f"{name} total: {err / scale:.3e} > {bound:.0e}")
    return e


def compare_faces(name, got, ref, bound, div=True):
    """Outputs of a face kernel, None where an option is off (in both
    versions); with ``div`` the last two are a (div, total) pair."""
    if len(got) != len(ref):
        raise AssertionError(f"{name}: {len(got)} outputs, want {len(ref)}")
    for g, r in zip(got, ref):
        if (g is None) != (r is None):
            raise AssertionError(f"{name}: outputs None in one version only")
    n = len(got) - 2 if div else len(got)
    keep = [(g, r) for g, r in zip(got[:n], ref[:n]) if g is not None]
    e = compare(name, *zip(*keep), bound)
    if div and got[-1] is not None:
        d = compare_div(name, got[-2:], ref[-2:], bound)
        e = (max(e[0], d[0]), max(e[1], d[1]))
    return e


@contextlib.contextmanager
def plain_versions():
    """Route every kernel wrapper of the main path through its plain
    version (the card-side reference run)."""
    from gerris_tpu_torch.ops.cuda import bcg, predict, projops, rbgs, rbgs3d
    swaps = [(rbgs, "residual_restrict"), (rbgs, "cascade_prolong_relax"),
             (rbgs, "prolong_relax"), (rbgs, "residual_restrict_pair"),
             (rbgs, "cascade_prolong_relax_pair"),
             (rbgs, "prolong_relax_pair"), (rbgs, "residual"),
             (rbgs, "rbgs_relax"), (rbgs, "coarse_vcycle"),
             (rbgs, "restrict2"), (projops, "divergence_mac"),
             (projops, "correct_project"), (projops, "interp_faces"),
             (predict, "predict_xy"), (bcg, "advect2d"),
             (bcg, "advect2d_pair"), (rbgs3d, "rbgs_relax_3d"),
             (rbgs, "residual_restrict_div"),
             (rbgs, "prolong_relax_correct"), (rbgs, "rbgs_relax_alpha")]
    saved = [getattr(mod, name) for mod, name in swaps]
    for mod, name in swaps:
        plain = "pool_plain" if name == "restrict2" else name + "_plain"
        setattr(mod, name, getattr(mod, plain))
    try:
        yield
    finally:
        for (mod, name), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def flat(outs):
    """([a0, a1], [b0, b1], ...) -> [a0, a1, b0, b1, ...]"""
    return [t for ts in outs for t in ts]


def check_face_kernels(rnd, dtype, n, record):
    """K6, K4, K5, K9, K14 and K7 against their plain versions at n^2 (the
    lid's BCs, dt = 0.8 h, the diffusion rhs scale of nu = 1e-3), and K7
    against two K14 launches; errors go to ``record`` when it is given."""
    import torch
    from gerris_tpu_torch.ops.cuda import bcg, predict, projops, rbgs
    from gerris_tpu_torch.solvers.poisson import _signs_offs
    cfg = lid_cfg(int(np.log2(n)))
    grid, u_bcs, p_bc = cfg.grid, cfg.u_bcs, cfg.p_bc
    name = str(dtype).replace("torch.", "")
    b = BOUND[name]
    h = grid.h
    dt = 0.8 * h
    dia = 1.0 / (dt * cfg.nu)
    U, V, Gx, Gy, p = (rnd(dtype, n, n) for _ in range(5))
    ufx, ufy = rnd(dtype, n + 1, n), rnd(dtype, n, n + 1)
    errs = {}
    for sc in (None, 1.0 / (h * dt / 2.0)):
        tag = "" if sc is None else " div_scale"
        got = predict.predict_xy(U, V, dt, grid, u_bcs, sc)
        ref = predict.predict_xy_plain(U, V, dt, grid, u_bcs, sc)
        errs.setdefault("predict_xy", []).append(compare_faces(
            f"K6 predict_xy {n}{tag}", got, ref, b))
    errs["divergence_mac"] = [compare_div(
        f"K4 divergence_mac {n}", projops.divergence_mac(ufx, ufy, dt, h),
        projops.divergence_mac_plain(ufx, ufy, dt, h), b)]
    if not torch.equal(projops.divergence_mac(ufx, ufy, dt, h)[0],
                       projops.divergence_mac(ufx, ufy, dt, h,
                                              block=(16, 16))[0]):
        raise AssertionError("K4: div differs between blocks 32x8 and 16x16")
    print(f"  K4 {n}: div bit-identical with blocks 32x8 and 16x16")
    for cells in (None, (U, V)):
        tag = "" if cells is None else " cells"
        errs.setdefault("correct_project", []).append(compare_faces(
            f"K5 correct_project {n}{tag}",
            projops.correct_project(p, ufx, ufy, dt, grid, p_bc, cells),
            projops.correct_project_plain(p, ufx, ufy, dt, grid, p_bc,
                                          cells), b, div=False))
    for gp in (None, (Gx, Gy)):
        for sc in (None, 1.0 / (h * dt)):
            tag = ("" if gp is None else " gp") + \
                ("" if sc is None else " div_scale")
            dtv = None if gp is None else dt
            errs.setdefault("interp_faces", []).append(compare_faces(
                f"K9 interp_faces {n}{tag}",
                projops.interp_faces(U, V, grid, u_bcs, gp, dtv, sc),
                projops.interp_faces_plain(U, V, grid, u_bcs, gp, dtv, sc),
                b))
    for c, v in enumerate((U, V)):
        for folds in (False, True):
            kw = dict(g=(Gx, Gy)[c], gp=p if folds else None,
                      oscale=-dia if folds else None)
            errs.setdefault("advect2d", []).append(compare(
                f"K14 advect2d {n} c={c}{' gp oscale' if folds else ''}",
                bcg.advect2d(v, c, ufx, ufy, dt, grid, u_bcs[c], **kw),
                bcg.advect2d_plain(v, c, ufx, ufy, dt, grid, u_bcs[c], **kw),
                b))
    # K7: both components with their own BCs (U's lid, V's walls), the
    # g, gp and oscale folds, in the rhs mode and the rr_dia mode
    fbcs = list(u_bcs)
    GPx, GPy = rnd(dtype, n, n), rnd(dtype, n, n)
    signs = _signs_offs(grid, fbcs[0], homogeneous=False)[0]
    offss = [_signs_offs(grid, f, homogeneous=False)[1] for f in fbcs]
    for rr in (False, True):
        tag = " rr_dia" if rr else ""
        kw = dict(g=(Gx, Gy), gp=(GPx, GPy), oscale=-dia,
                  rr_dia=dia if rr else None)
        got = bcg.advect2d_pair(U, V, ufx, ufy, dt, grid, fbcs, **kw)
        ref = bcg.advect2d_pair_plain(U, V, ufx, ufy, dt, grid, fbcs, **kw)
        got, ref = (flat(got), flat(ref)) if rr else (got, ref)
        errs.setdefault("advect2d_pair", []).append(compare(
            f"K7 advect2d_pair {n}{tag}", got, ref, b))
        k14 = [bcg.advect2d(v, c, ufx, ufy, dt, grid, fbcs[c], g=g, gp=gp,
                            oscale=-dia)
               for c, (v, g, gp) in enumerate(((U, Gx, GPx), (V, Gy, GPy)))]
        if rr:
            k14 = flat(rbgs.residual_restrict_pair(
                [U, V], k14, [dia, dia], h2=h * h, signs=signs,
                offss=offss))
        compare(f"K7 vs two K14{' + K8a' if rr else ''} {n}{tag}", got, k14,
                b)
        same = all(torch.equal(x, y) for x, y in zip(got, k14))
        print(f"  K7 vs two K14{' + K8a' if rr else ''} {n}{tag}: "
              f"bit-identical={same}")
    if record is not None:
        for k, es in errs.items():
            record[k].update(zip(ERR_KEYS, map(max, zip(*es))))


def check_pair_kernels(rnd, dtype, n, record):
    """The diffusion pair K8a, K8b (at n/2, 1 sweep, 40 coarsest) and K8c
    against their plain versions at n^2, with the lid's U and V systems:
    shared signs, their own ghost offsets (U's lid 2.0 on the top side),
    subs and dias; errors go to ``record`` when it is given."""
    from gerris_tpu_torch.ops.cuda import rbgs
    from gerris_tpu_torch.solvers.poisson import _signs_offs
    cfg = lid_cfg(int(np.log2(n)))
    name = str(dtype).replace("torch.", "")
    b = BOUND[name]
    b2 = 1e-12 if name == "float64" else 1e-4
    signs = _signs_offs(cfg.grid, cfg.u_bcs[0], homogeneous=False)[0]
    offss = [_signs_offs(cfg.grid, f, homogeneous=False)[1]
             for f in cfg.u_bcs]
    h2 = 1.0 / n ** 2
    # the diffusion systems' dia = 1/(dt nu) at dt = 0.8 h, and half of it
    dias = [1.0 / (0.8 / n * 1e-3), 0.5 / (0.8 / n * 1e-3)]
    us = [rnd(dtype, n, n) for _ in range(2)]
    rhss = [rnd(dtype, n, n) for _ in range(2)]
    subs = [0.0, rnd(dtype, 1)]
    kw = dict(h2=h2, signs=signs, offss=offss, per_y=False)
    errs = {"residual_restrict_pair": compare(
        f"K8a residual_restrict_pair {n}",
        flat(rbgs.residual_restrict_pair(us, rhss, dias, subs, **kw)),
        flat(rbgs.residual_restrict_pair_plain(us, rhss, dias, subs, **kw)),
        b)}
    r1s = [rnd(dtype, n // 2, n // 2) for _ in range(2)]
    r2s = [rnd(dtype, n // 4, n // 4) for _ in range(2)]
    ckw = dict(nsweeps=1, coarsest=40, h2_half=4 * h2, signs=signs,
               per_y=False, omega=1.0)
    errs["cascade_prolong_relax_pair"] = compare(
        f"K8b cascade_prolong_relax_pair {n // 2} nsweeps=1",
        rbgs.cascade_prolong_relax_pair(r1s, r2s, dias, **ckw),
        rbgs.cascade_prolong_relax_pair_plain(r1s, r2s, dias, **ckw), b2)
    coarses = [rnd(dtype, n // 2, n // 2) for _ in range(2)]
    pkw = dict(nsweeps=1, h2=h2, signs=signs, per_y=False, omega=1.0)
    errs["prolong_relax_pair"] = compare(
        f"K8c prolong_relax_pair {n} nsweeps=1",
        rbgs.prolong_relax_pair(coarses, rhss, dias, us, **pkw),
        rbgs.prolong_relax_pair_plain(coarses, rhss, dias, us, **pkw), b)
    if record is not None:
        for k, e in errs.items():
            record[k].update(zip(ERR_KEYS, e))


def fold_ghosts(n):
    """(tag, signs, offs, per_y) of the fold route's pressure ghosts at
    n^2: the lid's (homogeneous Neumann), inhomogeneous Neumann on every
    side (offsets -g h / +g h, poisson._signs_offs), and Neumann rows with
    periodic columns."""
    h = 1.0 / n
    return (("lid", (1.0,) * 4, (0.0,) * 4, False),
            ("neumann", (1.0,) * 4, (-0.25 * h, -0.5 * h, 0.4 * h, 0.75 * h),
             False),
            ("per_y", (1.0,) * 4, (-0.25 * h, 0.5 * h, 0.0, 0.0), True))


def check_fold_kernels(rnd, dtype, n, record):
    """K16 and K17 against their plain versions at n^2 with every
    fold_ghosts() case: K16 with sub 0 (the fold route's) and a device
    scalar, K17 with and without the cells at the projections' 5 sweeps
    and omega 1.5 (its gradient outputs, which amplify p' by 1/h, held
    to their own max as every output is); on the lid's ghosts each is also
    set beside the unfolded kernels it replaces (K4 + K1, K3 + K5).
    Errors go to ``record`` when it is given."""
    import torch
    from gerris_tpu_torch.ops.cuda import projops, rbgs
    cfg = lid_cfg(int(np.log2(n)))
    name = str(dtype).replace("torch.", "")
    b = BOUND[name]
    h = cfg.grid.h
    h2, dt = h * h, 0.8 * h
    u, rhs, U, V = (rnd(dtype, n, n) for _ in range(4))
    ufx, ufy = rnd(dtype, n + 1, n), rnd(dtype, n, n + 1)
    c, sub = rnd(dtype, n // 2, n // 2), rnd(dtype, 1)
    errs = {"residual_restrict_div": [], "prolong_relax_correct": []}
    for tag, signs, offs, per_y in fold_ghosts(n):
        kw = dict(h2=h2, signs=signs, offs=offs, per_y=per_y)
        for s in (0.0, sub):
            stag = "" if isinstance(s, float) else " sub"
            got = rbgs.residual_restrict_div(u, ufx, ufy, dt * h, 0.0, s,
                                             **kw)
            errs["residual_restrict_div"].append(compare(
                f"K16 residual_restrict_div {n} {tag}{stag}", got,
                rbgs.residual_restrict_div_plain(u, ufx, ufy, dt * h, 0.0,
                                                 s, **kw), b))
        if tag == "lid":
            div = projops.divergence_mac(ufx, ufy, dt, h)[0]
            k1 = rbgs.residual_restrict(u, div, 0.0, 0.0, **kw)
            print(f"  K16 vs K4 + K1 {n}: bit-identical="
                  f"{all(torch.equal(x, y) for x, y in zip(got, k1))}")
        kw = dict(nsweeps=5, h2=h2, signs=signs, offs=offs, per_y=per_y,
                  omega=1.5)
        for cells in (None, (U, V)):
            ctag = "" if cells is None else " cells"
            got = rbgs.prolong_relax_correct(c, rhs, 0.0, u, ufx, ufy, dt, h,
                                             cells, **kw)
            errs["prolong_relax_correct"].append(compare_faces(
                f"K17 prolong_relax_correct {n} {tag}{ctag}", got,
                rbgs.prolong_relax_correct_plain(c, rhs, 0.0, u, ufx, ufy,
                                                 dt, h, cells, **kw),
                b, div=False))
            if tag == "lid":
                p3 = rbgs.prolong_relax(c, rhs, 0.0, u, nsweeps=5, h2=h2,
                                        signs=signs, omega=1.5)
                k5 = (p3,) + tuple(projops.correct_project(
                    p3, ufx, ufy, dt, cfg.grid, cfg.p_bc, cells))
                same = all(x is y or torch.equal(x, y)
                           for x, y in zip(got, k5))
                print(f"  K17 vs K3 + K5 {n}{ctag}: bit-identical={same}")
    if record is not None:
        for k, es in errs.items():
            record[k].update(zip(ERR_KEYS, map(max, zip(*es))))


def check_fold_tiles(rnd):
    """K17 bit-identical across tiles 32 and 16 at 2048^2, and whole-level
    against tiled at 64^2, with and without periodic columns."""
    import torch
    from gerris_tpu_torch.ops.cuda import rbgs
    for n, kws in ((N_MAIN, (dict(tile=32), dict(tile=16))),
                   (N_SMALL, (dict(), dict(tile=16, whole_max=32)))):
        f32 = torch.float32
        c = rnd(f32, n // 2, n // 2)
        rhs, u, U, V = (rnd(f32, n, n) for _ in range(4))
        ufx, ufy = rnd(f32, n + 1, n), rnd(f32, n, n + 1)
        for tag, signs, offs, per_y in fold_ghosts(n)[1:]:
            kw = dict(nsweeps=5, h2=1.0 / n ** 2, signs=signs, offs=offs,
                      per_y=per_y, omega=1.5)
            a, b = (rbgs.prolong_relax_correct(c, rhs, 0.0, u, ufx, ufy,
                                               0.8 / n, 1.0 / n, (U, V),
                                               **kw, **k) for k in kws)
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                raise AssertionError(f"K17 {n} {tag}: {kws[0]} and {kws[1]}"
                                     " differ")
    print("  K17 tile 32 == tile 16 at 2048, whole == tiled at 64, "
          "periodic columns or not: bit-identical")


def check_adaptive_kernels(rnd, dtype, record):
    """K11, K10 and K12 against their plain versions at the adaptive
    routes' shapes: K11 at 2048^2 with the lid's offsets (and bit-identical
    to K1's r0 with sub = 0), periodic rows, periodic columns and both;
    K10 at 2048^2 with the "relax" diffusion's 4 sweeps at dia = 1/(dt nu)
    (the lid's walls), periodic rows and doubly periodic (the periodic
    Poisson's corrections); K12 at 512^2 with 5 sweeps, 40 coarsest, per_y
    off and on, dia 0 and the diffusion's; its 64^2 block kernel alone.
    Errors go to ``record`` when it is given."""
    import torch
    from gerris_tpu_torch.ops.cuda import rbgs
    from gerris_tpu_torch.solvers.poisson import _signs_offs
    cfg = lid_cfg(11)
    signs, offs = _signs_offs(cfg.grid, cfg.u_bcs[0], homogeneous=False)
    name = str(dtype).replace("torch.", "")
    b = BOUND[name]
    n = N_MAIN
    h2 = 1.0 / n ** 2
    dia_diff = 1.0 / (0.8 / n * 1e-3)
    neumann, per_signs = (1.0,) * 4, (1.0,) * 4
    errs = {}
    u, rhs = rnd(dtype, n, n), rnd(dtype, n, n)
    for per, sg, of in (((False, False), signs, offs),
                        ((True, False), (1.0, 1.0, -1.0, -1.0),
                         (0.0, 0.0, 0.5, -0.25)),
                        ((False, True), (-1.0, 1.0, 1.0, 1.0),
                         (1.5, 0.25, 0.0, 0.0)),
                        ((True, True), per_signs, (0.0,) * 4)):
        kw = dict(h2=h2, signs=sg, offs=of, periodic=per)
        errs.setdefault("residual", []).append(compare(
            f"K11 residual {n} periodic={per}",
            rbgs.residual(u, rhs, dia_diff, **kw),
            rbgs.residual_plain(u, rhs, dia_diff, **kw), b))
    r0 = rbgs.residual_restrict(u, rhs, dia_diff, 0.0, h2=h2, signs=signs,
                                offs=offs)[0]
    if not torch.equal(r0, rbgs.residual(u, rhs, dia_diff, h2=h2,
                                         signs=signs, offs=offs)):
        raise AssertionError("K11 and K1's r0 differ")
    print(f"  K11 {n}: bit-identical to K1's r0 (sub = 0)")
    for per, sg, dia, nsw, omega in (
            ((False, False), signs, dia_diff, 4, 1.0),
            ((True, False), (1.0, 1.0, -1.0, 1.0), 0.0, 5, 1.5),
            ((True, True), per_signs, 0.0, 4, 1.0)):
        kw = dict(nsweeps=nsw, h2=h2, signs=sg, periodic=per, omega=omega)
        errs.setdefault("rbgs_relax", []).append(compare(
            f"K10 rbgs_relax {n} nsweeps={nsw} periodic={per}",
            rbgs.rbgs_relax(u, rhs, dia, **kw),
            rbgs.rbgs_relax_plain(u, rhs, dia, **kw), b))
    r512 = rnd(dtype, 512, 512)
    for per_y, dia in ((False, 0.0), (True, 0.0), (False, dia_diff)):
        sg = (1.0, 1.0, 1.0, 1.0) if per_y else (signs if dia else neumann)
        kw = dict(nsweeps=5, coarsest=40, h2=16 * h2, signs=sg,
                  per_y=per_y, min_n=16)
        errs.setdefault("coarse_vcycle", []).append(compare(
            f"K12 coarse_vcycle 512 per_y={per_y} dia={dia:.3g}",
            rbgs.coarse_vcycle(r512, dia, **kw),
            rbgs.coarse_vcycle_plain(r512, dia, **kw), b))
    r64 = rnd(dtype, 64, 64)
    for per_y in (False, True):
        kw = dict(nsweeps=5, coarsest=40, h2=(n // 64) ** 2 * h2,
                  signs=per_signs if per_y else neumann, per_y=per_y,
                  min_n=16)
        errs.setdefault("coarse_block", []).append(compare(
            f"K12 coarse_block 64 per_y={per_y}",
            rbgs.coarse_block(r64, 0.0, **kw),
            rbgs.coarse_vcycle_plain(r64, 0.0, **kw), b))
    if record is not None:
        for k, es in errs.items():
            record[k].update(zip(ERR_KEYS, map(max, zip(*es))))


def lid3d_cfg(level=LEVEL_3D):
    """The bench's 3D figure (bench.py:279-294): the lid cavity in 3D, U
    = 1 on the top side and 0 on the other walls, V and W 0, pressure
    Neumann, nu 1e-3, beta 1, both projections one fixed cycle at nrelax 4
    and omega 1.5 (no TPU floor in 3D), the diffusion one cycle at 1
    sweep, the dense coarsest solve at 16^3 (dense_coarse_max 4096)."""
    import dataclasses
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.models import ns
    from gerris_tpu_torch.solvers.poisson import MultilevelParams
    u_bc = bc.FieldBC.make(3, default=bc.Dirichlet(0.0), top=bc.Dirichlet(1.0))
    v_bc = bc.FieldBC.uniform(bc.Dirichlet(0.0), 3)
    proj = MultilevelParams(tolerance=1e-3, nitermax=100, ncycles=1,
                            omega=1.5)
    diff = dataclasses.replace(proj, nrelax=1, omega=1.0)
    return ns.NSConfig(grid=Grid(level=level, dim=3), u_bcs=(u_bc, v_bc, v_bc),
                       nu=1e-3, beta=1.0, projection=proj,
                       approx_projection=proj, diffusion_params=diff)


def check_rbgs3d(rnd, dtype, record):
    """K13 against its plain version: at 128^3 with the projections'
    settings (Neumann, 4 sweeps, omega 1.5, dia 0) and the diffusion's
    (the lid's Dirichlet sides, 1 sweep, dia = 1/(dt nu) at dt = 0.8 h);
    at 32^3, 64^3 and (32, 64, 128) with mixed sides; at 256^3 in float32
    (the port's K13 has no plane limit); u left as it was.  Errors go to
    ``record`` when it is given."""
    import torch
    from gerris_tpu_torch.ops.cuda import rbgs3d
    name = str(dtype).replace("torch.", "")
    b = BOUND[name]
    n = 1 << LEVEL_3D
    mixed = (-1.0, 1.0, 1.0, -1.0, -1.0, 1.0)
    cases = [((n,) * 3, (1.0,) * 6, 4, 1.5, 0.0),
             ((n,) * 3, (-1.0,) * 6, 1, 1.0, 1.0 / (0.8 / n * 1e-3)),
             ((32,) * 3, mixed, 4, 1.5, 0.0), ((64,) * 3, mixed, 3, 1.3, 0.7),
             ((32, 64, 128), mixed, 4, 1.5, 0.0)]
    if dtype == torch.float32:
        cases.append(((256,) * 3, (1.0,) * 6, 4, 1.5, 0.0))
    errs = []
    for shape, signs, nsw, omega, dia in cases:
        u, rhs = rnd(dtype, *shape), rnd(dtype, *shape)
        u0 = u.clone()
        kw = dict(nsweeps=nsw, h2=1.0 / shape[0] ** 2, signs=signs,
                  omega=omega)
        errs.append(compare(
            f"K13 rbgs_relax_3d {shape} nsweeps={nsw} omega={omega} "
            f"dia={dia:.4g} signs={signs}",
            rbgs3d.rbgs_relax_3d(u, rhs, dia, **kw),
            rbgs3d.rbgs_relax_3d_plain(u, rhs, dia, **kw), b))
        if not torch.equal(u, u0):
            raise AssertionError("K13 changed its input u")
    if record is not None:
        record["rbgs_relax_3d"].update(zip(ERR_KEYS, map(max, zip(*errs))))


def check_relax_tiles(rnd):
    """K10 bit-identical across tiles 32 and 16, whole-level and tiled, on
    every periodicity, and with its sweeps split over two launches."""
    import torch
    from gerris_tpu_torch.ops.cuda import rbgs
    n = N_MAIN
    u, rhs = rnd(torch.float32, n, n), rnd(torch.float32, n, n)
    u64, r64 = u[:64, :64].contiguous(), rhs[:64, :64].contiguous()
    for per in ((False, False), (True, False), (True, True)):
        kw = dict(nsweeps=4, h2=1.0 / n ** 2, signs=(-1.0, 1.0, -1.0, 1.0),
                  periodic=per)
        if not torch.equal(rbgs.rbgs_relax(u, rhs, 0.5, tile=32, **kw),
                           rbgs.rbgs_relax(u, rhs, 0.5, tile=16, **kw)):
            raise AssertionError(f"K10 periodic={per}: tiles 32 and 16 "
                                 "differ")
        if not torch.equal(rbgs.rbgs_relax(u64, r64, 0.5, **kw),
                           rbgs.rbgs_relax(u64, r64, 0.5, tile=16,
                                           whole_max=32, **kw)):
            raise AssertionError(f"K10 periodic={per}: whole-level and "
                                 "tiled launches differ")
    kw["nsweeps"] = 40
    if not torch.equal(rbgs.rbgs_relax(u, rhs, 0.5, **kw),
                       rbgs.rbgs_relax(u, rhs, 0.5, tile=16, **kw)):
        raise AssertionError("K10: split sweeps differ across tiles")
    print("  K10 tile 32 == tile 16 at 2048, whole == tiled at 64, every "
          "periodicity; 40 sweeps over two launches: bit-identical")


ALPHA_CASES = (("walls", (-1.0, -1.0, -1.0, -1.0), (False, False)),
               ("per_x", (1.0, 1.0, -1.0, 1.0), (True, False)),
               ("per_xy", (1.0, 1.0, 1.0, 1.0), (True, True)))


def alpha_system(rnd, dtype, n, periodic, cell, dead):
    """u, rhs, positive face coefficients (face n = face 0 on a periodic
    axis, as the two-phase coefficients are), a scalar or positive cell
    dia; ``dead``: a few cells with all four faces and dia zero."""
    u, rhs = rnd(dtype, n, n), rnd(dtype, n, n)
    ax = 0.2 + rnd(dtype, n + 1, n).abs()
    ay = 0.2 + rnd(dtype, n, n + 1).abs()
    dia = 0.5 + rnd(dtype, n, n).abs() if cell else 0.3
    if periodic[0]:
        ax[n] = ax[0]
    if periodic[1]:
        ay[:, n] = ay[:, 0]
    if dead:
        for i, j in ((1, 2), (n // 2, n // 2 + 1), (n - 2, 3)):
            ax[i, j] = ax[i + 1, j] = ay[i, j] = ay[i, j + 1] = 0.0
            if cell:
                dia[i, j] = 0.0
        if not cell:
            dia = 0.0
    return u, rhs, ax, ay, dia


def check_alpha_kernels(rnd, dtype, record):
    """K15 against its plain version at 1024^2 (the twophase route's
    finest level): walls, periodic rows, doubly periodic; scalar and cell
    dia; omega 1 and 1.5; 8 sweeps (every upward level) and 24 (the
    coarsest level's 8 + 16); with zero-diagonal cells, which keep their
    value.  Then every level size of a correction down to 4^2."""
    from gerris_tpu_torch.ops.cuda import rbgs
    name = str(dtype).replace("torch.", "")
    b = BOUND[name]
    n = 1 << LEVEL_TWOPHASE
    errs = []
    for kind, signs, per in ALPHA_CASES:
        for cell in (False, True):
            for omega, nsw, dead in ((1.0, 8, False), (1.5, 8, True),
                                     (1.0, 24, True), (1.5, 24, False)):
                u, rhs, ax, ay, dia = alpha_system(rnd, dtype, n, per, cell,
                                                   dead)
                kw = dict(nsweeps=nsw, h2=1.0 / n ** 2, signs=signs,
                          periodic=per, omega=omega, dia_cell=cell)
                got = rbgs.rbgs_relax_alpha(u, rhs, ax, ay, dia, **kw)
                errs.append(compare(
                    f"K15 rbgs_relax_alpha {n} {kind} "
                    f"dia={'cell' if cell else 'scalar'} omega={omega} "
                    f"nsweeps={nsw}{' dead cells' if dead else ''}", got,
                    rbgs.rbgs_relax_alpha_plain(u, rhs, ax, ay, dia, **kw),
                    b))
                if dead and not (got[1, 2] == u[1, 2]
                                 and got[n - 2, 3] == u[n - 2, 3]):
                    raise AssertionError("K15: a zero-diagonal cell moved")
    m = n // 2
    while m >= 4:
        for kind, signs, per in ALPHA_CASES:
            u, rhs, ax, ay, dia = alpha_system(rnd, dtype, m, per, True,
                                               False)
            kw = dict(nsweeps=24 if m == 4 else 8, h2=1.0 / m ** 2,
                      signs=signs, periodic=per, omega=1.0, dia_cell=True)
            compare(f"K15 rbgs_relax_alpha {m} {kind}",
                    rbgs.rbgs_relax_alpha(u, rhs, ax, ay, dia, **kw),
                    rbgs.rbgs_relax_alpha_plain(u, rhs, ax, ay, dia, **kw),
                    b)
        m //= 2
    if record is not None:
        record["rbgs_relax_alpha"].update(zip(ERR_KEYS, map(max, zip(*errs))))


def check_alpha_tiles(rnd):
    """K15 bit-identical across tiles 64, 32 and 16 at 1024^2 (float32;
    32 and 16 in float64), whole-level and tiled at 64^2, on every
    periodicity, and with its sweeps split over launches."""
    import torch
    from gerris_tpu_torch.ops.cuda import rbgs
    n = 1 << LEVEL_TWOPHASE
    for dtype, tiles in ((torch.float32, (64, 32, 16)),
                         (torch.float64, (32, 16))):
        for kind, signs, per in ALPHA_CASES:
            u, rhs, ax, ay, dia = alpha_system(rnd, dtype, n, per, True, True)
            kw = dict(nsweeps=8, h2=1.0 / n ** 2, signs=signs, periodic=per,
                      omega=1.5, dia_cell=True)
            outs = [rbgs.rbgs_relax_alpha(u, rhs, ax, ay, dia, tile=t, **kw)
                    for t in tiles]
            if not all(torch.equal(outs[0], o) for o in outs[1:]):
                raise AssertionError(f"K15 {kind} {dtype}: tiles {tiles} "
                                     "differ")
            s64 = alpha_system(rnd, dtype, 64, per, True, True)
            if not torch.equal(
                    rbgs.rbgs_relax_alpha(*s64, **kw),
                    rbgs.rbgs_relax_alpha(*s64, tile=16, whole_max=32,
                                          **kw)):
                raise AssertionError(f"K15 {kind} {dtype}: whole-level and "
                                     "tiled launches differ")
            rbgs.reset_launch_counts()
            split = rbgs.rbgs_relax_alpha(u, rhs, ax, ay, dia, tile=32,
                                          **dict(kw, nsweeps=30))
            if rbgs.LAUNCHES["rbgs_relax_alpha"] < 2 or not torch.equal(
                    split, rbgs.rbgs_relax_alpha(u, rhs, ax, ay, dia,
                                                 tile=16,
                                                 **dict(kw, nsweeps=30))):
                raise AssertionError(f"K15 {kind} {dtype}: split sweeps "
                                     "differ across tiles")
    print(f"  K15 tiles 64 == 32 == 16 at {n} (float64: 32 == 16), whole "
          "== tiled at 64, every periodicity; 30 sweeps over several "
          "launches: bit-identical")


def alpha_flops(n, nsweeps, omega):
    """Operations of K15 on an n^2 level: den once (5 per cell), then per
    sweep the numerator (7), the rhs term (2), the division (1) and the
    omega blend (3)."""
    return n * n * (5 + nsweeps * (10 + (3 if omega != 1.0 else 0)))


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(in_bytes, out, flops):
    """(bound_ms, bound_by): the larger of the bytes a call must move (its
    inputs read once, its outputs written once) over HBM3's rate and its
    float32 operations over the card's peak rate."""
    out = out if isinstance(out, (tuple, list)) else (out,)
    t_bytes = (in_bytes + nbytes(*out)) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cycle_flops(n, nsweeps, omega):
    """Operations of K3 on an n^2 level: the prolongation (6 per cell), a
    sweep's update (7 per cell, 3 more with omega != 1), the + u (1)."""
    return n * n * (7 + nsweeps * (7 + (3 if omega != 1.0 else 0)))


def cascade_flops(n_half, nsweeps, omega, coarsest=40):
    """Operations of K2 at n/2 = n_half: K3 at every level from 2 x 16 up
    to n_half, ``coarsest`` sweeps at 16^2, and the pools (3 per coarse
    cell) from n_half/4 down to 16."""
    levels = [n_half >> k for k in range(CASCADE_LEVELS - 1)]
    return (sum(cycle_flops(m, nsweeps, omega) for m in levels)
            + cycle_flops(16, coarsest, omega)
            + sum(m * m * 3 for m in levels[2:]) + 16 * 16 * 3)


def vcycle_flops(n_top, nsweeps, coarsest, min_n=16):
    """Operations of K12 at n_top: K3's at every level from 2 min_n up to
    n_top, ``coarsest`` sweeps at min_n^2, the pools (3 per coarse cell)."""
    levels = [m for m in (n_top >> k for k in range(12)) if m > min_n]
    return (sum(cycle_flops(m, nsweeps, 1.0) for m in levels)
            + cycle_flops(min_n, coarsest, 1.0)
            + sum((m // 2) ** 2 * 3 for m in levels))


def phase_kernels(dev, record):
    import torch
    import torch.nn.functional as F
    from gerris_tpu_torch.ops.cuda import bcg, predict, projops, rbgs
    from gerris_tpu_torch.solvers.poisson import _signs_offs
    cfg = lid_cfg(11)
    signs, offs = _signs_offs(cfg.grid, cfg.u_bcs[0], homogeneous=False)
    gen = torch.Generator(device=dev).manual_seed(20261016)
    n = N_MAIN
    h2 = 1.0 / n ** 2
    # the diffusion systems' dia = 1/(dt nu) at dt = 0.8 h
    dia_diff = 1.0 / (0.8 / n * 1e-3)

    def rnd(dtype, *shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    for dtype in (torch.float64, torch.float32):
        name = str(dtype).replace("torch.", "")
        b13 = BOUND[name]
        b2 = 1e-12 if dtype == torch.float64 else 1e-4
        main = dtype == torch.float32
        print(f"phase 2 [{name}]")
        u, rhs, sub = rnd(dtype, n, n), rnd(dtype, n, n), rnd(dtype, 1)
        kw = dict(h2=h2, signs=signs, offs=offs, per_y=False)
        e = compare("K1 residual_restrict 2048",
                    rbgs.residual_restrict(u, rhs, dia_diff, sub, **kw),
                    rbgs.residual_restrict_plain(u, rhs, dia_diff, sub, **kw),
                    b13)
        if main:
            record["residual_restrict"].update(zip(ERR_KEYS, e))
        m = 512
        while m >= 32:
            r = rnd(dtype, m, m)
            e = compare(f"restrict2 {m}", rbgs.restrict2(r),
                        rbgs.pool_plain(r), b13)
            if main and m == 512:
                record["restrict2"].update(zip(ERR_KEYS, e))
            m //= 2
        # K3 at every level of the main path's cycle
        for m, nsw, omega, dia, add_u in (
                (2048, 5, 1.5, 0.0, True), (2048, 1, 1.0, dia_diff, True),
                (1024, 5, 1.5, 0.0, False), (512, 5, 1.5, 0.0, False),
                (256, 1, 1.0, dia_diff / 4, False),
                (128, 5, 1.5, 0.0, False), (64, 5, 1.5, 0.0, False),
                (32, 5, 1.5, 0.0, False), (16, 40, 1.5, 0.0, None)):
            c = None if add_u is None else rnd(dtype, m // 2, m // 2)
            rh = rnd(dtype, m, m)
            uu = rnd(dtype, m, m) if add_u else None
            kw = dict(nsweeps=nsw, h2=1.0 / m ** 2, signs=signs,
                      per_y=False, omega=omega)
            e = compare(f"K3 prolong_relax {m} nsweeps={nsw} omega={omega}"
                        f"{' coarse=None' if c is None else ''}",
                        rbgs.prolong_relax(c, rh, dia, uu, **kw),
                        rbgs.prolong_relax_plain(c, rh, dia, uu, **kw), b13)
            if main and m == 2048 and nsw == 5:
                record["prolong_relax"].update(zip(ERR_KEYS, e))
        # periodic columns (not on the lid path; kept covered)
        c, rh = rnd(dtype, 128, 128), rnd(dtype, 256, 256)
        kw = dict(nsweeps=5, h2=1.0 / 256 ** 2, signs=(-1.0, 1.0, 1.0, 1.0),
                  per_y=True, omega=1.5)
        compare("K3 prolong_relax 256 per_y",
                rbgs.prolong_relax(c, rh, 0.0, **kw),
                rbgs.prolong_relax_plain(c, rh, 0.0, **kw), b13)
        # K2 at the main path's n/2 = 1024, projection and diffusion
        r1, r2 = rnd(dtype, 1024, 1024), rnd(dtype, 512, 512)
        for nsw, omega, dia in ((5, 1.5, 0.0), (1, 1.0, dia_diff)):
            kw = dict(nsweeps=nsw, coarsest=40, h2_half=4 * h2, signs=signs,
                      per_y=False, omega=omega)
            e = compare(f"K2 cascade_prolong_relax 1024 nsweeps={nsw}",
                        rbgs.cascade_prolong_relax(r1, r2, dia, **kw),
                        rbgs.cascade_prolong_relax_plain(r1, r2, dia, **kw),
                        b2)
            if main and nsw == 5:
                record["cascade_prolong_relax"].update(zip(ERR_KEYS, e))
        # the diffusion pair, and the predictor, projection and advection
        # kernels, at the main path's size and at the Ghia phase's
        check_pair_kernels(rnd, dtype, n, record if main else None)
        check_pair_kernels(rnd, dtype, N_SMALL, None)
        check_face_kernels(rnd, dtype, n, record if main else None)
        check_face_kernels(rnd, dtype, N_SMALL, None)
        check_adaptive_kernels(rnd, dtype, record if main else None)
        check_fold_kernels(rnd, dtype, n, record if main else None)
        check_fold_kernels(rnd, dtype, N_SMALL, None)
        check_rbgs3d(rnd, dtype, record if main else None)
        check_alpha_kernels(rnd, dtype, record if main else None)
    check_relax_tiles(rnd)
    check_fold_tiles(rnd)
    check_alpha_tiles(rnd)

    # K3 tile invariance: bit-identical across tile sizes and whole-level
    c, rh, uu = (rnd(torch.float32, n // 2, n // 2),
                 rnd(torch.float32, n, n), rnd(torch.float32, n, n))
    kw = dict(nsweeps=5, h2=h2, signs=signs, omega=1.5)
    a = rbgs.prolong_relax(c, rh, 0.0, uu, tile=32, **kw)
    b = rbgs.prolong_relax(c, rh, 0.0, uu, tile=16, **kw)
    if not torch.equal(a, b):
        raise AssertionError("K3: tile 32 and tile 16 differ")
    c, rh = rnd(torch.float32, 32, 32), rnd(torch.float32, 64, 64)
    if not torch.equal(rbgs.prolong_relax(c, rh, 0.0, **kw),
                       rbgs.prolong_relax(c, rh, 0.0, tile=16, whole_max=32,
                                          **kw)):
        raise AssertionError("K3: whole-level and tiled launches differ")
    print("  K3 tile 32 == tile 16 at 2048, whole == tiled at 64: "
          "bit-identical")
    # K8c: the same, for both systems of a pair (own dias)
    cs = [rnd(torch.float32, n // 2, n // 2) for _ in range(2)]
    rhs_s = [rnd(torch.float32, n, n) for _ in range(2)]
    us = [rnd(torch.float32, n, n) for _ in range(2)]
    dias = [dia_diff, 0.5 * dia_diff]
    kw = dict(nsweeps=1, h2=h2, signs=signs)
    a = rbgs.prolong_relax_pair(cs, rhs_s, dias, us, tile=32, **kw)
    b = rbgs.prolong_relax_pair(cs, rhs_s, dias, us, tile=16, **kw)
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("K8c: tile 32 and tile 16 differ")
    cs = [rnd(torch.float32, 32, 32) for _ in range(2)]
    rhs_s = [rnd(torch.float32, 64, 64) for _ in range(2)]
    kw["h2"] = 1.0 / 64 ** 2
    none = [None, None]
    if not all(torch.equal(x, y) for x, y in zip(
            rbgs.prolong_relax_pair(cs, rhs_s, dias, none, **kw),
            rbgs.prolong_relax_pair(cs, rhs_s, dias, none, tile=16,
                                    whole_max=32, **kw))):
        raise AssertionError("K8c: whole-level and tiled launches differ")
    print("  K8c tile 32 == tile 16 at 2048, whole == tiled at 64: "
          "bit-identical")

    # times at the main path's shapes, float32 (CUDA events).  Each entry:
    # (kernel call, plain call, input bytes, operations, library call); a
    # key "name|variant" records the variant's times beside the kernel's
    # own as ms_variant, plain_ms_variant and bound_ms_variant
    f32 = torch.float32
    h = 1.0 / n
    dt = 0.8 * h
    u, rhs, sub = rnd(f32, n, n), rnd(f32, n, n), rnd(f32, 1)
    kw = dict(h2=h2, signs=signs, offs=offs, per_y=False)
    timings = {
        # residual (7 per cell) + two pools (3 per coarse cell)
        "residual_restrict": (
            lambda: rbgs.residual_restrict(u, rhs, 0.0, sub, **kw),
            lambda: rbgs.residual_restrict_plain(u, rhs, 0.0, sub, **kw),
            nbytes(u, rhs, sub), n * n * 8, None),
    }
    r512 = rnd(f32, 512, 512)
    r512_4d = r512.view(1, 1, 512, 512)
    timings["restrict2"] = (lambda: rbgs.restrict2(r512),
                            lambda: rbgs.pool_plain(r512), nbytes(r512),
                            256 * 256 * 3,
                            lambda: F.avg_pool2d(r512_4d, 2))
    c = rnd(f32, n // 2, n // 2)
    kw3 = dict(nsweeps=5, h2=h2, signs=signs, per_y=False, omega=1.5)
    timings["prolong_relax"] = (
        lambda: rbgs.prolong_relax(c, rhs, 0.0, u, **kw3),
        lambda: rbgs.prolong_relax_plain(c, rhs, 0.0, u, **kw3),
        nbytes(c, rhs, u), cycle_flops(n, 5, 1.5), None)
    r1, r2 = rnd(f32, n // 2, n // 2), rnd(f32, n // 4, n // 4)
    kw2 = dict(nsweeps=5, coarsest=40, h2_half=4 * h2, signs=signs,
               per_y=False, omega=1.5)
    timings["cascade_prolong_relax"] = (
        lambda: rbgs.cascade_prolong_relax(r1, r2, 0.0, **kw2),
        lambda: rbgs.cascade_prolong_relax_plain(r1, r2, 0.0, **kw2),
        nbytes(r1, r2), cascade_flops(n // 2, 5, 1.5), None)
    # the diffusion pair as the main path runs it: 1 sweep, omega 1, both
    # systems at dia = 1/(dt nu), their own ghost offsets and subs
    offss = [offs, _signs_offs(cfg.grid, cfg.u_bcs[1],
                               homogeneous=False)[1]]
    dias = [dia_diff, dia_diff]
    us = [rnd(f32, n, n) for _ in range(2)]
    rhss = [rnd(f32, n, n) for _ in range(2)]
    subs = [sub, rnd(f32, 1)]
    kwa = dict(h2=h2, signs=signs, offss=offss, per_y=False)
    timings["residual_restrict_pair"] = (
        lambda: rbgs.residual_restrict_pair(us, rhss, dias, subs, **kwa),
        lambda: rbgs.residual_restrict_pair_plain(us, rhss, dias, subs,
                                                  **kwa),
        nbytes(*us, *rhss, *subs), 2 * n * n * 8, None)
    r1s = [rnd(f32, n // 2, n // 2) for _ in range(2)]
    r2s = [rnd(f32, n // 4, n // 4) for _ in range(2)]
    kwb = dict(nsweeps=1, coarsest=40, h2_half=4 * h2, signs=signs,
               per_y=False, omega=1.0)
    timings["cascade_prolong_relax_pair"] = (
        lambda: rbgs.cascade_prolong_relax_pair(r1s, r2s, dias, **kwb),
        lambda: rbgs.cascade_prolong_relax_pair_plain(r1s, r2s, dias, **kwb),
        nbytes(*r1s, *r2s), 2 * cascade_flops(n // 2, 1, 1.0), None)
    cs = [rnd(f32, n // 2, n // 2) for _ in range(2)]
    kwc = dict(nsweeps=1, h2=h2, signs=signs, per_y=False, omega=1.0)
    timings["prolong_relax_pair"] = (
        lambda: rbgs.prolong_relax_pair(cs, rhss, dias, us, **kwc),
        lambda: rbgs.prolong_relax_pair_plain(cs, rhss, dias, us, **kwc),
        nbytes(*cs, *rhss, *us), 2 * cycle_flops(n, 1, 1.0), None)
    grid, u_bcs, p_bc = cfg.grid, cfg.u_bcs, cfg.p_bc
    dia = 1.0 / (dt * cfg.nu)
    U, V, Gx, Gy, p = (rnd(f32, n, n) for _ in range(5))
    ufx, ufy = rnd(f32, n + 1, n), rnd(f32, n, n + 1)
    # K6: per face ~30 (slope, limits, transverse term, Godunov choice),
    # two faces per cell
    timings["predict_xy"] = (
        lambda: predict.predict_xy(U, V, dt, grid, u_bcs),
        lambda: predict.predict_xy_plain(U, V, dt, grid, u_bcs),
        nbytes(U, V), n * n * 60, None)
    # K4: 3 differences, a scale, a sum per cell
    timings["divergence_mac"] = (
        lambda: projops.divergence_mac(ufx, ufy, dt, h),
        lambda: projops.divergence_mac_plain(ufx, ufy, dt, h),
        nbytes(ufx, ufy), n * n * 5, None)
    # K5 with the cells, as in the approximate projection (21 of 41
    # launches): 4 face gradients (2 each), 2 face and 2 cell corrections
    # (2 each), 2 cell gradients (2 each)
    timings["correct_project"] = (
        lambda: projops.correct_project(p, ufx, ufy, dt, grid, p_bc, (U, V)),
        lambda: projops.correct_project_plain(p, ufx, ufy, dt, grid, p_bc,
                                              (U, V)),
        nbytes(p, ufx, ufy, U, V), n * n * 20, None)
    timings["correct_project|without_cells"] = (
        lambda: projops.correct_project(p, ufx, ufy, dt, grid, p_bc),
        lambda: projops.correct_project_plain(p, ufx, ufy, dt, grid, p_bc),
        nbytes(p, ufx, ufy), n * n * 16, None)
    # the fold route's kernels with the lid's pressure ghosts.  K16: K4's
    # divergence (4 per cell) and K1's residual and pools (8 per cell)
    kw16 = dict(h2=h2, signs=(1.0,) * 4, offs=(0.0,) * 4, per_y=False)
    timings["residual_restrict_div"] = (
        lambda: rbgs.residual_restrict_div(u, ufx, ufy, dt * h, 0.0, 0.0,
                                           **kw16),
        lambda: rbgs.residual_restrict_div_plain(u, ufx, ufy, dt * h, 0.0,
                                                 0.0, **kw16),
        nbytes(u, ufx, ufy), n * n * 12, None)
    # K17 at the projections' 5 sweeps, omega 1.5: K3's operations and
    # K5's, with the cells as in the approximate projection and without
    # as in the MAC projection
    kw17 = dict(nsweeps=5, h2=h2, signs=(1.0,) * 4, offs=(0.0,) * 4,
                per_y=False, omega=1.5)
    timings["prolong_relax_correct"] = (
        lambda: rbgs.prolong_relax_correct(c, rhs, 0.0, u, ufx, ufy, dt, h,
                                           (U, V), **kw17),
        lambda: rbgs.prolong_relax_correct_plain(c, rhs, 0.0, u, ufx, ufy,
                                                 dt, h, (U, V), **kw17),
        nbytes(c, rhs, u, ufx, ufy, U, V), cycle_flops(n, 5, 1.5) + n * n * 20,
        None)
    timings["prolong_relax_correct|without_cells"] = (
        lambda: rbgs.prolong_relax_correct(c, rhs, 0.0, u, ufx, ufy, dt, h,
                                           **kw17),
        lambda: rbgs.prolong_relax_correct_plain(c, rhs, 0.0, u, ufx, ufy,
                                                 dt, h, **kw17),
        nbytes(c, rhs, u, ufx, ufy), cycle_flops(n, 5, 1.5) + n * n * 16,
        None)
    # K9 with gp, as in every step: 2 cell updates, 2 face means (2 each)
    timings["interp_faces"] = (
        lambda: projops.interp_faces(U, V, grid, u_bcs, (Gx, Gy), dt),
        lambda: projops.interp_faces_plain(U, V, grid, u_bcs, (Gx, Gy), dt),
        nbytes(U, V, Gx, Gy), n * n * 8, None)
    # K14 of u with the g, gp and oscale folds, as on the main path: two
    # faces per cell at ~32 each (2 BCG values ~13 each, the Godunov
    # choice, the g correction 4, the flux 1), the flux difference, gp
    # and oscale ~10
    timings["advect2d"] = (
        lambda: bcg.advect2d(U, 0, ufx, ufy, dt, grid, u_bcs[0], g=Gx,
                             gp=Gy, oscale=-dia),
        lambda: bcg.advect2d_plain(U, 0, ufx, ufy, dt, grid, u_bcs[0], g=Gx,
                                   gp=Gy, oscale=-dia),
        nbytes(U, ufx, ufy, Gx, Gy), n * n * 75, None)
    # K7 as on the main path: both components, g, gp and oscale, K14's
    # operations twice; rr_dia mode: the residual (7 per cell) and the two
    # pools (3 per coarse cell) of both systems on top
    GPx, GPy = rnd(f32, n, n), rnd(f32, n, n)
    kw7 = dict(g=(Gx, Gy), gp=(GPx, GPy), oscale=-dia)
    in7 = nbytes(U, V, ufx, ufy, Gx, Gy, GPx, GPy)
    timings["advect2d_pair"] = (
        lambda: bcg.advect2d_pair(U, V, ufx, ufy, dt, grid, u_bcs, **kw7),
        lambda: bcg.advect2d_pair_plain(U, V, ufx, ufy, dt, grid, u_bcs,
                                        **kw7),
        in7, 2 * n * n * 75, None)
    timings["advect2d_pair|rr_dia"] = (
        lambda: flat(bcg.advect2d_pair(U, V, ufx, ufy, dt, grid, u_bcs,
                                       rr_dia=dia, **kw7)),
        lambda: flat(bcg.advect2d_pair_plain(U, V, ufx, ufy, dt, grid, u_bcs,
                                             rr_dia=dia, **kw7)),
        in7, 2 * n * n * (75 + 8), None)
    # the adaptive routes' kernels.  K11 with the lid's offsets: the
    # neighbour sum, the difference, the scale, the dia term (8 per cell)
    kw11 = dict(h2=h2, signs=signs, offs=offs)
    timings["residual"] = (
        lambda: rbgs.residual(u, rhs, dia, **kw11),
        lambda: rbgs.residual_plain(u, rhs, dia, **kw11),
        nbytes(u, rhs), n * n * 8, None)
    # K10 as the "relax" diffusion runs it (4 sweeps at dia = 1/(dt nu), 7
    # per cell per sweep), and as the periodic corrections run it
    kw10 = dict(nsweeps=4, h2=h2, signs=signs)
    timings["rbgs_relax"] = (
        lambda: rbgs.rbgs_relax(u, rhs, dia, **kw10),
        lambda: rbgs.rbgs_relax_plain(u, rhs, dia, **kw10),
        nbytes(u, rhs), n * n * 4 * 7, None)
    kwp = dict(kw10, signs=(1.0,) * 4, periodic=(True, True))
    timings["rbgs_relax|periodic"] = (
        lambda: rbgs.rbgs_relax(u, rhs, 0.0, **kwp),
        lambda: rbgs.rbgs_relax_plain(u, rhs, 0.0, **kwp),
        nbytes(u, rhs), n * n * 4 * 7, None)
    # K12 as the adaptive projections run it: 512^2 with the adaptive
    # schedule's 5 sweeps and 40 coarsest; its block kernel alone at 64^2
    r512k, r64k = rnd(f32, 512, 512), rnd(f32, 64, 64)
    kw12 = dict(nsweeps=5, coarsest=40, h2=16 * h2, signs=(1.0,) * 4,
                min_n=16)
    timings["coarse_vcycle"] = (
        lambda: rbgs.coarse_vcycle(r512k, 0.0, **kw12),
        lambda: rbgs.coarse_vcycle_plain(r512k, 0.0, **kw12),
        nbytes(r512k), vcycle_flops(512, 5, 40), None)
    kwcb = dict(kw12, h2=(n // 64) ** 2 * h2)
    timings["coarse_block"] = (
        lambda: rbgs.coarse_block(r64k, 0.0, **kwcb),
        lambda: rbgs.coarse_vcycle_plain(r64k, 0.0, **kwcb),
        nbytes(r64k), vcycle_flops(64, 5, 40), None)
    # K13 at 128^3 as the projections run it (4 sweeps, omega 1.5: 10 per
    # cell per sweep) and as the diffusion does (1 sweep, 7 per cell)
    from gerris_tpu_torch.ops.cuda import rbgs3d
    n3 = 1 << LEVEL_3D
    u3, r3 = rnd(f32, n3, n3, n3), rnd(f32, n3, n3, n3)
    kw13 = dict(nsweeps=4, h2=1.0 / n3 ** 2, signs=(1.0,) * 6, omega=1.5)
    timings["rbgs_relax_3d"] = (
        lambda: rbgs3d.rbgs_relax_3d(u3, r3, 0.0, **kw13),
        lambda: rbgs3d.rbgs_relax_3d_plain(u3, r3, 0.0, **kw13),
        nbytes(u3, r3), n3 ** 3 * 4 * 10, None)
    dia3 = 1.0 / (0.8 / n3 * 1e-3)
    kw13d = dict(nsweeps=1, h2=1.0 / n3 ** 2, signs=(-1.0,) * 6)
    timings["rbgs_relax_3d|diffusion"] = (
        lambda: rbgs3d.rbgs_relax_3d(u3, r3, dia3, **kw13d),
        lambda: rbgs3d.rbgs_relax_3d_plain(u3, r3, dia3, **kw13d),
        nbytes(u3, r3), n3 ** 3 * 7, None)
    # K15 as the twophase route runs it at its finest level, 1024^2: the
    # diffusion's cell dia (rho) and 8 sweeps, and the projections'
    # scalar dia 0
    na = 1 << LEVEL_TWOPHASE
    ua, ra, axa, aya, da = alpha_system(rnd, f32, na, (False, False), True,
                                        False)
    kw15 = dict(nsweeps=8, h2=1.0 / na ** 2, signs=(-1.0,) * 4)
    timings["rbgs_relax_alpha"] = (
        lambda: rbgs.rbgs_relax_alpha(ua, ra, axa, aya, da, dia_cell=True,
                                      **kw15),
        lambda: rbgs.rbgs_relax_alpha_plain(ua, ra, axa, aya, da,
                                            dia_cell=True, **kw15),
        nbytes(ua, ra, axa, aya, da), alpha_flops(na, 8, 1.0), None)
    kw15p = dict(kw15, signs=(1.0,) * 4)
    timings["rbgs_relax_alpha|scalar_dia"] = (
        lambda: rbgs.rbgs_relax_alpha(ua, ra, axa, aya, 0.0, **kw15p),
        lambda: rbgs.rbgs_relax_alpha_plain(ua, ra, axa, aya, 0.0, **kw15p),
        nbytes(ua, ra, axa, aya), alpha_flops(na, 8, 1.0), None)
    # K15 at every level of a twophase correction with the default tiles
    # (printed only; the record holds the 1024^2 time)
    per_level = []
    m = na
    while m >= 4:
        ul, rl, axl, ayl, dl = alpha_system(rnd, f32, m, (False, False),
                                            True, False)
        kwl = dict(nsweeps=24 if m == 4 else 8, h2=1.0 / m ** 2,
                   signs=(-1.0,) * 4, dia_cell=True)
        t = cuda_ms(lambda: rbgs.rbgs_relax_alpha(ul, rl, axl, ayl, dl,
                                                  **kwl))
        per_level.append(f"{m}: {t:.4f}")
        m //= 2
    print(f"  K15 per level of a twophase correction (float32, cell dia, 8 "
          f"sweeps, 24 at 4^2; ms): {', '.join(per_level)}")
    print("phase 2 times (float32, main-path shapes; plain, kernel, "
          "kernel, plain)")
    for k, (kern, plain, in_bytes, ops, lib) in timings.items():
        p1 = cuda_ms(plain)
        k1 = cuda_ms(kern)
        k2 = cuda_ms(kern)
        p2 = cuda_ms(plain)
        lib_ms = None if lib is None else cuda_ms(lib)
        out = kern()
        bms, by = bound(in_bytes, flat(out) if isinstance(out[0], list)
                        else out, ops)
        vals = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}
        name, _, variant = k.partition("|")
        if variant:
            record[name].update(
                {f"{key}_{variant}": v for key, v in vals.items()
                 if key in ("ms", "plain_ms", "bound_ms")})
        else:
            record[k].update(vals)
        print(f"  {k}: kernel {k1:.4f} {k2:.4f} ms, plain {p1:.4f} "
              f"{p2:.4f} ms, bound {bms:.4f} ms ({by})"
              + ("" if lib_ms is None else f", library {lib_ms:.4f} ms"))


def lid_sim(dev, route, level=11):
    """The 2^level lid cavity of ``route`` (ROUTES), float32, after init.
    dtmax = the bench's fixed dt 0.8 h; from rest the CFL bound is
    unbounded, later steps run at 0.8 h / max|u| <= 0.8 h."""
    import torch
    from gerris_tpu_torch.models.simulation import Simulation, Time
    cfg = lid_cfg(level, **ROUTES[route])
    return Simulation(cfg, time=Time(dtmax=0.8 * cfg.grid.h), device=dev,
                      dtype=torch.float32).init()


def run_route(dev, route, steps):
    """init + ``steps`` steps of ``route`` through the kernels, with the
    launch counts set to 0 just before and gated just after; then the same
    steps through the plain versions on the card, held to MAIN_PATH_RTOL.
    Returns (the simulation, its launch counts)."""
    import torch
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = lid_sim(dev, route)
    s.run(max_steps=steps)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    counts = launch_counts()
    print(f"  {route} route, init + {steps} steps: {t_run:.3f} s; "
          f"launches {counts}")
    for k, want in want_launches(route, steps).items():
        if counts[k] != want:
            raise AssertionError(f"{route} route: {k}: {counts[k]} "
                                 f"launches, want {want}")
    for k, v in s.state.items():
        if v.shape != s.cfg.grid.shape or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{k}: not finite or wrong shape")
    with plain_versions():
        ref = lid_sim(dev, route).run(max_steps=steps)
    if launch_counts() != counts:
        raise AssertionError("the plain reference run launched kernels")
    for k in ("U", "V", "P"):
        rel = rel_err(s.state[k], ref.state[k])
        print(f"  {route} route, kernels vs plain after {steps} steps, {k}: "
              f"rel {rel:.3e} (bound {MAIN_PATH_RTOL:.0e})")
        if not rel <= MAIN_PATH_RTOL:
            raise AssertionError(f"{route} route {k}: rel {rel:.3e}")
    return s, counts


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max())


def phase_main_path(dev, card):
    import torch
    print(f"phase 3: {N_MAIN}^2 lid cavity, float32, {MAIN_STEPS} steps, "
          "the bench's route")
    s, counts = run_route(dev, "pair", MAIN_STEPS)

    walls = []
    for _ in range(TIMED_WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.run(max_steps=TIMED_STEPS)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    dt = float(np.median(walls))
    sps = TIMED_STEPS / dt
    print(f"  timed windows of {TIMED_STEPS} steps: "
          f"{' '.join(f'{w:.4f}' for w in walls)} s; median {sps:.3f} "
          f"steps/s, {sps * N_MAIN ** 2 / 1e6:.2f}M cell-updates/s on {card}")
    phase_profile(s, dt / TIMED_STEPS, card)
    return counts, s


def phase_routes(dev, card, main_sim):
    """The per-component, rr_in_advect and fold routes at ROUTE_STEPS
    steps, each gated and held to its plain versions, and each against
    the bench's route after the same steps on the card (the same
    functions: K7 computes K14 twice over, its rr_dia mode K8a's
    residual; the fold routes drop the compatibility mean, a rounding
    error here, and their P is compared with its mean taken out, as a
    pure-Neumann pressure is defined up to a constant); then
    fold_correct's step timed beside the main path's and profiled.
    Returns the launch counts by route."""
    print(f"phase 3, other routes: {N_MAIN}^2, float32, {ROUTE_STEPS} steps")
    pair = lid_sim(dev, "pair").run(max_steps=ROUTE_STEPS)
    counts, sims = {}, {}
    for route in ("per_component", "rr", "fold_div", "fold_correct"):
        s, counts[route] = run_route(dev, route, ROUTE_STEPS)
        sims[route] = s
        fold = route.startswith("fold")
        for k in ("U", "V", "P"):
            a, b = s.state[k], pair.state[k]
            if fold and k == "P":
                a, b = a - a.mean(), b - b.mean()
            rel = rel_err(a, b)
            same = bool((a == b).all())
            print(f"  {route} vs pair route after {ROUTE_STEPS} steps, {k}"
                  f"{' mean-free' if fold and k == 'P' else ''}: rel "
                  f"{rel:.3e} (bound {MAIN_PATH_RTOL:.0e}), "
                  f"bit-identical={same}")
            if not rel <= MAIN_PATH_RTOL:
                raise AssertionError(f"{route} vs pair route {k}: "
                                     f"rel {rel:.3e}")
    dropped_mean(pair)
    time_fold(sims["fold_correct"], main_sim, card)
    return counts


def dropped_mean(sim):
    """The compatibility mean that the fold route drops, at the state of
    ``sim``: total / ncells of the approximate projection's divergence
    (K9's faces with the gc re-add), against max|div|."""
    from gerris_tpu_torch.ops.cuda import projops
    from gerris_tpu_torch.solvers import projection as proj
    cfg, st = sim.cfg, sim.state
    dt = 0.8 * cfg.grid.h
    uf, _, _ = proj.face_interpolated_velocity(
        [st["U"], st["V"]], cfg.grid, list(cfg.u_bcs),
        gp=[st["Gx"], st["Gy"]], dtv=dt)
    div, total = projops.divergence_mac(uf[0], uf[1], dt, cfg.grid.h)
    mean = float(total[0]) / div.numel()
    print(f"  the dropped compatibility mean at the pair route's state: "
          f"{mean:.3e}, {abs(mean) / float(div.abs().max()):.3e} of "
          f"max|div/dt|")


def time_fold(fold_sim, main_sim, card):
    """fold_correct's step against the main path's, TIMED_STEPS-step
    windows in turns (main, fold) five times, then a profile of the fold
    route.  For the record only: nothing is gated on the times."""
    import torch
    walls = {"main": [], "fold_correct": []}
    for _ in range(TIMED_WINDOWS):
        for name, s in (("main", main_sim), ("fold_correct", fold_sim)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.run(max_steps=TIMED_STEPS)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
    step = {k: float(np.median(w)) / TIMED_STEPS for k, w in walls.items()}
    for k, w in walls.items():
        print(f"  {k} step, windows of {TIMED_STEPS} steps in turns: "
              f"{' '.join(f'{x:.4f}' for x in w)} s; median "
              f"{step[k] * 1e3:.3f} ms/step on {card}")
    phase_profile(fold_sim, step["fold_correct"], card)


def phase_profile(s, step_s, card, steps=PROFILE_STEPS):
    """torch.profiler over ``steps`` steps of the running simulation:
    device time by kernel, the port's kernels against the plain torch
    ops, and the device's busy share of an unprofiled step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        s.run(max_steps=steps)
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        # device-side events only (kernels, copies, sets): a CPU op's
        # device time repeats its kernels'
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        rows.append((us, evt.count, evt.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    if total <= 0:
        raise AssertionError("profiler: no device time recorded")
    own = sum(r[0] for r in rows if any(k in r[2] for k in OWN_KERNELS))
    launches = sum(r[1] for r in rows)
    busy = total / 1e6 / steps
    print(f"  profile, {steps} steps on {card}: device {total / 1e3:.3f}"
          f" ms ({busy * 1e3:.3f} ms/step); {launches / steps:.0f} "
          f"device ops per step")
    print(f"  port kernels {own / 1e3:.3f} ms ({100 * own / total:.1f}%), "
          f"plain torch {(total - own) / 1e3:.3f} ms "
          f"({100 * (total - own) / total:.1f}%); unprofiled step "
          f"{step_s * 1e3:.3f} ms, device busy {100 * busy / step_s:.1f}% "
          f"of it")
    for us, count, key in rows[:16]:
        print(f"    {us / 1e3:9.3f} ms {100 * us / total:5.1f}% "
              f"{count / steps:6.1f}/step  {key[:90]}")


@contextlib.contextmanager
def recording_solves():
    """Record every poisson.solve call of the block: (solver, niter, a
    fixed count (nitermin = nitermax) or not, host syncs)."""
    from gerris_tpu_torch.solvers import poisson
    solve = poisson.solve
    log = []

    def recorded(*args, **kw):
        out = solve(*args, **kw)
        params = args[4] if len(args) > 4 else kw["params"]
        fixed = params.ncycles == 0 and params.nitermin == params.nitermax
        log.append((params.solver, out[1].niter, fixed, out[1].host_syncs))
        return out

    poisson.solve = recorded
    try:
        yield log
    finally:
        poisson.solve = solve


def ada_sim(dev, schedule):
    """The 2048^2 lid cavity under ``schedule`` (schedules()), float32,
    not yet initialised."""
    import torch
    from gerris_tpu_torch.models.simulation import Simulation, Time
    cfg = lid_cfg(11, schedule=schedule)
    return Simulation(cfg, time=Time(dtmax=0.8 * cfg.grid.h), device=dev,
                      dtype=torch.float32)


def run_adaptive(dev, schedule, steps):
    """init + ``steps`` steps under ``schedule`` through the kernels, the
    launch counts set to 0 just before and gated just after as functions
    of the solves' cycle counts; then the same steps through the plain
    versions on the card.  Returns (run, plain run, counts, solves of
    the kernels' run, solves of the plain run)."""
    import torch
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording_solves() as log:
        s = ada_sim(dev, schedule).init()
        s.run(max_steps=steps)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    counts = launch_counts()
    print(f"  {schedule}, init + {steps} steps: {t_run:.3f} s; niter per "
          f"solve {[n for _, n, _, _ in log]}; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    want = want_adaptive(steps, [(sv, n, f) for sv, n, f, _ in log])
    for k, w in want.items():
        if counts[k] != w:
            raise AssertionError(f"{schedule}: {k}: {counts[k]} launches, "
                                 f"want {w}")
    for k, v in s.state.items():
        if v.shape != s.cfg.grid.shape or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{schedule} {k}: not finite or wrong shape")
    with plain_versions(), recording_solves() as plog:
        ref = ada_sim(dev, schedule).init().run(max_steps=steps)
    if launch_counts() != counts:
        raise AssertionError("the plain reference run launched kernels")
    print(f"  {schedule}, plain versions: niter per solve "
          f"{[n for _, n, _, _ in plog]}")
    return s, ref, counts, log, plog


def hold(name, s, ref, bound):
    for k in ("U", "V", "P"):
        rel = rel_err(s.state[k], ref.state[k])
        print(f"  {name}, kernels vs plain after {ADA_STEPS} steps, {k}: "
              f"rel {rel:.3e} (bound {bound:.0e})")
        if not rel <= bound:
            raise AssertionError(f"{name} {k}: rel {rel:.3e}")


def phase_adaptive(dev, card, main_sim):
    """The adaptive routes at 2048^2, float32: ``adaptive`` (K11, K12, K3)
    and ``adaptive_relax`` (K11, K10), each as a fixed-count run held to
    the plain versions at MAIN_PATH_RTOL and as the tolerance run, gated
    from its cycle counts and held to its plain run at ADAPTIVE_RTOL;
    ``adaptive``'s step timed and profiled; the honesty check; the
    periodic Poisson solve.  Returns the launch counts of the tolerance
    runs by route."""
    import torch
    print(f"phase 3, adaptive routes: {N_MAIN}^2, float32, {ADA_STEPS} steps")
    counts = {}
    for route, (sched, fixed) in (("adaptive", ("adaptive", "adaptive_fixed")),
                                  ("adaptive_relax", ("relax",
                                                      "relax_fixed"))):
        s, ref, _, _, _ = run_adaptive(dev, fixed, ADA_STEPS)
        hold(fixed, s, ref, MAIN_PATH_RTOL)
        s, ref, counts[route], _, _ = run_adaptive(dev, sched, ADA_STEPS)
        hold(sched, s, ref, ADAPTIVE_RTOL)
        if route == "adaptive":
            ada = s
    walls, syncs = [], []
    for _ in range(TIMED_WINDOWS):
        with recording_solves() as log:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ada.run(max_steps=ADA_TIMED_STEPS)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        # the solves' condition reads, and the CFL dt's one per step
        syncs.append(sum(x[3] for x in log) / ADA_TIMED_STEPS + 1)
        niters = [x[1] for x in log]
    step = float(np.median(walls)) / ADA_TIMED_STEPS
    print(f"  adaptive step, timed windows of {ADA_TIMED_STEPS} steps: "
          f"{' '.join(f'{w:.4f}' for w in walls)} s; median "
          f"{step * 1e3:.3f} ms/step; host syncs per step "
          f"{' '.join(f'{x:.1f}' for x in syncs)}; niter per solve in the "
          f"last window {niters} on {card}")
    phase_profile(ada, step, card, ADA_PROFILE_STEPS)
    honesty_check(main_sim)
    errs = {n: periodic_poisson(dev, n) for n in (1024, 2048)}
    ratio = errs[1024] / errs[2048]
    print(f"  periodic_poisson: Linf error 1024^2 {errs[1024]:.4e}, 2048^2 "
          f"{errs[2048]:.4e}, ratio {ratio:.4f} (want {POISSON_ORDER})")
    if not POISSON_ORDER[0] <= ratio <= POISSON_ORDER[1]:
        raise AssertionError(f"periodic_poisson: order ratio {ratio:.4f}")
    return counts


def honesty_check(main_sim):
    """The bench's honesty check (bench.py:250-267): from the main path's
    state, one fixed-schedule step and one adaptive step at dt = 0.8 h;
    max over U, V of max|fixed - adaptive| / max|adaptive|."""
    from gerris_tpu_torch.models import ns
    cfg_ada = lid_cfg(11, schedule="adaptive")
    dt = 0.8 * cfg_ada.grid.h
    t = main_sim.time.t
    s_fix = ns.ns_step(dict(main_sim.state), dt, t, main_sim.cfg)
    s_ada = ns.ns_step(dict(main_sim.state), dt, t, cfg_ada)
    rel = max(rel_err(s_fix[k], s_ada[k]) for k in ("U", "V"))
    print(f"  honesty check after {main_sim.time.i} steps of the main path: "
          f"fixed_vs_adaptive_rel {rel:.4e} (bound {FIXED_VS_ADAPTIVE_MAX})")
    if not rel < FIXED_VS_ADAPTIVE_MAX:
        raise AssertionError(f"fixed_vs_adaptive_rel {rel:.4e}")


def periodic_poisson(dev, n):
    """lap p = -8 pi^2 cos(2 pi x) cos(2 pi y), mean subtracted, doubly
    periodic, at n^2 in float64 to tolerance 1e-10 (in float32, or at
    1e-3, the solver's error or the rounding would hide the ~1e-6
    discretisation error): K11, restrict2, the dense 64^2 solve and
    prolong + K10 per level; launches gated, held to the plain route.
    Returns the Linf error against the exact p, both means removed."""
    import math
    import torch
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.solvers import poisson
    grid = Grid(level=int(math.log2(n)))
    fbc = bc.FieldBC.uniform(bc.Periodic(), 2)
    x, y = (torch.from_numpy(c).to(dev) for c in grid.centers)
    exact = torch.cos(2 * math.pi * x) * torch.cos(2 * math.pi * y)
    rhs = -8 * math.pi ** 2 * exact
    rhs = rhs - rhs.mean()
    params = poisson.MultilevelParams(tolerance=1e-10)
    p0 = torch.zeros_like(rhs)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p, st = poisson.solve(p0, rhs, grid, fbc, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    levels = grid.level - 6       # restrictions down to the dense 64^2
    want = {k: 0 for k in counts}
    want.update(residual=st.niter + 1, restrict2=levels * st.niter,
                rbgs_relax=levels * st.niter)
    if counts != want:
        raise AssertionError(f"periodic_poisson {n}: launches {counts}, "
                             f"want {want}")
    with plain_versions():
        pr, rst = poisson.solve(p0, rhs, grid, fbc, params)
    if launch_counts() != counts:
        raise AssertionError("the plain reference run launched kernels")
    rel = rel_err(p, pr)
    err = float(((p - p.mean()) - (exact - exact.mean())).abs().max())
    print(f"  periodic_poisson {n}^2 float64: niter {st.niter} (plain "
          f"{rst.niter}), {wall:.3f} s, residual "
          f"{float(st.residual_after['infty']):.3e}, Linf error {err:.4e}; "
          f"kernels vs plain rel {rel:.3e} (bound {POISSON_PLAIN_RTOL:.0e}); "
          f"launches {counts['residual']} K11, {counts['restrict2']} "
          f"restrict2, {counts['rbgs_relax']} K10")
    if not rel <= POISSON_PLAIN_RTOL:
        raise AssertionError(f"periodic_poisson {n}: rel {rel:.3e}")
    return err


def lid3d_sim(dev):
    """The 128^3 lid cavity of lid3d_cfg(), float32, after init; dtmax =
    the bench's fixed dt 0.8 h (from rest the CFL bound is unbounded,
    later steps run at 0.8 h / max|u| <= 0.8 h)."""
    import torch
    from gerris_tpu_torch.models.simulation import Simulation, Time
    cfg = lid3d_cfg()
    return Simulation(cfg, time=Time(dtmax=0.8 * cfg.grid.h), device=dev,
                      dtype=torch.float32).init()


def phase_lid3d(dev, card):
    """init + LID3D_STEPS steps of the bench's 3D figure through the
    kernels, the counts set to 0 just before and gated just after (K13
    only: K13_PER_STEP calls per step and the initial projection's
    K13_LEVELS, no 2D kernel); the same steps through the plain versions
    on the card, held to MAIN_PATH_RTOL on U, V, W and P; five timed
    windows (cups_3d_128, the bench's key) and a profile.  Returns the
    launch counts."""
    import torch
    print(f"phase 3, lid3d: {1 << LEVEL_3D}^3 lid cavity, float32, "
          f"{LID3D_STEPS} steps, the bench's fixed 3D schedule")
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = lid3d_sim(dev)
    s.run(max_steps=LID3D_STEPS)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    counts = launch_counts()
    solves = LID3D_STEPS + 1
    want = {k: 0 for k in counts}
    want.update({
        "rbgs_relax_3d": K13_PER_STEP * LID3D_STEPS + K13_LEVELS,
        "rbgs_relax_3d.half_sweep":
            K13_HALF_SWEEPS_PER_STEP * LID3D_STEPS + K13_LEVELS * 2 * 4})
    print(f"  lid3d, init + {LID3D_STEPS} steps (the first builds the dense "
          f"16^3 solves): {t_run:.3f} s; launches "
          f"{ {k: v for k, v in counts.items() if v} }; {solves} approximate"
          " projections")
    if counts != want:
        raise AssertionError(f"lid3d: launches {counts}, want {want}")
    for k, v in s.state.items():
        if v.shape != s.cfg.grid.shape or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"lid3d {k}: not finite or wrong shape")
    with plain_versions():
        ref = lid3d_sim(dev).run(max_steps=LID3D_STEPS)
    if launch_counts() != counts:
        raise AssertionError("the plain reference run launched kernels")
    for k in ("U", "V", "W", "P"):
        rel = rel_err(s.state[k], ref.state[k])
        print(f"  lid3d, kernels vs plain after {LID3D_STEPS} steps, {k}: "
              f"rel {rel:.3e} (bound {MAIN_PATH_RTOL:.0e})")
        if not rel <= MAIN_PATH_RTOL:
            raise AssertionError(f"lid3d {k}: rel {rel:.3e}")
    walls = []
    for _ in range(TIMED_WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.run(max_steps=LID3D_TIMED_STEPS)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    step = float(np.median(walls)) / LID3D_TIMED_STEPS
    cups = (1 << LEVEL_3D) ** 3 / step
    print(f"  lid3d, timed windows of {LID3D_TIMED_STEPS} steps: "
          f"{' '.join(f'{w:.4f}' for w in walls)} s; median "
          f"{step * 1e3:.3f} ms/step, cups_3d_128 {cups:.6e} cell-updates/s "
          f"on {card}")
    phase_profile(s, step, card, LID3D_PROFILE_STEPS)
    # a fixed-schedule solve computes its residual before and after the
    # cycle eagerly besides the cycle's own (poisson.solve's statistics);
    # a jitted JAX step drops the unused one and shares the other
    from gerris_tpu_torch.solvers import poisson
    p, cfg = s.state["P"], s.cfg
    res_ms = cuda_ms(lambda: poisson.residual(p, p, cfg.grid, cfg.p_bc))
    print(f"  lid3d: one 128^3 residual {res_ms:.4f} ms; the statistics' "
          f"2 per fixed solve, 5 solves per step: {10 * res_ms:.3f} ms/step")
    return counts


def twophase_cfg(level=LEVEL_TWOPHASE):
    """__graft_entry__._dryrun_twophase at 2^level cells per side: walls
    with Dirichlet 0 velocities, nu 1e-3, beta 1, one VOF tracer T with
    the default scalar BCs, tension 0.5, density ("T", 10, 1, 1), the
    default projections (adaptive to 1e-3, at most 100 cycles) and
    diffusion (diffuse's default), on the schedule that
    utils/convert.config_from_jax gives them: the TPU's floors, nrelax 8
    and 16 coarsest sweeps."""
    import dataclasses
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.models import ns
    from gerris_tpu_torch.solvers.poisson import MultilevelParams
    from gerris_tpu_torch.utils.convert import params_from_jax
    walls = bc.FieldBC.uniform(bc.Dirichlet(0.0), 2)
    proj = MultilevelParams(tolerance=1e-3, nitermax=100, nrelax=8,
                            coarsest_relax=16)
    diff = params_from_jax(None, 2)
    if dataclasses.replace(proj, nitermax=10) != diff:
        raise AssertionError(f"the diffusion's default schedule {diff}")
    return ns.NSConfig(grid=Grid(level=level), u_bcs=(walls, walls),
                       nu=1e-3, beta=1.0,
                       vof_tracers=(("T", bc.default_scalar_bc(2)),),
                       tension=(("T", 0.5),), density=("T", 10.0, 1.0, 1),
                       projection=proj, approx_projection=proj,
                       diffusion_params=diff)


def twophase_sim(dev):
    """The twophase configuration in float32 on the card, T0 the fraction
    of the level set -(y - 0.01 cos 2 pi x) (the capwave-style perturbed
    interface of _dryrun_twophase), at rest, not yet run."""
    import torch
    from gerris_tpu_torch.models.simulation import Simulation, Time
    from gerris_tpu_torch.physics import vof
    cfg = twophase_cfg()
    T0 = vof.fraction_from_levelset(
        cfg.grid, lambda x, y: -(y - 0.01 * torch.cos(2 * torch.pi * x)),
        device=dev, dtype=torch.float32)
    return Simulation(cfg, time=Time(), device=dev,
                      dtype=torch.float32).init(T=T0)


def want_twophase(steps, niters):
    """Launches of init + ``steps`` two-phase steps from the cycle counts
    of every solve (the initial projection's, then per step the MAC
    projection, the U and V diffusions, the approximate projection): per
    cycle K15 at each of the K15_LEVELS levels and restrict2 between
    them; per step K6 once, K4 once per projection, K14 once per
    component, K9 once; no K1-K3, K5, K7, K8, K10-K13, K16, K17 (the
    alpha solves and the generic correction take none)."""
    w = {k: 0 for k in want_launches("pair", 0)}
    cycles = sum(niters)
    w.update(predict_xy=steps, divergence_mac=2 * steps + 1,
             interp_faces=steps + 1, advect2d=2 * steps,
             rbgs_relax_alpha=K15_LEVELS * cycles,
             restrict2=(K15_LEVELS - 1) * cycles)
    return w


def phase_twophase(dev, card):
    """init + TWOPHASE_STEPS steps of the twophase configuration through
    the kernels, the counts set to 0 just before and gated just after
    from every solve's recorded cycle count; finite values; T's volume;
    the first TWOPHASE_CHECK_STEPS steps against the same steps through
    the plain versions on the card (U, V, T, mean-free P, ADAPTIVE_RTOL:
    the solves stop at their tolerance); five timed windows and a
    profile.  Returns the launch counts."""
    import torch
    n = 1 << LEVEL_TWOPHASE
    print(f"phase 3, twophase: {n}^2 VOF + tension + density 10/1, "
          f"float32, init + {TWOPHASE_STEPS} steps")
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording_solves() as log:
        s = twophase_sim(dev)
        vol0 = float(s.state["T"].double().sum())
        s.run(max_steps=TWOPHASE_CHECK_STEPS)
        early = {k: v.clone() for k, v in s.state.items()}
        s.run(max_steps=TWOPHASE_STEPS - TWOPHASE_CHECK_STEPS)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    counts = launch_counts()
    niters = [x[1] for x in log]
    print(f"  twophase, init + {TWOPHASE_STEPS} steps: {t_run:.3f} s; "
          f"{len(niters)} solves, niter {niters}; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    if len(niters) != 4 * TWOPHASE_STEPS + 1:
        raise AssertionError(f"twophase: {len(niters)} solves")
    want = want_twophase(TWOPHASE_STEPS, niters)
    for k, w in want.items():
        if counts[k] != w:
            raise AssertionError(f"twophase: {k}: {counts[k]} launches, "
                                 f"want {w}")
    print(f"  twophase: rbgs_relax_alpha {counts['rbgs_relax_alpha']} "
          f"launches = {K15_LEVELS} x sum(niter) {sum(niters)}")
    for k, v in s.state.items():
        if v.shape != s.cfg.grid.shape or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"twophase {k}: not finite or wrong shape")
    vol = float(s.state["T"].double().sum())
    dvol = abs(vol - vol0) / vol0
    print(f"  twophase: T's volume {vol0 / n ** 2:.9f} -> {vol / n ** 2:.9f}"
          f", rel change {dvol:.3e} (bound {TWOPHASE_VOLUME_RTOL:.0e}); "
          f"t {s.time.t:.6e} after {s.time.i} steps, dt {s.dt:.6e}")
    if not dvol <= TWOPHASE_VOLUME_RTOL:
        raise AssertionError(f"twophase: T's volume changed by {dvol:.3e}")
    with plain_versions(), recording_solves() as plog:
        ref = twophase_sim(dev).run(max_steps=TWOPHASE_CHECK_STEPS)
    if launch_counts() != counts:
        raise AssertionError("the plain reference run launched kernels")
    print(f"  twophase, plain versions: niter {[x[1] for x in plog]}")
    for k in ("U", "V", "T", "P"):
        a, b = early[k], ref.state[k]
        if k == "P":
            a, b = a - a.mean(), b - b.mean()
        rel = rel_err(a, b)
        print(f"  twophase, kernels vs plain after {TWOPHASE_CHECK_STEPS} "
              f"steps, {k}{' (mean-free)' if k == 'P' else ''}: rel "
              f"{rel:.3e} (bound {ADAPTIVE_RTOL:.0e})")
        if not rel <= ADAPTIVE_RTOL:
            raise AssertionError(f"twophase {k}: rel {rel:.3e}")
    walls, syncs = [], []
    for _ in range(TIMED_WINDOWS):
        with recording_solves() as log:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.run(max_steps=TWOPHASE_TIMED_STEPS)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        # the solves' condition reads, and the CFL dt's one per step
        syncs.append(sum(x[3] for x in log) / TWOPHASE_TIMED_STEPS + 1)
        niters = [x[1] for x in log]
    step = float(np.median(walls)) / TWOPHASE_TIMED_STEPS
    print(f"  twophase step, timed windows of {TWOPHASE_TIMED_STEPS} steps: "
          f"{' '.join(f'{w:.4f}' for w in walls)} s; median "
          f"{step * 1e3:.3f} ms/step; host syncs per step "
          f"{' '.join(f'{x:.1f}' for x in syncs)}; niter per solve in the "
          f"last window {niters} on {card}")
    phase_profile(s, step, card, TWOPHASE_PROFILE_STEPS)
    return counts


def oscillation_cfg(level=OSC_LEVEL):
    """test/oscillation (tests/test_oscillation.py): symmetry walls
    (normal velocity Dirichlet 0, tangential Neumann), nu 0, sigma 1, rho
    1 inside / 1e-3 outside through the filtered fraction, projections
    adaptive to 1e-4 in at most 100 cycles (the port's schedule as
    given: the reference's test states it)."""
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.models import ns
    from gerris_tpu_torch.solvers.poisson import MultilevelParams
    d, nn = bc.Dirichlet(0.0), bc.Neumann()
    proj = MultilevelParams(tolerance=1e-4, nitermax=100)
    return ns.NSConfig(
        grid=Grid(level=level), u_bcs=(bc.FieldBC(((d, d), (nn, nn))),
                                       bc.FieldBC(((nn, nn), (d, d)))),
        nu=0.0, vof_tracers=(("T", bc.default_scalar_bc(2)),),
        tension=(("T", OSC_SIGMA),),
        density=("T", OSC_RHO_L, OSC_RHO_G, 1), projection=proj,
        approx_projection=proj)


def phase_oscillation(dev, card):
    """The reference's test/oscillation on the card in float32 at level
    6 to t = 1: the kinetic energy every step, fitted by k(t) = a
    exp(-b t) (1 - cos c t); gate |c - 153.984| / 153.984 < 0.005 and
    b > 0."""
    import math
    import torch
    from scipy.optimize import curve_fit
    from gerris_tpu_torch.events.events import Event
    from gerris_tpu_torch.models.simulation import Simulation, Time
    from gerris_tpu_torch.physics import vof
    cfg = oscillation_cfg()
    h2 = cfg.grid.h ** 2
    ke = []

    def record(sim):
        st = sim.state
        rho = OSC_RHO_G + torch.clamp(st["T"], 0, 1) * (OSC_RHO_L - OSC_RHO_G)
        ke.append((sim.time.t, torch.sum(rho * (st["U"] ** 2
                                                + st["V"] ** 2)) * h2))

    def phi(x, y):
        xx, yy = x + 0.5, y + 0.5
        r = OSC_D / 2.0 * (1.0 + OSC_EPS
                           * torch.cos(2.0 * torch.atan2(yy, xx)))
        return r * r - (xx * xx + yy * yy)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = Simulation(cfg, time=Time(end=1.0), device=dev, dtype=torch.float32,
                   events=[Event(action=record, istep=1)])
    s.init(T=vof.fraction_from_levelset(cfg.grid, phi, device=dev,
                                        dtype=torch.float32))
    s.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k = np.array([(t, float(e)) for t, e in ke])
    omega0 = math.sqrt(6.0 * OSC_SIGMA / ((OSC_RHO_L + OSC_RHO_G)
                                          * (OSC_D / 2) ** 3))

    def model(t, a, b, c):
        return a * np.exp(-b * t) * (1.0 - np.cos(c * t))

    (a, b, c), _ = curve_fit(model, k[:, 0], k[:, 1],
                             p0=(3e-4, 1.5, 2 * omega0), maxfev=20000)
    rel = abs(c - OSC_REF_C) / OSC_REF_C
    print(f"phase 4, oscillation: level {OSC_LEVEL} float32, {s.time.i} "
          f"steps to t = {s.time.t:.6f} in {wall:.2f} s; fit a {a:.4e} b "
          f"{b:.4f} c {c:.4f} (reference {OSC_REF_C}, rel {rel:.3e} < "
          f"{OSC_RTOL}; 2 omega0 {2 * omega0:.2f}) on {card}")
    if not (rel < OSC_RTOL and b > 0):
        raise AssertionError("oscillation: the fit misses the reference")


def neumann_poisson_3d(dev, n):
    """lap p = -3 pi^2 p for p = cos pi(x+1/2) cos pi(y+1/2) cos pi(z+1/2)
    in the Neumann box, the rhs's mean subtracted, at n^3 in float64 to
    tolerance 1e-10 (default schedule: 4 sweeps, the dense 16^3 solve):
    the torch residual and restriction, K13 at every level above 16^3;
    launches gated, held to the plain route.  Returns the Linf error
    against the exact p, both means removed."""
    import math
    import torch
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.solvers import poisson
    grid = Grid(level=int(math.log2(n)), dim=3)
    fbc = bc.FieldBC.uniform(bc.Neumann(), 3)
    x, y, z = (torch.from_numpy(c).to(dev) for c in grid.centers)
    exact = (torch.cos(math.pi * (x + 0.5)) * torch.cos(math.pi * (y + 0.5))
             * torch.cos(math.pi * (z + 0.5)))
    rhs = -3 * math.pi ** 2 * exact
    rhs = rhs - rhs.mean()
    params = poisson.MultilevelParams(tolerance=1e-10)
    p0 = torch.zeros_like(rhs)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p, st = poisson.solve(p0, rhs, grid, fbc, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    levels = grid.level - 4       # the levels above the dense 16^3
    want = {k: 0 for k in counts}
    want.update({"rbgs_relax_3d": levels * st.niter,
                 "rbgs_relax_3d.half_sweep": levels * st.niter * 2 * 4})
    if counts != want:
        raise AssertionError(f"poisson3d {n}: launches {counts}, want {want}")
    with plain_versions():
        pr, rst = poisson.solve(p0, rhs, grid, fbc, params)
    if launch_counts() != counts:
        raise AssertionError("the plain reference run launched kernels")
    rel = rel_err(p, pr)
    err = float(((p - p.mean()) - (exact - exact.mean())).abs().max())
    print(f"  poisson3d {n}^3 float64: niter {st.niter} (plain {rst.niter}),"
          f" {wall:.3f} s, residual {float(st.residual_after['infty']):.3e},"
          f" Linf error {err:.4e}; kernels vs plain rel {rel:.3e} (bound "
          f"{POISSON_PLAIN_RTOL:.0e}); launches {counts['rbgs_relax_3d']} "
          f"K13")
    if not rel <= POISSON_PLAIN_RTOL:
        raise AssertionError(f"poisson3d {n}: rel {rel:.3e}")
    return err


def phase_poisson3d(dev):
    errs = {n: neumann_poisson_3d(dev, n) for n in (64, 128)}
    ratio = errs[64] / errs[128]
    print(f"  poisson3d: Linf error 64^3 {errs[64]:.4e}, 128^3 "
          f"{errs[128]:.4e}, ratio {ratio:.4f} (want {POISSON_ORDER})")
    if not POISSON_ORDER[0] <= ratio <= POISSON_ORDER[1]:
        raise AssertionError(f"poisson3d: order ratio {ratio:.4f}")


def phase_physics(dev, card, dtype_name="float32"):
    import torch
    from gerris_tpu_torch.events.events import EventStop
    from gerris_tpu_torch.models.simulation import Simulation, Time
    dtype = getattr(torch, dtype_name)
    cfg = lid_cfg(6)
    stop = EventStop("U", 1e-4, istep=10)
    # dtmax as tests/test_lid.py: from rest the CFL timestep is unbounded
    s = Simulation(cfg, time=Time(end=1e6, dtmax=1.0), events=[stop],
                   device=dev, dtype=dtype).init()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.run(max_steps=20000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # the reference's measure (test/lid/lid.sh, tests/test_lid.py): the
    # profiles interpolated at Ghia's points with the BC ghosts, so the
    # wall points see the wall values
    u_prof = s.interpolate("U", [(0.0, y) for y in GHIA_U[:, 0]])
    v_prof = s.interpolate("V", [(x, 0.0) for x in GHIA_V[:, 0]])
    eu = float(np.abs(u_prof - GHIA_U[:, 1]).max())
    ev = float(np.abs(v_prof - GHIA_V[:, 1]).max())
    # tests/test_bench_schedule.py's measure, for comparison only: np.interp
    # over cell centres clamps Ghia's wall point to the first cell's value
    g = cfg.grid
    n = g.n
    U = s.state["U"].double().cpu().numpy()
    V = s.state["V"].double().cpu().numpy()
    cu = np.abs(np.interp(GHIA_U[:-1, 0], g.axis_centers(1),
                          0.5 * (U[n // 2 - 1, :] + U[n // 2, :]))
                - GHIA_U[:-1, 1]).max()
    cv = np.abs(np.interp(GHIA_V[:-1, 0], g.axis_centers(0),
                          0.5 * (V[:, n // 2 - 1] + V[:, n // 2]))
                - GHIA_V[:-1, 1]).max()
    print(f"phase 4 [{dtype_name}]: 64^2 lid, steady={s.stop} after "
          f"{s.time.i} steps (last max|dU| {stop.last_change}), wall "
          f"{wall:.2f} s; Ghia Linf U {eu:.4e} (<= {GHIA_LINF_U}), "
          f"V {ev:.4e} (<= {GHIA_LINF_V}); centre-line np.interp measure "
          f"U {cu:.4e} V {cv:.4e} (not gated) on {card}")
    return s.stop, eu, ev


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from gerris_tpu_torch.ops.cuda import build

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    # the dense coarsest solves' products (the 2D periodic Poisson's 64^2,
    # the 3D path's 16^3: mat-vecs with a 4096^2 Q) stay in float32, and
    # no float32 reference could round to TF32 either
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.library()
    print(f"phase 1: kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")

    record = {k: {"name": k, "route": "cuda", "source": src, "replaces": rep}
              for k, (src, rep) in KERNELS.items()}
    phase_kernels(dev, record)
    counts, main_sim = phase_main_path(dev, card)
    route_counts = phase_routes(dev, card, main_sim)
    route_counts.update(phase_adaptive(dev, card, main_sim))
    route_counts["lid3d"] = phase_lid3d(dev, card)
    phase_poisson3d(dev)
    route_counts["twophase"] = phase_twophase(dev, card)
    # launches on each kernel's path: the main path's; K14 is off it (K7
    # takes its place), so its count is that of its own path, the
    # per-component route; K10-K12 are the adaptive routes'; K13 lid3d's
    for k in record:
        path = ("per_component" if k == "advect2d" else
                "lid3d" if k == "rbgs_relax_3d" else
                "twophase" if k == "rbgs_relax_alpha" else
                FOLD_KERNELS.get(k) or ADAPTIVE_KERNELS.get(k, "main"))
        c = counts if path == "main" else route_counts[path]
        record[k].update(launches=c[k], path=path)
    for k, sub in (("cascade_prolong_relax", ""),
                   ("cascade_prolong_relax_pair", "_pair")):
        record[k]["launches_restrict2"] = counts["restrict2" + sub]
        record[k]["launches_prolong_relax"] = \
            counts[f"cascade{sub}.prolong_relax"]
    record["residual_restrict_div"]["launches_fold_div"] = \
        route_counts["fold_div"]["residual_restrict_div"]
    record["rbgs_relax_3d"]["launches_half_sweep"] = \
        route_counts["lid3d"]["rbgs_relax_3d.half_sweep"]
    ada = route_counts["adaptive"]
    record["coarse_vcycle"].update(
        launches_restrict2=ada["coarse_vcycle.restrict2"],
        launches_block=ada["coarse_block"],
        launches_prolong_relax=ada["coarse_vcycle.prolong_relax"])

    ok, eu, ev = phase_physics(dev, card)
    if not (ok and eu <= GHIA_LINF_U and ev <= GHIA_LINF_V):
        if not ok:
            # for the diagnosis: the same run in f64
            phase_physics(dev, card, "float64")
        raise AssertionError("Ghia phase failed")
    phase_oscillation(dev, card)

    print(json.dumps({"kernels": list(record.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
