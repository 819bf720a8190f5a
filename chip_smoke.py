#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gerris_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result):
  1. setup: the card's name and power limit, torch/CUDA versions, the
     kernels' build from gerris_tpu_torch/csrc (one nvcc per source, in
     parallel), the native block table's (g++, native/block_table.cpp)
     build and load, ptxas's registers, stack frame and spills of the BCG
     kernels (K6, K7/K14), K1's, K13's, the block kernel's and K4's;
  2. kernel checks: every kernel wrapper against its plain version on the
     card, float64 and float32: the multigrid kernels K1-K3 at the 2048^2
     main-path shapes and their coarser levels (K3 at each level's tile),
     the restriction pyramid bit-identical to the chain of restrict2
     launches and to its plain version (single and pair; 512 -> 16,
     2048 -> 512, 1024 -> 4, and the bubble's box (1024, 2048) -> (4,
     8)), plus K3's tile invariance (64, 32, 16);
     the diffusion pair K8a-c (own offsets, subs and dias per system) at
     2048^2 and 64^2, plus K8c's tile invariance; the predictor,
     projection and advection kernels K6, K4, K5 (with and without the
     cells), K9 (with and without gp and div_scale), K14 (both
     components, with and without the gp/oscale folds) and K7 (both
     modes, also against two K14 launches, bit-identical in the rhs
     mode) at 2048^2 and 64^2, plus K4's div bit-identical across two
     sum tiles, K6's, K7's and K14's outputs bit-identical across
     their tile plans and K6's div bit-identical to K4's on its faces; the adaptive solve's K11
     (the lid's offsets, periodic rows, periodic columns; bit-identical
     to K1's r0), K10 (non-periodic, periodic rows, doubly periodic, plus
     its invariance across tiles, threads and sweep splits) at 2048^2,
     K11 and K10 on the capillary wave's box levels, (1024, 3072) down to
     (1, 3) and two transposed, with K10 bit-identical across tiles and
     threads on the (1024, 3072) box and its transpose and whole against
     tiled at (32, 96), and K12 at 512^2 (per_y off and on)
     with its 64^2 block kernel alone; the block kernel as every cascade
     runs it (K2's and K8b's tails at the main path's shapes, a periodic
     pair down to 2^2) bit-identical to the K3 launches it replaces, and
     alone and as a pair at omega 1.5 against its plain version; the
     fold route's K16 and K17 at 2048^2 and 64^2 (the lid's pressure
     ghosts, inhomogeneous Neumann offsets, periodic columns; K16 with
     and without a sub, K17 with and without the cells), plus K17's tile
     invariance; K1, K8a and K16 also at a 16^2 level, and bit-identical
     across K1's tile heights; the 3D smoother K13 at 128^3 with the
     projections' and the diffusion's settings, at 32^3, 64^3 and (32, 64,
     128) with mixed sides, and at 256^3 (float32), from a given u and with
     the prolongation of a coarse correction folded in (+ u) at 32^3, 64^3,
     128^3 and 256^3, one launch a call, u and the coarse correction left
     as they were, bit-identical across block counts, threads and bricks;
     the two-phase
     smoother K15 at 1024^2 (walls, periodic
     rows, doubly periodic; scalar and cell dia; omega 1 and 1.5; 8 and
     24 sweeps; zero-diagonal cells), from a given u and with the
     prolongation of a coarse correction folded in (+ u), and at every
     level down to 4^2 as a correction runs it, and on the bubble's box
     levels, (1024, 2048) down to (4, 8), plus its invariance across
     tiles, threads and sweep splits (the box's tiles, and a whole 32 x
     64 level against the same level tiled), and on the cylinder's
     levels, (3072, 1024) down to (12, 4), with its geometry's face
     fractions, dead cells and cell dia (the projections' and the
     viscous solves' systems; the dead cells keep their value), and on
     slice 4b's levels, 2048^2 down to 4^2: the moving disk's (its
     geometry after one step), the axisymmetric pipe's and the stretched
     cavity's systems; the pyramid also 2048^2 -> 4^2; then
     each kernel's time
     against its plain version's at the main-path shapes (K13 at 128^3,
     from u and with the fold; K15 at 1024^2, at the bubble's (1024,
     2048), at the cylinder's (3072, 1024) and at 2048^2 as the moving
     disk's and the axisymmetric pipe's viscous solves run it, the
     pyramid also at (1024, 2048), (3072, 1024) and 2048^2 -> 4^2),
     float32 (CUDA events), K1
     per tile height, K13 per level and launch shape (device time per
     launch, profiled), K7 beside two K14 launches,
     K15's and K3's per level, K15's per tile and threads (with and
     without the coarse correction), K10's per tile and threads, K7's,
     K14's and K6's per tile plan, the host's time per call and the
     card's per launch of restrict2 and avg_pool2d, the block kernel at
     K12's shape and at the main path's tails beside the K3 launches they
     replace, and device time per call (profiled) of K4, K5, K9, K11, K17
     and the block kernel at those shapes;
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
     values, K13's launches gated (one launch a call, every call with the
     coarser level's correction prolonged in the kernel), agreement with
     the same steps through the plain versions, the median step rate of
     five timed windows as ``cups_3d_128`` and a profile with the device
     ops per step and the torch prolongation's kinds (roll, where, the
     stack's CatArray copies) per step; and ``poisson3d``, a Neumann box
     solved adaptively in float64 at 64^3 and 128^3 (the torch residual,
     the dense 16^3 solve, K13), its second order gated and held to the
     plain route; then ``twophase``, __graft_entry__._dryrun_twophase at
     1024^2 in float32 (VOF, height-function tension, density 10/1, the
     default adaptive solves on the TPU's floored schedule): init + 20
     steps through K6, K4, K15 in every correction of the four alpha
     solves per step (one launch per level, the prolongation folded into
     every upward one), K14 per component and K9, launches gated from
     every solve's recorded cycle count, finite values, T's volume, the
     first 5 steps held to the plain versions, five timed windows and a
     profile with its device ops per step; then ``bubble``, Hysing et
     al.'s rising bubble (test case 1) at 1024 x 2048 in float32 (a
     variable viscosity of the filtered fraction, gravity and tension as
     face sources, density 1000/100, the box 1 x 2): init + 20 steps
     through the twophase route's kernels (K15 on the box's levels),
     launches gated from the recorded cycle counts, finite values, the
     first 5 steps held to the plain versions (float64 kernels vs plain
     to 1e-9; in float32, where the velocities of the state from rest
     are at float32's floor, T and P to 2e-3 and U and V to twice the
     plain route's own distance from float64), five timed
     windows and a profile; then ``spurious``, the reference's static
     droplet (test/spurious) at 1024^2 in float32, scheme "none", solves
     to 1e-6, with the well-balanced and then the CSS tension: init + 20
     steps each through K4, K9, K5 (CSS: every projection; else at init),
     K11, K12, the pyramid and K3, gated from the recorded cycle counts,
     T's volume, held to the plain versions as the bubble is (float64 to
     1e-9), five timed windows and a profile; ``tracer``, a tracer C on
     the bench's 2048^2 route (K14 and a fused diffusion cycle a step
     beside K7 and the K8 pair) and with van Leer slopes (the generic
     route), gated and held to the plain versions (1e-4 on U, V, P, C);
     ``mgcg``, the stiff 4-decade coefficient system at 1024^2 in
     float64 (K15 per level of each preconditioning V-cycle, gated from
     niter; the residual within 1e-9 of max|rhs| in no more iterations
     than the adaptive multigrid; held to the plain versions), and cg at
     256^2 to its cap; ``sessile``, a drop with contact angles 60 and
     120 degrees at 256^2 in float64, 5 steps gated and held to the
     plain versions (1e-9); ``droplet3d``, the 3D static droplet
     (tests/test_vof3d.py::test_static_droplet_3d) at 128^3 in float32,
     init + 10 steps through K13 in every correction of its five solves
     a step, gated from the recorded cycle counts (no 2D kernel), the
     first 2 steps held to the plain versions as the bubble is (float64
     to 1e-9, on W too) with T's volume over them in float64, five
     timed windows and a profile with K13's share; ``bubble3d``, the
     rising bubble in 3D (1 x 2 x 1 box) at 128 x 256 x 128 in float32,
     init + 5 steps with no kernel launched (its solves take face
     coefficients or a cell dia), the first step held to the plain
     versions by the bubble's rule, 3 steps at 16 x 32 x 16 in float64
     on the card held to the port's CPU run (1e-9), five timed windows
     and a profile; ``capwave``, the capillary wave (test/capwave) at
     1024 x 3072 in float32 on its 1 x 3 box with periodic rows, init +
     5 steps through K4, K11, the pyramid and K10 on the box's levels,
     gated from the recorded cycle counts, held to the plain versions as
     the bubble is (float64 to 1e-9), five timed windows and a profile;
     ``cylinder``, the flow past a cylinder (Re 160, the Gerris
     tutorial's vortex street cut to a 3 x 1 box) at 3072 x 1024 in
     float32 with a static embedded solid: init + 5 steps through K15 in
     every correction of its six solves a step and the pyramid, gated
     from the recorded cycle counts (K6 and K9 refuse its outflow BCs: no
     other kernel), the solid's geometry printed, held to the plain
     versions (float64 to 1e-9), run twice bit for bit (digests), five
     timed windows and a profile; slice 4b's routes at 2048^2 in float32,
     each gated from its solves' recorded cycle counts (K15 at every
     level down to 4^2 in every correction, all but the coarsest with the
     prolongation folded in, and the pyramid; K6 and K9 where the walls
     admit them; no other kernel), held to the plain versions (float64 to
     1e-9; in float32 U and V by the floor rule, P within ADAPTIVE_RTOL
     of plain or, where named below, by the floor rule), one step's host
     syncs against its solves' reads plus a stated constant
     (count_syncs), five timed windows and a profile with K15's share:
     ``moving1`` and ``moving2``, the impulsively started disk of
     tests/test_moving.py (Re 150: nu 1e-3) at orders 1 and 2, init + 5
     steps, its geometry and merge groups re-cut every step, run twice
     bit for bit, three syncs a step beyond the solves' (the Dirichlet
     surface's cut cells, the merge groups' two), P by the floor rule
     (from rest its float32 pressure is at its floor); ``rigid``, the
     falling disk of tests/test_rigid.py (a RigidBodyDriver, 5 steps;
     the force and the motion stay on the card: three syncs beyond the
     solves', the moving solid's), its trajectory printed; ``axi``, the
     axisymmetric Poiseuille pipe (init + 5; x periodic: no K6 or K9; V
     and P, 0 up to the solves' tolerance, relative to max|U|); and
     ``stretch``, the bench's lid cavity under MetricStretch(1, 0.1)
     (init + 5, one cycle a solve), P by the floor rule and P less its
     mean over y in each column (``P_y``, column_free) too: the float32
     sweeps on its 100:1 coefficients leave the column means, its
     weakest x modes, ~0.25 of max from float64 at 2048^2, as the JAX
     package's float32 step does (tools/stretch_f32_floor.py).
     Slice 5's composite AMR routes, init + 5 steps each in float32,
     the first 2 held to the plain versions (float64 to 1e-9, U and V by
     the floor rule), launches gated from every composite solve's
     recorded cycle count (want_amr), one step's host syncs against its
     solves' reads plus AMR_SYNCS, the leaves against the uniform count,
     five timed windows and a profile: ``amr_osc``, the oscillating
     droplet of tests/test_amr_ns.py adapting every step up to level 10
     (1024^2 at the finest, base 8^2) on the block engine with
     composite_vof and block_advect (its fallback warning an error):
     K15 in its base corrections, the pyramid, K6 and K9 on every level;
     ``amr_capwave``, test/capwave's graded static mesh at level 10
     (1024 x 3072 at the finest) on the dense engine: K11 and K10 on
     every box level; then the kernels at their AMR shapes (K15 at 4^2,
     8^2 and 1024^2, K6 and K9 at 1024^2 and 8^2, K11 and K10 at (1024,
     3072) and (8, 24)) against plain, timed with bounds, and the block
     solve's time on ring meshes at lmax 8-11 (its growth from 8 to 9
     under 3x: test_blockrt_walltime_scales_with_leaves).
     Slice 6's route ``particles``: the 2048^2 lid with 2^20 two-way
     coupled particles (particle_coupling, a ParticleSystem: density
     1000, diameter h, the five default forces at gravity 0, the
     Gaussian deposit of radius h over 7^2 cells), float32, init + 5
     steps: launches gated (want_particles: the per-component route with
     a fused K1-K2-K3 cycle per diffusion, no K7 or K8), held to the
     plain versions (float64 to 1e-9; float32 by the floor rule on U, V,
     P and the particles' pos and vel), one step's host syncs equal to
     the per-component lid route's, five timed windows and a profile
     with the particle phase's and the deposit's device time
     (record_function spans).
     Slice 7's phase ``gfs``: the bench's lid as .gfs text (GFS_LID) at
     2048^2, float32, init + 5 steps through gerris_tpu_torch.cli.run and
     through a Simulation built by hand from the configuration the reader
     must give (gfs_lid_cfg): bit-identical states, equal launches per
     kernel (the launch counts set to 0 before each run, read after; the
     kernels line's launches_gfs) and equal to the adaptive route's rule
     of the CLI run's own solves (want_adaptive), equal OutputScalarNorm
     rows, held to the plain versions (2e-3); timed windows without an
     output event, with OutputScalarNorm every step and with OutputTiming
     (median ms/step, host syncs per step; the step timer's CUDA events,
     recorded only under OutputTiming), and a profile; python3 -m
     gerris_tpu_torch on the same file in a process of its own (exit 0,
     its OutputScalarNorm lines the in-process run's, its end.gfs dump
     resumed through the reader to the same state, bit for bit);
     GfsPoisson (test/poisson) at 2048^2 in float32 against its plain
     run (launches gated from its cycles) and at levels 6-8 in float64
     (error norms falling 4 +- 0.6 a level, level 6 within 1e-10 of the
     JAX package's pinned run, tests/data/jax_pins/gfs_poisson.npz);
     GfsAdvection at 1024^2, whose generic route runs no hand-written
     kernel: no launch and finite fields.
     Every route held to the plain versions in float32 also bounds the
     plain float32 run's distance from the plain float64 run per field
     (FLOOR_BOUNDS);
  4. physics: the 64^2 lid cavity under the bench's configuration to
     steady state (EventStop U 1e-4 every 10 steps, at most 20000 steps),
     float32, against Ghia, Ghia & Shin (1982) at the reference tolerances
     and by the reference's measure (tests/test_lid.py); and the
     reference's test/oscillation at level 6 in float32 to t = 1
     (tests/test_oscillation.py): the fitted frequency within 0.5% of the
     reference's 153.984, decaying; and the bubble at level 6 (64 x 128)
     in float32 to t = 3: its maximum mean rise velocity and its centroid
     at t = 3 within 3% and 2% of Hysing's (0.2417, 1.0813) and within 1%
     of gerris_tpu's own level-6 values; and the static droplet at level
     5 in float64 to t = 1 with each tension: its shape error (L2, Linf
     of T - T0) within 1% and max|u| within a factor 2 of gerris_tpu's
     (tools/spurious_reference.py); and the 3D droplet at level 4 in
     float64, 20 steps: max|u| and max|T - T0| within 1% of gerris_tpu's
     (tools/droplet3d_reference.py) and inside the test's bounds; the
     level-5 static droplet also within the absolute bounds of
     tests/test_spurious.py:84-90; the capillary wave at levels 4, 5 and 6
     in float64 to t = 2.2426 (its RMS amplitude error against
     Prosperetti's within 5% of the reference's table at levels 4 and 5
     and within 1% of gerris_tpu's, tools/capwave_reference.py, the order
     between them above 1.5, level 6 within 10% of the table); and the
     sessile drop at level 4 in float64, 3000 steps at 60 and 120
     degrees: the band's mean curvature within 8% of 1/R(theta), its std
     within 0.25 of it; test/circle in float64 at levels 7-9 (the level-8
     Richardson L1 and L2 within 2x of the reference's error.ref, orders
     above 1.5, the multigrid's reduction at least 8x a cycle at level 7)
     and at level 6 within 1% of gerris_tpu's (tools/circle_reference.py);
     the Couette profile at level 6 in float64 within tests/test_couette.py's
     bounds; slice 4b's, in float64: the axisymmetric Poiseuille pipe at
     level 5 (at most 400 steps to steady) within 1% of u(r) = G (1 -
     r^2) / (4 nu), V below 1e-6, and the axisymmetric Poisson's order
     between levels 5 and 6 above 1.8, its error below 3e-4
     (tests/test_axi.py); the moving disk's order-2 temporal rate above
     order 1's + 0.05 at level 5 (tests/test_moving.py's weak gate), the
     Galilean disk's far field within 0.06 of the stream at level 6
     (every fluid cell within 0.6), the buoyancy force on a disk in a
     hydrostatic field within 5% of Archimedes' (Fx within 2% of it;
     tests/test_rigid.py); the stretch Poisson's order in (1.8, 2.2) and
     the lon-lat one's above 1.6 with its error below 5e-4 at levels 5-6
     (tests/test_metric.py); slice 5's, in float64: the AMR oscillation
     (pinned and composite VOF) at level 5 to t = 1, c within 1% of the
     JAX package's level-5 fit, b > 0, the mean leaves under 0.55 of
     uniform; the AMR capillary wave at levels 4 and 5 within 25% of the
     table, the order above 1.5, level 5's leaves under 0.75 of uniform;
     the interface-not-pinned droplet (level 6, the volume within 5e-3,
     interface cells on coarser leaves); slice 6's, in this process:
     2^16 bubbles' Minnaert periods within 5% (float32, on the lid's
     grid), 64 interacting bubbles against the CPU (float64, 1e-9) and
     the in-phase pair's frequency shift within 5%; the particles
     route's energy spectrum (Parseval, and the CPU's float64, 1e-5) and
     init_solenoidal at 2048^2 (divergence 1e-6, shells 1e-5); 4096
     droplets to particles, fed and stamped back with the volume kept
     (1e-6); the stream function of the route's velocity (lap psi =
     omega to 1e-8); the momentum gate at 256^2 in float64 (20%).  The capwave, sessile, circle,
     Couette, axi, moving, metric and AMR gates run as child processes
     of this script (``python3 chip_smoke.py --gate NAME``, gate_jobs)
     beside the others.
The last two lines are the kernels' JSON record and the device line.
"""
import contextlib
import json
import math
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
# above the dense 16^3 level, each one launch with the coarser level's
# correction prolonged in the kernel; per step one correction per
# projection (4 sweeps) and one per velocity component's diffusion (1
# sweep)
K13_LEVELS = 3
K13_PER_STEP = K13_LEVELS * (2 + 3)
# the torch prolongation's device kernels, by a substring of their names
# (torch.roll, torch.where, torch.stack's copies), counted per lid3d step
PROLONG_KINDS = ("roll", "where", "CatArray")

# twophase: __graft_entry__._dryrun_twophase at full width, 1024^2
# float32 (VOF, height-function tension, variable density 10 / 1)
LEVEL_TWOPHASE = 10
TWOPHASE_STEPS = 20
TWOPHASE_CHECK_STEPS = 5
TWOPHASE_TIMED_STEPS = 10
TWOPHASE_PROFILE_STEPS = 5
# K15 launches per correction at 1024^2: every level from 1024^2 down to
# minlevel 2 (4^2), 1 at the coarsest and 8 upward, each upward one with
# the coarser level's result prolonged at placement; the correction's
# residual restrictions in one restrict_pyramid launch
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

# bubble: Hysing et al., "Quantitative benchmark computations of
# two-dimensional bubble dynamics", Int. J. Numer. Meth. Fluids 60 (2009)
# 1259-1288, test case 1, at full width: level 10 in the 1 x 2 box,
# 1024 x 2048 cells, float32 (rho 1000 / 100, mu 10 / 1, g 0.98, sigma
# 24.5, the bubble of radius 0.25 at (0.5, 0.5)); its step runs the
# twophase route's kernels, K15 on the box's levels
LEVEL_BUBBLE = 10
BUBBLE_STEPS = 20
BUBBLE_CHECK_STEPS = 5
BUBBLE_TIMED_STEPS = 10
BUBBLE_PROFILE_STEPS = 5
# the same steps through the kernels and through the plain versions in
# float64: the two compute one function, and in float64 no VOF or
# curvature decision sits at the rounding's edge, so they agree to the
# CPU gates' bound between two float64 implementations (the port and
# gerris_tpu, tests/test_torch_bubble.py)
BUBBLE_F64_RTOL = 1e-9
# the physics gate: the bubble at level 6 (64 x 128) in float32 to t = 3;
# the mean rise velocity sum((1 - T) V) / sum(1 - T) and the centroid
# sum((1 - T) y) / sum(1 - T), each step.  Hysing's reference values
# (TP2D, test case 1): maximum rise velocity 0.2417 at t = 0.9213,
# centroid 1.0813 at t = 3, gated within 3% and 2%; and gerris_tpu's own
# at level 6 in float64 on the CPU (tools/bubble_reference.py 6 3.0: 575
# steps, the maximum 0.24064975467766936 at t = 0.9286956521739148, the
# centroid 1.0777377578901863 at t = 3), both within 1%
BUBBLE_GATE_LEVEL = 6
BUBBLE_GATE_T = 3.0
HYSING_VMAX, HYSING_YC = 0.2417, 1.0813
HYSING_VMAX_RTOL, HYSING_YC_RTOL = 0.03, 0.02
JAX_VMAX, JAX_YC = 0.24064975467766936, 1.0777377578901863
JAX_RTOL = 0.01

# spurious: the static droplet of the reference's test/spurious (Popinet,
# J. Comput. Phys. 228 (2009) 5838-5866, section 5.1; tests/test_spurious.py)
# at full width: level 10, 1024^2, float32; the droplet of radius 0.4 at
# (-0.5, 0.5), velocity_bc walls, sigma 1, rho 1, nu = sqrt(0.8 / 12000),
# scheme "none", projections to 1e-6 in at most 100 cycles, diffusion to
# 1e-6 in at most 20; once with the well-balanced tension, once with CSS
LEVEL_SPURIOUS = 10
SPURIOUS_STEPS = 20
SPURIOUS_CHECK_STEPS = 5
SPURIOUS_TIMED_STEPS = 4
SPURIOUS_PROFILE_STEPS = 3
SPURIOUS_LA = 12000.0
SPURIOUS_KINDS = ("tension", "tension_css")
# the correction of a 1024^2 adaptive solve: K12 at 512^2, one
# restrict_pyramid launch (1024 -> 512) and one K3 at 1024^2
SPURIOUS_PROLONGS = 1
# the physics gate: level 5 in float64 to t = 1, both tensions, against
# the JAX package's values at the same level and time
# (tools/spurious_reference.py 5 1.0: 321 steps each, on the CPU): the
# shape error L2 and Linf of T - T0 within 1%, max|u| within a factor 2
# (it sits at the solves' tolerance)
SPURIOUS_GATE_LEVEL = 5
SPURIOUS_GATE_T = 1.0
JAX_SPURIOUS = {
    "tension": dict(shape_l2=0.0002367918334313299,
                    shape_linf=0.0028132143746509852,
                    umax=0.0001189633766583472, steps=321),
    "tension_css": dict(shape_l2=0.04842093096789282,
                        shape_linf=0.6008629355446319,
                        umax=0.5881899111738118, steps=321),
}
SPURIOUS_SHAPE_RTOL = 0.01
SPURIOUS_UMAX_FACTOR = 2.0
# tracer: the bench's 2048^2 cavity on its route with one tracer C (D
# 1e-3, the default scalar BCs, C0 = x + 0.5): K14 once a step for C and
# its diffusion's fused cycle (K1, K2, K3) beside the main path's launches
TRACER_STEPS = 5
# mgcg: tests/test_poisson.py's stiff (4-decade) coefficient system at
# level 10 in float64, to 1e-10 of max|rhs|; cg at level 8 to its cap
LEVEL_MGCG = 10
LEVEL_CG = 8
MGCG_TOL = 1e-10
MGCG_RESIDUAL = 1e-9
# sessile: a quarter disk of radius 0.3 in the corner of the bottom wall
# (contact angle 60 and 120 degrees) and the symmetry axis, level 8,
# float64, 5 steps, kernels vs plain
LEVEL_SESSILE = 8
SESSILE_STEPS = 5
SESSILE_ANGLES = (60.0, 120.0)
SESSILE_RTOL = 1e-9
# the sessile gate (tests/test_gfs_verbatim3.py:82-115 on sessile_cfg, the
# .gfs not being in the repository): level 4, float64, 3000 steps per
# angle; the mean curvature of the band 0.05 < T < 0.95 within 8% of
# 1/R(theta) of the drop's volume (the symmetry axis doubling it), and
# its std within 0.25 of 1/R(theta)
SESSILE_GATE_LEVEL = 4
SESSILE_GATE_STEPS = 3000
SESSILE_GATE_RTOL = 0.08
SESSILE_GATE_STD = 0.25
# the absolute bounds of tests/test_spurious.py:84-90 on the
# well-balanced run of the level-5 gate (3x the reference table's shape
# and curvature errors; the currents decayed from their first samples,
# one every 20 steps, and the capillary number below 1e-4)
SPURIOUS_SHAPE_L2_MAX = 3.0 * 9.129e-05
SPURIOUS_SHAPE_LINF_MAX = 3.0 * 1.271e-03
SPURIOUS_KAPPA_LINF_MAX = 3.0 * 3.021e-03
SPURIOUS_CA_MAX = 1e-4
# capwave: the capillary wave of the reference's test/capwave (Popinet,
# J. Comput. Phys. 228 (2009) 5838-5866, section 5.3, against
# Prosperetti's solution; tests/test_capwave.py): the 1 x 3 box at
# origin (-0.5, -1.5), periodic in x, u Neumann and v Dirichlet 0 on y,
# nu 0.0182571749236, sigma 1, equal densities (no density: every solve
# has unit coefficients), T from y - 0.01 cos(2 pi x), the solves to 1e-6
# in at most 100 (projections) and 20 (diffusion) cycles; at full width,
# level 10, 1024 x 3072, float32, init + 5 steps.  Every correction
# restricts to the dense (32, 96) level (one restrict_pyramid launch) and
# runs prolong + K10 on each of the CAPWAVE_K10_LEVELS box levels above
# it (periodic rows: no K3 or K12); K11 per cycle, K4 per projection; the
# predictor, advection and face interpolation are torch (K6, K14, K9 and
# K5 refuse periodic rows, as the reference's kernels do)
LEVEL_CAPWAVE = 10
CAPWAVE_STEPS = 5
CAPWAVE_CHECK_STEPS = 2
CAPWAVE_TIMED_STEPS = 1
CAPWAVE_PROFILE_STEPS = 1
CAPWAVE_DENSE_LEVEL = 5
CAPWAVE_K10_LEVELS = LEVEL_CAPWAVE - CAPWAVE_DENSE_LEVEL
CAPWAVE_NU = 0.0182571749236
CAPWAVE_A0 = 0.01
# the gate: levels 4 and 5 in float64 to t = 2.2426211256, the amplitude
# sampled every 3.04290519077e-3 as tests/test_capwave.py samples it, its
# RMS error against Prosperetti's over A0 within 5% of the reference's
# table (test/capwave/convergence.ref) and within 1% of the JAX
# package's own values (tools/capwave_reference.py LEVEL on the CPU in
# float64: 737 steps at either level), the order between them above 1.5;
# level 6 against the table within 10% (test_capwave_level6; 2211
# steps, ~180 s on an H100)
CAPWAVE_TEND = 2.2426211256
CAPWAVE_SAMPLE = 3.04290519077e-3
CAPWAVE_REF = {4: 0.0316239, 5: 0.00769877, 6: 0.00215977}
JAX_CAPWAVE = {4: 0.031909645677380125, 5: 0.007553518978307288}
CAPWAVE_REF_RTOL = 0.05
CAPWAVE_L6_RTOL = 0.1
CAPWAVE_ORDER_MIN = 1.5
# the gate jobs (gate_jobs) must end within this many seconds of their
# start
GATE_TIMEOUT = 900.0

# the gfs phase (slice 7): the lid's .gfs text at 2^GFS_LEVEL per side,
# float32, GFS_STEPS steps through the CLI's entry point and by hand; the
# timed windows; GfsPoisson at GFS_POISSON_LEVEL in float32 against its
# plain run and at GFS_POISSON_F64 in float64 (error norms falling by
# GFS_POISSON_ORDER per level, the first level's held to the JAX
# package's pinned run, tests/data/jax_pins/gfs_poisson.npz, within
# GFS_PIN_RTOL); GfsAdvection at 2^GFS_ADVECTION_LEVEL (no kernel, finite
# fields)
GFS_LEVEL = 11
GFS_STEPS = 5
GFS_TIMED_STEPS = 10
GFS_WINDOWS = 3
GFS_PROFILE_STEPS = 3
GFS_POISSON_LEVEL = 11
GFS_POISSON_F64 = (6, 7, 8)
GFS_POISSON_ORDER = (3.4, 4.6)
GFS_PIN_RTOL = 1e-10
GFS_ADVECTION_LEVEL = 10
GFS_POISSON = """1 0 GfsPoisson GfsBox GfsGEdge {} {
  Time { iend = 1 }
  Refine LEVEL
  ApproxProjectionParams { tolerance = 1e-30 nitermin = 10 nitermax = 10 }
  Init {} {
    Div = { int k = 3, l = 3; return -M_PI*M_PI*(k*k + l*l)*sin (M_PI*k*x)*sin (M_PI*l*y); }
  }
}
GfsBox {}
"""
GFS_ADVECTION = """1 0 GfsAdvection GfsBox GfsGEdge {} {
  Time { end = 0.1 }
  Refine LEVEL
  VariableTracerVOF T
  VariableTracer C { gradient = gfs_center_minmod_gradient }
  InitFraction T (0.0225 - (x - 0.1)*(x - 0.1) - y*y)
  Init {} { C = exp(-100.*(x*x + y*y)) }
  VariableStreamFunction { istep = 1 } Psi sin(M_PI*(x + 0.5))*sin(M_PI*(y + 0.5))/M_PI
}
GfsBox {}
"""
# droplet3d: the 3D static droplet of tests/test_vof3d.py::
# test_static_droplet_3d (the 3D counterpart of test/spurious) at the 3D
# bench's size, level 7, 128^3, float32: a sphere of radius 0.3 at the
# centre of the unit box, velocity_bc walls, sigma 1, rho 1, nu 0.1,
# scheme "none", both projections to 1e-6 in at most 50 cycles, the
# default diffusion; dt the capillary bound.  Every solve's correction
# runs K13 at 32^3, 64^3 and 128^3 above the dense 16^3 level
# (K13_LEVELS launches a cycle); no other kernel lies on its path
LEVEL_DROPLET3D = 7
DROPLET3D_STEPS = 10
DROPLET3D_CHECK_STEPS = 2
DROPLET3D_TIMED_STEPS = 2
DROPLET3D_PROFILE_STEPS = 2
DROPLET3D_R = 0.3
# |sum(T) - sum(T0)| / sum(T0) after DROPLET3D_CHECK_STEPS steps in
# float64: the sweeps conserve the volume up to the faces' divergence,
# which the projections leave at their tolerance (1e-6 of max|rhs|; at
# 16^3 on the CPU ~1e-8 a step, ~1e-13 with the solves to 1e-11)
DROPLET3D_VOLUME_RTOL = 1e-8
# the physics gate: the test's own run, level 4 (16^3), float64, 20
# steps to end time 1 (dt the capillary bound snapped to it), the dense
# coarsest solve at 8^3 as the JAX package takes it on the CPU
# (dense_coarse_max 1024), so K13 runs at 16^3; max|u| after the 20
# steps and the shape error max|T - T0| within 1% of gerris_tpu's
# (tools/droplet3d_reference.py 4 20 at commit d74d5c1, on the CPU in
# float64: t 0.17543859649122806 after 20 steps) and inside the test's
# bounds (umax < 5e-2, shape error < 2.5e-2)
DROPLET3D_GATE_LEVEL = 4
DROPLET3D_GATE_STEPS = 20
JAX_DROPLET3D = dict(umax=0.0016816510622530796, shape_err=0.021415058367104,
                     t=0.17543859649122806)
DROPLET3D_UMAX_MAX, DROPLET3D_SHAPE_MAX = 5e-2, 2.5e-2
# bubble3d: Hysing et al.'s test case 1 as Adelsberger et al. (2014)
# extended it to 3D: the box [0, 1] x [0, 2] x [0, 1] (y up), a sphere of
# radius 0.25 at (0.5, 0.5, 0.5), rho 1000 / 100, mu 10 / 1 of the
# once-filtered fraction, gravity -0.98 on V, tension 24.5, no-slip at y
# = 0 and 2, free slip on the four other sides; level 7, 128 x 256 x 128,
# float32, init + 5 steps.  Every solve takes face coefficients or a cell
# dia: the torch correction and smoother, no kernel
LEVEL_BUBBLE3D = 7
BUBBLE3D_STEPS = 5
BUBBLE3D_CHECK_STEPS = 1
BUBBLE3D_TIMED_STEPS = 1
BUBBLE3D_PROFILE_STEPS = 1
# the card against the port's CPU run: level 4 (16 x 32 x 16), float64,
# 3 steps
BUBBLE3D_CPU_LEVEL = 4
BUBBLE3D_CPU_STEPS = 3
# the plain float32 run's distance from the plain float64 run after each
# route's check steps (max|a - b| / max|b|, P mean-free), bounded per
# route and field (check_floor): about 3x (2.7x to 3.5x) the distances
# that an H100 (700 W) measured with the piecewise line area and plane
# volume (PERF.md, Findings: bubble U, V 1.51e-2 / 1.41e-2, T 6.7e-6, P
# 2.4e-4; spurious 3.68e-3 / 3.74e-3, 6.3e-6, 1.41e-4; CSS 2.5e-5 /
# 2.6e-5, 6.3e-6, 3.2e-5; capwave 5.77e-2 / 0.160, 1.42e-6, 1.12e-3;
# droplet3d U, V, W 2.06e-3 / 2.52e-3 / 2.11e-3, T 1.54e-6, P 7.6e-6;
# bubble3d 1.83e-3 / 2.22e-3 / 1.80e-3, 2.19e-6, 6.2e-4; cylinder U, V
# 4.46e-5 / 1.84e-5, P 3.11e-3, its first run, from U = 1; the moving disk
# at order 1 U, V, P 9.32e-4 / 1.13e-3 / 5.87e-3, at order 2 8.25e-4 /
# 1.04e-3 / 4.78e-3; the falling disk 1.38e-4 / 1.06e-4 / 1.11e-4; the
# axisymmetric pipe U 9.49e-4, V and P 7.2e-6 and 4.2e-5 of max|U|; the
# stretched cavity 1.97e-3 / 4.73e-4 / 0.252: the float32 sweeps on its
# 100:1 coefficients leave its pressure's column means, its weakest x
# modes, to the rounding, as the JAX package's float32 step does
# (tools/stretch_f32_floor.py: both 1.0e-2 from float64 at 256^2, the
# port's P less its column means 2.1e-4), and P less its column means
# (P_y, column_free) 6.21e-3 at 2048^2.  The velocities
# of these states from rest are small, and the float32 pressure's
# rounding moves them by ~1e-6 of max|P|: a floor that grows as they
# shrink with the level (tools/torch_f32_floor.py --cpu LEVEL).  The
# closed-form line area and plane volume put them at 5.9 (capwave V 20.6)
# and 1.23 of max, which these bounds fail.  The AMR routes:
# amr_osc U, V 1.15e-3 / 1.27e-3, T 6.5e-6, P 1.98e-4; amr_capwave 5.77e-2
# / 0.160, 1.42e-6, 1.10e-3, the uniform capwave's.  The particles route
# (on an H100): U 1.27e-5, V 7.5e-6, P 3.1e-5, the particles' pos 2.2e-7
# and vel 8.8e-5.
FLOOR_BOUNDS = {
    "bubble": dict(U=5e-2, V=5e-2, T=2e-5, P=8e-4),
    "spurious": dict(U=1e-2, V=1e-2, T=2e-5, P=5e-4),
    "spurious_css": dict(U=8e-5, V=8e-5, T=2e-5, P=1e-4),
    "capwave": dict(U=0.2, V=0.5, T=5e-6, P=4e-3),
    "droplet3d": dict(U=7e-3, V=8e-3, W=7e-3, T=5e-6, P=3e-5),
    "bubble3d": dict(U=6e-3, V=7e-3, W=6e-3, T=7e-6, P=2e-3),
    "cylinder": dict(U=1.5e-4, V=6e-5, P=1e-2),
    "moving1": dict(U=3e-3, V=3.5e-3, P=1.8e-2),
    "moving2": dict(U=2.5e-3, V=3e-3, P=1.5e-2),
    "rigid": dict(U=4e-4, V=3.5e-4, P=3.5e-4),
    "axi": dict(U=3e-3, V=2e-5, P=1.3e-4),
    "stretch": dict(U=6e-3, V=1.5e-3, P=0.75, P_y=2e-2),
    "amr_osc": dict(U=3.5e-3, V=4e-3, T=2e-5, P=6e-4),
    "amr_capwave": dict(U=0.2, V=0.5, T=5e-6, P=4e-3),
    "particles": dict(U=4e-5, V=2.5e-5, P=1e-4, pos=7e-7, vel=3e-4),
}
# the routes with no VOF tracer (FLOOR_BOUNDS holds no T for them)
SINGLE_PHASE_ROUTES = ("cylinder", "moving1", "moving2", "rigid", "axi",
                       "stretch", "particles")

# the flow past a cylinder (slice 4a): the Gerris tutorial's vortex
# street (a cylinder of diameter 0.125, inflow 1, nu 0.00078125: Re 160)
# in a channel of 3 unit boxes (the tutorial's 8 cut to 3: the port's box
# levels are n x 2n and n x 3n), at 3072 x 1024 in float32, init + 5
# steps; its solves' corrections run K15 on every level from (3072, 1024)
# down to minlevel 2's (12, 4)
LEVEL_CYLINDER = 10
CYLINDER_R = 0.0625
CYLINDER_NU = 0.00078125
CYLINDER_STEPS = 5
CYLINDER_CHECK_STEPS = 2
CYLINDER_TIMED_STEPS = 2
CYLINDER_PROFILE_STEPS = 2
CYLINDER_F64_RTOL = 1e-9
# the solid-route gates (phase 4, child processes): tests/test_circle.py
# at levels 7-9 in float64 (the reference's error.ref at level 8: L1
# 6.904e-05, L2 8.562e-05; within CIRCLE_REF_FACTOR either way), its
# orders and its multigrid reduction at level 7 with erelax 2; the
# circle's level-6 Richardson norms within JAX_RTOL of the JAX package's
# (python3 tools/circle_reference.py 6); tests/test_couette.py's
# profile at level 6 in float64
CIRCLE_REF = dict(l1=6.904e-05, l2=8.562e-05)
CIRCLE_REF_FACTOR = 2.0
CIRCLE_ORDER_MIN = 1.5
CIRCLE_REDUCTION_MIN = 8.0
JAX_CIRCLE6 = dict(l1=0.0013984713600482578, l2=0.001775144877487753,
                   linf=0.008834733502320669)
COUETTE_LEVEL = 6
COUETTE_LINF = 0.012
COUETTE_L2 = 6e-3

ERR_KEYS = ("max_abs_err", "max_rel_err")
CSRC = "gerris_tpu_torch/csrc/"
# wrapper -> (source, the TPU kernel it replaces)
KERNELS = {
    "residual_restrict": (CSRC + "rbgs.cu",
                          "gerris_tpu/ops/pallas/rbgs.py:1234"),
    "cascade_prolong_relax": (CSRC + "rbgs.cu",
                              "gerris_tpu/ops/pallas/rbgs.py:1446"),
    "restrict_pyramid": (CSRC + "rbgs.cu",
                         "gerris_tpu/ops/pallas/rbgs.py:1446"),
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
# levels of a cascade at n/2 = 1024 with the 16^2 coarsest level: one
# restrict_pyramid launch (512 -> 16, 5 levels), one coarse_block launch
# for the 3 levels 16 .. 64, then CASCADE_K3 prolong_relax (128 .. 1024)
CASCADE_LEVELS = 7
CASCADE_TAIL = 3
CASCADE_K3 = CASCADE_LEVELS - CASCADE_TAIL
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
# K12's levels at 512^2: one pyramid down to 16^2, one block-kernel
# launch for 64^2 .. 16^2 and 3 K3 up from it;
# the correction's pyramid 2048 -> 1024 -> 512 and its K3 launches at
# 1024^2 and 2048^2
K12_LEVELS, ADA_PROLONGS = 3, 2


def want_launches(route, steps):
    """Launches of init + ``steps`` steps at 2048^2.  Per step: the two
    projections' solves of K1-K3 (and the initial projection's; K2 a
    pyramid, one block-kernel launch for its levels 16 .. 64 and K3 above);
    K6 once;
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
        "restrict2": 0, "restrict_pyramid": 0, "restrict_pyramid_pair": 0,
        "cascade.restrict_pyramid": solves,
        "cascade.coarse_block": solves,
        "cascade.prolong_relax": CASCADE_K3 * solves,
        "predict_xy": steps, "divergence_mac": 0 if fold else solves,
        "correct_project": 0 if correct else solves,
        "interp_faces": steps + 1,
        "advect2d": 2 * steps - 2 * pair, "advect2d_pair": pair,
        "residual_restrict_pair": steps if route != "rr" else 0,
        "cascade_prolong_relax_pair": steps,
        "cascade_pair.restrict_pyramid": steps,
        "cascade_pair.coarse_block": steps,
        "cascade_pair.prolong_relax": CASCADE_K3 * steps,
        "prolong_relax_pair": steps,
        "residual": 0, "rbgs_relax": 0, "coarse_vcycle": 0,
        "coarse_vcycle.restrict_pyramid": 0, "coarse_block": 0,
        "coarse_block_pair": 0, "coarse_vcycle.prolong_relax": 0,
        "coarse_block.restrict_pyramid": 0,
        "coarse_block_pair.restrict_pyramid": 0, "rbgs_relax_3d": 0, "rbgs_relax_3d.launch": 0,
        "rbgs_relax_3d.prolong": 0,
        "rbgs_relax_alpha": 0, "rbgs_relax_alpha.prolong": 0,
    }


def want_adaptive(steps, solves):
    """Launches of init + ``steps`` steps of an adaptive route at 2048^2
    from its solves' records (solver, niter, fixed count or not): per
    multigrid solve one K11 for r0, one per cycle (and one more after
    the cycles of a fixed count), and per cycle the correction's K12 at
    512^2 (its 1 + 1 + 3 launches), 1 restrict_pyramid and 2 K3; per
    "relax"
    solve K11 twice and K10 once.  Per step K6 once, K4 and K5 once per
    projection, K9 once, K14 once per component (the per-component route:
    the pair route needs a fixed diffusion schedule); no K1, K2, K7 or
    K8."""
    w = {k: 0 for k in want_launches("pair", 0)}
    w.update(predict_xy=steps, divergence_mac=2 * steps + 1,
             correct_project=2 * steps + 1, interp_faces=steps + 1,
             advect2d=2 * steps)
    return add_solves(w, solves, ADA_PROLONGS)


# device kernels of the port, by a substring of their names.  The pairs
# K8a-c launch the K1, restrict_pyramid and K3 kernels with a batch of
# two, so their names are K1's, restrict_pyramid's and K3's; K7 and K14
# are instances of one kernel, advect2d_kernel
OWN_KERNELS = ("residual_restrict_kernel", "restrict_pyramid_kernel",
               "prolong_relax_kernel", "divergence_mac_kernel",
               "correct_project_kernel", "interp_faces_kernel",
               "predict_xy_kernel", "advect2d_kernel", "sum_partials_kernel", "residual_kernel", "rbgs_relax_kernel",
               "coarse_block_kernel", "rbgs3d_",
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


def gfs_lid_cfg(level):
    """The configuration the reader gives for the lid's .gfs text
    (GFS_LID): the reference's default walls (each component Dirichlet 0
    on the walls normal to it, Neumann 0 along the others) with U = 1 on
    the top, nu 1e-3, and both projections and the diffusion on the JAX
    reader's adaptive defaults with the TPU's floors
    (utils/convert.params_from_jax: 8 sweeps per level, 16 coarsest).
    tests/test_torch_gfs_build.py holds the reader to it."""
    import dataclasses
    import types
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.models import ns
    from gerris_tpu_torch.solvers.poisson import MultilevelParams
    from gerris_tpu_torch.utils.convert import params_from_jax
    d0, n0 = bc.Dirichlet(0.0), bc.Neumann()
    u_bc = bc.FieldBC(((d0, d0), (n0, bc.Dirichlet(1.0))))
    v_bc = bc.FieldBC(((n0, n0), (d0, d0)))
    proj = params_from_jax(types.SimpleNamespace(
        **dataclasses.asdict(MultilevelParams()), tpu_nrelax=8), 2)
    return ns.NSConfig(grid=Grid(level=level), u_bcs=(u_bc, v_bc),
                       p_bc=bc.FieldBC.uniform(n0, 2), nu=1e-3,
                       projection=proj, approx_projection=proj,
                       diffusion_params=params_from_jax(None, 2))


# the lid's .gfs text for the gfs phase (its defines: LEVEL, DTMAX, IEND,
# DUMP): the bench's cavity with U = 1 on the top and the reference's
# default walls elsewhere; dtmax, as from rest the CFL step is unbounded
GFS_LID = """1 0 GfsSimulation GfsBox GfsGEdge {} {
  Time { iend = IEND dtmax = DTMAX }
  Refine LEVEL
  SourceViscosity 1e-3
  OutputScalarNorm { istep = 1 } stdout { v = U }
  OutputSimulation { start = end } DUMP
}
GfsBox { top = Boundary { BcDirichlet U 1 } }
"""


def gfs_build(text, dev, dtype, **defines):
    """The simulation of a .gfs text through the port's reader."""
    from gerris_tpu_torch.utils import gfs_config
    return gfs_config.build_simulation(
        gfs_config.parse_gfs(text, {k: str(v) for k, v in defines.items()}),
        device=dev, dtype=dtype)


def gfs_resume(path, dev, dtype):
    """An OutputSimulation .gfs dump read back through the reader (its
    InitCheckpoint restores the state and time)."""
    with open(path) as f:
        return gfs_build(f.read(), dev, dtype)


def gfs_lid_runs(path, level, dtmax, iend, dump, dev, dtype, counted=False):
    """The lid's .gfs file at ``path`` run through the CLI's entry point
    (gerris_tpu_torch.cli.run) and a Simulation built by hand from
    gfs_lid_cfg(level) with the same Time and an OutputScalarNorm of U:
    their final states, norm rows, and with ``counted`` each run's kernel
    launches (the counts set to 0 just before the run, read just after)
    and its solves' records (solver, niter, fixed count or not).  The
    CLI's run writes the end dump to ``dump``."""
    import torch
    from gerris_tpu_torch import cli
    from gerris_tpu_torch.events.outputs import OutputScalarNorm
    from gerris_tpu_torch.models.simulation import Simulation, Time
    out = {}
    argv = [path, "-D", f"LEVEL={level}", "-D", f"DTMAX={dtmax!r}", "-D",
            f"IEND={iend}", "-D", f"DUMP={dump}", "--device", str(dev),
            "--dtype", str(dtype).removeprefix("torch.")]
    if counted:
        reset_launch_counts()
    with recording_solves() as log:
        sim = cli.run(argv)
    if counted:
        out["counts_cli"] = launch_counts()
        out["solves_cli"] = [(sv, n, f) for sv, n, f, _ in log]
    cfg = gfs_lid_cfg(level)
    if sim.cfg != cfg:
        raise AssertionError("the reader's configuration of the lid's text "
                             "is not gfs_lid_cfg")
    norm = OutputScalarNorm("U", istep=1)
    if counted:
        reset_launch_counts()
    with recording_solves() as log:
        hand = Simulation(cfg, time=Time(iend=iend, dtmax=dtmax),
                          events=[norm], device=dev,
                          dtype=dtype).init().run()
    if counted:
        out["counts_hand"] = launch_counts()
        out["solves_hand"] = [(sv, n, f) for sv, n, f, _ in log]
    out.update(cli=sim.state, hand=hand.state, sim=sim,
               rows_cli=sim.events[0].rows, rows_hand=norm.rows)
    return out


def launch_counts():
    from gerris_tpu_torch.ops.cuda import bcg, predict, projops, rbgs, rbgs3d
    return {**rbgs.LAUNCHES, **projops.LAUNCHES, **predict.LAUNCHES,
            **bcg.LAUNCHES, **rbgs3d.LAUNCHES}


def reset_launch_counts():
    from gerris_tpu_torch.ops.cuda import bcg, predict, projops, rbgs, rbgs3d
    for mod in (rbgs, projops, predict, bcg, rbgs3d):
        mod.reset_launch_counts()


def print_ptxas(entries):
    """ptxas's registers, stack frame and spills of the given kernels (the
    BCG kernels K6 and K7/K14's engine, K1's, K13's, the block kernel's
    and K4's), one line per template instance."""
    names = [name for name, _ in entries]
    try:
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        pass
    print(f"  ptxas -v, {len(entries)} kernel instances:")
    for name, (_, lines) in zip(names, entries):
        short = name.replace("(anonymous namespace)::", "").split("(")[0]
        short = short.removeprefix("void ")
        print(f"    {short}: {'; '.join(lines[1:])}")


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
             (rbgs, "restrict2"), (rbgs, "restrict_pyramid"),
             (projops, "divergence_mac"),
             (projops, "correct_project"), (projops, "interp_faces"),
             (predict, "predict_xy"), (bcg, "advect2d"),
             (bcg, "advect2d_pair"), (rbgs3d, "rbgs_relax_3d"),
             (rbgs, "residual_restrict_div"),
             (rbgs, "prolong_relax_correct"), (rbgs, "rbgs_relax_alpha")]
    saved = [getattr(mod, name) for mod, name in swaps]
    for mod, name in swaps:
        plain = {"restrict2": "pool_plain",
                 "restrict_pyramid": "pyramid_plain"}.get(name,
                                                          name + "_plain")
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
        # every tile plan gives the same faces (and div) bit for bit
        for tile in bcg.TILES:
            other = predict.predict_xy(U, V, dt, grid, u_bcs, sc, tile=tile)
            if not all(x is y or torch.equal(x, y)
                       for x, y in zip(got[:3], other[:3])):
                raise AssertionError(f"K6 {n}{tag}: tile {tile} differs")
        if sc is not None:
            # K4 on K6's faces: K6's div bit for bit (K4's scale 1/(dt h))
            k4 = projops.divergence_mac(got[0], got[1], dt / 2.0, h)[0]
            if not torch.equal(k4, got[2]):
                raise AssertionError(f"K6 {n}: div differs from K4's")
    print(f"  K6 {n}: tiles {', '.join(map(str, bcg.TILES))} bit-identical; "
          "div bit-identical to K4's on its faces")
    errs["divergence_mac"] = [compare_div(
        f"K4 divergence_mac {n}", projops.divergence_mac(ufx, ufy, dt, h),
        projops.divergence_mac_plain(ufx, ufy, dt, h), b)]
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
            got = bcg.advect2d(v, c, ufx, ufy, dt, grid, u_bcs[c], **kw)
            errs.setdefault("advect2d", []).append(compare(
                f"K14 advect2d {n} c={c}{' gp oscale' if folds else ''}",
                got,
                bcg.advect2d_plain(v, c, ufx, ufy, dt, grid, u_bcs[c], **kw),
                b))
            for tile in bcg.TILES:
                if not torch.equal(got, bcg.advect2d(
                        v, c, ufx, ufy, dt, grid, u_bcs[c], tile=tile, **kw)):
                    raise AssertionError(f"K14 {n} c={c}: tile {tile} "
                                         "differs")
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
        for tile in bcg.TILES:
            other = bcg.advect2d_pair(U, V, ufx, ufy, dt, grid, fbcs,
                                      tile=tile, **kw)
            if not all(torch.equal(x, y) for x, y in zip(
                    got, flat(other) if rr else other)):
                raise AssertionError(f"K7 {n}{tag}: tile {tile} differs")
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
        # K14 is the one-component instance of K7's engine
        if not rr and not same:
            raise AssertionError(f"K7 {n}: not two K14 launches bit for bit")
    print(f"  K7 (both modes) and K14 {n}: tiles "
          f"{', '.join(map(str, bcg.TILES))} bit-identical")
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
    """K17 bit-identical across tiles 64 (the plan's at 2048^2), 32 and 16
    at 2048^2, and whole-level against tiled at 64^2, with and without
    periodic columns."""
    import torch
    from gerris_tpu_torch.ops.cuda import rbgs
    for n, kws in ((N_MAIN, (dict(tile=16), dict(tile=32), dict(tile=64),
                             dict())),
                   (N_SMALL, (dict(), dict(tile=16, whole_max=32)))):
        f32 = torch.float32
        c = rnd(f32, n // 2, n // 2)
        rhs, u, U, V = (rnd(f32, n, n) for _ in range(4))
        ufx, ufy = rnd(f32, n + 1, n), rnd(f32, n, n + 1)
        for tag, signs, offs, per_y in fold_ghosts(n)[1:]:
            kw = dict(nsweeps=5, h2=1.0 / n ** 2, signs=signs, offs=offs,
                      per_y=per_y, omega=1.5)
            a, *others = (rbgs.prolong_relax_correct(
                c, rhs, 0.0, u, ufx, ufy, 0.8 / n, 1.0 / n, (U, V), **kw,
                **k) for k in kws)
            for k, b in zip(kws[1:], others):
                if not all(torch.equal(x, y) for x, y in zip(a, b)):
                    raise AssertionError(f"K17 {n} {tag}: {kws[0]} and {k}"
                                         " differ")
    print("  K17 tiles 64 == 32 == 16 == the plan's at 2048, whole == tiled "
          "at 64, periodic columns or not: bit-identical")


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
    check_box_kernels(rnd, dtype, errs)
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
    check_coarse_tails(rnd, dtype, dia_diff, errs)
    if record is not None:
        for k, es in errs.items():
            record[k].update(zip(ERR_KEYS, map(max, zip(*es))))


def k3_tail(levels, dias, nsweeps, coarsest, h2, signs, omega, per_y=False):
    """A cascade's levels at and below 64^2 (``levels`` per system, finest
    first, ``h2`` the finest's) as the K3 launches that ran them before the
    block kernel: from zero at the coarsest, prolong + relax above, each
    launch over the batch."""
    from gerris_tpu_torch.ops.cuda import rbgs
    n = levels[0][0].shape[0]
    kw = dict(signs=signs, per_y=per_y, omega=omega)
    du = [None] * len(levels)
    for k in reversed(range(len(levels[0]))):
        rk = [lv[k] for lv in levels]
        h2k = h2 * (n // rk[0].shape[0]) ** 2
        nsw = coarsest if du[0] is None else nsweeps
        if len(levels) == 2:
            du = rbgs.prolong_relax_pair(du, rk, dias, [None, None],
                                         nsweeps=nsw, h2=h2k, **kw)
        else:
            du = [rbgs.prolong_relax(du[0], rk[0], dias[0], nsweeps=nsw,
                                     h2=h2k, **kw)]
    return du


def tail_kernel(levels, dias, nsweeps, coarsest, h2, signs, omega,
                per_y=False):
    """The same levels in one launch of the block kernel (the cascades'
    route into it)."""
    from gerris_tpu_torch.ops.cuda import rbgs
    return rbgs._coarse_block_cuda(levels, dias, nsweeps, coarsest, h2, signs,
                                   per_y, omega, "coarse_block")


def tail_plain(levels, dias, nsweeps, coarsest, h2, signs, omega,
               per_y=False):
    from gerris_tpu_torch.ops.cuda import rbgs
    return [rbgs.coarse_tail_plain(lv, d, nsweeps=nsweeps, coarsest=coarsest,
                                   h2=h2, signs=signs, per_y=per_y,
                                   omega=omega) for lv, d in zip(levels, dias)]


def main_tails(rnd, dtype, dia):
    """The main path's cascade tails at 2048^2, levels 64^2, 32^2 and 16^2
    (40 sweeps there): K2's (one system, 5 sweeps at omega 1.5, the
    pressure's Neumann signs) and K8b's (the U+V pair, 1 sweep at omega
    1, each at the diffusion's dia, Dirichlet signs), as (levels, dias,
    nsweeps, coarsest, h2, signs, omega)."""
    def levels():
        return [rnd(dtype, m, m) for m in (64, 32, 16)]
    h2 = (N_MAIN // 64) ** 2 / N_MAIN ** 2
    return {"k2": ([levels()], [0.0], 5, 40, h2, (1.0,) * 4, 1.5),
            "k8b": ([levels(), levels()], [dia, dia], 1, 40, h2, (-1.0,) * 4,
                    1.0)}


def tail_flops(args):
    """Operations of a tail: K3's at each level above the coarsest, the
    coarsest's sweeps, per system."""
    levels, _, nsweeps, coarsest, _, _, omega = args
    sizes = [t.shape[0] for t in levels[0]]
    return len(levels) * (sum(cycle_flops(m, nsweeps, omega)
                              for m in sizes[:-1])
                          + cycle_flops(sizes[-1], coarsest, omega))


def check_coarse_tails(rnd, dtype, dia, errs):
    """The block kernel as the cascades run it, bit for bit the K3
    launches it replaced: K2's and K8b's tails at the main path's shapes
    and a periodic-column pair down to 2^2 at omega 1.2; and alone and as
    a pair (two dias) at omega 1.5, periodic columns or not, against its
    plain version (errors into ``errs``)."""
    import torch
    from gerris_tpu_torch.ops.cuda import rbgs
    b = 1e-12 if dtype == torch.float64 else 1e-4
    cases = dict(main_tails(rnd, dtype, dia))
    cases["per_y_2"] = ([[rnd(dtype, m, m) for m in (64, 32, 16, 8, 4, 2)]
                         for _ in range(2)], [0.0, dia], 2, 24, 1.0 / 64 ** 2,
                        (1.0, -1.0, 1.0, 1.0), 1.2)
    for name, args in cases.items():
        per_y = name == "per_y_2"
        got = tail_kernel(*args, per_y=per_y)
        if not all(torch.equal(x, y) for x, y in
                   zip(got, k3_tail(*args, per_y=per_y))):
            raise AssertionError(f"coarse_block {name} {dtype}: differs "
                                 "from the K3 launches it replaces")
        errs.setdefault("coarse_block", []).append(compare(
            f"coarse_block tail {name}", got,
            tail_plain(*args, per_y=per_y), b))
    r, r2 = rnd(dtype, 64, 64), rnd(dtype, 64, 64)
    for per_y in (False, True):
        kw = dict(nsweeps=5, coarsest=40, h2=1.0 / 64 ** 2, omega=1.5,
                  signs=(1.0,) * 4 if per_y else (-1.0,) * 4, per_y=per_y)
        errs["coarse_block"].append(compare(
            f"coarse_block pair 64 omega 1.5 per_y={per_y}",
            rbgs.coarse_block_pair([r, r2], [0.0, dia], **kw),
            [rbgs.coarse_vcycle_plain(x, d, **kw)
             for x, d in ((r, 0.0), (r2, dia))], b))
    print(f"  coarse_block {dtype}: K2's and K8b's tails and a per_y pair "
          "to 2^2 bit-identical to the K3 launches they replace")


def check_residual_restrict(rnd, dtype, b):
    """K1, K8a and K16 at 16^2, a level smaller than the kernel's tile
    (the lid's ghosts, periodic columns or not, own subs and dias per
    system), against their plain versions; and each bit-identical across
    K1's tile heights (16 and 8 rows against 32) at 2048^2 and 64^2."""
    import torch
    from gerris_tpu_torch.ops.cuda import rbgs
    signs, offs = (-1.0,) * 4, (0.0, 0.0, 0.0, 2.0)
    for n in (16, 2048, 64):
        u, u2, rhs, rhs2 = (rnd(dtype, n, n) for _ in range(4))
        ufx, ufy, sub = rnd(dtype, n + 1, n), rnd(dtype, n, n + 1), rnd(
            dtype, 1)
        for per_y in (False, True):
            kw = dict(h2=1.0 / n ** 2, signs=signs, offs=offs, per_y=per_y)
            kwp = dict(h2=1.0 / n ** 2, signs=signs, per_y=per_y,
                       offss=[offs, (0.0,) * 4])
            pair = ([u, u2], [rhs, rhs2], [0.6, 2.0], [sub, 0.0])
            calls = {
                "K1": (lambda **t: rbgs.residual_restrict(
                           u, rhs, 0.6, sub, **kw, **t),
                       lambda: rbgs.residual_restrict_plain(
                           u, rhs, 0.6, sub, **kw)),
                "K8a": (lambda **t: flat(rbgs.residual_restrict_pair(
                            *pair, **kwp, **t)),
                        lambda: flat(rbgs.residual_restrict_pair_plain(
                            *pair, **kwp))),
                "K16": (lambda **t: rbgs.residual_restrict_div(
                            u, ufx, ufy, 0.3 / n ** 2, 0.0, sub, **kw, **t),
                        lambda: rbgs.residual_restrict_div_plain(
                            u, ufx, ufy, 0.3 / n ** 2, 0.0, sub, **kw)),
            }
            for k, (kern, plain) in calls.items():
                if n == 16:
                    compare(f"{k} {n}^2 per_y={per_y}", kern(), plain(), b)
                    continue
                ref = kern()
                for rows in rbgs.RR_ROWS[1:]:
                    if not all(torch.equal(x, y) for x, y in zip(
                            ref, kern(tile_rows=rows))):
                        raise AssertionError(f"{k} {n}^2 {dtype} per_y="
                                             f"{per_y}: tile rows {rows} "
                                             "and 32 differ")
    print(f"  K1, K8a, K16 {dtype}: tile rows 16 and 8 bit-identical to 32 "
          "at 2048^2 and 64^2")


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
    (the port's K13 has no plane limit); and with the fold, from the
    prolongation of a coarse correction, with and without an added u, at
    32^3, 64^3 and 128^3 with mixed sides, at 128^3 with the diffusion's
    settings and at 256^3 in float32.  Each call one launch; u, the
    coarse correction and the added field left as they were.  Then the
    launch at 256 and 512 threads, several block counts and bricks
    bit-identical to the plan's at 32^3 and 64^3.  Errors go to
    ``record`` when it is given."""
    import torch
    from gerris_tpu_torch.ops.cuda import rbgs3d
    name = str(dtype).replace("torch.", "")
    b = BOUND[name]
    n = 1 << LEVEL_3D
    mixed = (-1.0, 1.0, 1.0, -1.0, -1.0, 1.0)
    dia_diff = 1.0 / (0.8 / n * 1e-3)
    cases = [((n,) * 3, (1.0,) * 6, 4, 1.5, 0.0),
             ((n,) * 3, (-1.0,) * 6, 1, 1.0, dia_diff),
             ((32,) * 3, mixed, 4, 1.5, 0.0), ((64,) * 3, mixed, 3, 1.3, 0.7),
             ((32, 64, 128), mixed, 4, 1.5, 0.0)]
    folds = [((32,) * 3, mixed, 4, 1.5, 0.0), ((64,) * 3, mixed, 4, 1.5, 0.0),
             ((n,) * 3, mixed, 4, 1.5, 0.0),
             ((n,) * 3, (-1.0,) * 6, 1, 1.0, dia_diff)]
    if dtype == torch.float32:
        cases.append(((256,) * 3, (1.0,) * 6, 4, 1.5, 0.0))
        folds.append(((256,) * 3, (1.0,) * 6, 4, 1.5, 0.0))
    errs = []

    def one_launch(fn, prolong):
        before = dict(rbgs3d.LAUNCHES)
        out = fn()
        delta = {k: v - before[k] for k, v in rbgs3d.LAUNCHES.items()}
        want = {"rbgs_relax_3d": 1, "rbgs_relax_3d.launch": 1,
                "rbgs_relax_3d.prolong": int(prolong)}
        if delta != want:
            raise AssertionError(f"K13: launches {delta}, want {want}")
        return out

    for shape, signs, nsw, omega, dia in cases:
        u, rhs = rnd(dtype, *shape), rnd(dtype, *shape)
        u0 = u.clone()
        kw = dict(nsweeps=nsw, h2=1.0 / shape[0] ** 2, signs=signs,
                  omega=omega)
        errs.append(compare(
            f"K13 rbgs_relax_3d {shape} nsweeps={nsw} omega={omega} "
            f"dia={dia:.4g} signs={signs}",
            one_launch(lambda: rbgs3d.rbgs_relax_3d(u, rhs, dia, **kw),
                       False),
            rbgs3d.rbgs_relax_3d_plain(u, rhs, dia, **kw), b))
        if not torch.equal(u, u0):
            raise AssertionError("K13 changed its input u")
    for shape, signs, nsw, omega, dia in folds:
        c = rnd(dtype, *(m // 2 for m in shape))
        rhs, add = rnd(dtype, *shape), rnd(dtype, *shape)
        c0, add0 = c.clone(), add.clone()
        for a in (None, add):
            kw = dict(nsweeps=nsw, h2=1.0 / shape[0] ** 2, signs=signs,
                      omega=omega, coarse=c, add=a)
            errs.append(compare(
                f"K13 fold {shape} nsweeps={nsw} omega={omega} dia={dia:.4g}"
                f" signs={signs} add={a is not None}",
                one_launch(lambda: rbgs3d.rbgs_relax_3d(None, rhs, dia, **kw),
                           True),
                rbgs3d.rbgs_relax_3d_plain(None, rhs, dia, **kw), b))
        if not (torch.equal(c, c0) and torch.equal(add, add0)):
            raise AssertionError("K13 changed its coarse correction or add")
    # the block decompositions: bit-identical to the plan's launch
    variants = [dict(threads=t, blocks=nb, brick=br)
                for t, nb, br in ((256, None, None), (512, 1, None),
                                  (256, 7, (1, 1)), (512, 132, (8, 16)),
                                  (512, None, (2, 4)), (256, None, (3, 5)))]
    for m in (32, 64):
        c, rhs, add = (rnd(dtype, m // 2, m // 2, m // 2),
                       rnd(dtype, m, m, m), rnd(dtype, m, m, m))
        kw = dict(nsweeps=4, h2=1.0 / m ** 2, signs=mixed, omega=1.5)
        for src in ("u", "coarse"):
            args = dict(kw, coarse=c, add=add) if src == "coarse" else kw
            first = add if src == "u" else None
            ref = rbgs3d.rbgs_relax_3d(first, rhs, 0.3, **args)
            for v in variants:
                if not torch.equal(ref, rbgs3d.rbgs_relax_3d(
                        first, rhs, 0.3, **args, **v)):
                    raise AssertionError(f"K13 {m}^3 {dtype} from {src}: "
                                         f"{v} differs from the plan's")
    print(f"  K13 {name}: {len(variants)} block decompositions bit-identical "
          "to the plan's at 32^3 and 64^3, from u and from a coarse "
          "correction + u")
    if record is not None:
        record["rbgs_relax_3d"].update(zip(ERR_KEYS, map(max, zip(*errs))))


# the capillary wave's box levels (the 1 x 3 box, periodic rows) from
# full width down to (1, 3), and two with the longer side first
BOX_SHAPES = ((1024, 3072), (512, 1536), (128, 384), (64, 192), (32, 96),
              (16, 48), (8, 24), (4, 12), (2, 6), (1, 3), (3072, 1024),
              (384, 128))


def check_box_kernels(rnd, dtype, errs):
    """K11 and K10 against their plain versions on the levels of a box of
    unit boxes (BOX_SHAPES): K11 with capwave's pressure ghosts (periodic
    rows, Neumann columns), with walls and their offsets, and (the longer
    side first) periodic columns; K10 from a given u with capwave's
    corrections' 4 sweeps (periodic rows, dia 0 and the diffusion's),
    12 sweeps on the coarsest boxes, and walls at omega 1.5.  Errors are
    appended to ``errs``."""
    from gerris_tpu_torch.ops.cuda import rbgs
    b = BOUND[str(dtype).replace("torch.", "")]
    walls = ((-1.0, 1.0, -1.0, 1.0), (0.5, 0.0, -0.25, 0.0))
    for shape in BOX_SHAPES:
        n0, n1 = shape
        h2 = (3.0 / max(shape)) ** 2
        dia_diff = 1.0 / (0.5 * 3.0 / max(shape) * CAPWAVE_NU)
        u, rhs = rnd(dtype, n0, n1), rnd(dtype, n0, n1)
        per = (True, False) if n0 <= n1 else (False, True)
        cases = ((per, (1.0,) * 4, (0.0,) * 4), ((False, False), *walls))
        for pr, sg, of in cases:
            kw = dict(h2=h2, signs=sg, offs=of, periodic=pr)
            errs.setdefault("residual", []).append(compare(
                f"K11 residual {shape} periodic={pr}",
                rbgs.residual(u, rhs, dia_diff, **kw),
                rbgs.residual_plain(u, rhs, dia_diff, **kw), b))
        nsw = 12 if min(shape) <= 2 else 4
        for pr, sg, dia, omega in ((per, (1.0, 1.0, 1.0, 1.0), 0.0, 1.0),
                                   (per, (1.0, 1.0, -1.0, -1.0), dia_diff,
                                    1.0),
                                   ((False, False), walls[0], 0.0, 1.5)):
            kw = dict(nsweeps=nsw, h2=h2, signs=sg, periodic=pr,
                      omega=omega)
            errs.setdefault("rbgs_relax", []).append(compare(
                f"K10 rbgs_relax {shape} nsweeps={nsw} periodic={pr} "
                f"omega={omega}", rbgs.rbgs_relax(u, rhs, dia, **kw),
                rbgs.rbgs_relax_plain(u, rhs, dia, **kw), b))


def check_relax_tiles(rnd):
    """K10 bit-identical across tiles 64, 32 and 16 and threads 256 and
    512 at 2048^2, whole-level and tiled at 64^2, on every periodicity,
    and with its sweeps split over launches."""
    import torch
    from gerris_tpu_torch.ops.cuda import rbgs
    n = N_MAIN
    u, rhs = rnd(torch.float32, n, n), rnd(torch.float32, n, n)
    u64, r64 = u[:64, :64].contiguous(), rhs[:64, :64].contiguous()
    for per in ((False, False), (True, False), (True, True)):
        kw = dict(nsweeps=4, h2=1.0 / n ** 2, signs=(-1.0, 1.0, -1.0, 1.0),
                  periodic=per)
        ref = rbgs.rbgs_relax(u, rhs, 0.5, tile=16, threads=256, **kw)
        for tile in (64, 32, 16):
            for threads in (256, 512):
                if not torch.equal(ref, rbgs.rbgs_relax(
                        u, rhs, 0.5, tile=tile, threads=threads, **kw)):
                    raise AssertionError(f"K10 periodic={per}: tile {tile} "
                                         f"x {threads} threads differs")
        if not torch.equal(rbgs.rbgs_relax(u64, r64, 0.5, **kw),
                           rbgs.rbgs_relax(u64, r64, 0.5, tile=16,
                                           whole_max=32, **kw)):
            raise AssertionError(f"K10 periodic={per}: whole-level and "
                                 "tiled launches differ")
    kw["nsweeps"] = 40
    rbgs.reset_launch_counts()
    split = rbgs.rbgs_relax(u, rhs, 0.5, tile=32, **kw)
    if rbgs.LAUNCHES["rbgs_relax"] < 2 or not all(
            torch.equal(split, rbgs.rbgs_relax(u, rhs, 0.5, tile=t, **kw))
            for t in (64, 16)):
        raise AssertionError("K10: split sweeps differ across tiles")
    # the box levels: tiles and threads at capwave's (1024, 3072) and its
    # transpose, a whole (32, 96) level against the same level tiled
    ub, rb = rnd(torch.float32, 1024, 3072), rnd(torch.float32, 1024, 3072)
    for a, r, per in ((ub, rb, (True, False)),
                      (ub.T.contiguous(), rb.T.contiguous(), (False, True))):
        kw = dict(nsweeps=4, h2=1.0 / 1024 ** 2, signs=(1.0,) * 4,
                  periodic=per)
        ref = rbgs.rbgs_relax(a, r, 0.0, **kw)
        for tile in (64, 32, 16):
            for threads in (256, 512):
                if not torch.equal(ref, rbgs.rbgs_relax(
                        a, r, 0.0, tile=tile, threads=threads, **kw)):
                    raise AssertionError(f"K10 box {tuple(a.shape)}: tile "
                                         f"{tile} x {threads} threads "
                                         "differs")
        a32, r32 = a[:32, :96].contiguous(), r[:32, :96].contiguous()
        if per[1]:
            a32, r32 = a[:96, :32].contiguous(), r[:96, :32].contiguous()
        whole = rbgs.rbgs_relax(a32, r32, 0.0, whole_max=96, **kw)
        if not all(torch.equal(whole, rbgs.rbgs_relax(
                a32, r32, 0.0, tile=t, **kw)) for t in (32, 16)):
            raise AssertionError(f"K10 box {tuple(a32.shape)}: whole-level "
                                 "and tiled launches differ")
    print("  K10 tiles 64 == 32 == 16 x threads 256 == 512 at 2048, whole "
          "== tiled at 64, every periodicity; 40 sweeps split over "
          "launches at each tile; on the box (1024, 3072) and its "
          "transpose every tile and threads, whole == tiled at (32, 96): "
          "bit-identical")


ALPHA_CASES = (("walls", (-1.0, -1.0, -1.0, -1.0), (False, False)),
               ("per_x", (1.0, 1.0, -1.0, 1.0), (True, False)),
               ("per_xy", (1.0, 1.0, 1.0, 1.0), (True, True)))


def alpha_system(rnd, dtype, n, periodic, cell, dead):
    """u, rhs, positive face coefficients (face n = face 0 on a periodic
    axis, as the two-phase coefficients are), a scalar or positive cell
    dia on an n^2 level, or an n0 x n1 one for ``n`` = (n0, n1) (a box's,
    such as the bubble's n x 2n); ``dead``: a few cells with all four
    faces and dia zero."""
    n0, n1 = (n, n) if isinstance(n, int) else n
    u, rhs = rnd(dtype, n0, n1), rnd(dtype, n0, n1)
    ax = 0.2 + rnd(dtype, n0 + 1, n1).abs()
    ay = 0.2 + rnd(dtype, n0, n1 + 1).abs()
    dia = 0.5 + rnd(dtype, n0, n1).abs() if cell else 0.3
    if periodic[0]:
        ax[n0] = ax[0]
    if periodic[1]:
        ay[:, n1] = ay[:, 0]
    if dead:
        for i, j in ((1, 2), (n0 // 2, n1 // 2 + 1), (n0 - 2, 3)):
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
    value; each from a given u and with a coarse correction's
    prolongation folded in, + u.  Then every level size of a correction
    down to 4^2 as the correction runs it: from zero at 4^2, the coarser
    level prolonged above, + u at the top."""
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
                c = rnd(dtype, n // 2, n // 2)
                kw = dict(nsweeps=nsw, h2=1.0 / n ** 2, signs=signs,
                          periodic=per, omega=omega, dia_cell=cell)
                tag = (f"{n} {kind} dia={'cell' if cell else 'scalar'} "
                       f"omega={omega} nsweeps={nsw}"
                       f"{' dead cells' if dead else ''}")
                got = rbgs.rbgs_relax_alpha(u, rhs, ax, ay, dia, **kw)
                errs.append(compare(
                    f"K15 rbgs_relax_alpha {tag}", got,
                    rbgs.rbgs_relax_alpha_plain(u, rhs, ax, ay, dia, **kw),
                    b))
                if dead and not (got[1, 2] == u[1, 2]
                                 and got[n - 2, 3] == u[n - 2, 3]):
                    raise AssertionError("K15: a zero-diagonal cell moved")
                fold = dict(kw, coarse=c, add=u)
                errs.append(compare(
                    f"K15 rbgs_relax_alpha coarse + u {tag}",
                    rbgs.rbgs_relax_alpha(None, rhs, ax, ay, dia, **fold),
                    rbgs.rbgs_relax_alpha_plain(None, rhs, ax, ay, dia,
                                                **fold), b))
    m = n
    while m >= 4:
        for kind, signs, per in ALPHA_CASES:
            u, rhs, ax, ay, dia = alpha_system(rnd, dtype, m, per, True,
                                               False)
            kw = dict(nsweeps=24 if m == 4 else 8, h2=1.0 / m ** 2,
                      signs=signs, periodic=per, omega=1.0, dia_cell=True,
                      coarse=None if m == 4 else rnd(dtype, m // 2, m // 2),
                      add=u if m == n else None)
            compare(f"K15 rbgs_relax_alpha {m} {kind} "
                    f"{'from zero' if m == 4 else 'coarse'}"
                    f"{' + u' if m == n else ''}",
                    rbgs.rbgs_relax_alpha(None, rhs, ax, ay, dia, **kw),
                    rbgs.rbgs_relax_alpha_plain(None, rhs, ax, ay, dia,
                                                **kw), b)
        m //= 2
    # the bubble's box levels (n, 2n): at (1024, 2048) with walls, a
    # scalar and a cell dia, zero-diagonal cells, from u and with a coarse
    # correction's prolongation + u; then every level of a bubble
    # correction down to (4, 8) with V's signs (Neumann x, Dirichlet y)
    box = (n, 2 * n)
    for cell in (False, True):
        u, rhs, ax, ay, dia = alpha_system(rnd, dtype, box, (False, False),
                                           cell, True)
        kw = dict(nsweeps=8, h2=1.0 / n ** 2, signs=(-1.0,) * 4,
                  periodic=(False, False), omega=1.0, dia_cell=cell)
        tag = f"{n}x{2 * n} walls dia={'cell' if cell else 'scalar'}"
        errs.append(compare(
            f"K15 rbgs_relax_alpha {tag}",
            rbgs.rbgs_relax_alpha(u, rhs, ax, ay, dia, **kw),
            rbgs.rbgs_relax_alpha_plain(u, rhs, ax, ay, dia, **kw), b))
        fold = dict(kw, coarse=rnd(dtype, n // 2, n), add=u)
        errs.append(compare(
            f"K15 rbgs_relax_alpha coarse + u {tag}",
            rbgs.rbgs_relax_alpha(None, rhs, ax, ay, dia, **fold),
            rbgs.rbgs_relax_alpha_plain(None, rhs, ax, ay, dia, **fold), b))
    m = n
    while m >= 4:
        u, rhs, ax, ay, dia = alpha_system(rnd, dtype, (m, 2 * m),
                                           (False, False), True, False)
        kw = dict(nsweeps=24 if m == 4 else 8, h2=1.0 / m ** 2,
                  signs=(1.0, 1.0, -1.0, -1.0), periodic=(False, False),
                  omega=1.0, dia_cell=True,
                  coarse=None if m == 4 else rnd(dtype, m // 2, m),
                  add=u if m == n else None)
        compare(f"K15 rbgs_relax_alpha {m}x{2 * m} "
                f"{'from zero' if m == 4 else 'coarse'}"
                f"{' + u' if m == n else ''}",
                rbgs.rbgs_relax_alpha(None, rhs, ax, ay, dia, **kw),
                rbgs.rbgs_relax_alpha_plain(None, rhs, ax, ay, dia, **kw), b)
        m //= 2
    if record is not None:
        record["rbgs_relax_alpha"].update(zip(ERR_KEYS, map(max, zip(*errs))))


def cylinder_systems(dev, dtype):
    """The cylinder's K15 systems at LEVEL_CYLINDER, down its correction's
    levels (poisson._coeff_hierarchy): ("projection", alpha = s, dia 0,
    the pressure's homogeneous signs) and ("viscous", alpha = beta dt nu s
    and the cell dia a + beta dt nu dia_s at dt = 0.8 h, u's and v's
    signs).  Returns [(name, signs, alphas, dias, grids)]."""
    import dataclasses
    from gerris_tpu_torch.models import ns
    from gerris_tpu_torch.solvers import poisson
    cfg = cylinder_cfg(LEVEL_CYLINDER)
    grid = cfg.grid
    ctx = ns._static_weights(grid, cfg.solid_phi, False, None, dev,
                               dtype)
    scale = 0.8 * grid.h * CYLINDER_NU
    nl = cylinder_levels(LEVEL_CYLINDER)
    grids = [dataclasses.replace(grid, level=LEVEL_CYLINDER - k)
             for k in range(nl)]
    out = []
    for name, fbc, alpha, dia in (
            ("projection", cfg.p_bc, ctx.s, 0.0),
            ("viscous u", cfg.u_bcs[0], tuple(scale * f for f in ctx.s),
             ctx.a + scale * ctx.ds.dia),
            ("viscous v", cfg.u_bcs[1], tuple(scale * f for f in ctx.s),
             ctx.a + scale * ctx.ds.dia)):
        alphas, dias = poisson._coeff_hierarchy(grid, 2, alpha, dia)
        signs = poisson._signs_offs(grid, fbc, True)[0]
        out.append((name, signs, alphas, dias, grids))
    return out, ctx


def check_alpha_systems(tag, systems, dead, rnd, dtype, errs):
    """K15 against its plain version on each system's levels (systems:
    [(name, signs, periodic, alphas, dias, grids)]): the whole cells of
    zero diagonal ``dead`` (a solid's), which keep their value, at the top
    from a given u (4 sweeps) and with the coarser level's correction
    prolonged + u; every level below as the correction runs it (the
    coarser one prolonged, 4 sweeps; from zero with 12 at the coarsest)."""
    from gerris_tpu_torch.ops.cuda import rbgs
    b = BOUND[str(dtype).replace("torch.", "")]
    for name, signs, periodic, alphas, dias, grids in systems:
        nl = len(grids)
        for k in range(nl):
            shape = grids[k].shape
            cell = not isinstance(dias[k], float)
            rhs = rnd(dtype, *shape)
            kw = dict(nsweeps=12 if k == nl - 1 else 4,
                      h2=grids[k].h ** 2, signs=signs,
                      periodic=periodic, dia_cell=cell)
            ax, ay = alphas[k]
            lab = f"{shape[0]}x{shape[1]} {tag} {name}"
            if k == 0:
                u = rnd(dtype, *shape)
                got = rbgs.rbgs_relax_alpha(u, rhs, ax, ay, dias[k], **kw)
                errs.append(compare(
                    f"K15 rbgs_relax_alpha {lab} from u", got,
                    rbgs.rbgs_relax_alpha_plain(u, rhs, ax, ay, dias[k],
                                                **kw), b))
                if not bool((got[dead] == u[dead]).all()):
                    raise AssertionError(f"K15 {lab}: a solid cell of zero "
                                         "diagonal moved")
            c = None if k == nl - 1 else rnd(dtype, *grids[k + 1].shape)
            fold = dict(kw, coarse=c, add=u if k == 0 else None)
            errs.append(compare(
                f"K15 rbgs_relax_alpha {lab} "
                f"{'from zero' if c is None else 'coarse'}"
                f"{' + u' if k == 0 else ''}",
                rbgs.rbgs_relax_alpha(None, rhs, ax, ay, dias[k], **fold),
                rbgs.rbgs_relax_alpha_plain(None, rhs, ax, ay, dias[k],
                                            **fold), b))
    print(f"  K15 on the {tag}'s levels: {int(dead.sum())} solid cells "
          "of zero diagonal kept")


def check_cylinder_alpha(dev, rnd, dtype, errs):
    """K15 against its plain version on the cylinder's levels, (3072,
    1024) down to (12, 4), with its geometry's coefficients
    (cylinder_systems, check_alpha_systems)."""
    systems, ctx = cylinder_systems(dev, dtype)
    check_alpha_systems("cylinder", [
        (name, signs, (False, False), alphas, dias, grids)
        for name, signs, alphas, dias, grids in systems], ctx.a == 0.0, rnd,
        dtype, errs)


def check_alpha_tiles(rnd):
    """K15 bit-identical across tiles 64, 32 and 16 and threads 256 and
    512 at 1024^2 (float32; tiles 32 and 16 in float64), from a given u
    and with the coarse correction folded in (+ u), whole-level and tiled
    at 64^2, on every periodicity, and with its sweeps split over
    launches."""
    import torch
    from gerris_tpu_torch.ops.cuda import rbgs
    n = 1 << LEVEL_TWOPHASE
    for dtype, tiles in ((torch.float32, (64, 32, 16)),
                         (torch.float64, (32, 16))):
        for kind, signs, per in ALPHA_CASES:
            u, rhs, ax, ay, dia = alpha_system(rnd, dtype, n, per, True, True)
            c = rnd(dtype, n // 2, n // 2)
            kw = dict(nsweeps=8, h2=1.0 / n ** 2, signs=signs, periodic=per,
                      omega=1.5, dia_cell=True)
            for start in (dict(), dict(coarse=c, add=u)):
                x = None if start else u
                outs = [rbgs.rbgs_relax_alpha(x, rhs, ax, ay, dia, tile=t,
                                              threads=th, **start, **kw)
                        for t in tiles for th in (256, 512)]
                if not all(torch.equal(outs[0], o) for o in outs[1:]):
                    raise AssertionError(f"K15 {kind} {dtype} {list(start)}:"
                                         f" tiles {tiles} differ")
            s64 = alpha_system(rnd, dtype, 64, per, True, True)
            c64 = rnd(dtype, 32, 32)
            for x, start in ((s64[0], dict()), (None, dict(coarse=c64))):
                if not torch.equal(
                        rbgs.rbgs_relax_alpha(x, *s64[1:], **start, **kw),
                        rbgs.rbgs_relax_alpha(x, *s64[1:], tile=16,
                                              whole_max=32, **start, **kw)):
                    raise AssertionError(f"K15 {kind} {dtype}: whole-level "
                                         "and tiled launches differ")
            if kind == "walls":
                # the bubble's box (n, 2n): tiled at every tile, and a
                # whole (32, 64) level (one block on the square buffer of
                # its longer side) against the same level tiled
                bu, brhs, bax, bay, bdia = alpha_system(
                    rnd, dtype, (n, 2 * n), per, True, True)
                bc_ = rnd(dtype, n // 2, n)
                outs = [rbgs.rbgs_relax_alpha(None, brhs, bax, bay, bdia,
                                              tile=t, coarse=bc_, add=bu,
                                              **kw) for t in tiles]
                if not all(torch.equal(outs[0], o) for o in outs[1:]):
                    raise AssertionError(f"K15 box {dtype}: tiles {tiles} "
                                         "differ")
                w = alpha_system(rnd, dtype, (32, 64), per, True, True)
                cw = rnd(dtype, 16, 32)
                for x, start in ((w[0], dict()), (None, dict(coarse=cw))):
                    if not torch.equal(
                            rbgs.rbgs_relax_alpha(x, *w[1:], **start, **kw),
                            rbgs.rbgs_relax_alpha(x, *w[1:], tile=16,
                                                  whole_max=32, **start,
                                                  **kw)):
                        raise AssertionError(f"K15 box {dtype}: whole-level"
                                             " and tiled launches differ")
            rbgs.reset_launch_counts()
            kws = dict(kw, nsweeps=30, coarse=c, add=u)
            split = rbgs.rbgs_relax_alpha(None, rhs, ax, ay, dia, tile=32,
                                          **kws)
            if rbgs.LAUNCHES["rbgs_relax_alpha"] < 2 or not torch.equal(
                    split, rbgs.rbgs_relax_alpha(None, rhs, ax, ay, dia,
                                                 tile=16, **kws)):
                raise AssertionError(f"K15 {kind} {dtype}: split sweeps "
                                     "differ across tiles")
    print(f"  K15 tiles 64 == 32 == 16 x threads 256 == 512 at {n} "
          "(float64: 32 == 16), from u and from a coarse correction + u, "
          "whole == tiled at 64, every periodicity; 30 sweeps over "
          f"several launches; the box {n}x{2 * n} at every tile and a "
          "whole 32x64 level == tiled: bit-identical")


def alpha_flops(n, nsweeps, omega, coarse=False, add=False):
    """Operations of K15 on an n^2 level: den once (5 per cell), then per
    sweep the numerator (7), the rhs term (2), the division (1) and the
    omega blend (3); with a coarse correction its prolongation (6 per
    cell), with an added u 1 per cell."""
    return n * n * (5 + nsweeps * (10 + (3 if omega != 1.0 else 0))
                    + (6 if coarse else 0) + (1 if add else 0))


def k13_flops(n, nsweeps, omega, coarse=False, add=False):
    """Operations of K13 on an n^3 level: per sweep the neighbour sum and
    update (7 per cell, 3 more with omega != 1); with a coarse correction
    its prolongation (3 per cell of each axis's output: 5.25 per fine
    cell, counted 6), with an added field 1 per cell."""
    return n ** 3 * (nsweeps * (7 + (3 if omega != 1.0 else 0))
                     + (6 if coarse else 0) + (1 if add else 0))


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


# the pyramids of the paths: (top, levels) of the cascades (512 -> 16),
# the adaptive correction (2048 -> 512), the twophase correction (1024 ->
# 4, past one cell per tile), the bubble's ((1024, 2048) -> (4, 8)), the
# capillary wave's ((1024, 3072) -> (32, 96)) and the cylinder's, the
# longer side first ((3072, 1024) -> (12, 4))
PYRAMIDS = (((512, 512), 5), ((2048, 2048), 2), ((1024, 1024), 8),
            ((1024, 2048), 8), ((1024, 3072), 5), ((3072, 1024), 8),
            ((2048, 2048), 9))


def check_pyramids(rnd, dtype):
    """restrict_pyramid, single and pair, bit-identical at every level to
    the chain of restrict2 launches it replaces and to its plain version,
    at each path's shape, twice (the last block resets the arrival count
    for the next launch).  Returns the (max_abs_err, max_rel_err) of the
    cascade's pyramid against its plain version, (0, 0) when it holds."""
    import torch
    from gerris_tpu_torch.ops.cuda import rbgs
    for n, levels in PYRAMIDS:
        r, r2 = rnd(dtype, *n), rnd(dtype, *n)
        chain, x = [], r
        for _ in range(levels):
            x = rbgs.restrict2(x)
            chain.append(x)
        for _ in range(2):
            got = rbgs.restrict_pyramid(r, levels)
            pair = rbgs.restrict_pyramid_pair([r, r2], levels)
            for name, want in (("the restrict2 chain", chain),
                               ("the plain version",
                                rbgs.pyramid_plain(r, levels)),
                               ("the pair's first system", pair[0])):
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"restrict_pyramid {n} {levels} "
                                         f"{dtype}: differs from {name}")
            if not all(torch.equal(a, b) for a, b in zip(
                    pair[1], rbgs.pyramid_plain(r2, levels))):
                raise AssertionError(f"restrict_pyramid_pair {n} {levels} "
                                     f"{dtype}: second system differs")
    print(f"  restrict_pyramid {dtype}, single and pair, " + ", ".join(
        f"{n[0]}x{n[1]} -> {n[0] >> lv}x{n[1] >> lv}" for n, lv in PYRAMIDS)
        + ": bit-identical to the restrict2 chain and the plain version")
    return 0.0, 0.0


def host_device_us(fn, calls=1000):
    """(host us per call, device us per launch) of ``fn``: time.perf_counter
    over ``calls`` calls with no synchronisation (the card's queue absorbs
    them), then torch.profiler's device time over as many calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev_us, launches = 0.0, 0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            us = getattr(evt, "self_device_time_total", None)
            dev_us += evt.self_cuda_time_total if us is None else us
            launches += evt.count
    return host, dev_us / max(launches, 1)


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
        check_residual_restrict(rnd, dtype, b13)
        e = check_pyramids(rnd, dtype)
        if main:
            record["restrict_pyramid"].update(zip(ERR_KEYS, e))
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
        errs15 = []
        check_cylinder_alpha(dev, rnd, dtype, errs15)
        errs_w = []
        check_weighted_alpha(dev, rnd, dtype, errs_w)
        if main:
            record["rbgs_relax_alpha"].update(
                {f"{k}_cylinder": v
                 for k, v in zip(ERR_KEYS, map(max, zip(*errs15)))})
            record["rbgs_relax_alpha"].update(
                {f"{k}_weighted": v
                 for k, v in zip(ERR_KEYS, map(max, zip(*errs_w)))})
    check_relax_tiles(rnd)
    check_fold_tiles(rnd)
    check_alpha_tiles(rnd)

    # K3 tile invariance: bit-identical across tile sizes (the plan's
    # choice, 64 at 2048^2, against 32 and 16) and whole-level, f32 and
    # f64, periodic columns or not
    for dtype in (torch.float32, torch.float64):
        c, rh, uu = (rnd(dtype, n // 2, n // 2), rnd(dtype, n, n),
                     rnd(dtype, n, n))
        for per_y in (False, True):
            kw = dict(nsweeps=5, h2=h2, signs=signs, omega=1.5, per_y=per_y)
            a = rbgs.prolong_relax(c, rh, 0.0, uu, tile=16, **kw)
            for tile in (32, 64, None):
                if not torch.equal(a, rbgs.prolong_relax(c, rh, 0.0, uu,
                                                         tile=tile, **kw)):
                    raise AssertionError(f"K3 {dtype} per_y={per_y}: tile "
                                         f"{tile} and tile 16 differ")
            c64, rh64 = rnd(dtype, 32, 32), rnd(dtype, 64, 64)
            if not torch.equal(rbgs.prolong_relax(c64, rh64, 0.0, **kw),
                               rbgs.prolong_relax(c64, rh64, 0.0, tile=16,
                                                  whole_max=32, **kw)):
                raise AssertionError("K3: whole-level and tiled launches "
                                     "differ")
    print("  K3 tiles 64 == 32 == 16 == the plan's at 2048 (f32, f64, "
          "periodic columns or not), whole == tiled at 64: bit-identical")
    # K8c: the same, for both systems of a pair (own dias)
    cs = [rnd(torch.float32, n // 2, n // 2) for _ in range(2)]
    rhs_s = [rnd(torch.float32, n, n) for _ in range(2)]
    us = [rnd(torch.float32, n, n) for _ in range(2)]
    dias = [dia_diff, 0.5 * dia_diff]
    kw = dict(nsweeps=1, h2=h2, signs=signs)
    a = rbgs.prolong_relax_pair(cs, rhs_s, dias, us, tile=16, **kw)
    for tile in (32, 64, None):
        b = rbgs.prolong_relax_pair(cs, rhs_s, dias, us, tile=tile, **kw)
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"K8c: tile {tile} and tile 16 differ")
    cs = [rnd(torch.float32, 32, 32) for _ in range(2)]
    rhs_s = [rnd(torch.float32, 64, 64) for _ in range(2)]
    kw["h2"] = 1.0 / 64 ** 2
    none = [None, None]
    if not all(torch.equal(x, y) for x, y in zip(
            rbgs.prolong_relax_pair(cs, rhs_s, dias, none, **kw),
            rbgs.prolong_relax_pair(cs, rhs_s, dias, none, tile=16,
                                    whole_max=32, **kw))):
        raise AssertionError("K8c: whole-level and tiled launches differ")
    print("  K8c tiles 64 == 32 == 16 == the plan's at 2048, whole == tiled "
          "at 64: bit-identical")

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
    for rows in rbgs.RR_ROWS[1:]:
        timings[f"residual_restrict|rows{rows}"] = (
            lambda rows=rows: rbgs.residual_restrict(u, rhs, 0.0, sub,
                                                     tile_rows=rows, **kw),
            timings["residual_restrict"][1], nbytes(u, rhs, sub), n * n * 8,
            None)
    # the cascades' pyramid, 512^2 -> 16^2 (3 operations per coarse
    # cell), single and pair; its one-level case restrict2 at 512^2
    # beside avg_pool2d, which computes that level
    r512, r512b = rnd(f32, 512, 512), rnd(f32, 512, 512)
    r512_4d = r512.view(1, 1, 512, 512)
    pyr_ops = sum((512 >> k) ** 2 * 3 for k in range(1, 6))
    timings["restrict_pyramid"] = (
        lambda: rbgs.restrict_pyramid(r512, 5),
        lambda: rbgs.pyramid_plain(r512, 5), nbytes(r512), pyr_ops, None)
    timings["restrict_pyramid|pair"] = (
        lambda: flat(rbgs.restrict_pyramid_pair([r512, r512b], 5)),
        lambda: flat([rbgs.pyramid_plain(r, 5) for r in (r512, r512b)]),
        nbytes(r512, r512b), 2 * pyr_ops, None)
    timings["restrict_pyramid|restrict2"] = (
        lambda: rbgs.restrict2(r512), lambda: rbgs.pool_plain(r512),
        nbytes(r512), 256 * 256 * 3, lambda: F.avg_pool2d(r512_4d, 2))
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
    # K7's function as the per-component route computes it: two K14
    # launches, timed in turns with K7
    k14_kw = [dict(g=Gx, gp=GPx, oscale=-dia), dict(g=Gy, gp=GPy, oscale=-dia)]
    timings["advect2d_pair|two_k14"] = (
        lambda: [bcg.advect2d(v, c, ufx, ufy, dt, grid, u_bcs[c], **k14_kw[c])
                 for c, v in enumerate((U, V))],
        lambda: [bcg.advect2d_plain(v, c, ufx, ufy, dt, grid, u_bcs[c],
                                    **k14_kw[c]) for c, v in enumerate((U, V))],
        in7, 2 * n * n * 75, None)
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
    # K11 and K10 on capwave's finest box level, (1024, 3072): K11 with
    # its pressure ghosts, K10 as its corrections run it (4 sweeps from the
    # prolonged correction, periodic rows, dia 0: 6 per cell per sweep)
    u13, r13 = rnd(f32, 1024, 3072), rnd(f32, 1024, 3072)
    kwb11 = dict(h2=(3.0 / 3072) ** 2, signs=(1.0,) * 4,
                 periodic=(True, False))
    timings["residual|box"] = (
        lambda: rbgs.residual(u13, r13, 0.0, **kwb11),
        lambda: rbgs.residual_plain(u13, r13, 0.0, **kwb11),
        nbytes(u13, r13), u13.numel() * 8, None)
    kwb10 = dict(kwb11, nsweeps=4)
    timings["rbgs_relax|box"] = (
        lambda: rbgs.rbgs_relax(u13, r13, 0.0, **kwb10),
        lambda: rbgs.rbgs_relax_plain(u13, r13, 0.0, **kwb10),
        nbytes(u13, r13), u13.numel() * 4 * 6, None)
    # K12 as the adaptive projections run it: 512^2 with the adaptive
    # schedule's 5 sweeps and 40 coarsest; its block kernel alone at 64^2
    # (one launch on the levels 64^2 .. 16^2 that K12's pyramid gives it)
    r512k, r64k = rnd(f32, 512, 512), rnd(f32, 64, 64)
    kw12 = dict(nsweeps=5, coarsest=40, h2=16 * h2, signs=(1.0,) * 4,
                min_n=16)
    timings["coarse_vcycle"] = (
        lambda: rbgs.coarse_vcycle(r512k, 0.0, **kw12),
        lambda: rbgs.coarse_vcycle_plain(r512k, 0.0, **kw12),
        nbytes(r512k), vcycle_flops(512, 5, 40), None)
    kwcb = dict(kw12, h2=(n // 64) ** 2 * h2)
    levels12 = [r64k] + rbgs.restrict_pyramid(r64k, 2)

    def k12_block(**kw):
        k = dict(kwcb, **kw)
        return rbgs._coarse_block_cuda(
            [levels12], [0.0], k["nsweeps"], k["coarsest"], k["h2"],
            k["signs"], False, 1.0, "coarse_block", fused=True)[0]

    timings["coarse_block"] = (
        k12_block,
        lambda: rbgs.coarse_vcycle_plain(r64k, 0.0, **kwcb),
        nbytes(r64k), vcycle_flops(64, 5, 40), None)
    # the block kernel at the main path's cascade tails (K2's, K8b's),
    # beside the three K3 launches that ran each before it
    tails = main_tails(rnd, f32, dia_diff)
    for name, args in tails.items():
        for how, fn in (("tail", tail_kernel), ("k3", k3_tail)):
            timings[f"coarse_block|{name}_{how}"] = (
                lambda fn=fn, args=args: fn(*args),
                lambda args=args: tail_plain(*args),
                nbytes(*flat(args[0])), tail_flops(args), None)
    # K13 at 128^3 as the projections run it (4 sweeps, omega 1.5: 10 per
    # cell per sweep) and as the diffusion does (1 sweep, 7 per cell)
    from gerris_tpu_torch.ops.cuda import rbgs3d
    n3 = 1 << LEVEL_3D
    u3, r3 = rnd(f32, n3, n3, n3), rnd(f32, n3, n3, n3)
    kw13 = dict(nsweeps=4, h2=1.0 / n3 ** 2, signs=(1.0,) * 6, omega=1.5)
    timings["rbgs_relax_3d"] = (
        lambda: rbgs3d.rbgs_relax_3d(u3, r3, 0.0, **kw13),
        lambda: rbgs3d.rbgs_relax_3d_plain(u3, r3, 0.0, **kw13),
        nbytes(u3, r3), k13_flops(n3, 4, 1.5), None)
    # the fold as the projections' finest level runs it: the 64^3
    # correction prolonged in the kernel, 4 sweeps, + u
    c3 = rnd(f32, n3 // 2, n3 // 2, n3 // 2)
    kw13f = dict(kw13, coarse=c3, add=u3)
    timings["rbgs_relax_3d|fold"] = (
        lambda: rbgs3d.rbgs_relax_3d(None, r3, 0.0, **kw13f),
        lambda: rbgs3d.rbgs_relax_3d_plain(None, r3, 0.0, **kw13f),
        nbytes(c3, r3, u3), k13_flops(n3, 4, 1.5, True, True), None)
    dia3 = 1.0 / (0.8 / n3 * 1e-3)
    kw13d = dict(nsweeps=1, h2=1.0 / n3 ** 2, signs=(-1.0,) * 6)
    timings["rbgs_relax_3d|diffusion"] = (
        lambda: rbgs3d.rbgs_relax_3d(u3, r3, dia3, **kw13d),
        lambda: rbgs3d.rbgs_relax_3d_plain(u3, r3, dia3, **kw13d),
        nbytes(u3, r3), k13_flops(n3, 1, 1.0), None)
    # K15 as the twophase route runs it at its finest level, 1024^2: the
    # diffusion's cell dia (rho) and 8 sweeps from a given u, the
    # projections' scalar dia 0, and the correction's fold: the coarse
    # level's result prolonged at placement, + u
    na = 1 << LEVEL_TWOPHASE
    ua, ra, axa, aya, da = alpha_system(rnd, f32, na, (False, False), True,
                                        False)
    ca = rnd(f32, na // 2, na // 2)
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
    kw15c = dict(kw15, dia_cell=True, coarse=ca, add=ua)
    timings["rbgs_relax_alpha|coarse"] = (
        lambda: rbgs.rbgs_relax_alpha(None, ra, axa, aya, da, **kw15c),
        lambda: rbgs.rbgs_relax_alpha_plain(None, ra, axa, aya, da, **kw15c),
        nbytes(ca, ra, axa, aya, da, ua),
        alpha_flops(na, 8, 1.0, coarse=True, add=True), None)
    # K15 at the bubble's finest level, the box's (1024, 2048), as its
    # corrections run it there: the coarse level's result prolonged at
    # placement, + u, the diffusion's cell dia; and the bubble's pyramid,
    # (1024, 2048) -> (4, 8) (3 operations per coarse cell)
    bx = alpha_system(rnd, f32, (na, 2 * na), (False, False), True, False)
    cbx = rnd(f32, na // 2, na)
    kwbx = dict(kw15, dia_cell=True, coarse=cbx, add=bx[0])
    timings["rbgs_relax_alpha|box"] = (
        lambda: rbgs.rbgs_relax_alpha(None, *bx[1:], **kwbx),
        lambda: rbgs.rbgs_relax_alpha_plain(None, *bx[1:], **kwbx),
        nbytes(cbx, *bx), 2 * alpha_flops(na, 8, 1.0, coarse=True, add=True),
        None)
    # K15 at the cylinder's finest level, (3072, 1024), as its viscous
    # solves run it there: the coarser level prolonged at placement, + u,
    # 4 sweeps, the cut cells' face coefficients and cell dia; and its
    # pyramid, (3072, 1024) -> (12, 4)
    cyl, _ = cylinder_systems(dev, f32)
    _, csg, cal, cdi, cgr = cyl[1]
    n0c, n1c = cgr[0].shape
    cu, cr = rnd(f32, n0c, n1c), rnd(f32, n0c, n1c)
    cc = rnd(f32, n0c // 2, n1c // 2)
    kwcy = dict(nsweeps=4, h2=cgr[0].h ** 2, signs=csg, dia_cell=True,
                coarse=cc, add=cu)
    timings["rbgs_relax_alpha|cylinder"] = (
        lambda: rbgs.rbgs_relax_alpha(None, cr, *cal[0], cdi[0], **kwcy),
        lambda: rbgs.rbgs_relax_alpha_plain(None, cr, *cal[0], cdi[0],
                                            **kwcy),
        nbytes(cc, cr, *cal[0], cdi[0], cu),
        3 * alpha_flops(n1c, 4, 1.0, coarse=True, add=True), None)
    pl_cy = len(cgr) - 1
    timings["restrict_pyramid|cylinder"] = (
        lambda: rbgs.restrict_pyramid(cr, pl_cy),
        lambda: rbgs.pyramid_plain(cr, pl_cy), nbytes(cr),
        sum((n0c >> k) * (n1c >> k) * 3 for k in range(1, pl_cy + 1)), None)
    # K15 at slice 4b's finest level, 2048^2, as the moving disk's viscous
    # u solve (its geometry after one step: the cut cells' face
    # coefficients and cell dia, the solid's dead cells) and the
    # axisymmetric pipe's viscous v solve (the cell dia a + beta dt nu a /
    # r^2) run it: coarse + u, 4 sweeps; and the pyramid 2048^2 -> 4^2
    from gerris_tpu_torch.models import ns as ns_mod
    for tag, cfg_w in (("moving", moving_cfg(LEVEL_MOVING, 1)),
                       ("axi", axi_cfg(LEVEL_AXI))):
        zw = torch.zeros(cfg_w.grid.shape, dtype=f32, device=dev)
        dtw = MOVING_DT * cfg_w.grid.h
        ww = ns_mod._moving_weights(cfg_w, [zw, zw], dtw, 0.0)[0] \
            if cfg_w.moving_solid else ns_mod._weights(cfg_w, zw)
        name_w = "viscous u" if tag == "moving" else "viscous v"
        _, wsg, wper, wal, wdi, wgr = [x for x in weighted_systems(
            cfg_w, ww, dtw) if x[0] == name_w][0]
        mw0, mw1 = wgr[0].shape
        wu, wr = rnd(f32, mw0, mw1), rnd(f32, mw0, mw1)
        wc = rnd(f32, mw0 // 2, mw1 // 2)
        kww = dict(nsweeps=4, h2=wgr[0].h ** 2, signs=wsg, periodic=wper,
                   dia_cell=True, coarse=wc, add=wu)
        timings[f"rbgs_relax_alpha|{tag}"] = (
            lambda wr=wr, wal=wal, wdi=wdi, kww=kww: rbgs.rbgs_relax_alpha(
                None, wr, *wal[0], wdi[0], **kww),
            lambda wr=wr, wal=wal, wdi=wdi, kww=kww:
                rbgs.rbgs_relax_alpha_plain(None, wr, *wal[0], wdi[0],
                                            **kww),
            nbytes(wc, wr, *wal[0], wdi[0], wu),
            3 * alpha_flops(mw0, 4, 1.0, coarse=True, add=True), None)
        del zw, ww
    timings["restrict_pyramid|2048_to_4"] = (
        lambda: rbgs.restrict_pyramid(wr, LEVEL_MOVING - 2),
        lambda: rbgs.pyramid_plain(wr, LEVEL_MOVING - 2), nbytes(wr),
        sum((mw0 >> k) * (mw1 >> k) * 3
            for k in range(1, LEVEL_MOVING - 1)), None)
    rbx = rnd(f32, na, 2 * na)
    timings["restrict_pyramid|box"] = (
        lambda: rbgs.restrict_pyramid(rbx, 8),
        lambda: rbgs.pyramid_plain(rbx, 8), nbytes(rbx),
        sum((na >> k) * (2 * na >> k) * 3 for k in range(1, 9)), None)
    # K15 at 1024^2 per tile and threads, with and without the coarse
    # correction, in turns (forward, then backward; the lower time)
    combos = [(t, th) for t in (64, 32, 16) for th in (256, 512)]
    k15_tiles = {}
    for t, th in combos + combos[::-1]:
        key = f"{t}x{th}"
        ts = {"u": cuda_ms(lambda: rbgs.rbgs_relax_alpha(
                  ua, ra, axa, aya, da, dia_cell=True, tile=t, threads=th,
                  **kw15)),
              "coarse": cuda_ms(lambda: rbgs.rbgs_relax_alpha(
                  None, ra, axa, aya, da, tile=t, threads=th, **kw15c))}
        k15_tiles[key] = {k: min(v, k15_tiles.get(key, {}).get(k, v))
                          for k, v in ts.items()}
    plan15 = rbgs._plan("rbgs_relax_alpha", ra, 8, None, None, 64)
    record["rbgs_relax_alpha"]["tiles"] = k15_tiles
    record["rbgs_relax_alpha"]["plan"] = f"{plan15[0]}x{plan15[2]}"
    print(f"  K15 per tile x threads at {na}^2 (float32, cell dia, 8 "
          f"sweeps; ms from u / from a coarse correction + u; the plan "
          f"{plan15[0]}x{plan15[2]}): " + ", ".join(
              f"{k} {v['u']:.4f} / {v['coarse']:.4f}"
              for k, v in k15_tiles.items()))
    # K15 at every level of a twophase correction as the correction runs
    # it (from zero with 24 sweeps at 4^2, the coarser level prolonged
    # with 8 above, + u at the top), the plan's tile: CUDA events at 256
    # and 512 threads (back to back, so the smallest levels read the
    # host's time per call), and the plan's device and host time per
    # launch (profiled); each level's plain time and bound beside
    k15_levels = {}
    m = na
    while m >= 4:
        ul, rl, axl, ayl, dl = alpha_system(rnd, f32, m, (False, False),
                                            True, False)
        cl = None if m == 4 else rnd(f32, m // 2, m // 2)
        al = ul if m == na else None
        nsw = 24 if m == 4 else 8
        kwl = dict(nsweeps=nsw, h2=1.0 / m ** 2, signs=(-1.0,) * 4,
                   dia_cell=True, coarse=cl, add=al)
        pl = rbgs._plan("rbgs_relax_alpha", rl, nsw, None, None, 64)
        lv = {f"ms_{th}": cuda_ms(lambda: rbgs.rbgs_relax_alpha(
                  None, rl, axl, ayl, dl, threads=th, **kwl))
              for th in (256, 512)}
        host, dev_us = host_device_us(lambda: rbgs.rbgs_relax_alpha(
            None, rl, axl, ayl, dl, **kwl), calls=200)
        lv.update(ms=lv[f"ms_{pl[2]}"], device_us=dev_us, host_us=host,
                  plain_ms=cuda_ms(lambda: rbgs.rbgs_relax_alpha_plain(
                      None, rl, axl, ayl, dl, **kwl)),
                  bound_ms=bound(nbytes(cl, rl, axl, ayl, dl, al), rl,
                                 alpha_flops(m, nsw, 1.0, cl is not None,
                                             al is not None))[0],
                  tile=pl[0], threads=pl[2])
        k15_levels[m] = lv
        m //= 2
    whole = sum(v["ms"] for m, v in k15_levels.items() if m <= 64)
    whole_dev = sum(v["device_us"] for m, v in k15_levels.items()
                    if m <= 64) / 1e3
    record["rbgs_relax_alpha"]["levels"] = k15_levels
    record["rbgs_relax_alpha"].update(whole_levels_ms=whole,
                                      whole_levels_device_ms=whole_dev)
    print("  K15 per level of a twophase correction (float32, cell dia, 8 "
          "sweeps, 24 from zero at 4^2, + u at the top; ms at 256 / 512 "
          "threads, the plan's device us and host us per launch, plain "
          "ms, bound ms, the plan): " + ", ".join(
              f"{m}: {v['ms_256']:.4f} / {v['ms_512']:.4f} "
              f"({v['device_us']:.2f} us, {v['host_us']:.2f} us, "
              f"{v['plain_ms']:.4f}, {v['bound_ms']:.4f}, "
              f"{v['tile']}x{v['threads']})" for m, v in k15_levels.items())
          + f"; the whole levels 64^2..4^2 {whole:.4f} ms per correction "
          f"back to back, {whole_dev:.4f} ms of device time")
    # K13 at every level of a lid3d projection's correction (4 sweeps at
    # omega 1.5, Neumann, the coarser level's correction prolonged in the
    # kernel, + u at 128^3) at the plan's launch and at other threads,
    # block counts and bricks: CUDA events ms (back to back: the smaller
    # levels read the host's time per call), device us and host us per
    # launch (profiled); the plain version's ms and the bound beside
    k13_levels = {}
    cands = {"default": {}, "t256": dict(threads=256),
             "b132": dict(blocks=132),
             "t256_brick2x4": dict(threads=256, brick=(2, 4)),
             "brick8x8": dict(brick=(8, 8)), "brick8x16": dict(brick=(8, 16))}
    for m in (32, 64, 128):
        cl, rl = rnd(f32, m // 2, m // 2, m // 2), rnd(f32, m, m, m)
        al = rnd(f32, m, m, m) if m == n3 else None
        kwl = dict(nsweeps=4, h2=1.0 / m ** 2, signs=(1.0,) * 6, omega=1.5,
                   coarse=cl, add=al)
        lv = {}
        for key, extra in cands.items():
            fn = lambda: rbgs3d.rbgs_relax_3d(None, rl, 0.0, **extra, **kwl)
            host, dev_us = host_device_us(fn, calls=200)
            lv[key] = {"ms": cuda_ms(fn), "device_us": dev_us,
                       "host_us": host}
        lv.update(plan=" ".join(map(str, rbgs3d.plan())),
                  plain_ms=cuda_ms(lambda: rbgs3d.rbgs_relax_3d_plain(
                      None, rl, 0.0, **kwl)),
                  bound_ms=bound(nbytes(cl, rl, al), rl,
                                 k13_flops(m, 4, 1.5, True,
                                           al is not None))[0])
        k13_levels[m] = lv
    record["rbgs_relax_3d"]["levels"] = k13_levels
    print("  K13 per level of a lid3d correction (float32, 4 sweeps, omega "
          "1.5, coarse prolonged in the kernel, + u at 128^3; per launch "
          "shape ms / device us / host us per launch; the plan (blocks, "
          "threads, brick); plain ms; bound ms): " + "; ".join(
              f"{m}: " + ", ".join(
                  f"{k} {v['ms']:.4f} / {v['device_us']:.2f} / "
                  f"{v['host_us']:.2f}" for k, v in lv.items()
                  if isinstance(v, dict))
              + f"; plan {lv['plan']}; plain {lv['plain_ms']:.4f}; bound "
              f"{lv['bound_ms']:.4f}" for m, lv in k13_levels.items()))
    # K1 per tile height at 2048^2, device us per launch (profiled)
    k1_rows = {rows: host_device_us(lambda rows=rows: rbgs.residual_restrict(
                   u, rhs, 0.0, sub, tile_rows=rows, h2=h2, signs=signs,
                   offs=offs), calls=200)[1] for rows in rbgs.RR_ROWS}
    record["residual_restrict"]["device_us_rows"] = k1_rows
    # device us per launch (profiled) of the single-launch kernels that
    # the event times above leave host-bound, at the same inputs: K4, K5,
    # K9, K11, K17 and K12's block kernel; the main path's tails in one
    # block launch and as their three K3 launches (per call)
    dev_us = {k: host_device_us(timings[k][0], calls=200)[1]
              for k in ("divergence_mac", "correct_project",
                        "correct_project|without_cells", "interp_faces",
                        "residual", "prolong_relax_correct",
                        "prolong_relax_correct|without_cells",
                        "coarse_block")}
    # K12's block with its coarsest or its upper sweeps, or both, left
    # out: where its time goes
    # (the timings' lambdas read kw and the like when called: no loop
    # here rebinds them)
    for part, kwz in (("no_coarsest", dict(coarsest=0)),
                      ("no_sweeps", dict(nsweeps=0)),
                      ("bare", dict(coarsest=0, nsweeps=0))):
        dev_us[f"coarse_block|{part}"] = host_device_us(
            lambda kwz=kwz: k12_block(**kwz), calls=200)[1]
    for name, args in tails.items():
        dev_us[f"coarse_block|{name}_tail"] = host_device_us(
            lambda args=args: tail_kernel(*args), calls=200)[1]
        dev_us[f"coarse_block|{name}_k3"] = CASCADE_TAIL * host_device_us(
            lambda args=args: k3_tail(*args), calls=200)[1]
    for k, v in dev_us.items():
        name, _, variant = k.partition("|")
        record[name]["device_us" + (f"_{variant}" if variant else "")] = v
    record["coarse_block"]["plan"] = "x".join(map(str, rbgs.CB_WARPS))
    print("  device us per call (profiled, float32): " + ", ".join(
        f"{k} {v:.2f}" for k, v in dev_us.items()))
    print(f"  K1 at {n}^2 per tile height (float32; device us per launch, "
          "profiled): " + ", ".join(f"{r}x128 {v:.2f}"
                                    for r, v in k1_rows.items()))
    # K10 at 2048^2 per tile and threads (the "relax" diffusion's 4
    # sweeps), in turns
    k10_tiles = {}
    for t, th in combos + combos[::-1]:
        key = f"{t}x{th}"
        v = cuda_ms(lambda: rbgs.rbgs_relax(u, rhs, dia, tile=t, threads=th,
                                            **kw10))
        k10_tiles[key] = min(v, k10_tiles.get(key, v))
    plan10 = rbgs._plan("rbgs_relax", u, 4, None, None, 64)
    record["rbgs_relax"]["tiles"] = k10_tiles
    record["rbgs_relax"]["plan"] = f"{plan10[0]}x{plan10[2]}"
    print(f"  K10 per tile x threads at {n}^2 (float32, 4 sweeps; ms; the "
          f"plan {plan10[0]}x{plan10[2]}): " + ", ".join(
              f"{k} {v:.4f}" for k, v in k10_tiles.items()))
    # K3 at every level of the main path's cycle with the plan's tiles:
    # 5 sweeps at omega 1.5 from the prolonged correction (+ u at 2048^2),
    # 40 from zero at 16^2; each level's bound beside its time
    k3_levels = {}
    for m in (2048, 1024, 512, 256, 128, 64, 32, 16):
        cl = None if m == 16 else rnd(f32, m // 2, m // 2)
        rl = rnd(f32, m, m)
        ul = rnd(f32, m, m) if m == n else None
        nsw = 40 if m == 16 else 5
        kwl = dict(nsweeps=nsw, h2=1.0 / m ** 2, signs=signs, omega=1.5)
        t = cuda_ms(lambda: rbgs.prolong_relax(cl, rl, 0.0, ul, **kwl))
        pt = cuda_ms(lambda: rbgs.prolong_relax_plain(cl, rl, 0.0, ul,
                                                      **kwl), iters=3)
        tile = rbgs._prolong_plan(rl, nsw, None, 64)[0]
        bms, _ = bound(nbytes(cl, rl, ul), rl, cycle_flops(m, nsw, 1.5))
        k3_levels[m] = {"ms": t, "plain_ms": pt, "bound_ms": bms,
                        "tile": tile}
    record["prolong_relax"]["levels"] = k3_levels
    print("  K3 per level of the main path's cycle (float32, omega 1.5, 5 "
          "sweeps, 40 from zero at 16^2; ms, plain ms, bound, tile): " +
          ", ".join(f"{m}: {v['ms']:.4f} ({v['plain_ms']:.4f}, "
                    f"{v['bound_ms']:.4f}, {v['tile']})"
                    for m, v in k3_levels.items()))
    # K7 (rhs mode, as on the main path), K14 (u) and K6 at every tile
    # plan, in turns (plans forward, then backward; the lower time)
    tile_ms = {}
    for tile in list(bcg.TILES) + list(reversed(bcg.TILES)):
        key = f"{tile[0]}x{tile[1]}"
        ts = {"advect2d_pair": cuda_ms(lambda: bcg.advect2d_pair(
                  U, V, ufx, ufy, dt, grid, u_bcs, tile=tile, **kw7)),
              "advect2d": cuda_ms(lambda: bcg.advect2d(
                  U, 0, ufx, ufy, dt, grid, u_bcs[0], tile=tile,
                  **k14_kw[0])),
              "predict_xy": cuda_ms(lambda: predict.predict_xy(
                  U, V, dt, grid, u_bcs, tile=tile))}
        tile_ms[key] = {k: min(v, tile_ms.get(key, {}).get(k, v))
                        for k, v in ts.items()}
    for k in ("advect2d_pair", "advect2d", "predict_xy"):
        record[k]["tiles"] = {t: v[k] for t, v in tile_ms.items()}
        record[k]["tile"] = "x".join(map(str, bcg.tile_plan()))
    print(f"  K7, K14 and K6 per tile plan (float32, {n}^2; ms; the plan "
          f"{record['predict_xy']['tile']}): " + ", ".join(
              f"{t} K7 {v['advect2d_pair']:.4f} K14 {v['advect2d']:.4f} "
              f"K6 {v['predict_xy']:.4f}" for t, v in tile_ms.items()))
    # the host's time per call and the card's per launch: restrict2 (one
    # pyramid level) and avg_pool2d at 512^2, and the cascade's pyramid
    hd = {"restrict2": host_device_us(lambda: rbgs.restrict2(r512)),
          "avg_pool2d": host_device_us(lambda: F.avg_pool2d(r512_4d, 2)),
          "restrict_pyramid": host_device_us(
              lambda: rbgs.restrict_pyramid(r512, 5))}
    for k, (host_us, dev_us) in hd.items():
        record["restrict_pyramid"].update(
            {f"host_us_{k}": host_us, f"device_us_{k}": dev_us})
    print("  host us per call (1000 calls, no sync) and device us per "
          "launch (profiled), 512^2: " + ", ".join(
              f"{k} {h:.2f} / {d:.2f}" for k, (h, d) in hd.items()))
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
                 if key in ("ms", "plain_ms", "bound_ms")
                 or key == "library_ms" and v is not None})
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


# device kernels of the torch ops that the 2D alpha correction's
# prolongation (rbgs.prolong_plain) ran between K15 launches, by a
# substring of their names: roll, where, stack (a cat), the 0.75/0.25
# products and sums, the edge masks' arange and ==
PROLONG_OPS = ("roll", "where", "CatArray", "MulFunctor", "CUDAFunctor_add",
               "arange", "CompareEqFunctor")


def phase_profile(s, step_s, card, steps=PROFILE_STEPS, watch=(),
                  kinds=None, shares=(), spans=(), host=True):
    """torch.profiler over ``steps`` steps of the running simulation:
    device time by kernel, the port's kernels against the plain torch
    ops, and the device's busy share of an unprofiled step; the device
    ops per step whose kernel names hold each substring of ``watch``
    (also into the dict ``kinds`` when given), and the share of the
    device time of the kernels whose names hold each of ``shares``;
    for each record_function span named in ``spans``, the device time
    of the kernels launched inside it (the span's CPU event, children
    included) and its extent on the card, per step.  ``host=False``
    records the card's activity only: the profiler's host events of a
    step of ~10^5 ops took 30-100 s to process (the AMR routes), and no
    number here but a span's reads them.  Returns the device ops per
    step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host
                                      else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        s.run(max_steps=steps)
        torch.cuda.synchronize()
    rows = []
    inside, extent = {}, {}
    for evt in prof.key_averages():
        if evt.key in spans:
            # a span: on the host its kernels' device time (children
            # included), on the card its annotation's extent
            if evt.device_type == DeviceType.CUDA:
                us = getattr(evt, "device_time_total", None)
                extent[evt.key] = evt.cuda_time_total if us is None else us
            else:
                us = getattr(evt, "device_time_total", None)
                inside[evt.key] = evt.cuda_time_total if us is None else us
            continue
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
    for w in shares:
        us = sum(r[0] for r in rows if w in r[2])
        print(f"  {w}: {us / 1e3 / steps:.3f} ms/step of device time, "
              f"{100 * us / total:.1f}%")
    for w in spans:
        us, ext = inside.get(w, 0.0), extent.get(w, 0.0)
        print(f"  span {w}: {us / 1e3 / steps:.3f} ms/step of device time "
              f"({100 * us / total:.1f}%), {ext / 1e3 / steps:.3f} ms/step "
              f"of extent on {card}")
    per_kind = {w: sum(r[1] for r in rows if w in r[2]) / steps
                for w in watch}
    if watch:
        print("  device ops per step by kind: " + ", ".join(
            f"{w} {v:.1f}" for w, v in per_kind.items()))
    if kinds is not None:
        kinds.update(per_kind)
    return launches / steps


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
    discretisation error): K11, one restrict_pyramid per cycle, the dense
    64^2 solve and prolong + K10 per level; launches gated, held to the
    plain route.
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
    want.update(residual=st.niter + 1, restrict_pyramid=st.niter,
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
          f"launches {counts['residual']} K11, "
          f"{counts['restrict_pyramid']} restrict_pyramid, "
          f"{counts['rbgs_relax']} K10")
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
    K13_LEVELS, each one launch with the coarser level's correction
    prolonged in the kernel, no 2D kernel; the profile's K13 kernels per
    step on the card too); the same steps through the plain versions
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
    # one cycle per solve: 5 solves a step and the initial projection
    want = want_k13(counts, K13_PER_STEP // K13_LEVELS * LID3D_STEPS + 1)
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
    kinds = {}
    ops = phase_profile(s, step, card, LID3D_PROFILE_STEPS,
                        watch=PROLONG_KINDS + ("rbgs3d_",), kinds=kinds)
    print(f"  lid3d: {ops:.1f} device ops per step; K13 kernels "
          f"{kinds['rbgs3d_']:.1f} per step on the card (want "
          f"{K13_PER_STEP}); the torch prolongation's kinds per step: "
          + ", ".join(f"{k} {kinds[k]:.1f}" for k in PROLONG_KINDS))
    if kinds["rbgs3d_"] != K13_PER_STEP:
        raise AssertionError(f"lid3d: {kinds['rbgs3d_']} K13 kernels per "
                             f"step on the card, want {K13_PER_STEP}")
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
    cycle K15 at each of the K15_LEVELS levels, all but the coarsest
    with the prolongation folded in, and one restrict_pyramid of the
    levels below the top; per step K6 once, K4 once per
    projection, K14 once per
    component, K9 once; no K1-K3, K5, K7, K8, K10-K13, K16, K17 (the
    alpha solves and the generic correction take none)."""
    w = {k: 0 for k in want_launches("pair", 0)}
    cycles = sum(niters)
    w.update(predict_xy=steps, divergence_mac=2 * steps + 1,
             interp_faces=steps + 1, advect2d=2 * steps,
             rbgs_relax_alpha=K15_LEVELS * cycles,
             restrict_pyramid=cycles)
    w["rbgs_relax_alpha.prolong"] = (K15_LEVELS - 1) * cycles
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
          f"launches = {K15_LEVELS} x sum(niter) {sum(niters)}, "
          f"{counts['rbgs_relax_alpha.prolong']} of them with the "
          f"prolongation folded in = {K15_LEVELS - 1} x {sum(niters)}")
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
    step = timed_windows("twophase", s, TWOPHASE_TIMED_STEPS, card, n * n)
    phase_profile(s, step, card, TWOPHASE_PROFILE_STEPS, watch=PROLONG_OPS)
    return counts


def bubble_mu(*xyz, t=0.0, T1=None):
    """The dynamic viscosity of the filtered liquid fraction T1: 10 in the
    liquid, 1 in the bubble (MU(T1), test/capwave/air-water's form), in
    2D and 3D."""
    return 10.0 * T1 + 1.0 * (1.0 - T1)


def bubble_cfg(level=LEVEL_BUBBLE):
    """Hysing test case 1 in the box [0, 1] x [0, 2] at 2^level cells per
    unit: one VOF tracer T (1 in the liquid), density ("T", 1000, 100, 1),
    nu 0 and the variable viscosity bubble_mu of the once-filtered T,
    gravity (None, -0.98) and tension 24.5 as face sources, no-slip bottom
    and top walls, free-slip side walls; the default adaptive projections
    and diffusion on the TPU's floored schedule (utils/convert), as
    twophase_cfg."""
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.models import ns
    from gerris_tpu_torch.solvers.poisson import MultilevelParams
    from gerris_tpu_torch.utils.convert import params_from_jax
    d0, nn = bc.Dirichlet(0.0), bc.Neumann()
    proj = MultilevelParams(tolerance=1e-3, nitermax=100, nrelax=8,
                            coarsest_relax=16)
    return ns.NSConfig(
        grid=Grid(level=level, dim=2, origin=(0.0, 0.0), extents=(1, 2)),
        u_bcs=(bc.FieldBC(((d0, d0), (d0, d0))),
               bc.FieldBC(((nn, nn), (d0, d0)))),
        nu=0.0, beta=1.0, vof_tracers=(("T", bc.default_scalar_bc(2)),),
        tension=(("T", 24.5),), density=("T", 1000.0, 100.0, 1),
        body_force=(None, -0.98), nu_var=bubble_mu,
        nu_var_fields=(("T1", "T", 1),), projection=proj,
        approx_projection=proj, diffusion_params=params_from_jax(None, 2))


def bubble_sim(dev, level=LEVEL_BUBBLE, events=(), end=math.inf,
               dtype=None):
    """The bubble on the card in ``dtype`` (float32 by default), at rest,
    not yet run (to ``end`` when it is run to its end)."""
    import torch
    from gerris_tpu_torch.models.simulation import Simulation, Time
    from gerris_tpu_torch.physics import vof
    dtype = dtype or torch.float32
    cfg = bubble_cfg(level)
    T0 = vof.fraction_from_levelset(
        cfg.grid, lambda x, y: torch.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2)
        - 0.25, device=dev, dtype=dtype)
    return Simulation(cfg, time=Time(end=end), device=dev, dtype=dtype,
                      events=list(events)).init(T=T0)


def phase_bubble(dev, card):
    """init + BUBBLE_STEPS steps of the bubble at 1024 x 2048 through the
    kernels, the counts set to 0 just before and gated just after from
    every solve's recorded cycle count (the twophase route's launches:
    want_twophase); finite values; the first
    BUBBLE_CHECK_STEPS steps against the same steps through the plain
    versions on the card, in float32 and float64 (check_bubble_plain);
    five timed windows and a profile.  Returns (launch counts, the profile's device
    ops per step)."""
    import torch
    n0, n1 = bubble_cfg().grid.shape
    print(f"phase 3, bubble: Hysing test case 1, {n0} x {n1}, float32, "
          f"init + {BUBBLE_STEPS} steps")
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording_solves() as log:
        s = bubble_sim(dev)
        vol0 = float(s.state["T"].double().sum())
        s.run(max_steps=BUBBLE_CHECK_STEPS)
        early = {k: v.clone() for k, v in s.state.items()}
        s.run(max_steps=BUBBLE_STEPS - BUBBLE_CHECK_STEPS)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    counts = launch_counts()
    niters = [x[1] for x in log]
    print(f"  bubble, init + {BUBBLE_STEPS} steps: {t_run:.3f} s; "
          f"{len(niters)} solves, niter {niters}; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    if len(niters) != 4 * BUBBLE_STEPS + 1:
        raise AssertionError(f"bubble: {len(niters)} solves")
    for k, w in want_twophase(BUBBLE_STEPS, niters).items():
        if counts[k] != w:
            raise AssertionError(f"bubble: {k}: {counts[k]} launches, "
                                 f"want {w}")
    print(f"  bubble: rbgs_relax_alpha {counts['rbgs_relax_alpha']} "
          f"launches = {K15_LEVELS} x sum(niter) {sum(niters)}, "
          f"{counts['rbgs_relax_alpha.prolong']} of them with the "
          f"prolongation folded in, {counts['restrict_pyramid']} "
          "restrict_pyramid")
    for k, v in s.state.items():
        if v.shape != (n0, n1) or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"bubble {k}: not finite or wrong shape")
    # T's volume is printed, not gated: the VOF update sets fractions
    # within FULL_TOL of 0 or 1 to 0 or 1 (physics/vof.py:sweep_update),
    # which a rising bubble's interface meets, unlike twophase's nearly
    # resting one
    vol = float(s.state["T"].double().sum())
    print(f"  bubble: T's volume rel change {abs(vol - vol0) / vol0:.3e}; "
          f"t {s.time.t:.6e} after {s.time.i} steps, dt {s.dt:.6e}; "
          f"max|V| {float(s.state['V'].abs().max()):.6e}")
    check_bubble_plain(dev, early)
    del early
    step = timed_windows("bubble", s, BUBBLE_TIMED_STEPS, card, n0 * n1)
    ops = phase_profile(s, step, card, BUBBLE_PROFILE_STEPS)
    return counts, ops


def check_bubble_plain(dev, early):
    """The bubble's first BUBBLE_CHECK_STEPS steps against the plain
    versions on the card (check_against_plain).  From rest the bubble's
    U and V after 5 steps (~1e-5 at dt 8e-5) are at float32's floor: the
    hydrostatic pressure (~2000) in float32 moves the velocities by ~1e-7
    a step, and the plain float32 run itself differs from the plain
    float64 run by more than ADAPTIVE_RTOL there, hence the float32 U
    and V gate against that floor."""
    check_against_plain("bubble", lambda dtype: bubble_sim(dev, dtype=dtype),
                        BUBBLE_CHECK_STEPS, early, BUBBLE_F64_RTOL)


def phase_bubble_gate(dev, card):
    """The physics gate: the bubble at level 6 (64 x 128) in float32 to t
    = 3, the mean rise velocity and the centroid of the gas recorded each
    step on the card and read once at the end; the maximum rise velocity
    within HYSING_VMAX_RTOL of Hysing's and within JAX_RTOL of
    gerris_tpu's, and the centroid at t = 3 within HYSING_YC_RTOL and
    JAX_RTOL."""
    import torch
    from gerris_tpu_torch.events.events import Event
    samples = []
    yc = None

    def record(sim):
        nonlocal yc
        if yc is None:
            from gerris_tpu_torch.models import ns
            yc = ns.cell_centers(sim.cfg.grid, dev, torch.float32)[1]
        g = 1.0 - sim.state["T"]
        m = g.sum()
        samples.append(torch.stack([
            torch.tensor(sim.time.t, device=dev), (g * sim.state["V"]).sum()
            / m, (g * yc).sum() / m]))

    t0 = time.perf_counter()
    s = bubble_sim(dev, BUBBLE_GATE_LEVEL,
                   events=[Event(action=record, istep=1)], end=BUBBLE_GATE_T)
    s.run()
    rec = torch.stack(samples).double().cpu().numpy()
    t_run = time.perf_counter() - t0
    k = int(np.argmax(rec[:, 1]))
    vmax, t_vmax, yc3, t_end = rec[k, 1], rec[k, 0], rec[-1, 2], rec[-1, 0]
    print(f"phase 4, bubble gate: level {BUBBLE_GATE_LEVEL} "
          f"({s.cfg.grid.shape[0]} x {s.cfg.grid.shape[1]}), float32, to t "
          f"= {t_end:.6f} in {s.time.i} steps, {t_run:.1f} s on {card}")
    checks = (("maximum rise velocity", vmax, HYSING_VMAX, HYSING_VMAX_RTOL,
               JAX_VMAX), ("centroid at t = 3", yc3, HYSING_YC,
                           HYSING_YC_RTOL, JAX_YC))
    for what, got, ref, rtol, jax_ref in checks:
        e_ref, e_jax = abs(got - ref) / ref, abs(got - jax_ref) / jax_ref
        print(f"  bubble gate, {what}: {got:.6f}"
              f"{f' at t = {t_vmax:.4f}' if 'velocity' in what else ''}; "
              f"Hysing {ref} (rel {e_ref:.4f}, bound {rtol}), gerris_tpu "
              f"level {BUBBLE_GATE_LEVEL} f64 {jax_ref:.6f} (rel "
              f"{e_jax:.4f}, bound {JAX_RTOL})")
        if not (e_ref <= rtol and e_jax <= JAX_RTOL):
            raise AssertionError(f"bubble gate: {what} {got:.6f}")
    if abs(t_end - BUBBLE_GATE_T) > 1e-6 or not np.isfinite(rec).all():
        raise AssertionError(f"bubble gate: ended at t = {t_end}")


def check_floor(name, floors):
    """Each field's ``floors`` entry, the plain float32 run's distance from
    the plain float64 run after the route's check steps, within the
    route's FLOOR_BOUNDS: a fault that the kernels and their plain
    versions share (the closed-form plane volume put droplet3d's f32
    velocities 1.23 off f64) fails here, where the kernels-vs-plain
    gates cannot see it."""
    bounds = FLOOR_BOUNDS[name]
    for k, v in floors.items():
        if not v <= bounds[k]:
            raise AssertionError(f"{name} {k}: the plain float32 run "
                                 f"{v:.3e} from the plain float64 run, "
                                 f"bound {bounds[k]:.1e}")


# check_against_plain's deferred checks (a list while main's phase 3 runs)
DEFERRED_PLAIN = None


def check_against_plain(name, make, steps, early, f64_rtol,
                        keys=("U", "V", "T", "P"), norm=None,
                        floor_rule=("U", "V", "W"), derived=None,
                        defer=True):
    """The first ``steps`` steps of ``name`` against the plain versions on
    the card: the float32 kernels' state ``early`` against the float32
    and float64 plain runs, and the same steps through the kernels in
    float64 against the plain float64 run (``make(dtype)`` builds the
    simulation at rest).  Gates: float64 kernels vs plain within
    ``f64_rtol`` on U, V, T and mean-free P (same arithmetic, no floor);
    float32 kernels vs plain within ADAPTIVE_RTOL on T and mean-free P;
    on U and V (the fields of ``floor_rule``) the float32 kernels no
    further from the float64 plain run than twice the plain float32 run
    is (or ADAPTIVE_RTOL, the larger): as accurate as float32 allows;
    and that floor, the plain
    float32 run's distance from the plain float64 run, within the
    route's FLOOR_BOUNDS on every field (check_floor).  ``keys``: the
    fields compared (W too in 3D); ``norm``: {field: other field} for a
    field whose distances are taken relative to the other's magnitude
    (the axisymmetric pipe's V and P, which are 0 up to the solves'
    tolerance, relative to U); ``derived``: {name: f(state)} for a key
    that is a function of the state's fields (stretch's P_y).  Returns
    the three runs' states.  While DEFERRED_PLAIN is a list (main's
    phase 3) the check is appended to it and returns None unless
    ``defer`` is False: main runs them once the gate jobs have started,
    so that no timed window shares the card with the jobs and the
    untimed plain runs overlap them."""
    import torch
    if defer and DEFERRED_PLAIN is not None:
        DEFERRED_PLAIN.append(lambda: check_against_plain(
            name, make, steps, early, f64_rtol, keys, norm, floor_rule,
            derived, defer=False))
        return None
    runs = {}
    for run, dtype, plain in (("plain32", torch.float32, True),
                              ("plain64", torch.float64, True),
                              ("kernels64", torch.float64, False)):
        ctx = plain_versions() if plain else contextlib.nullcontext()
        before = launch_counts()
        with ctx, recording_solves() as log:
            runs[run] = make(dtype).run(max_steps=steps).state
        print(f"  {name}, {run}: niter {[x[1] for x in log]}")
        if plain and launch_counts() != before:
            raise AssertionError("the plain reference run launched kernels")
    floors = {}
    norm = norm or {}
    derived = derived or {}
    for k in keys:
        def rel(a, b):
            if k in derived:
                a, b = derived[k](a), derived[k](b)
            else:
                a, b = a[k], b[k]
            a, b = a.double(), b.double()
            if k == "P":
                a, b = a - a.mean(), b - b.mean()
            if k in norm:
                return float((a - b).abs().max()) / float(
                    runs["plain64"][norm[k]].double().abs().max())
            return rel_err(a, b)
        e32 = rel(early, runs["plain32"])
        floor = floors[k] = rel(runs["plain32"], runs["plain64"])
        e32_64 = rel(early, runs["plain64"])
        e64 = rel(runs["kernels64"], runs["plain64"])
        print(f"  {name} after {steps} steps, {k}"
              f"{' (mean-free)' if k == 'P' else ''}"
              f"{f' (relative to max|{norm[k]}|)' if k in norm else ''}: "
              "kernels vs plain "
              f"float32 {e32:.3e}, float64 {e64:.3e} (bound "
              f"{f64_rtol:.0e}); against the plain float64 run: "
              f"float32 kernels {e32_64:.3e}, float32 plain {floor:.3e}")
        if not e64 <= f64_rtol:
            raise AssertionError(f"{name} {k}: float64 kernels vs plain "
                                 f"{e64:.3e}")
        if k not in floor_rule and not e32 <= ADAPTIVE_RTOL:
            raise AssertionError(f"{name} {k}: kernels vs plain {e32:.3e}")
        if k in floor_rule and not e32_64 <= max(2 * floor, ADAPTIVE_RTOL):
            raise AssertionError(f"{name} {k}: float32 kernels {e32_64:.3e}"
                                 f" from float64, plain {floor:.3e}")
    print(f"  {name}: the plain float32 run's distance from float64 "
          "(bound): " + ", ".join(f"{k} {v:.3e} ({FLOOR_BOUNDS[name][k]:.1e})"
                                  for k, v in floors.items()))
    check_floor(name, floors)
    return runs


def timed_windows(name, s, steps, card, cells):
    """TIMED_WINDOWS windows of ``steps`` steps of the running ``s``, each
    closed by a synchronize: the median ms/step, the host syncs per step
    (the solves' condition reads and the CFL dt's one) and the last
    window's niter per solve.  Returns the median step in seconds."""
    import torch
    walls, syncs = [], []
    for _ in range(TIMED_WINDOWS):
        with recording_solves() as log:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.run(max_steps=steps)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        syncs.append(sum(x[3] for x in log) / steps + 1)
        niters = [x[1] for x in log]
    step = float(np.median(walls)) / steps
    print(f"  {name} step, timed windows of {steps} steps: "
          f"{' '.join(f'{w:.4f}' for w in walls)} s; median "
          f"{step * 1e3:.3f} ms/step, {cells / step / 1e6:.2f}M "
          f"cell-updates/s; host syncs per step "
          f"{' '.join(f'{x:.1f}' for x in syncs)}; niter per solve in the "
          f"last window {niters} on {card}")
    return step


def droplet_phi(x, y):
    """test/spurious's droplet of radius 0.4 at (-0.5, 0.5)."""
    return 0.16 - ((x + 0.5) ** 2 + (y - 0.5) ** 2)


def spurious_cfg(level, kind="tension"):
    """test/spurious (tests/test_spurious.py:33-50) at 2^level cells per
    side, with the well-balanced ("tension") or the CSS ("tension_css")
    surface tension, sigma 1."""
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.models import ns
    from gerris_tpu_torch.solvers.advection import AdvectionParams
    from gerris_tpu_torch.solvers.poisson import MultilevelParams
    proj = MultilevelParams(tolerance=1e-6, nitermax=100)
    return ns.NSConfig(
        grid=Grid(level=level), u_bcs=(bc.velocity_bc(0), bc.velocity_bc(1)),
        nu=math.sqrt(0.8 / SPURIOUS_LA), beta=1.0,
        advection=AdvectionParams(scheme="none"),
        vof_tracers=(("T", bc.default_scalar_bc(2)),), projection=proj,
        approx_projection=proj,
        diffusion_params=MultilevelParams(tolerance=1e-6, nitermax=20),
        **{kind: (("T", 1.0),)})


def spurious_sim(dev, kind, level=None, dtype=None, end=math.inf,
                 events=()):
    """The static droplet at rest on the card at ``level`` (LEVEL_SPURIOUS
    by default) in ``dtype`` (float32 by default), dt from Simulation
    (the CFL and the capillary bound), not yet run."""
    import torch
    from gerris_tpu_torch.models.simulation import Simulation, Time
    from gerris_tpu_torch.physics import vof
    dtype = dtype or torch.float32
    cfg = spurious_cfg(level or LEVEL_SPURIOUS, kind)
    T0 = vof.fraction_from_levelset(cfg.grid, droplet_phi, device=dev,
                                    dtype=dtype)
    return Simulation(cfg, time=Time(end=end), device=dev, dtype=dtype,
                      events=list(events)).init(T=T0)


def add_solves(w, solves, prolongs, k12=True):
    """Add to ``w`` the launches of the 2D adaptive solves recorded as
    (solver, niter, fixed count or not): per multigrid solve one K11 for
    r0, one per cycle (and one more after a fixed count's cycles), and
    per cycle the correction's restrict_pyramid, ``prolongs`` K3 and,
    with ``k12``, K12 at 512^2 (its pyramid, block and K12_LEVELS K3);
    per "relax" solve K11 twice and K10 once."""
    for solver, niter, fixed in solves:
        if solver == "relax":
            w["residual"] += 2
            w["rbgs_relax"] += 1
            continue
        w["residual"] += 1 + niter + int(fixed)
        if k12:
            w["coarse_vcycle"] += niter
            w["coarse_block"] += niter
            w["coarse_vcycle.restrict_pyramid"] += niter
            w["coarse_vcycle.prolong_relax"] += K12_LEVELS * niter
        w["restrict_pyramid"] += niter
        w["prolong_relax"] += prolongs * niter
    return w


def want_spurious(steps, solves, css):
    """Launches of init + ``steps`` static-droplet steps at 1024^2: K4
    once per projection; K5 in every projection with CSS, and with the
    well-balanced tension (face sources: the generic correction) only in
    the initial projection; K9 once a step and at init; the adaptive
    solves' K11, K12, pyramid and K3 (add_solves); no K6 or K14 (scheme
    "none" takes the generic route)."""
    w = {k: 0 for k in want_launches("pair", 0)}
    w.update(divergence_mac=2 * steps + 1,
             correct_project=2 * steps + 1 if css else 1,
             interp_faces=steps + 1)
    return add_solves(w, solves, SPURIOUS_PROLONGS)


def phase_spurious(dev, card):
    """init + SPURIOUS_STEPS steps of the static droplet at 1024^2 in
    float32 with each tension, through the kernels, the counts set to 0
    just before and gated just after from every solve's recorded cycle
    count; finite values; T's volume; the first SPURIOUS_CHECK_STEPS
    steps against the plain versions (check_against_plain, float64 to
    1e-9); five timed windows and a profile.  Returns {kind: (launch
    counts, device ops per step)}."""
    import torch
    n = 1 << LEVEL_SPURIOUS
    out = {}
    for kind in SPURIOUS_KINDS:
        css = kind == "tension_css"
        name = "spurious" + ("_css" if css else "")
        print(f"phase 3, {name}: the static droplet (test/spurious), {n}^2,"
              f" {'CSS' if css else 'well-balanced'} tension, scheme none, "
              f"float32, init + {SPURIOUS_STEPS} steps")
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recording_solves() as log:
            s = spurious_sim(dev, kind)
            vol0 = float(s.state["T"].double().sum())
            s.run(max_steps=SPURIOUS_CHECK_STEPS)
            early = {k: v.clone() for k, v in s.state.items()}
            s.run(max_steps=SPURIOUS_STEPS - SPURIOUS_CHECK_STEPS)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        counts = launch_counts()
        niters = [x[1] for x in log]
        capped = sum(x[1] == (20 if i % 4 in (1, 2) else 100)
                     for i, x in enumerate(log[1:]))
        print(f"  {name}, init + {SPURIOUS_STEPS} steps: {t_run:.3f} s; "
              f"{len(niters)} solves, niter {niters} ({capped} of the "
              f"steps' solves stopped at nitermax, not at 1e-6); host "
              f"syncs {sum(x[3] for x in log)}; launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        if len(niters) != 4 * SPURIOUS_STEPS + 1:
            raise AssertionError(f"{name}: {len(niters)} solves")
        want = want_spurious(SPURIOUS_STEPS, [x[:3] for x in log], css)
        for k, w in want.items():
            if counts[k] != w:
                raise AssertionError(f"{name}: {k}: {counts[k]} launches, "
                                     f"want {w}")
        for k, v in s.state.items():
            if v.shape != (n, n) or not bool(torch.isfinite(v).all()):
                raise AssertionError(f"{name} {k}: not finite or wrong "
                                     "shape")
        vol = float(s.state["T"].double().sum())
        print(f"  {name}: T's volume rel change {abs(vol - vol0) / vol0:.3e}"
              f"; t {s.time.t:.6e} after {s.time.i} steps, dt {s.dt:.6e}; "
              f"max|U| {float(s.state['U'].abs().max()):.6e}")
        # kind bound now: the check runs after the loop (deferred)
        check_against_plain(name, lambda dtype, kind=kind: spurious_sim(
                                dev, kind, dtype=dtype),
                            SPURIOUS_CHECK_STEPS, early, 1e-9)
        del early
        step = timed_windows(name, s, SPURIOUS_TIMED_STEPS, card, n * n)
        ops = phase_profile(s, step, card, SPURIOUS_PROFILE_STEPS)
        out[name] = (counts, ops)
    return out


def phase_spurious_gate(dev, card):
    """The physics gate: the static droplet at level 5 in float64 to t = 1
    on the card with each tension, its shape error (L2 and Linf of T -
    T0) within SPURIOUS_SHAPE_RTOL of the JAX package's at the same level
    and time and max|u| within SPURIOUS_UMAX_FACTOR of it
    (JAX_SPURIOUS), printed beside them; and the well-balanced run
    within the absolute bounds of tests/test_spurious.py:84-90
    (check_spurious_bounds)."""
    import torch
    from gerris_tpu_torch.events.events import Event
    for kind in SPURIOUS_KINDS:
        t0 = time.perf_counter()
        umax_hist = []

        def track(sim):
            umax_hist.append((sim.state["U"] ** 2 + sim.state["V"] ** 2)
                             .sqrt().max())

        s = spurious_sim(dev, kind, SPURIOUS_GATE_LEVEL, torch.float64,
                         end=SPURIOUS_GATE_T,
                         events=[Event(action=track, istep=20)])
        T0 = s.state["T"].clone()
        s.run()
        e = s.state["T"] - T0
        got = dict(shape_l2=float(e.pow(2).mean().sqrt()),
                   shape_linf=float(e.abs().max()),
                   umax=float((s.state["U"] ** 2 + s.state["V"] ** 2)
                              .sqrt().max()))
        if kind == "tension":
            check_spurious_bounds(s, got, torch.stack(umax_hist).tolist())
        ref = JAX_SPURIOUS[kind]
        print(f"phase 4, spurious gate, {kind}: level {SPURIOUS_GATE_LEVEL}"
              f", float64, to t = {s.time.t:.6f} in {s.time.i} steps "
              f"(gerris_tpu {ref['steps']}), "
              f"{time.perf_counter() - t0:.1f} s on {card}")
        for key, what in (("shape_l2", "shape error L2"),
                          ("shape_linf", "shape error Linf"),
                          ("umax", "max|u|")):
            r = got[key] / ref[key]
            if key == "umax":
                bound = f"within x{SPURIOUS_UMAX_FACTOR:g}"
                ok = 1 / SPURIOUS_UMAX_FACTOR <= r <= SPURIOUS_UMAX_FACTOR
            else:
                bound = f"rel {SPURIOUS_SHAPE_RTOL}"
                ok = abs(r - 1.0) <= SPURIOUS_SHAPE_RTOL
            print(f"  spurious gate, {kind}, {what}: {got[key]:.6e}; "
                  f"gerris_tpu level {SPURIOUS_GATE_LEVEL} f64 "
                  f"{ref[key]:.6e} (ratio {r:.6f}, bound {bound})")
            if not ok:
                raise AssertionError(f"spurious gate {kind}: {what} "
                                     f"{got[key]:.6e}")
        if abs(s.time.t - SPURIOUS_GATE_T) > 1e-9:
            raise AssertionError(f"spurious gate: ended at t = {s.time.t}")


def check_spurious_bounds(s, got, umax_hist):
    """The absolute bounds of tests/test_spurious.py:84-90 on the
    well-balanced static droplet ``s`` (its shape errors ``got`` and
    max|u| every 20 steps ``umax_hist``): the shape error L2 and Linf and
    the curvature error Linf over 1/R = 2.5 on the interface cells below
    3x the reference table's, the last sampled max|u| below half the
    largest of the first five samples, and the capillary number max|u|
    nu below SPURIOUS_CA_MAX."""
    import torch
    from gerris_tpu_torch.physics import vof
    T = s.state["T"]
    kap = vof.curvature(T, s.cfg.grid, s.cfg.vof_tracers[0][1])
    ifc = (T > 1e-6) & (T < 1 - 1e-6) & torch.isfinite(kap)
    kinf = float(torch.where(ifc, (kap - 2.5).abs(), 0.0).max()) / 2.5
    ca = umax_hist[-1] * s.cfg.nu
    early = max(umax_hist[:5])
    print(f"  spurious gate, tension, the test's bounds: shape L2 "
          f"{got['shape_l2']:.3e} (< {SPURIOUS_SHAPE_L2_MAX:.3e}), Linf "
          f"{got['shape_linf']:.3e} (< {SPURIOUS_SHAPE_LINF_MAX:.3e}); "
          f"curvature Linf / K {kinf:.3e} (< {SPURIOUS_KAPPA_LINF_MAX:.3e});"
          f" max|u| every 20 steps {len(umax_hist)} samples, last "
          f"{umax_hist[-1]:.3e} (< half the first five's largest, "
          f"{early:.3e}); Ca {ca:.3e} (< {SPURIOUS_CA_MAX:.0e})")
    if not (got["shape_l2"] < SPURIOUS_SHAPE_L2_MAX
            and got["shape_linf"] < SPURIOUS_SHAPE_LINF_MAX
            and kinf < SPURIOUS_KAPPA_LINF_MAX
            and umax_hist[-1] < 0.5 * early and ca < SPURIOUS_CA_MAX):
        raise AssertionError("spurious gate: outside the test's bounds")


def tracer_sim(dev, gradient="centered"):
    """The bench's 2048^2 cavity (lid_cfg, its route) with the tracer C
    (D 1e-3, the default scalar BCs) and ``gradient``, float32, C0 = x +
    0.5, after init."""
    import dataclasses
    import torch
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.models.simulation import Simulation, Time
    from gerris_tpu_torch.solvers.advection import AdvectionParams
    cfg = dataclasses.replace(
        lid_cfg(11), tracers=(("C", bc.default_scalar_bc(2), 1e-3),),
        advection=AdvectionParams(gradient=gradient))
    return Simulation(cfg, time=Time(dtmax=0.8 * cfg.grid.h), device=dev,
                      dtype=torch.float32).init(C=lambda x, y: x + 0.5)


def want_tracer(steps, gradient):
    """Launches of init + ``steps`` steps of tracer_sim.  Centred: the
    main path's (want_launches("pair")), and per step K14 once for C and
    C's diffusion in one fused cycle (K1, K2, K3).  Van Leer (the generic
    route): no K6, K7, K14 or K8; each projection and each diffusion (U,
    V and C) one fused cycle; K4, K5 and K9 as on the main path."""
    solves = 2 * steps + 1
    if gradient == "centered":
        w = want_launches("pair", steps)
        w["advect2d"] += steps
        extra = steps
    else:
        w = {k: 0 for k in want_launches("pair", 0)}
        w.update(divergence_mac=solves, correct_project=solves,
                 interp_faces=steps + 1)
        extra = solves + 3 * steps
    for k, per in (("residual_restrict", 1), ("cascade_prolong_relax", 1),
                   ("prolong_relax", 1), ("cascade.restrict_pyramid", 1),
                   ("cascade.coarse_block", 1),
                   ("cascade.prolong_relax", CASCADE_K3)):
        w[k] += per * extra
    return w


def phase_tracer(dev, card):
    """The tracer on the bench's route (centred: K14 for C beside K7) and
    on the generic route (van Leer), ROUTE_STEPS = TRACER_STEPS steps
    each, gated, and held to the plain versions (MAIN_PATH_RTOL on U, V,
    P and C).  Returns the centred run's launch counts."""
    import torch
    out = {}
    for gradient in ("centered", "van_leer"):
        print(f"phase 3, tracer: {N_MAIN}^2 lid cavity + tracer C, "
              f"{gradient} slopes, float32, init + {TRACER_STEPS} steps")
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = tracer_sim(dev, gradient).run(max_steps=TRACER_STEPS)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        counts = launch_counts()
        print(f"  tracer ({gradient}), init + {TRACER_STEPS} steps: "
              f"{t_run:.3f} s; launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        for k, w in want_tracer(TRACER_STEPS, gradient).items():
            if counts[k] != w:
                raise AssertionError(f"tracer ({gradient}): {k}: {counts[k]}"
                                     f" launches, want {w}")
        for k, v in s.state.items():
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"tracer {k}: not finite")
        with plain_versions():
            ref = tracer_sim(dev, gradient).run(max_steps=TRACER_STEPS)
        if launch_counts() != counts:
            raise AssertionError("the plain reference run launched kernels")
        for k in ("U", "V", "P", "C"):
            rel = rel_err(s.state[k], ref.state[k])
            print(f"  tracer ({gradient}), kernels vs plain after "
                  f"{TRACER_STEPS} steps, {k}: rel {rel:.3e} (bound "
                  f"{MAIN_PATH_RTOL:.0e})")
            if not rel <= MAIN_PATH_RTOL:
                raise AssertionError(f"tracer ({gradient}) {k}: rel "
                                     f"{rel:.3e}")
        out[gradient] = counts
    return out["centered"]


def stiff_system(dev, level):
    """tests/test_poisson.py's stiff system at 2^level cells per side in
    float64 on the card: Dirichlet 0 walls, the 4-decade blobby
    coefficient k (8 x 8 blocks from numpy's default_rng(7)), harmonic
    means on the faces, rhs sin(3 pi x) sin(2 pi y).  Returns (grid,
    fbc, alpha, rhs)."""
    import torch
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.core.grid import Grid
    n = 1 << level
    rng = np.random.default_rng(7)
    k = np.exp(4.0 * np.log(10.0) * rng.random((8, 8)))
    kf = np.kron(k, np.ones((n // 8, n // 8)))
    kf = kf / kf.max()
    alpha = []
    for c in range(2):
        pad = np.pad(kf, [(1, 1) if a == c else (0, 0) for a in range(2)],
                     mode="edge")
        lo = pad[tuple(slice(0, -1) if a == c else slice(None)
                       for a in range(2))]
        hi = pad[tuple(slice(1, None) if a == c else slice(None)
                       for a in range(2))]
        alpha.append(torch.as_tensor(2.0 / (1.0 / lo + 1.0 / hi),
                                     device=dev))
    grid = Grid(level=level)
    x, y = (torch.as_tensor(c, device=dev) for c in grid.centers)
    rhs = (torch.sin(3 * torch.pi * x) * torch.sin(2 * torch.pi * y)
           + torch.zeros(grid.shape, dtype=torch.float64, device=dev))
    return grid, bc.FieldBC.uniform(bc.Dirichlet(0.0), 2), tuple(alpha), rhs


def phase_mgcg(dev, card):
    """mgcg on the stiff system at level LEVEL_MGCG in float64: the
    residual within MGCG_RESIDUAL of max|rhs|, niter at most the
    adaptive multigrid's on the same system, K15's launches gated from
    niter (one correction for z0 and one per iteration, each one K15
    launch per level, the prolongation folded into all but the
    coarsest), held to the plain versions (same niter, 1e-9); then cg at
    level LEVEL_CG to its cap, its residual printed.  Returns mgcg's
    launch counts."""
    import torch
    from gerris_tpu_torch.solvers import poisson
    grid, fbc, alpha, rhs = stiff_system(dev, LEVEL_MGCG)
    u0 = torch.zeros_like(rhs)
    scale = float(rhs.abs().max())
    levels = LEVEL_MGCG - 2 + 1
    runs = {}
    for solver in ("mgcg", "multigrid"):
        params = poisson.MultilevelParams(tolerance=MGCG_TOL, nitermax=60,
                                          solver=solver)
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u, st = poisson.solve(u0, rhs, grid, fbc, params, alpha=alpha)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        r = float(poisson.residual(u, rhs, grid, fbc, alpha=alpha).abs()
                  .max()) / scale
        runs[solver] = (u, st, counts)
        print(f"phase 3, mgcg: the stiff system at {grid.shape[0]}^2, "
              f"float64, {solver}: niter {st.niter}, max|r| / max|rhs| "
              f"{r:.3e}, {wall:.3f} s, host syncs {st.host_syncs}; launches "
              f"{ {k: v for k, v in counts.items() if v} } on {card}")
        if solver == "mgcg" and not r <= MGCG_RESIDUAL:
            raise AssertionError(f"mgcg: residual {r:.3e}")
    u, st, counts = runs["mgcg"]
    if not st.niter <= runs["multigrid"][1].niter:
        raise AssertionError(f"mgcg: niter {st.niter} > multigrid's "
                             f"{runs['multigrid'][1].niter}")
    want = {k: 0 for k in want_launches("pair", 0)}
    want.update(rbgs_relax_alpha=levels * (st.niter + 1),
                restrict_pyramid=st.niter + 1)
    want["rbgs_relax_alpha.prolong"] = (levels - 1) * (st.niter + 1)
    for k, w in want.items():
        if counts[k] != w:
            raise AssertionError(f"mgcg: {k}: {counts[k]} launches, "
                                 f"want {w}")
    params = poisson.MultilevelParams(tolerance=MGCG_TOL, nitermax=60,
                                      solver="mgcg")
    with plain_versions():
        up, sp = poisson.solve(u0, rhs, grid, fbc, params, alpha=alpha)
    rel = rel_err(u, up)
    print(f"  mgcg, kernels vs plain: niter {st.niter} / {sp.niter}, u rel "
          f"{rel:.3e} (bound 1e-9)")
    if sp.niter != st.niter or not rel <= 1e-9:
        raise AssertionError(f"mgcg vs plain: rel {rel:.3e}")
    grid, fbc, alpha, rhs = stiff_system(dev, LEVEL_CG)
    params = poisson.MultilevelParams(tolerance=MGCG_TOL, nitermax=60,
                                      solver="cg")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u, st = poisson.solve(torch.zeros_like(rhs), rhs, grid, fbc, params,
                          alpha=alpha)
    torch.cuda.synchronize()
    r = float(poisson.residual(u, rhs, grid, fbc, alpha=alpha).abs().max())
    print(f"  cg at {grid.shape[0]}^2: niter {st.niter} (cap "
          f"{20 * params.nitermax}), max|r| / max|rhs| "
          f"{r / float(rhs.abs().max()):.3e}, "
          f"{time.perf_counter() - t0:.3f} s, host syncs {st.host_syncs}")
    return counts


def sessile_cfg(level, angle):
    """The sessile drop: T with Contact(angle) on the bottom wall (the
    left wall is the symmetry axis), velocity_bc walls, nu 0.1, tension
    1, unit density, the default adaptive solves."""
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.models import ns
    from gerris_tpu_torch.solvers.poisson import MultilevelParams
    proj = MultilevelParams(tolerance=1e-3, nitermax=100)
    return ns.NSConfig(
        grid=Grid(level=level), u_bcs=(bc.velocity_bc(0), bc.velocity_bc(1)),
        nu=0.1, beta=1.0,
        vof_tracers=(("T", bc.FieldBC.make(2, bottom=bc.Contact(angle))),),
        tension=(("T", 1.0),), projection=proj, approx_projection=proj)


def sessile_sim(dev, angle):
    import torch
    from gerris_tpu_torch.models.simulation import Simulation, Time
    from gerris_tpu_torch.physics import vof
    cfg = sessile_cfg(LEVEL_SESSILE, angle)
    T0 = vof.fraction_from_levelset(
        cfg.grid, lambda x, y: 0.09 - ((x + 0.5) ** 2 + (y + 0.5) ** 2),
        device=dev, dtype=torch.float64)
    return Simulation(cfg, time=Time(), device=dev,
                      dtype=torch.float64).init(T=T0)


def phase_sessile(dev, card):
    """init + SESSILE_STEPS steps of the sessile drop at 256^2 in float64
    for each angle, gated from the recorded cycle counts (K6, K4 per
    projection, K5 at init, K9, K14 per component, and per cycle K11,
    the pyramid and 2 K3 above the dense 64^2 level), held to the plain
    versions on U, V, T and mean-free P within SESSILE_RTOL.  Returns
    the 60-degree run's launch counts."""
    import torch
    out = {}
    for angle in SESSILE_ANGLES:
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recording_solves() as log:
            s = sessile_sim(dev, angle).run(max_steps=SESSILE_STEPS)
        torch.cuda.synchronize()
        counts = launch_counts()
        print(f"phase 3, sessile: contact angle {angle:g}, "
              f"{s.cfg.grid.shape[0]}^2, float64, init + {SESSILE_STEPS} "
              f"steps: {time.perf_counter() - t0:.3f} s; niter "
              f"{[x[1] for x in log]}; launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        w = {k: 0 for k in want_launches("pair", 0)}
        w.update(predict_xy=SESSILE_STEPS,
                 divergence_mac=2 * SESSILE_STEPS + 1, correct_project=1,
                 interp_faces=SESSILE_STEPS + 1,
                 advect2d=2 * SESSILE_STEPS)
        add_solves(w, [x[:3] for x in log], 2, k12=False)
        for k, v in w.items():
            if counts[k] != v:
                raise AssertionError(f"sessile {angle:g}: {k}: {counts[k]} "
                                     f"launches, want {v}")
        with plain_versions():
            ref = sessile_sim(dev, angle).run(max_steps=SESSILE_STEPS)
        if launch_counts() != counts:
            raise AssertionError("the plain reference run launched kernels")
        for k in ("U", "V", "T", "P"):
            a, b = s.state[k], ref.state[k]
            if k == "P":
                a, b = a - a.mean(), b - b.mean()
            rel = rel_err(a, b)
            print(f"  sessile {angle:g}, kernels vs plain after "
                  f"{SESSILE_STEPS} steps, {k}"
                  f"{' (mean-free)' if k == 'P' else ''}: rel {rel:.3e} "
                  f"(bound {SESSILE_RTOL:.0e})")
            if not rel <= SESSILE_RTOL:
                raise AssertionError(f"sessile {angle:g} {k}: rel {rel:.3e}")
        out[angle] = counts
    return out[SESSILE_ANGLES[0]]


def sessile_gate_measure(s, angle):
    """(mean band curvature, its std, 1/R(theta), band cells) of the
    sessile drop ``s`` with contact angle ``angle``: the band 0.05 < T < 0.95 where the curvature is
    finite, 1/R(theta) = sqrt((theta - cos sin) / V) with V twice the
    computed quarter's volume (the left wall is the symmetry axis), as
    tests/test_gfs_verbatim3.py:99-115 measures it."""
    import torch
    from gerris_tpu_torch.physics import vof
    T, g = s.state["T"], s.cfg.grid
    tbc = dict(s.cfg.vof_tracers)["T"]
    kap = vof.curvature(T, g, tbc)
    band = (T > 0.05) & (T < 0.95) & torch.isfinite(kap)
    vol = 2.0 * float(T.double().sum()) * g.h ** 2
    th = math.radians(angle)
    kex = math.sqrt((th - math.cos(th) * math.sin(th)) / vol)
    kb = kap[band].double()
    return float(kb.mean()), float(kb.std()), kex, int(band.sum())


def sessile_gate(dev, card, angle):
    """The physics gate at one contact angle: the sessile drop at
    SESSILE_GATE_LEVEL in float64 for SESSILE_GATE_STEPS steps on the
    card; the mean curvature of the interface band within
    SESSILE_GATE_RTOL of 1/R(theta) and its std within SESSILE_GATE_STD
    of it."""
    import torch
    from gerris_tpu_torch.models.simulation import Simulation, Time
    from gerris_tpu_torch.physics import vof
    t0 = time.perf_counter()
    cfg = sessile_cfg(SESSILE_GATE_LEVEL, angle)
    T0 = vof.fraction_from_levelset(
        cfg.grid, lambda x, y: 0.09 - ((x + 0.5) ** 2 + (y + 0.5) ** 2),
        device=dev, dtype=torch.float64)
    s = Simulation(cfg, time=Time(), device=dev,
                   dtype=torch.float64).init(T=T0)
    s.run(max_steps=SESSILE_GATE_STEPS)
    kavg, kstd, kex, nband = sessile_gate_measure(s, angle)
    rel, spread = abs(kavg - kex) / kex, kstd / kex
    print(f"phase 4, sessile gate, contact angle {angle:g}: level "
          f"{SESSILE_GATE_LEVEL}, float64, {s.time.i} steps to t = "
          f"{s.time.t:.6f}, {time.perf_counter() - t0:.1f} s on {card}; "
          f"band of {nband} cells, mean curvature {kavg:.6f}, 1/R(theta) "
          f"{kex:.6f} (rel {rel:.4f}, bound {SESSILE_GATE_RTOL}), std / "
          f"(1/R) {spread:.4f} (bound {SESSILE_GATE_STD})")
    if s.time.i != SESSILE_GATE_STEPS or nband <= 4 or not (
            rel < SESSILE_GATE_RTOL and spread < SESSILE_GATE_STD):
        raise AssertionError(f"sessile gate {angle:g}: curvature "
                             f"{kavg:.6f} vs {kex:.6f}, std {kstd:.6f}")


def capwave_cfg(level):
    """tests/test_capwave.py's configuration (the reference's
    test/capwave) at 2^level x 3 2^level cells: the 1 x 3 box at origin
    (-0.5, -1.5), periodic in x, u Neumann and v Dirichlet 0 on y, T
    Neumann on y, nu CAPWAVE_NU, sigma 1, equal densities, the
    projections to 1e-6 in at most 100 cycles, the diffusion to 1e-6 in
    at most 20."""
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
        nu=CAPWAVE_NU, beta=1.0, vof_tracers=(("T", bc.FieldBC((per, nn))),),
        tension=(("T", 1.0),), projection=proj, approx_projection=proj,
        diffusion_params=MultilevelParams(tolerance=1e-6, nitermax=20))


def capwave_sim(dev, level=None, dtype=None, events=(), end=math.inf):
    """The capillary wave on the card at ``level`` (LEVEL_CAPWAVE by
    default) in ``dtype`` (float32 by default), T0 the fraction of y - A0
    cos(2 pi x), at rest, not yet run."""
    import torch
    from gerris_tpu_torch.models.simulation import Simulation, Time
    from gerris_tpu_torch.physics import vof
    dtype = dtype or torch.float32
    cfg = capwave_cfg(level or LEVEL_CAPWAVE)
    T0 = vof.fraction_from_levelset(
        cfg.grid, lambda x, y: y - CAPWAVE_A0 * torch.cos(2 * math.pi * x),
        device=dev, dtype=dtype)
    return Simulation(cfg, time=Time(end=end), device=dev, dtype=dtype,
                      events=list(events)).init(T=T0)


def want_capwave(steps, solves):
    """Launches of init + ``steps`` capillary-wave steps from the solves
    recorded as (solver, niter, fixed): K4 once per projection; per solve
    one K11 for r0 and one per cycle; per cycle one restrict_pyramid down
    to the dense level and CAPWAVE_K10_LEVELS K10 (prolong + K10 on each
    box level above it); nothing else."""
    w = {k: 0 for k in want_launches("pair", 0)}
    w.update(divergence_mac=2 * steps + 1)
    for solver, niter, fixed in solves:
        if solver != "multigrid" or fixed:
            raise AssertionError(f"capwave: a {solver} solve")
        w["residual"] += 1 + niter
        w["restrict_pyramid"] += niter
        w["rbgs_relax"] += CAPWAVE_K10_LEVELS * niter
    return w


def phase_capwave(dev, card):
    """init + CAPWAVE_STEPS steps of the capillary wave at 1024 x 3072 in
    float32 through the kernels, the counts set to 0 just before and
    gated just after from every solve's recorded cycle count
    (want_capwave); finite values; T's volume; the first
    CAPWAVE_CHECK_STEPS steps against the plain versions
    (check_against_plain, float64 to 1e-9); five timed windows and a
    profile.  Returns the launch counts."""
    import torch
    n0, n1 = capwave_cfg(LEVEL_CAPWAVE).grid.shape
    print(f"phase 3, capwave: the capillary wave (test/capwave), {n0} x "
          f"{n1}, periodic x, float32, init + {CAPWAVE_STEPS} steps")
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording_solves() as log:
        s = capwave_sim(dev)
        vol0 = float(s.state["T"].double().sum())
        s.run(max_steps=CAPWAVE_CHECK_STEPS)
        early = {k: v.clone() for k, v in s.state.items()}
        s.run(max_steps=CAPWAVE_STEPS - CAPWAVE_CHECK_STEPS)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    counts = launch_counts()
    niters = [x[1] for x in log]
    print(f"  capwave, init + {CAPWAVE_STEPS} steps: {t_run:.3f} s; "
          f"{len(niters)} solves, niter {niters}; host syncs "
          f"{sum(x[3] for x in log)}; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    if len(niters) != 4 * CAPWAVE_STEPS + 1:
        raise AssertionError(f"capwave: {len(niters)} solves")
    for k, w in want_capwave(CAPWAVE_STEPS, [x[:3] for x in log]).items():
        if counts[k] != w:
            raise AssertionError(f"capwave: {k}: {counts[k]} launches, "
                                 f"want {w}")
    for k, v in s.state.items():
        if v.shape != (n0, n1) or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"capwave {k}: not finite or wrong shape")
    vol = float(s.state["T"].double().sum())
    print(f"  capwave: T's volume rel change {abs(vol - vol0) / vol0:.3e}; "
          f"t {s.time.t:.6e} after {s.time.i} steps, dt {s.dt:.6e}; "
          f"max|V| {float(s.state['V'].abs().max()):.6e}")
    check_against_plain("capwave", lambda dtype: capwave_sim(dev,
                                                             dtype=dtype),
                        CAPWAVE_CHECK_STEPS, early, 1e-9)
    del early
    step = timed_windows("capwave", s, CAPWAVE_TIMED_STEPS, card, n0 * n1)
    phase_profile(s, step, card, CAPWAVE_PROFILE_STEPS)
    return counts


def capwave_rms(dev, level, dtype=None):
    """The capillary wave at ``level`` on the card to CAPWAVE_TEND, the
    amplitude max |y| of the interface points of the cells 1e-6 < T <
    1 - 1e-6 (tests/test_capwave.py:amplitude) recorded every
    CAPWAVE_SAMPLE on the card and read once at the end: (RMS of the
    amplitude's error against Prosperetti's over A0, steps)."""
    import torch
    from gerris_tpu_torch.events.events import Event
    from gerris_tpu_torch.models import ns
    from gerris_tpu_torch.physics import vof
    from gerris_tpu_torch.utils.analytic import prosperetti_capwave
    dtype = dtype or torch.float64
    times, amps = [], []

    def record(sim):
        T, grid = sim.state["T"], sim.cfg.grid
        mx, my = vof.normals(T, grid, sim.cfg.vof_tracers[0][1])
        _, py = vof.interface_point(T, mx, my)
        ypos = ns.cell_centers(grid, dev, dtype)[1] + py * grid.h
        ifc = (T > 1e-6) & (T < 1 - 1e-6)
        times.append(sim.time.t)
        amps.append(torch.where(ifc, ypos.abs(), 0.0).max())

    s = capwave_sim(dev, level, dtype,
                    events=[Event(action=record, step=CAPWAVE_SAMPLE)],
                    end=CAPWAVE_TEND)
    s.run()
    got = torch.stack(amps).double().cpu().numpy()
    exact = np.abs(prosperetti_capwave(np.array(times), CAPWAVE_A0,
                                       2 * math.pi, CAPWAVE_NU, 1.0))
    if abs(s.time.t - CAPWAVE_TEND) > 1e-9 or not np.isfinite(got).all():
        raise AssertionError(f"capwave gate: ended at t = {s.time.t}")
    return math.sqrt(float(np.mean((got - exact) ** 2))) / CAPWAVE_A0, \
        s.time.i


def capwave_gate(dev, card, level):
    """The physics gate at one level: the capillary wave in float64 to
    CAPWAVE_TEND (capwave_rms); levels 4 and 5 within CAPWAVE_REF_RTOL
    of the reference's table and JAX_RTOL of the JAX package's values,
    level 6 within CAPWAVE_L6_RTOL of the table.  Prints the RMS as a
    JSON line for capwave_order."""
    import torch
    t0 = time.perf_counter()
    rms, steps = capwave_rms(dev, level, torch.float64)
    e_ref = abs(rms - CAPWAVE_REF[level]) / CAPWAVE_REF[level]
    rtol = CAPWAVE_REF_RTOL if level in JAX_CAPWAVE else CAPWAVE_L6_RTOL
    jax = JAX_CAPWAVE.get(level)
    e_jax = 0.0 if jax is None else abs(rms - jax) / jax
    print(f"phase 4, capwave gate: level {level}, float64, {steps} steps to "
          f"t = {CAPWAVE_TEND}, {time.perf_counter() - t0:.1f} s on {card}: "
          f"RMS / A0 {rms:.6g}; the reference's table {CAPWAVE_REF[level]} "
          f"(rel {e_ref:.4f}, bound {rtol})"
          + ("" if jax is None else
             f", gerris_tpu level {level} f64 {jax:.6g} (rel {e_jax:.4f}, "
             f"bound {JAX_RTOL})"))
    print(json.dumps({"capwave_level": level, "rms": rms}))
    if not (e_ref <= rtol and e_jax <= JAX_RTOL):
        raise AssertionError(f"capwave gate: level {level} RMS {rms:.6g}")


def capwave_order(outputs):
    """The order between the capwave gate's levels 4 and 5 from their
    jobs' outputs, above CAPWAVE_ORDER_MIN."""
    rms = {}
    for out in outputs:
        for line in out.splitlines():
            if line.startswith('{"capwave_level"'):
                d = json.loads(line)
                rms[d["capwave_level"]] = d["rms"]
    order = math.log2(rms[4] / rms[5])
    print(f"phase 4, capwave gate: order between levels 4 and 5 "
          f"{order:.4f} (bound > {CAPWAVE_ORDER_MIN})")
    if not order > CAPWAVE_ORDER_MIN:
        raise AssertionError(f"capwave gate: order {order:.4f}")


def cylinder_phi(x, y):
    """The cylinder's level set: the fluid outside the disk of radius
    CYLINDER_R at the origin."""
    import torch
    return torch.sqrt(x * x + y * y) - CYLINDER_R


def cylinder_cfg(level):
    """The flow past a cylinder at 3 2^level x 2^level cells: the 3 x 1
    box at origin (-0.5, -0.5), the cylinder at the origin (fluid
    outside, a no-slip wall at rest: surface_u (0, 0)); u Dirichlet 1 at
    the inflow (x low), Neumann 0 at the outflow and on the y sides (free
    slip); v Dirichlet 0 at the inflow and on the y sides, Neumann 0 at
    the outflow; p Dirichlet 0 at the outflow, Neumann elsewhere; nu
    CYLINDER_NU; everything else NSConfig's defaults (the projections
    adaptive to 1e-3 in at most 100 cycles, diffuse's default
    diffusion)."""
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.models import ns
    nn = (bc.Neumann(), bc.Neumann())
    u_bc = bc.FieldBC(((bc.Dirichlet(1.0), bc.Neumann()), nn))
    v_bc = bc.FieldBC(((bc.Dirichlet(0.0), bc.Neumann()),
                       (bc.Dirichlet(0.0), bc.Dirichlet(0.0))))
    p_bc = bc.FieldBC(((bc.Neumann(), bc.Dirichlet(0.0)), nn))
    return ns.NSConfig(
        grid=Grid(level=level, dim=2, origin=(-0.5, -0.5), extents=(3, 1)),
        u_bcs=(u_bc, v_bc), p_bc=p_bc, nu=CYLINDER_NU,
        solid_phi=cylinder_phi, surface_u=(0.0, 0.0))


def cylinder_sim(dev, level=None, dtype=None):
    """The cylinder at ``level`` (LEVEL_CYLINDER by default) in ``dtype``
    (float32 by default), U = 1 everywhere at t = 0 (the tutorial's
    Init), not yet run."""
    import torch
    from gerris_tpu_torch.models.simulation import Simulation, Time
    cfg = cylinder_cfg(level or LEVEL_CYLINDER)
    return Simulation(cfg, time=Time(), device=dev,
                      dtype=dtype or torch.float32).init(U=1.0)


def cylinder_levels(level):
    """K15's levels in a correction of the cylinder at ``level``: down to
    MultilevelParams' minlevel 2."""
    return level - 2 + 1


def want_cylinder(level, solves):
    """Launches of the cylinder route from its solves (solver, niter,
    fixed): every solve adaptive multigrid with face fractions, so per
    cycle K15 at each level (cylinder_levels), all but the coarsest with
    the prolongation folded in, and one restrict_pyramid; no other
    kernel: the divergence, residual and correction of a cut-cell solve
    are torch (K4, K11, K5 take no face coefficients), the velocity
    advection takes the generic route with a solid (no K7 or K14), and K6
    and K9 refuse the outflow's Neumann u (their x faces want Dirichlet
    values), as the reference's do (gerris_tpu/models/ns.py:190-196,
    solvers/projection.py:303-310)."""
    w = {k: 0 for k in want_launches("pair", 0)}
    for solver, niter, fixed in solves:
        if solver != "multigrid" or fixed:
            raise AssertionError(f"cylinder: a {solver} solve")
    cycles = sum(x[1] for x in solves)
    nl = cylinder_levels(level)
    w.update(rbgs_relax_alpha=nl * cycles, restrict_pyramid=cycles)
    w["rbgs_relax_alpha.prolong"] = (nl - 1) * cycles
    return w


def digests(state):
    """A short sha256 of each field's bytes."""
    import hashlib
    return {k: hashlib.sha256(v.contiguous().cpu().numpy().tobytes())
            .hexdigest()[:16] for k, v in sorted(state.items())}


def phase_cylinder(dev, card):
    """init + CYLINDER_STEPS steps of the cylinder at 3072 x 1024 in float32
    through the kernels, the counts set to 0 just before and gated just
    after from every solve's recorded cycle count (want_cylinder); finite
    values; the solid's geometry (fluid area, mixed and solid cells, merge
    groups); the first CYLINDER_CHECK_STEPS steps against the plain
    versions (check_against_plain, float64 to CYLINDER_F64_RTOL); the run
    again with the geometry rebuilt, bit for bit the first (digests); five
    timed windows and a profile.  Returns the launch counts."""
    import torch
    from gerris_tpu_torch.models import ns
    from gerris_tpu_torch.physics import solid
    cfg = cylinder_cfg(LEVEL_CYLINDER)
    n0, n1 = cfg.grid.shape
    print(f"phase 3, cylinder: the flow past a cylinder (Re 160), {n0} x "
          f"{n1}, float32, init + {CYLINDER_STEPS} steps")
    ns._static_weights.cache_clear()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording_solves() as log:
        s = cylinder_sim(dev)
        s.run(max_steps=CYLINDER_CHECK_STEPS)
        early = {k: v.clone() for k, v in s.state.items()}
        s.run(max_steps=CYLINDER_STEPS - CYLINDER_CHECK_STEPS)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    counts = launch_counts()
    niters = [x[1] for x in log]
    print(f"  cylinder, init + {CYLINDER_STEPS} steps: {t_run:.3f} s (the "
          f"geometry's build included); {len(niters)} solves, niter "
          f"{niters}; host syncs {sum(x[3] for x in log)}; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    if len(niters) != 6 * CYLINDER_STEPS + 1:
        raise AssertionError(f"cylinder: {len(niters)} solves")
    for k, w in want_cylinder(LEVEL_CYLINDER, [x[:3] for x in log]).items():
        if counts[k] != w:
            raise AssertionError(f"cylinder: {k}: {counts[k]} launches, "
                                 f"want {w}")
    nl = cylinder_levels(LEVEL_CYLINDER)
    print(f"  cylinder: rbgs_relax_alpha {counts['rbgs_relax_alpha']} "
          f"launches = {nl} x sum(niter) {sum(niters)}, "
          f"{counts['rbgs_relax_alpha.prolong']} with the prolongation "
          f"folded in, {counts['restrict_pyramid']} restrict_pyramid; "
          "predict_xy and interp_faces 0 (the outflow's BCs)")
    for k, v in s.state.items():
        if v.shape != (n0, n1) or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"cylinder {k}: not finite or wrong shape")
    ctx = ns._weights(cfg, s.state["U"])
    h = cfg.grid.h
    area = float(ctx.a.double().sum()) * h * h
    exact = 3.0 - math.pi * CYLINDER_R ** 2
    small, tgt = solid._merge_targets(ctx.a, ctx.s)
    src = torch.nonzero(small.reshape(-1)).squeeze(1)
    dst = tgt.reshape(-1)[src]
    mutual = int((small.reshape(-1)[dst] & (tgt.reshape(-1)[dst] == src))
                 .sum())
    inside = float(s.state["U"].masked_select(ctx.a == 0.0).abs().max())
    print(f"  cylinder: fluid area {area:.6f} (exact {exact:.6f}), "
          f"{int(ctx.ds.mixed.sum())} cut cells, {int((ctx.a == 0).sum())} "
          f"solid cells, {int(small.sum())} small cells in "
          f"{ctx.groups.ngroups} merge groups of at most "
          f"{ctx.groups.index.shape[1]}, {mutual} in mutual pairs; max|U| "
          f"{float(s.state['U'].abs().max()):.6f}, max|V| "
          f"{float(s.state['V'].abs().max()):.6f}, |U| in the solid "
          f"{inside}; t {s.time.t:.6e} after {s.time.i} steps, dt "
          f"{s.dt:.6e}")
    if abs(area - exact) > 1e-3 * exact or inside != 0.0:
        raise AssertionError(f"cylinder: fluid area {area}, |U| in the "
                             f"solid {inside}")
    check_against_plain("cylinder", lambda dtype: cylinder_sim(dev,
                                                               dtype=dtype),
                        CYLINDER_CHECK_STEPS, early,
                        CYLINDER_F64_RTOL, keys=("U", "V", "P"))
    del early
    # determinism: the same run with the geometry and merge groups
    # rebuilt gives the same bits
    first = digests(s.state)
    ns._static_weights.cache_clear()
    again = cylinder_sim(dev).run(max_steps=CYLINDER_STEPS)
    second = digests(again.state)
    print(f"  cylinder digests, run 1: {first}; run 2: {second}")
    if first != second or any(not torch.equal(v, s.state[k])
                              for k, v in again.state.items()):
        raise AssertionError("cylinder: two runs differ")
    del again
    step = timed_windows("cylinder", s, CYLINDER_TIMED_STEPS, card, n0 * n1)
    phase_profile(s, step, card, CYLINDER_PROFILE_STEPS)
    return counts


def circle_rhs(x, y):
    """test/circle's rhs: test/poisson's with K = 3."""
    import torch
    return -(math.pi ** 2) * 18.0 * torch.sin(3 * math.pi * x) * \
        torch.sin(3 * math.pi * y)


def circle_phi(x, y):
    """test/circle's disk of radius 0.25 at the origin (fluid outside)."""
    return x * x + y * y - 0.0625


def circle_solve(dev, level):
    """tests/test_circle.py:solve_level on the port in float64: 10 cycles
    with erelax 2, Neumann box walls.  Returns (u, a)."""
    import torch
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.models import ns
    from gerris_tpu_torch.physics import solid
    from gerris_tpu_torch.solvers.poisson import MultilevelParams
    grid = Grid(level=level)
    x, y = ns.cell_centers(grid, dev, torch.float64)
    u, _, a, _ = solid.poisson_solid_solve(
        circle_rhs(x, y), grid, circle_phi, bc.default_scalar_bc(2),
        MultilevelParams(nitermin=10, nitermax=10, erelax=2))
    return u, a


def circle_richardson(coarse, fine):
    """tests/test_circle.py:richardson_error from two levels' (u, a): the
    L1, L2 and Linf norms of the difference between the coarse solution
    and the fine one, volume-weighted restricted, less their fluid means,
    on the cells fluid at both."""
    import torch
    u0, a0 = coarse
    u1, a1 = fine
    n0, n1 = u0.shape

    def pool(t):
        return t.reshape(n0, 2, n1, 2).sum(dim=(1, 3))

    ac = pool(a1)
    u1r = pool(u1 * a1) / torch.clamp(ac, min=1e-300)
    a1r = ac / 4.0

    def mean(u, a):
        return (u * a).sum() / a.sum()

    d = (u0 - mean(u0, a0)) - (u1r - mean(u1r, a1r))
    w = torch.minimum(a0, a1r)
    w = torch.where(w > 1e-6, w, 0.0)
    wsum = w.sum()
    return (float((d.abs() * w).sum() / wsum),
            float(torch.sqrt((d * d * w).sum() / wsum)),
            float(torch.where(w > 0.0, d.abs(), 0.0).max()))


def circle_reduction(dev, level=7, cycles=8):
    """tests/test_circle.py:test_circle_mg_reduction on the port in
    float64: the average factor by which a cycle (erelax 2) reduces
    max|r| over ``cycles`` cycles from zero."""
    import torch
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.models import ns
    from gerris_tpu_torch.physics import solid
    from gerris_tpu_torch.solvers import poisson
    grid = Grid(level=level)
    fbc = bc.default_scalar_bc(2)
    a, s = solid.solid_fractions(grid, circle_phi, dev, torch.float64)
    rhs = a * circle_rhs(*ns.cell_centers(grid, dev, torch.float64))
    rhs = rhs - a * (rhs.sum() / a.sum())
    params = poisson.MultilevelParams(erelax=2)
    u = torch.zeros_like(rhs)
    res = [poisson.residual(u, rhs, grid, fbc, alpha=s).abs().max()]
    for _ in range(cycles):
        u = poisson.cycle(u, rhs, grid, fbc, params, alpha=s)
        res.append(poisson.residual(u, rhs, grid, fbc, alpha=s).abs().max())
    res = [float(r) for r in res]
    return (res[0] / res[-1]) ** (1.0 / cycles), res


def circle_gate(dev, card):
    """test/circle on the card in float64 at levels 7, 8 and 9: the level-8
    Richardson L1 and L2 within CIRCLE_REF_FACTOR of the reference's
    error.ref either way, the L1 and L2 orders between levels 7 and 8
    above CIRCLE_ORDER_MIN, and the multigrid's average reduction per
    cycle at level 7 at least CIRCLE_REDUCTION_MIN."""
    t0 = time.perf_counter()
    sols = {lv: circle_solve(dev, lv) for lv in (7, 8, 9)}
    e7 = circle_richardson(sols[7], sols[8])
    e8 = circle_richardson(sols[8], sols[9])
    orders = [math.log2(e7[k] / e8[k]) for k in range(3)]
    red, res = circle_reduction(dev)
    ratios = [e8[0] / CIRCLE_REF["l1"], e8[1] / CIRCLE_REF["l2"]]
    print(f"phase 4, circle gate: float64, levels 7-9, "
          f"{time.perf_counter() - t0:.1f} s on {card}: Richardson L1, L2, "
          f"Linf at level 7 {e7}, level 8 {e8} (error.ref L1 "
          f"{CIRCLE_REF['l1']}, L2 {CIRCLE_REF['l2']}: ratios "
          f"{ratios[0]:.3f}, {ratios[1]:.3f}, bound {CIRCLE_REF_FACTOR}x); "
          f"orders {orders[0]:.4f}, {orders[1]:.4f}, {orders[2]:.4f} "
          f"(L1 and L2 bound > {CIRCLE_ORDER_MIN}); multigrid reduction at "
          f"level 7 {red:.2f} per cycle (bound >= {CIRCLE_REDUCTION_MIN}), "
          f"max|r| {res[0]:.3e} -> {res[-1]:.3e}")
    if not (all(1.0 / CIRCLE_REF_FACTOR <= r <= CIRCLE_REF_FACTOR
                for r in ratios)
            and orders[0] > CIRCLE_ORDER_MIN and orders[1] > CIRCLE_ORDER_MIN
            and red >= CIRCLE_REDUCTION_MIN):
        raise AssertionError(f"circle gate: {e8}, orders {orders}, "
                             f"reduction {red}")


def circle_jax_gate(dev, card):
    """test/circle's Richardson norms at level 6 (levels 6 and 7) on the
    card in float64 within JAX_RTOL of the JAX package's
    (tools/circle_reference.py 6, JAX_CIRCLE6)."""
    t0 = time.perf_counter()
    e6 = circle_richardson(circle_solve(dev, 6), circle_solve(dev, 7))
    rel = [abs(e6[k] - JAX_CIRCLE6[key]) / JAX_CIRCLE6[key]
           for k, key in enumerate(("l1", "l2", "linf"))]
    print(f"phase 4, circle gate against gerris_tpu: level 6, float64, "
          f"{time.perf_counter() - t0:.1f} s on {card}: L1, L2, Linf {e6}; "
          f"gerris_tpu {JAX_CIRCLE6['l1']}, {JAX_CIRCLE6['l2']}, "
          f"{JAX_CIRCLE6['linf']} (rel {rel[0]:.2e}, {rel[1]:.2e}, "
          f"{rel[2]:.2e}, bound {JAX_RTOL})")
    if not all(r <= JAX_RTOL for r in rel):
        raise AssertionError(f"circle gate against gerris_tpu: {rel}")


COUETTE_R = (0.25, 0.49998)


def couette_cfg(level):
    """tests/test_couette.py:test_couette_profile's configuration (the
    reference's test/couette): the annulus 0.25 < r < 0.49998 in the unit
    box, the inner cylinder turning with (-y, x) and the outer one at
    rest (a surface velocity split at r = 0.375), nu 1, beta 1, velocity_bc
    walls, scheme "none", the projections to 1e-6 in at most 100 cycles,
    the diffusion to 1e-6 in at most 30."""
    import torch
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.models import ns
    from gerris_tpu_torch.solvers.advection import AdvectionParams
    from gerris_tpu_torch.solvers.poisson import MultilevelParams
    proj = MultilevelParams(tolerance=1e-6, nitermax=100)
    return ns.NSConfig(
        grid=Grid(level=level), u_bcs=(bc.velocity_bc(0, 2),
                                       bc.velocity_bc(1, 2)),
        nu=1.0, beta=1.0, solid_phi=couette_phi,
        surface_u=(couette_us_u, couette_us_v),
        advection=AdvectionParams(scheme="none"), projection=proj,
        approx_projection=proj,
        diffusion_params=MultilevelParams(tolerance=1e-6, nitermax=30))


def couette_phi(x, y):
    import torch
    r2 = x * x + y * y
    return torch.minimum(COUETTE_R[1] ** 2 - r2, r2 - COUETTE_R[0] ** 2)


def couette_us_u(x, y):
    import torch
    return torch.where(x * x + y * y > 0.375 ** 2, 0.0, -y)


def couette_us_v(x, y):
    import torch
    return torch.where(x * x + y * y > 0.375 ** 2, 0.0, x)


def couette_gate(dev, card, level=COUETTE_LEVEL):
    """tests/test_couette.py's gate on the card in float64: at most 100
    steps of dt 1e-2, stopping when a step moves U by less than 1e-5; the
    tangential velocity V(r, 0) at 11 radii in [0.27, 0.47] against the
    analytic profile, Linf < COUETTE_LINF and L2 < COUETTE_L2."""
    import torch
    from gerris_tpu_torch.models.simulation import Simulation, Time
    t0 = time.perf_counter()
    sim = Simulation(couette_cfg(level), time=Time(iend=100, dtmax=1e-2),
                     device=dev, dtype=torch.float64).init()
    prev = None
    for _ in range(100):
        sim.run(max_steps=1)
        U = sim.state["U"]
        if prev is not None and float((U - prev).abs().max()) < 1e-5:
            break
        prev = U
    rs = np.linspace(0.27, 0.47, 11)
    vt = np.array([sim.interpolate("V", (r, 0.0)) for r in rs])
    ex = rs * ((0.5 / rs) ** 2 - 1.0) / ((0.5 / 0.25) ** 2 - 1.0)
    err = np.abs(vt - ex)
    linf, l2 = float(err.max()), float(np.sqrt((err ** 2).mean()))
    print(f"phase 4, couette gate: level {level}, float64, {sim.time.i} "
          f"steps, {time.perf_counter() - t0:.1f} s on {card}: Linf "
          f"{linf:.5f} (bound {COUETTE_LINF}), L2 {l2:.5f} (bound "
          f"{COUETTE_L2})")
    if not (linf < COUETTE_LINF and l2 < COUETTE_L2):
        raise AssertionError(f"couette gate: Linf {linf}, L2 {l2}")


# ---------------------------------------------------------------------------
# slice 4b: moving solids, rigid bodies, the axisymmetric and general
# metrics
# ---------------------------------------------------------------------------
# the impulsively started disk of tests/test_moving.py:102-121 (radius
# 0.15 from x = -0.2, surface velocity (0.5, 0), velocity_bc walls, dt =
# 0.25 h) with nu 1e-3 (Re 150 on the diameter), so that the moving
# Dirichlet surface's viscous solve runs; at 2048^2 in float32, init + 5
# steps at orders 1 and 2, the NSConfig defaults' schedule (the test's
# solves to 1e-9 are below float32's floor)
LEVEL_MOVING = 11
MOVING_R = 0.15
MOVING_U = 0.5
MOVING_NU = 1e-3
MOVING_DT = 0.25          # times h
MOVING_STEPS = 5
MOVING_CHECK_STEPS = 2
MOVING_TIMED_STEPS = 2
MOVING_PROFILE_STEPS = 2
WEIGHTED_F64_RTOL = 1e-9
# host syncs of a step (ns_step, or a rigid body's step) beyond its
# solves' condition reads: with a moving solid the Dirichlet surface's cut
# cells (one nonzero) and the merge groups' two (solid.merge_groups: the
# linked cells, then the count and largest size of the groups), whatever
# the groups' sizes.  A Simulation adds its CFL dt's read.
MOVING_SYNCS = 3
# the falling disk of tests/test_rigid.py:37-66 (mass 0.1, radius 0.12
# from (0, 0.2), gravity -1, nu 0, dt 0.25 h) at 2048^2 in float32, 5
# steps, the NSConfig defaults' schedule
LEVEL_RIGID = 11
RIGID_MASS = 0.1
RIGID_R = 0.12
RIGID_Y0 = 0.2
RIGID_G = -1.0
RIGID_STEPS = 5
RIGID_CHECK_STEPS = 2
# the axisymmetric Poiseuille pipe of tests/test_axi.py:56-93 (origin
# (-0.5, 0), x periodic, G 1, nu 0.5, scheme "none", dtmax 2e-2) at
# 2048^2 in float32, init + 5 steps, the NSConfig defaults' schedule
LEVEL_AXI = 11
AXI_G = 1.0
AXI_NU = 0.5
AXI_STEPS = 5
AXI_CHECK_STEPS = 2
# the bench's lid cavity (bench.py:128-173, lid_cfg) under
# MetricStretch(1, 0.1), test/lake's factor, at 2048^2 in float32, init
# + 5 steps
LEVEL_STRETCH = 11
STRETCH = (1.0, 0.1)
STRETCH_STEPS = 5
STRETCH_CHECK_STEPS = 2
# the phases' timed windows and profiles (steps)
WEIGHTED_TIMED_STEPS = 2
WEIGHTED_PROFILE_STEPS = 2
# the gates (phase 4, child processes; tests/test_axi.py, test_moving.py,
# test_metric.py, test_rigid.py on the port): the axi Poiseuille at level
# 5 in float64 within 1% of u(r), V below 1e-6; the axi Poisson's order
# above 1.8 at levels 5-6, its error below 3e-4; the moving disk's
# order-2 temporal rate above order 1's + 0.05 at level 5 in float64 (a
# weak gate, ROADMAP); the Galilean disk's far field within 0.06 at level
# 6; the buoyancy force within 5% at level 6; the stretch Poisson's order
# in (1.8, 2.2), the lon-lat one's above 1.6 with its error below 5e-4
AXI_GATE_LEVEL = 5
AXI_POISEUILLE_RTOL = 0.01
AXI_ORDER_MIN = 1.8
AXI_ERR_MAX = 3e-4
MOVING_GATE_LEVEL = 5
MOVING_RATE_GAIN = 0.05
GALILEAN_LEVEL = 6
GALILEAN_FAR = 0.06
BUOYANCY_RTOL = 0.05
STRETCH_ORDER = (1.8, 2.2)
LONLAT_ORDER_MIN = 1.6
LONLAT_ERR_MAX = 5e-4


# the tensor calls that read a value back to the host: each a host sync
# on the card
HOST_READS = frozenset(("item", "__bool__", "__float__", "__int__",
                        "__index__", "tolist", "nonzero", "equal",
                        "unique_consecutive", "bincount", "cpu", "numpy"))


def count_syncs(fn, dev=None, where=None):
    """(host syncs, fn's result): on the card (``dev`` None or CUDA) the
    synchronizing CUDA operations of fn(), counted by torch.cuda's sync
    debug mode (a warning each); on the CPU the calls of HOST_READS that
    fn() makes, counted by a torch function mode.  ``where``: a list
    that takes each sync's (file, line) on the card."""
    import warnings
    import torch
    from torch.overrides import TorchFunctionMode
    if dev is not None and torch.device(dev).type == "cpu":
        class Reads(TorchFunctionMode):
            n = 0

            def __torch_function__(self, func, types, args=(), kwargs=None):
                if getattr(func, "__name__", "") in HOST_READS:
                    self.n += 1
                return func(*args, **(kwargs or {}))

        with Reads() as mode:
            out = fn()
        return mode.n, out
    # the first switch to "warn" in a process reports one sync of its
    # own (torch/cuda/__init__.py): switch once uncounted
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode("default")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [(w.filename, w.lineno) for w in caught
             if "synchroniz" in str(w.message)]
    if where is not None:
        where.extend(syncs)
    return len(syncs), out


def walls():
    from gerris_tpu_torch.core import bc
    return (bc.velocity_bc(0, 2), bc.velocity_bc(1, 2))


def moving_phi(x, y, t):
    """The impulsively started disk's level set at time t (fluid
    outside), tests/test_moving.py:107."""
    import torch
    return torch.sqrt((x + 0.2 - 0.5 * t) ** 2 + y ** 2) - MOVING_R


def moving_cfg(level, order):
    """The impulsively started disk (LEVEL_MOVING's comment) at 2^level
    cells per side, scheme order ``order``."""
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.models import ns
    return ns.NSConfig(grid=Grid(level=level), u_bcs=walls(), nu=MOVING_NU,
                       solid_phi=moving_phi, moving_solid=True,
                       moving_order=order, surface_u=(MOVING_U, 0.0))


def moving_sim(dev, order, level=None, dtype=None):
    """The disk from rest in ``dtype`` (float32 by default), dt = 0.25 h,
    not yet run."""
    import torch
    from gerris_tpu_torch.models.simulation import Simulation, Time
    cfg = moving_cfg(level or LEVEL_MOVING, order)
    return Simulation(cfg, time=Time(dtmax=MOVING_DT * cfg.grid.h),
                      device=dev, dtype=dtype or torch.float32).init()


def rigid_shape(x, y, cx, cy):
    import torch
    return torch.sqrt((x - cx) ** 2 + (y - cy) ** 2) - RIGID_R


class BodyRun:
    """A RigidBodyDriver stepped at a fixed dt, as a Simulation is run:
    run(max_steps) and state."""

    def __init__(self, drv, dt):
        self.drv, self.dt = drv, dt

    def run(self, max_steps):
        for _ in range(max_steps):
            self.drv.step(self.dt)
        return self

    @property
    def state(self):
        return self.drv.state


def rigid_run(dev, level=None, dtype=None):
    """The falling disk (LEVEL_RIGID's comment) at rest, dt = 0.25 h, as a
    BodyRun."""
    import torch
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.models import rigid
    grid = Grid(level=level or LEVEL_RIGID)
    drv = rigid.RigidBodyDriver(
        grid, walls(), rigid_shape,
        rigid.RigidBody(mass=RIGID_MASS, pos=(0.0, RIGID_Y0),
                        gravity=(0.0, RIGID_G)),
        device=dev, dtype=dtype or torch.float32)
    return BodyRun(drv, MOVING_DT * grid.h)


def axi_cfg(level, tol=None):
    """The axisymmetric Poiseuille pipe (LEVEL_AXI's comment) at 2^level
    cells per side; ``tol``: every solve to that tolerance (the test's
    1e-8, at most 100 cycles, 30 for the diffusion), else the NSConfig
    defaults'."""
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.models import ns
    from gerris_tpu_torch.solvers.advection import AdvectionParams
    from gerris_tpu_torch.solvers.poisson import MultilevelParams
    per = (bc.Periodic(), bc.Periodic())
    ubc = bc.FieldBC((per, (bc.Neumann(), bc.Dirichlet(0.0))))
    vbc = bc.FieldBC((per, (bc.Dirichlet(0.0), bc.Dirichlet(0.0))))
    kw = {}
    if tol is not None:
        proj = MultilevelParams(tolerance=tol, nitermax=100)
        kw = dict(projection=proj, approx_projection=proj,
                  diffusion_params=MultilevelParams(tolerance=tol,
                                                    nitermax=30))
    return ns.NSConfig(
        grid=Grid(level=level, origin=(-0.5, 0.0)), u_bcs=(ubc, vbc),
        nu=AXI_NU, beta=1.0, axi=True, body_force=(AXI_G, None),
        advection=AdvectionParams(scheme="none"), **kw)


def axi_sim(dev, level=None, dtype=None, tol=None, iend=2 ** 31):
    import torch
    from gerris_tpu_torch.models.simulation import Simulation, Time
    return Simulation(axi_cfg(level or LEVEL_AXI, tol),
                      time=Time(iend=iend, dtmax=2e-2), device=dev,
                      dtype=dtype or torch.float32).init()


def stretch_cfg(level):
    """The bench's lid cavity under MetricStretch(*STRETCH)."""
    import dataclasses
    from gerris_tpu_torch.core.metric import MetricStretch
    return dataclasses.replace(lid_cfg(level), metric=MetricStretch(*STRETCH))


def stretch_sim(dev, level=None, dtype=None):
    import torch
    from gerris_tpu_torch.models.simulation import Simulation, Time
    cfg = stretch_cfg(level or LEVEL_STRETCH)
    return Simulation(cfg, time=Time(dtmax=0.8 * cfg.grid.h), device=dev,
                      dtype=dtype or torch.float32).init()


def want_weighted(level, solves, steps, faces, inits=1):
    """Launches of a weighted route (a solid or a metric) from its solves
    (solver, niter, fixed): every solve multigrid with face coefficients,
    so per cycle K15 at each level down to minlevel 2, all but the
    coarsest with the prolongation folded in, and one restrict_pyramid;
    with ``faces`` (walls: K6 and K9 take the BCs) one predict_xy a step
    and one interp_faces a step and per initial projection (``inits``);
    no other kernel: a weighted divergence, residual and correction are
    torch (K4, K11, K5 take no face coefficients) and the velocity
    advection takes the generic route (no K7 or K14), as the
    reference's (gerris_tpu/models/ns.py:257, :342, solvers/
    projection.py:218)."""
    w = {k: 0 for k in want_launches("pair", 0)}
    for solver, niter, fixed in solves:
        if solver != "multigrid":
            raise AssertionError(f"a {solver} solve on a weighted route")
    cycles = sum(x[1] for x in solves)
    nl = level - 2 + 1
    w.update(rbgs_relax_alpha=nl * cycles, restrict_pyramid=cycles)
    w["rbgs_relax_alpha.prolong"] = (nl - 1) * cycles
    if faces:
        w.update(predict_xy=steps, interp_faces=steps + inits)
    return w


def one_step(s):
    """One step of a run, a Simulation's ns_step at its dt and time (no CFL
    read, the run left as it was) or a BodyRun's."""
    from gerris_tpu_torch.models import ns
    if isinstance(s, BodyRun):
        return s.drv.step(s.dt)
    return ns.ns_step(s.state, s.dt, s.time.t, s.cfg,
                      cstart=s.time.i % s.cfg.dim)


def phase_weighted(dev, card, name, make, level, steps, check_steps,
                   faces, syncs, inits=1, cells=None, twice=False,
                   norm=None, floor_rule=("U", "V"), derived=None):
    """init + ``steps`` steps of ``make(float32)`` through the kernels, the
    counts set to 0 just before and gated just after from every solve's
    recorded cycle count (want_weighted); finite values; the first
    ``check_steps`` steps against the plain versions (check_against_plain,
    float64 to WEIGHTED_F64_RTOL, U, V, P and the keys of ``derived``,
    ``norm``, ``floor_rule`` and ``derived`` as there); one more
    step's host syncs
    (one_step, count_syncs) against its solves' reads plus ``syncs``; with
    ``twice`` the run again, bit for bit (digests); five timed windows
    and a profile with K15's share.  Returns (counts, the run, digests,
    the device ops per step)."""
    import torch
    derived = derived or {}
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording_solves() as log:
        s = make(torch.float32)
        s.run(max_steps=check_steps)
        early = {k: v.clone() for k, v in s.state.items()}
        s.run(max_steps=steps - check_steps)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    counts = launch_counts()
    niters = [x[1] for x in log]
    print(f"  {name}, {'init + ' if inits else ''}{steps} steps: "
          f"{t_run:.3f} s; {len(niters)} solves, niter {niters}; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    for k, w in want_weighted(level, [x[:3] for x in log], steps, faces,
                              inits).items():
        if counts[k] != w:
            raise AssertionError(f"{name}: {k}: {counts[k]} launches, "
                                 f"want {w}")
    shape = tuple(s.state["U"].shape)
    for k, v in s.state.items():
        if v.shape != shape or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{name} {k}: not finite or wrong shape")
    print(f"  {name}: rbgs_relax_alpha {counts['rbgs_relax_alpha']} "
          f"launches ({level - 1} levels x sum(niter) {sum(niters)}), "
          f"{counts['rbgs_relax_alpha.prolong']} with the prolongation "
          f"folded in, {counts['restrict_pyramid']} restrict_pyramid, "
          f"predict_xy {counts['predict_xy']}, interp_faces "
          f"{counts['interp_faces']}; max|U| "
          f"{float(s.state['U'].abs().max()):.6f}, max|V| "
          f"{float(s.state['V'].abs().max()):.6f}")
    digest = digests(s.state)
    check_against_plain(name, make, check_steps, early,
                        WEIGHTED_F64_RTOL, keys=("U", "V", "P", *derived),
                        norm=norm, floor_rule=floor_rule, derived=derived)
    del early
    if twice:
        again = make(torch.float32).run(max_steps=steps)
        second = digests(again.state)
        print(f"  {name} digests, run 1: {digest}; run 2: {second}")
        if digest != second or any(not torch.equal(v, s.state[k])
                                    for k, v in again.state.items()):
            raise AssertionError(f"{name}: two runs differ")
        del again
    # the caching allocator's own syncs (a cache flush when an allocation
    # fails) are not the step's: start the counted step with an empty
    # cache
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    where = []
    with recording_solves() as log:
        n, _ = count_syncs(lambda: one_step(s), dev, where)
    own = sum(x[3] for x in log)
    print(f"  {name}: host syncs of one step {n} = its solves' {own} + "
          f"{n - own} (want {syncs})")
    if n - own != syncs:
        raise AssertionError(f"{name}: {n} host syncs a step, its solves' "
                             f"{own} + {syncs} wanted; at {where}")
    cells = cells or shape[0] * shape[1]
    step = timed_windows(name, s, WEIGHTED_TIMED_STEPS, card, cells)
    ops = phase_profile(s, step, card, WEIGHTED_PROFILE_STEPS,
                        shares=("rbgs_relax_alpha",))
    return counts, s, digest, ops


def phase_moving(dev, card):
    """The moving disk at orders 1 and 2 (phase_weighted, run twice bit for
    bit), its geometry after the run (cut cells, small cells, merge
    groups).  Returns {route: counts}."""
    from gerris_tpu_torch.models import ns
    from gerris_tpu_torch.physics import solid
    out = {}
    for order in (1, 2):
        name = f"moving{order}"
        n = 1 << LEVEL_MOVING
        print(f"phase 3, {name}: the impulsively started disk (Re 150), "
              f"order {order}, {n}^2, float32, init + {MOVING_STEPS} steps")
        out[name], s, _, _ = phase_weighted(
            # order bound now: the plain check runs after the loop
            dev, card, name, lambda dtype, order=order: moving_sim(
                dev, order, dtype=dtype),
            LEVEL_MOVING, MOVING_STEPS, MOVING_CHECK_STEPS, True,
            MOVING_SYNCS, twice=True, floor_rule=("U", "V", "P"))
        w, _, _, _ = ns._moving_weights(s.cfg, [s.state["U"], s.state["V"]],
                                        s.dt, s.time.t)
        small, _ = solid._merge_targets(w.a, w.s)
        print(f"  {name}: at t {s.time.t:.6e}, {int(w.ds.mixed.sum())} cut "
              f"cells, {int(small.sum())} small cells, "
              f"{w.groups.members.numel()} cells in {w.groups.ngroups} merge "
              f"groups of at most {w.groups.index.shape[1]}")
    return out


def phase_rigid(dev, card):
    """The falling disk at 2048^2 (phase_weighted: no initial projection,
    no CFL read; the body's force and motion stay on the device), its
    trajectory after the steps."""
    n = 1 << LEVEL_RIGID
    print(f"phase 3, rigid: the falling disk, {n}^2, float32, "
          f"{RIGID_STEPS} steps")
    counts, run, _, _ = phase_weighted(
        dev, card, "rigid", lambda dtype: rigid_run(dev, dtype=dtype),
        LEVEL_RIGID, RIGID_STEPS, RIGID_CHECK_STEPS, True, MOVING_SYNCS,
        inits=0)
    traj = run.drv.trajectory()
    t, x, y, u, v, fx, fy = traj[RIGID_STEPS - 1]
    print(f"  rigid after {RIGID_STEPS} steps: t {t:.6e}, position "
          f"({x:.9f}, {y:.9f}), velocity ({u:.6e}, {v:.6e}), force "
          f"({fx:.6e}, {fy:.6e})")
    if not (np.isfinite(traj).all() and y < RIGID_Y0 and v < 0.0
            and v > RIGID_G * t * 1.5):
        raise AssertionError(f"rigid: trajectory {traj[-1]}")
    return counts


def phase_axi(dev, card):
    n = 1 << LEVEL_AXI
    print(f"phase 3, axi: the axisymmetric Poiseuille pipe, {n}^2, "
          f"float32, init + {AXI_STEPS} steps")
    return phase_weighted(dev, card, "axi",
                          lambda dtype: axi_sim(dev, dtype=dtype),
                          LEVEL_AXI, AXI_STEPS, AXI_CHECK_STEPS, False,
                          0, norm={"V": "U", "P": "U"})[0]


def phase_stretch(dev, card):
    n = 1 << LEVEL_STRETCH
    print(f"phase 3, stretch: the bench's lid cavity under MetricStretch"
          f"{STRETCH}, {n}^2, float32, init + {STRETCH_STEPS} steps")
    return phase_weighted(dev, card, "stretch",
                          lambda dtype: stretch_sim(dev, dtype=dtype),
                          LEVEL_STRETCH, STRETCH_STEPS, STRETCH_CHECK_STEPS,
                          True, 0, floor_rule=("U", "V", "P", "P_y"),
                          derived={"P_y": column_free})[0]


def column_free(state):
    """The pressure less its mean over y in each column (x = const): the
    part of the stretched cavity's pressure that its strong y coupling
    fixes (the column means are its weakest x modes)."""
    p = state["P"]
    return p - p.mean(dim=1, keepdim=True)


def weighted_systems(cfg, w, dt):
    """The K15 systems of a weighted configuration ``cfg`` with weights
    ``w`` (ns.Weights) at time step ``dt``, down its correction's levels
    (poisson._coeff_hierarchy): ("projection", alpha = s, dia 0) and with
    nu > 0 ("viscous u" / "viscous v", alpha = beta dt nu s, the cell dia
    a + beta dt nu (dia_s + the axisymmetric a / r^2 on v)).  Returns
    [(name, signs, periodic, alphas, dias, grids)]."""
    import dataclasses
    import torch
    from gerris_tpu_torch.solvers import poisson
    grid = cfg.grid
    nl = grid.level - 2 + 1
    grids = [dataclasses.replace(grid, level=grid.level - k)
             for k in range(nl)]
    scale = cfg.beta * dt * cfg.nu
    systems = [("projection", cfg.p_bc, w.s, 0.0)]
    if cfg.nu > 0.0:
        for c in range(2):
            dia = w.a
            if cfg.axi and c == 1:
                yc = torch.as_tensor(grid.axis_centers(1), dtype=w.a.dtype,
                                     device=w.a.device)[None, :]
                dia = dia + scale * (w.a / (yc * yc))
            if w.ds is not None:
                dia = dia + scale * w.ds.dia
            systems.append((f"viscous {'uv'[c]}", cfg.u_bcs[c],
                            tuple(scale * f for f in w.s), dia))
    out = []
    for name, fbc, alpha, dia in systems:
        alphas, dias = poisson._coeff_hierarchy(grid, 2, alpha, dia)
        out.append((name, poisson._signs_offs(grid, fbc, True)[0],
                    poisson._periodic(fbc), alphas, dias, grids))
    return out


def check_weighted_alpha(dev, rnd, dtype, errs):
    """K15 against its plain version on the levels of the moving disk (its
    order-1 geometry after its first step), the axisymmetric pipe and the
    stretched cavity, 2048^2 down to 4^2, with their coefficients
    (weighted_systems, check_alpha_systems)."""
    import torch
    from gerris_tpu_torch.models import ns
    for name, cfg in (("moving", moving_cfg(LEVEL_MOVING, 1)),
                      ("axi", axi_cfg(LEVEL_AXI)),
                      ("stretch", stretch_cfg(LEVEL_STRETCH))):
        z = torch.zeros(cfg.grid.shape, dtype=dtype, device=dev)
        dt = MOVING_DT * cfg.grid.h
        if cfg.moving_solid:
            w = ns._moving_weights(cfg, [z, z], dt, 0.0)[0]
        else:
            w = ns._weights(cfg, z)
        check_alpha_systems(name, weighted_systems(cfg, w, dt), w.a == 0.0,
                            rnd, dtype, errs)


def axi_poiseuille(dev, level=AXI_GATE_LEVEL, dtype=None):
    """tests/test_axi.py::test_axi_poiseuille on the port: at most 400 steps
    (dtmax 2e-2, solves to 1e-8), stopping when a step moves U by less
    than 1e-7.  Returns (steps, max|mean U(r) - G (1 - r^2) / (4 nu)| /
    max of it, max|V|)."""
    import torch
    s = axi_sim(dev, level, dtype or torch.float64, tol=1e-8, iend=400)
    prev = None
    for _ in range(400):
        s.run(max_steps=1)
        if prev is not None and \
                float((s.state["U"] - prev).abs().max()) < 1e-7:
            break
        prev = s.state["U"]
    y = s.cfg.grid.axis_centers(1)
    prof = s.state["U"].double().mean(dim=0).cpu().numpy()
    exact = AXI_G * (1.0 - y * y) / (4.0 * AXI_NU)
    return (s.time.i, float(np.abs(prof - exact).max() / exact.max()),
            float(s.state["V"].abs().max()))


def axi_poisson(dev, levels=(4, 5, 6)):
    """tests/test_axi.py::test_axi_poisson_order on the port in float64:
    div(r grad u) = r f with u = (1 - r^2)^2 on r in [0, 1], Neumann at the
    axis, Dirichlet 0 at r = 1, 10 cycles.  Returns the Linf errors."""
    import torch
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.models import ns
    from gerris_tpu_torch.solvers import poisson
    errs = []
    for lv in levels:
        g = Grid(level=lv, origin=(-0.5, 0.0))
        cm, fm = ns._axi_metric(g, dev, torch.float64)
        y = ns.cell_centers(g, dev, torch.float64)[1]
        fbc = bc.FieldBC(((bc.Neumann(), bc.Neumann()),
                          (bc.Neumann(), bc.Dirichlet(0.0))))
        u, _ = poisson.solve(torch.zeros(g.shape, dtype=torch.float64,
                                         device=dev),
                             cm * 8.0 * (2.0 * y * y - 1.0), g, fbc,
                             poisson.MultilevelParams(nitermin=10,
                                                      nitermax=10),
                             alpha=fm)
        errs.append(float((u - (1.0 - y * y) ** 2).abs().max()))
    return errs


def moving_rates(dev, level=MOVING_GATE_LEVEL, steps=(16, 32, 64)):
    """tests/test_moving.py::test_moving_order2_temporal_convergence on the
    port in float64: an oscillating disk (x_c = 0.08 sin(2 pi t)) to t =
    0.25 in each count of ``steps``, nu 0, solves to 1e-10 in at most 60
    cycles, from rest; per order the rate log2(e1 / e2) of the mean
    differences on the cells fluid at the end, e1 = the coarsest count's
    from the finest's, e2 the middle one's.  Returns {order: rate}."""
    import torch
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.models import ns
    from gerris_tpu_torch.physics import solid
    from gerris_tpu_torch.solvers.poisson import MultilevelParams
    A, W, T = 0.08, 2 * math.pi, 0.25
    grid = Grid(level=level)

    def phi(x, y, t):
        return torch.sqrt((x - A * math.sin(W * t)) ** 2 + y ** 2) - MOVING_R

    def us_u(x, y, t):
        return A * W * math.cos(W * t) + 0 * x

    proj = MultilevelParams(tolerance=1e-10, nitermax=60)
    fluid = solid.solid_fractions(grid, lambda x, y: phi(x, y, T), dev,
                                  torch.float64)[0] > 0.999

    def run(order, n):
        cfg = ns.NSConfig(
            grid=grid, u_bcs=(bc.FieldBC.uniform(bc.Neumann(), 2),
                              bc.FieldBC.uniform(bc.Dirichlet(0.0), 2)),
            solid_phi=phi, moving_solid=True, moving_order=order,
            surface_u=(us_u, 0.0), projection=proj, approx_projection=proj)
        z = torch.zeros(grid.shape, dtype=torch.float64, device=dev)
        s = {k: z for k in ("U", "V", "P", "Pmac", "Gx", "Gy")}
        dt, t = T / n, 0.0
        for i in range(n):
            s = ns.ns_step(s, dt, t, cfg, first_step=(i == 0))
            t += dt
        return s["U"], s["V"]

    rates = {}
    for order in (1, 2):
        sols = {n: run(order, n) for n in steps}
        e1, e2 = (max(float((sols[n][k] - sols[steps[-1]][k]).abs()[fluid]
                            .mean()) for k in range(2)) for n in steps[:2])
        rates[order] = math.log2(e1 / e2)
    return rates


def galilean(dev, level=GALILEAN_LEVEL, steps=8):
    """tests/test_moving.py::test_galilean_uniform_flow on the port in
    float64: a disk moving at (1, 0) through a co-moving uniform stream, x
    periodic, 8 steps of 0.25 h.  Returns (max|U - 1|, max|V|) on the far
    fluid cells (r > 0.35) and on every fluid cell."""
    import torch
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.models import ns
    from gerris_tpu_torch.physics import solid
    from gerris_tpu_torch.solvers.poisson import MultilevelParams
    grid = Grid(level=level)
    per = (bc.Periodic(), bc.Periodic())
    uper = bc.FieldBC((per, (bc.Neumann(), bc.Neumann())))
    vper = bc.FieldBC((per, (bc.Dirichlet(0.0), bc.Dirichlet(0.0))))

    def phi(x, y, t):
        return torch.sqrt((torch.remainder(x - t + 0.5, 1.0) - 0.5) ** 2
                          + y ** 2) - MOVING_R

    proj = MultilevelParams(tolerance=1e-9, nitermax=50)
    cfg = ns.NSConfig(grid=grid, u_bcs=(uper, vper), solid_phi=phi,
                      moving_solid=True, surface_u=(1.0, 0.0),
                      projection=proj, approx_projection=proj)
    z = torch.zeros(grid.shape, dtype=torch.float64, device=dev)
    s = {"U": z + 1.0, "V": z, "P": z, "Pmac": z, "Gx": z, "Gy": z}
    dt, t = 0.25 * grid.h, 0.0
    for i in range(steps):
        s = ns.ns_step(s, dt, t, cfg, first_step=(i == 0))
        t += dt
    a = solid.solid_fractions(grid, lambda x, y: phi(x, y, t), dev,
                              torch.float64)[0]
    fluid = a > 0.99
    x, y = ns.cell_centers(grid, dev, torch.float64)
    r = torch.sqrt((torch.remainder(x - t + 0.5, 1.0) - 0.5) ** 2 + y ** 2)
    far = fluid & (r > 0.35)
    du, v = (s["U"] - 1.0).abs(), s["V"].abs()
    return (float(du[far].max()), float(v[far].max()),
            float(du[fluid].max()), float(v[fluid].max()))


def buoyancy(dev, level=6):
    """tests/test_rigid.py::test_hydrostatic_buoyancy_force on the port in
    float64: a disk of radius 0.2 in P = 2.5 y.  Returns (Fx, Fy, the
    exact Fy = -2.5 pi R^2)."""
    import torch
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.models import ns, rigid
    R, c = 0.2, 2.5

    def phi(x, y, t, cx, cy, vx, vy):
        return torch.sqrt((x - cx) ** 2 + (y - cy) ** 2) - R

    grid = Grid(level=level)
    cfg = ns.NSConfig(grid=grid, u_bcs=walls(), solid_phi=phi,
                      moving_solid=True)
    y = ns.cell_centers(grid, dev, torch.float64)[1]
    z = torch.zeros(grid.shape, dtype=torch.float64, device=dev)
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    fx, fy = rigid.solid_force({"P": c * y, "U": z, "V": z}, cfg, 0.0,
                               (zero,) * 4)
    return float(fx), float(fy), -c * math.pi * R ** 2


def stretch_poisson(dev, levels=(5, 6), sy=0.4):
    """tests/test_metric.py::test_stretch_poisson_order on the port in
    float64: cos(pi x) cos(pi y) on the box stretched by (1, sy),
    Dirichlet 0, solves to 1e-11.  Returns the Linf errors."""
    import torch
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.core.metric import MetricStretch
    from gerris_tpu_torch.models import ns
    from gerris_tpu_torch.solvers import poisson
    errs = []
    for lv in levels:
        g = Grid(level=lv)
        x, y = ns.cell_centers(g, dev, torch.float64)
        exact = torch.cos(math.pi * x) * torch.cos(math.pi * y)
        cm, fm = MetricStretch(1.0, sy).weights(g, dev)
        u, _ = poisson.solve(
            torch.zeros_like(exact),
            cm * (-(math.pi ** 2) * (1.0 + 1.0 / sy ** 2) * exact), g,
            bc.FieldBC.uniform(bc.Dirichlet(0.0), 2),
            poisson.MultilevelParams(tolerance=1e-11, nitermax=60),
            alpha=fm)
        errs.append(float((u - exact).abs().max()))
    return errs


def lonlat_poisson(dev, levels=(5, 6)):
    """tests/test_metric.py::test_lonlat_poisson on the port in float64:
    sin(lat) on the latitude band [-pi/4, pi/4] (MetricLonLat(pi / 2)),
    its value on the band's edges, solves to 1e-11.  Returns the Linf
    errors."""
    import torch
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.core.metric import MetricLonLat
    from gerris_tpu_torch.models import ns
    from gerris_tpu_torch.solvers import poisson
    scale = math.pi / 2.0

    def blat(x, y, t=0.0):
        return torch.sin(y * scale)

    errs = []
    for lv in levels:
        g = Grid(level=lv)
        y = ns.cell_centers(g, dev, torch.float64)[1]
        cm, fm = MetricLonLat(scale).weights(g, dev)
        fbc = bc.FieldBC(((bc.Neumann(), bc.Neumann()),
                          (bc.Dirichlet(blat), bc.Dirichlet(blat))))
        u, _ = poisson.solve(
            torch.zeros_like(y), cm * scale * scale * (-2.0 * torch.sin(
                y * scale)), g, fbc,
            poisson.MultilevelParams(tolerance=1e-11, nitermax=60), alpha=fm)
        errs.append(float((u - torch.sin(y * scale)).abs().max()))
    return errs


def axi_gate(dev, card):
    """The axi Poiseuille (AXI_GATE_LEVEL, float64) within
    AXI_POISEUILLE_RTOL of u(r) and V below 1e-6, and the axi Poisson's
    order above AXI_ORDER_MIN, its error below AXI_ERR_MAX."""
    t0 = time.perf_counter()
    steps, err, vmax = axi_poiseuille(dev)
    errs = axi_poisson(dev)
    order = math.log2(errs[-2] / errs[-1])
    print(f"phase 4, axi gate: float64, {time.perf_counter() - t0:.1f} s on "
          f"{card}: the Poiseuille pipe at level {AXI_GATE_LEVEL} after "
          f"{steps} steps, max|U(r) - exact| / max exact {err:.3e} (bound "
          f"{AXI_POISEUILLE_RTOL}), max|V| {vmax:.3e} (bound 1e-6); the "
          f"Poisson's errors {errs}, order {order:.4f} (bound > "
          f"{AXI_ORDER_MIN}, error < {AXI_ERR_MAX})")
    if not (err < AXI_POISEUILLE_RTOL and vmax < 1e-6
            and order > AXI_ORDER_MIN and errs[-1] < AXI_ERR_MAX):
        raise AssertionError(f"axi gate: {err}, {vmax}, {errs}")


def moving_gate(dev, card):
    """The moving disk's temporal rates (order 2 above order 1 +
    MOVING_RATE_GAIN, level MOVING_GATE_LEVEL), the Galilean disk's far
    field within GALILEAN_FAR (and every fluid cell within 0.6), and the
    buoyancy force within BUOYANCY_RTOL, float64."""
    t0 = time.perf_counter()
    rates = moving_rates(dev)
    gal = galilean(dev)
    fx, fy, exact = buoyancy(dev)
    print(f"phase 4, moving gate: float64, {time.perf_counter() - t0:.1f} s "
          f"on {card}: temporal rates at level {MOVING_GATE_LEVEL}, order 1 "
          f"{rates[1]:.4f}, order 2 {rates[2]:.4f} (bound: order 1 + "
          f"{MOVING_RATE_GAIN}); the Galilean disk at level "
          f"{GALILEAN_LEVEL}, far field max|U - 1| {gal[0]:.4f}, max|V| "
          f"{gal[1]:.4f} (bound {GALILEAN_FAR}), every fluid cell "
          f"{gal[2]:.4f}, {gal[3]:.4f} (bound 0.6); buoyancy ({fx:.6f}, "
          f"{fy:.6f}) against (0, {exact:.6f}) (bound {BUOYANCY_RTOL})")
    if not (rates[2] > rates[1] + MOVING_RATE_GAIN
            and max(gal[:2]) < GALILEAN_FAR and max(gal[2:]) < 0.6
            and abs(fx) < 0.02 * abs(exact)
            and abs(fy - exact) < BUOYANCY_RTOL * abs(exact)):
        raise AssertionError(f"moving gate: {rates}, {gal}, {fx}, {fy}")


def metric_gate(dev, card):
    """The stretch Poisson's order within STRETCH_ORDER and the lon-lat
    one's above LONLAT_ORDER_MIN with its error below LONLAT_ERR_MAX,
    float64, levels 5 and 6."""
    t0 = time.perf_counter()
    es, el = stretch_poisson(dev), lonlat_poisson(dev)
    os_, ol = math.log2(es[0] / es[1]), math.log2(el[0] / el[1])
    print(f"phase 4, metric gate: float64, {time.perf_counter() - t0:.1f} s "
          f"on {card}: the stretch Poisson's errors {es}, order {os_:.4f} "
          f"(bound {STRETCH_ORDER}); the lon-lat one's {el}, order "
          f"{ol:.4f} (bound > {LONLAT_ORDER_MIN}, error < {LONLAT_ERR_MAX})")
    if not (STRETCH_ORDER[0] < os_ < STRETCH_ORDER[1]
            and ol > LONLAT_ORDER_MIN and el[-1] < LONLAT_ERR_MAX):
        raise AssertionError(f"metric gate: {es}, {el}")


def gate_jobs():
    """The host-bound physics gates that run as child processes of this
    script beside phase 4's others (each a few hundred to a few thousand
    steps on grids of 16^2 to 64 x 192, where a step is a few thousand
    device ops paced by the host), each entry one process running its
    comma-separated gates in turn: the oscillation (level 6), the
    capwave gate at levels 4, 5 and 6, the sessile gate at each angle,
    the AMR gates (the oscillation pinned and composite, the capillary
    wave at levels 4 and 5), the circle gate (levels 7-9), the circle
    against gerris_tpu (level 6), the Couette gate, the axi, moving and
    metric gates and the AMR interface-not-pinned gate.  Eight processes
    (the card's host has 8 cores and this process keeps one busy), the
    gates packed by their seconds on the card's host beside each other
    (~430 s for a sessile angle, ~300 for the AMR oscillation, ~100 for
    the capwave at level 4 or 5).  They start after the last timed
    window and profile of phase 3: nothing they run shares the card with
    a measurement."""
    short = ["circle_9", "circlejax_6", f"couette_{COUETTE_LEVEL}",
             "metric_6", f"amrpinned_{AMR_PINNED_LEVEL}"]
    return ([f"sessile_{a:g}" for a in SESSILE_ANGLES]
            + [f"capwave_6,moving_{MOVING_GATE_LEVEL}",
               ",".join(["amrosc_1", f"axi_{AXI_GATE_LEVEL}", *short]),
               "amrcap_5,capwave_5", "amrosc_0,capwave_4", "amrcap_4",
               "oscillation_6"])


def run_gate(name, dev, card):
    """One job of gate_jobs in this process."""
    kind, arg = name.split("_")
    if kind == "oscillation":
        phase_oscillation(dev, card)
    elif kind == "capwave":
        capwave_gate(dev, card, int(arg))
    elif kind == "sessile":
        sessile_gate(dev, card, float(arg))
    elif kind == "circle":
        circle_gate(dev, card)
    elif kind == "circlejax":
        circle_jax_gate(dev, card)
    elif kind == "axi":
        axi_gate(dev, card)
    elif kind == "moving":
        moving_gate(dev, card)
    elif kind == "metric":
        metric_gate(dev, card)
    elif kind == "amrosc":
        amr_osc_gate(dev, card, arg == "1")
    elif kind == "amrcap":
        amr_capwave_gate(dev, card, int(arg))
    elif kind == "amrpinned":
        amr_pinned_gate(dev, card)
    else:
        couette_gate(dev, card, int(arg))


def start_gates(names):
    """Start each gate job as a child process (python3 chip_smoke.py
    --gate NAME[,NAME...]), its output piped."""
    import os
    here = os.path.abspath(__file__)
    # one host thread each: the jobs' host work is their dispatch
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return {n: subprocess.Popen([sys.executable, here, "--gate", n],
                                stdout=subprocess.PIPE, env=env,
                                stderr=subprocess.STDOUT, text=True)
            for n in names}


def finish_gates(procs, t_start, timeout=GATE_TIMEOUT):
    """Wait for the gate jobs (within ``timeout`` s of ``t_start``), print
    each one's output and seconds, and check the capwave order; any job
    that failed or overran fails the run."""
    outs, failed = [], []
    for name, p in procs.items():
        left = max(1.0, timeout - (time.perf_counter() - t_start))
        try:
            out, _ = p.communicate(timeout=left)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            failed.append(f"{name} (over {timeout:.0f} s)")
        print(out.rstrip())
        print(f"phase 4, gate job {name}: exit {p.returncode}, done "
              f"{time.perf_counter() - t_start:.1f} s after the jobs' start")
        if p.returncode != 0 and name not in str(failed):
            failed.append(name)
        outs.append(out)
    if failed:
        raise AssertionError(f"gate jobs failed: {failed}")
    capwave_order(outs)
    amr_capwave_order(outs)


def stop_gates(procs):
    """Kill every gate job still running (the run failed before them)."""
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()

def droplet3d_cfg(level, dense_coarse_max=4096):
    """tests/test_vof3d.py::test_static_droplet_3d at 2^level cells per
    side (LEVEL_DROPLET3D's comment), the dense coarsest solve at the
    finest level of at most ``dense_coarse_max`` unknowns."""
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.models import ns
    from gerris_tpu_torch.solvers.advection import AdvectionParams
    from gerris_tpu_torch.solvers.poisson import MultilevelParams
    proj = MultilevelParams(tolerance=1e-6, nitermax=50,
                            dense_coarse_max=dense_coarse_max)
    return ns.NSConfig(
        grid=Grid(level=level, dim=3),
        u_bcs=tuple(bc.velocity_bc(c, 3) for c in range(3)), nu=0.1,
        beta=1.0, advection=AdvectionParams(scheme="none"),
        vof_tracers=(("T", bc.default_scalar_bc(3)),), tension=(("T", 1.0),),
        projection=proj, approx_projection=proj,
        diffusion_params=MultilevelParams(tolerance=1e-3, nitermax=10,
                                          dense_coarse_max=dense_coarse_max))


def droplet3d_sim(dev, level=None, dtype=None, end=math.inf,
                  dense_coarse_max=4096):
    """The 3D droplet at rest on the card at ``level`` (LEVEL_DROPLET3D by
    default) in ``dtype`` (float32 by default), dt from Simulation (the
    capillary bound), not yet run."""
    import torch
    from gerris_tpu_torch.models.simulation import Simulation, Time
    from gerris_tpu_torch.physics import vof
    dtype = dtype or torch.float32
    cfg = droplet3d_cfg(level or LEVEL_DROPLET3D, dense_coarse_max)
    r2 = DROPLET3D_R ** 2
    T0 = vof.fraction_from_levelset(
        cfg.grid, lambda x, y, z: r2 - (x * x + y * y + z * z), device=dev,
        dtype=dtype)
    return Simulation(cfg, time=Time(end=end), device=dev,
                      dtype=dtype).init(T=T0)


def want_k13(counts, cycles):
    """K13's launches for ``cycles`` corrections of K13_LEVELS folded
    launches each, and no other kernel's."""
    want = {k: 0 for k in counts}
    k13 = K13_LEVELS * cycles
    want.update({"rbgs_relax_3d": k13, "rbgs_relax_3d.launch": k13,
                 "rbgs_relax_3d.prolong": k13})
    return want


def phase_droplet3d(dev, card):
    """init + DROPLET3D_STEPS steps of the 3D droplet at 128^3 in float32
    through the kernels, the counts set to 0 just before and gated just
    after from every solve's recorded cycle count (want_k13: K13 only,
    no 2D kernel); finite values; the first DROPLET3D_CHECK_STEPS steps
    against the plain versions (check_against_plain: float64 to 1e-9 on
    U, V, W, T and mean-free P), T's volume over them in float64; five
    timed windows and a profile with K13's share.  Returns the launch
    counts."""
    import torch
    n = 1 << LEVEL_DROPLET3D
    print(f"phase 3, droplet3d: the 3D static droplet "
          f"(test_static_droplet_3d), {n}^3, float32, init + "
          f"{DROPLET3D_STEPS} steps")
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording_solves() as log:
        s = droplet3d_sim(dev)
        s.run(max_steps=DROPLET3D_CHECK_STEPS)
        early = {k: v.clone() for k, v in s.state.items()}
        s.run(max_steps=DROPLET3D_STEPS - DROPLET3D_CHECK_STEPS)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    counts = launch_counts()
    niters = [x[1] for x in log]
    print(f"  droplet3d, init + {DROPLET3D_STEPS} steps (the first builds "
          f"the dense 16^3 solves): {t_run:.3f} s; {len(niters)} solves, "
          f"niter {niters}; host syncs {sum(x[3] for x in log)}; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    if len(niters) != 5 * DROPLET3D_STEPS + 1:
        raise AssertionError(f"droplet3d: {len(niters)} solves")
    want = want_k13(counts, sum(niters))
    if counts != want:
        raise AssertionError(f"droplet3d: launches {counts}, want {want}")
    print(f"  droplet3d: rbgs_relax_3d {counts['rbgs_relax_3d']} launches "
          f"= {K13_LEVELS} x sum(niter) {sum(niters)}, all with the "
          "coarser level's correction prolonged in the kernel")
    for k, v in s.state.items():
        if v.shape != (n, n, n) or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"droplet3d {k}: not finite or wrong shape")
    u = torch.sqrt(s.state["U"] ** 2 + s.state["V"] ** 2 + s.state["W"] ** 2)
    print(f"  droplet3d: t {s.time.t:.6e} after {s.time.i} steps, dt "
          f"{s.dt:.6e}; max|u| {float(u.max()):.6e}")
    runs = check_against_plain(
        "droplet3d", lambda dtype: droplet3d_sim(dev, dtype=dtype),
        DROPLET3D_CHECK_STEPS, early, 1e-9,
        keys=("U", "V", "W", "T", "P"), defer=False)
    del early
    T0 = droplet3d_sim(dev, dtype=torch.float64).state["T"]
    vol0 = float(T0.sum())
    for run in ("kernels64", "plain64"):
        drift = abs(float(runs[run]["T"].sum()) - vol0) / vol0
        print(f"  droplet3d, {run}: T's volume rel change after "
              f"{DROPLET3D_CHECK_STEPS} steps {drift:.3e} (bound "
              f"{DROPLET3D_VOLUME_RTOL:.0e})")
        if not drift <= DROPLET3D_VOLUME_RTOL:
            raise AssertionError(f"droplet3d: T's volume {drift:.3e}")
    del runs, T0
    step = timed_windows("droplet3d", s, DROPLET3D_TIMED_STEPS, card, n ** 3)
    kinds = {}
    phase_profile(s, step, card, DROPLET3D_PROFILE_STEPS, watch=("rbgs3d_",),
                  kinds=kinds)
    print(f"  droplet3d: K13 kernels {kinds['rbgs3d_']:.1f} per step on the "
          "card")
    if not kinds["rbgs3d_"] > 0:
        raise AssertionError("droplet3d: no K13 kernel in the profile")
    vof_ops(s)
    return counts


def device_ops(fn):
    """The device ops (kernels, copies, sets) that one call of ``fn``
    runs, counted by torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def vof_ops(s):
    """The device ops of a 3D two-phase step's VOF modules on the running
    ``s``'s state: one advection (three sweeps, each one 40-step
    bisection of the plane's alpha), one bisection alone, and the
    tension sources (the 3D curvature, its fill and the faces); the
    counts depend on the shapes only."""
    import torch
    from gerris_tpu_torch.models import ns
    from gerris_tpu_torch.physics import vof
    cfg, T = s.cfg, s.state["T"]
    g, fbc = cfg.grid, cfg.vof_tracers[0][1]
    uf = [torch.zeros(g.face_shape(a), dtype=T.dtype, device=T.device)
          for a in range(g.dim)]
    ops = dict(advect=device_ops(lambda: vof.advect(T, uf, g, fbc, s.dt)),
               bisection=device_ops(lambda: vof.plane_alpha_positive(
                   T, T, T, T)),
               tension=device_ops(lambda: ns.tension_sources(s.state, cfg)))
    print("  " + ", ".join(f"{k} {v}" for k, v in ops.items())
          + " device ops a call on the card")


def phase_droplet3d_gate(dev, card):
    """The physics gate: test_static_droplet_3d's own run (level 4,
    float64, DROPLET3D_GATE_STEPS steps to end time 1, dense at 8^3) on
    the card: max|u| and max|T - T0| within JAX_RTOL of the JAX
    package's values (JAX_DROPLET3D) and inside the test's bounds."""
    import torch
    t0 = time.perf_counter()
    reset_launch_counts()
    s = droplet3d_sim(dev, DROPLET3D_GATE_LEVEL, torch.float64, end=1.0,
                      dense_coarse_max=1024)
    T0 = s.state["T"].clone()
    s.run(max_steps=DROPLET3D_GATE_STEPS)
    k13 = launch_counts()["rbgs_relax_3d"]
    st = s.state
    got = dict(umax=float((st["U"] ** 2 + st["V"] ** 2 + st["W"] ** 2)
                          .sqrt().max()),
               shape_err=float((st["T"] - T0).abs().max()))
    print(f"phase 4, droplet3d gate: level {DROPLET3D_GATE_LEVEL}, float64, "
          f"t = {s.time.t:.12f} after {s.time.i} steps (gerris_tpu "
          f"{JAX_DROPLET3D['t']:.12f}), {k13} K13 launches, "
          f"{time.perf_counter() - t0:.1f} s on {card}")
    for key, what, bound in (("umax", "max|u|", DROPLET3D_UMAX_MAX),
                             ("shape_err", "shape error max|T - T0|",
                              DROPLET3D_SHAPE_MAX)):
        ref = JAX_DROPLET3D[key]
        rel = abs(got[key] - ref) / ref
        print(f"  droplet3d gate, {what}: {got[key]:.6e}; gerris_tpu level "
              f"{DROPLET3D_GATE_LEVEL} f64 {ref:.6e} (rel {rel:.2e}, bound "
              f"{JAX_RTOL}); the test's bound {bound}")
        if not (rel <= JAX_RTOL and got[key] < bound):
            raise AssertionError(f"droplet3d gate: {what} {got[key]:.6e}")
    if s.time.i != DROPLET3D_GATE_STEPS or \
            abs(s.time.t - JAX_DROPLET3D["t"]) > 1e-12 or not k13:
        raise AssertionError(f"droplet3d gate: t = {s.time.t}, {k13} K13")


def bubble3d_cfg(level=None):
    """The 3D bubble (LEVEL_BUBBLE3D's comment) at 2^level cells per
    unit (LEVEL_BUBBLE3D by default): each component Dirichlet on its own
    walls and at y = 0 and 2, Neumann elsewhere; NSConfig's default adaptive projections and
    diffusion (in 3D the TPU's schedule carries no floor: utils/convert)."""
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.models import ns
    d0, nn = bc.Dirichlet(0.0), bc.Neumann()
    return ns.NSConfig(
        grid=Grid(level=level or LEVEL_BUBBLE3D, dim=3,
                  origin=(0.0, 0.0, 0.0), extents=(1, 2, 1)),
        u_bcs=tuple(bc.FieldBC(tuple((d0, d0) if a in (c, 1) else (nn, nn)
                                     for a in range(3))) for c in range(3)),
        nu=0.0, beta=1.0, vof_tracers=(("T", bc.default_scalar_bc(3)),),
        tension=(("T", 24.5),), density=("T", 1000.0, 100.0, 1),
        body_force=(None, -0.98, None), nu_var=bubble_mu,
        nu_var_fields=(("T1", "T", 1),))


def bubble3d_sim(dev, level=None, dtype=None):
    """The 3D bubble on ``dev`` at ``level`` (LEVEL_BUBBLE3D by default) in
    ``dtype`` (float32 by default), at rest, not yet run."""
    import torch
    from gerris_tpu_torch.models.simulation import Simulation, Time
    from gerris_tpu_torch.physics import vof
    dtype = dtype or torch.float32
    cfg = bubble3d_cfg(level)
    T0 = vof.fraction_from_levelset(
        cfg.grid, lambda x, y, z: torch.sqrt(
            (x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2) - 0.25,
        device=dev, dtype=dtype)
    return Simulation(cfg, time=Time(), device=dev, dtype=dtype).init(T=T0)


def phase_bubble3d(dev, card):
    """init + BUBBLE3D_STEPS steps of the 3D bubble at 128 x 256 x 128 in
    float32, the counts set to 0 just before and read just after (no
    kernel lies on its path: every count 0); finite values; the first
    step against the plain runs (check_against_plain, the bubble's rule,
    float64 to BUBBLE_F64_RTOL); at 16 x 32 x 16 in float64, 3 steps on
    the card against the port's CPU run of the same steps
    (BUBBLE_F64_RTOL); five timed windows and a profile."""
    import torch
    n0, n1, n2 = bubble3d_cfg().grid.shape
    print(f"phase 3, bubble3d: Hysing test case 1 in 3D, {n0} x {n1} x "
          f"{n2}, float32, init + {BUBBLE3D_STEPS} steps")
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording_solves() as log:
        s = bubble3d_sim(dev)
        s.run(max_steps=BUBBLE3D_CHECK_STEPS)
        early = {k: v.clone() for k, v in s.state.items()}
        s.run(max_steps=BUBBLE3D_STEPS - BUBBLE3D_CHECK_STEPS)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    counts = launch_counts()
    niters = [x[1] for x in log]
    print(f"  bubble3d, init + {BUBBLE3D_STEPS} steps: {t_run:.3f} s; "
          f"{len(niters)} solves, niter {niters}; host syncs "
          f"{sum(x[3] for x in log)}")
    if len(niters) != 5 * BUBBLE3D_STEPS + 1:
        raise AssertionError(f"bubble3d: {len(niters)} solves")
    if any(counts.values()):
        raise AssertionError(f"bubble3d: kernels launched {counts}")
    for k, v in s.state.items():
        if v.shape != (n0, n1, n2) or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"bubble3d {k}: not finite or wrong shape")
    print(f"  bubble3d: t {s.time.t:.6e} after {s.time.i} steps, dt "
          f"{s.dt:.6e}; max|V| {float(s.state['V'].abs().max()):.6e}")
    check_against_plain("bubble3d", lambda dtype: bubble3d_sim(dev,
                                                               dtype=dtype),
                        BUBBLE3D_CHECK_STEPS, early, BUBBLE_F64_RTOL,
                        keys=("U", "V", "W", "T", "P"))
    del early
    t0 = time.perf_counter()
    small = [bubble3d_sim(d, BUBBLE3D_CPU_LEVEL, torch.float64).run(
        max_steps=BUBBLE3D_CPU_STEPS).state for d in (dev, "cpu")]
    for k in ("U", "V", "W", "T", "P"):
        a, b = small[0][k].cpu(), small[1][k]
        if k == "P":
            a, b = a - a.mean(), b - b.mean()
        rel = rel_err(a, b)
        print(f"  bubble3d, {BUBBLE3D_CPU_STEPS} steps at level "
              f"{BUBBLE3D_CPU_LEVEL}, float64, the card vs the CPU, {k}"
              f"{' (mean-free)' if k == 'P' else ''}: rel {rel:.3e} (bound "
              f"{BUBBLE_F64_RTOL:.0e})")
        if not rel <= BUBBLE_F64_RTOL:
            raise AssertionError(f"bubble3d card vs CPU {k}: rel {rel:.3e}")
    print(f"  bubble3d: card vs CPU runs {time.perf_counter() - t0:.1f} s")
    step = timed_windows("bubble3d", s, BUBBLE3D_TIMED_STEPS, card,
                         n0 * n1 * n2)
    phase_profile(s, step, card, BUBBLE3D_PROFILE_STEPS)
    vof_ops(s)
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
    want.update({k: levels * st.niter for k in (
        "rbgs_relax_3d", "rbgs_relax_3d.launch", "rbgs_relax_3d.prolong")})
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


# ---------------------------------------------------------------------------
# slice 5: composite AMR (gerris_tpu_torch/models/amr_ns.py)
# ---------------------------------------------------------------------------
# amr_osc: tests/test_amr_ns.py:run_oscillation_amr's droplet at maxlevel
# 10 (1024^2 at the finest, base 8^2), adapting every step on
# interface_vorticity_criterion (cmax 0.01, minlevel 3), density 1 /
# 1e-3, sigma 1, composite_vof and block_advect on the block engine: its
# projections' base corrections run K15 (levels 2-3), its predictor K6
# and its face interpolation K9 on every level; the initial projection
# (the uniform 1024^2 start) runs the dense engine's K15 sweeps on every
# level.  amr_capwave: capwave_mesh(10), test/capwave's graded static
# mesh, 1024 x 3072 at the finest on the 1 x 3 box (base (8, 24)),
# periodic in x, nu and sigma as CAPWAVE_*, the solves to 1e-6: the
# dense engine, K11 for every level's residual and one K10 per sweep on
# every level above the base; the base (8, 24) is solved dense (192
# unknowns under dense_coarse_max), so no pyramid, K12 or K3 launches;
# K6 and K9 refuse its periodic rows.  init + AMR_STEPS steps each in
# float32, the first AMR_CHECK_STEPS held to the plain versions
LEVEL_AMR = 10
AMR_STEPS = 5
AMR_CHECK_STEPS = 2
AMR_TIMED_STEPS = 1
# the AMR routes' timed windows: three of TIMED_WINDOWS' five since slice
# 6, whose route and gates took the script past its clock
AMR_TIMED_WINDOWS = 3
AMR_PROFILE_STEPS = 1
AMR_F64_RTOL = 1e-9
AMR_OSC_MINLEVEL = 3
# host syncs of one step beyond its solves' loop conditions: the CFL dt's
# read, and with adaptation the costs' one transfer to the host and the
# masks' and block tables' one copy each to the card
AMR_SYNCS = {"amr_osc": 4, "amr_capwave": 1}
# physics gates (gate_jobs, float64): tests/test_amr_ns.py's oscillation
# frequency and its composite twin (composite_vof, no block_advect, as
# the test runs it) at level 5: level 6, the test's, takes ~1300 steps
# at ~0.8 s of host time each on the card, past GATE_TIMEOUT, and at
# level 5 the JAX package's own AMR gives c 4.4% under the test's table
# (REF_C[5] = 152.80; ROADMAP Queue 3), so c is held within JAX_RTOL of
# the JAX package's level-5 fit (JAX_AMR_OSC5: tools/amr_reference.py
# --oscillation 5, float64 on the CPU) and within AMR_OSC_TABLE_RTOL of
# the table, b > 0, the mean leaves below 0.55 of the uniform count;
# test_capwave_amr_
# convergence at levels 4 and 5 (the RMS within 25% of the table, the
# order above 1.5, the level-5 leaves below 0.75 of uniform);
# test_adaptive_twophase_interface_not_pinned (level 6: the volume within
# 5e-3, some interface cells on coarser leaves, T within [-1e-6, 1 +
# 1e-6]); and test_blockrt_walltime_scales_with_leaves's measure (the
# block solve's time between ring meshes at lmax 8 and 9 grows < 3x)
AMR_OSC_GATE_LEVEL = 5
AMR_OSC_REF_C = 152.80
# the test's 1.5% plus the JAX package's own miss of the level-5 table
# (JAX_AMR_OSC5: 4.44%)
AMR_OSC_TABLE_RTOL = 0.015 + 0.045
JAX_AMR_OSC5 = {False: dict(c=146.01980616729338, b=1.4578208830119996),
                True: dict(c=146.08669944025036, b=1.4669175453412986)}
AMR_LEAF_RATIO = 0.55
AMR_CAPWAVE_RTOL = 0.25
AMR_CAPWAVE_LEAF_RATIO = 0.75
AMR_PINNED_LEVEL = 6
AMR_PINNED_MASS_RTOL = 5e-3
LEAF_SCALING_MAX = 3.0


class AMRRun:
    """An AMRSimulation as check_against_plain and phase_profile take a
    run: ``run`` returns the run, ``state`` is the finest level of every
    field (synced, so slaves hold the coarser leaves' data)."""

    def __init__(self, sim):
        self.sim = sim

    def run(self, max_steps=None):
        self.sim.run(max_steps=max_steps)
        return self

    @property
    def state(self):
        return {n: self.sim.fine(n) for n in self.sim.state}


def amr_osc_cfg(level, composite=True, block_advect=None):
    """run_oscillation_amr's configuration (tests/test_amr_ns.py):
    velocity_bc walls, nu 0, sigma 1, density 1 / 1e-3 of the once
    filtered fraction, the projections to 1e-4 in at most 100 cycles;
    ``composite``: composite_vof, and block_advect unless
    ``block_advect`` says otherwise."""
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.models import ns
    from gerris_tpu_torch.solvers.poisson import MultilevelParams
    proj = MultilevelParams(tolerance=1e-4, nitermax=100)
    return ns.NSConfig(
        grid=Grid(level=level), u_bcs=walls(), nu=0.0,
        vof_tracers=(("T", bc.default_scalar_bc(2)),),
        tension=(("T", OSC_SIGMA),), density=("T", OSC_RHO_L, OSC_RHO_G, 1),
        composite_vof=composite,
        block_advect=composite if block_advect is None else block_advect,
        projection=proj, approx_projection=proj)


def osc_phi(x, y):
    """test/oscillation's droplet (fluid inside), torch."""
    import torch
    xx, yy = x + 0.5, y + 0.5
    r = OSC_D / 2.0 * (1.0 + OSC_EPS * torch.cos(2.0 * torch.atan2(yy, xx)))
    return r * r - (xx * xx + yy * yy)


def amr_osc_sim(dev, level=None, dtype=None, composite=True, events=(),
                end=math.inf, block_advect=None):
    """The adaptive oscillating droplet on ``dev`` at maxlevel ``level``
    (LEVEL_AMR), not yet run."""
    import torch
    from gerris_tpu_torch.models.amr_ns import (
        AdaptSpec, AMRSimulation, interface_vorticity_criterion)
    from gerris_tpu_torch.models.simulation import Time
    from gerris_tpu_torch.physics import vof
    dtype = dtype or torch.float32
    cfg = amr_osc_cfg(level or LEVEL_AMR, composite, block_advect)
    adapt = AdaptSpec(criterion=interface_vorticity_criterion, cmax=0.01,
                      minlevel=AMR_OSC_MINLEVEL, maxlevel=cfg.grid.level,
                      istep=1)
    s = AMRSimulation(cfg, adapt=adapt, time=Time(end=end), device=dev,
                      dtype=dtype, events=list(events))
    return s.init(T=vof.fraction_from_levelset(cfg.grid, osc_phi,
                                               device=dev, dtype=dtype))


def capwave_mesh(level):
    """test/capwave's graded static mesh, Refine floor(LEVEL + 1 - (LEVEL
    - 2) |y| / 1.5) (capwave.gfs:65) on the 1 x 3 box, base level 3."""
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.solvers.composite import CompositeGrid
    base = Grid(level=3, origin=(-0.5, -1.5), extents=(1, 3))
    return CompositeGrid.from_refine_fn(base, level, lambda x, y, l: np.floor(
        level + 1 - (level - 2) * np.abs(y) / 1.5) > l)


def amr_capwave_sim(dev, level=None, dtype=None, events=(), end=math.inf):
    """The capillary wave on capwave_mesh(level) (LEVEL_AMR), not yet
    run."""
    import torch
    from gerris_tpu_torch.models.amr_ns import AMRSimulation
    from gerris_tpu_torch.models.simulation import Time
    from gerris_tpu_torch.physics import vof
    dtype = dtype or torch.float32
    level = level or LEVEL_AMR
    cfg = capwave_cfg(level)
    s = AMRSimulation(cfg, mesh=capwave_mesh(level), time=Time(end=end),
                      device=dev, dtype=dtype, events=list(events))
    return s.init(T=vof.fraction_from_levelset(
        cfg.grid, lambda x, y: y - CAPWAVE_A0 * torch.cos(2 * math.pi * x),
        device=dev, dtype=dtype))


AMR_ROUTES = {"amr_osc": amr_osc_sim, "amr_capwave": amr_capwave_sim}


@contextlib.contextmanager
def recording_amr_solves():
    """Record every composite solve of the block: (engine "dense" or
    "block", niter, face coefficients or not, host syncs)."""
    from gerris_tpu_torch.solvers import amr
    saved = amr.solve, amr.solve_block
    log = []

    def wrap(fn, engine):
        def recorded(*args, **kw):
            out = fn(*args, **kw)
            log.append((engine, out[1].niter, kw.get("alpha") is not None,
                        out[1].host_syncs))
            return out
        return recorded

    amr.solve, amr.solve_block = wrap(saved[0], "dense"), \
        wrap(saved[1], "block")
    try:
        yield log
    finally:
        amr.solve, amr.solve_block = saved


def want_amr(name, solves, steps, lmin, lmax, nrelax=4):
    """Launches of init + ``steps`` steps of an AMR route from its
    composite solves, recorded as (engine, niter, alpha):
    * a dense solve's cycle: with face coefficients two base corrections,
      each one pyramid launch (8^2 -> 4^2) and two K15 levels (2 and 3,
      the upper one with the prolongation folded in), and nrelax K15
      sweeps on each level above the base; else
      (capwave) K11 on every level for the leaf residual and again for
      its check, one K11 in each base correction, nrelax K10 sweeps on
      each level above the base (the base solved dense);
    * a block solve's cycle (face coefficients, amr_osc): the same two
      base corrections, nothing else (the blocks are torch);
    * amr_osc: K6 on every level each step, K9 on every level each step
      and at init."""
    w = {k: 0 for k in want_launches("pair", 0)}
    nlev = lmax - lmin + 1
    for engine, niter, alpha in solves:
        if alpha:
            w["rbgs_relax_alpha"] += 4 * niter
            w["rbgs_relax_alpha.prolong"] += 2 * niter
            w["restrict_pyramid"] += 2 * niter
            if engine == "dense":
                w["rbgs_relax_alpha"] += (nlev - 1) * nrelax * niter
        else:
            if engine != "dense":
                raise AssertionError(f"{name}: a unit block solve")
            w["residual"] += (2 * nlev + 2) * niter
            w["rbgs_relax"] += (nlev - 1) * nrelax * niter
    if name == "amr_osc":
        w.update(predict_xy=nlev * steps, interp_faces=nlev * (steps + 1))
    return w


def amr_leaves(name, s):
    """The leaf count after each adaptation (or the static mesh's) against
    the uniform count at the finest level."""
    uni = int(np.prod(s.topo.grid(s.topo.lmax).shape))
    hist = s.leaf_history or [s.n_leaves()]
    print(f"  {name}: leaves {hist} of {uni} uniform (ratio "
          f"{' '.join(f'{n / uni:.4f}' for n in hist)}); levels "
          f"{s.topo.lmin}-{s.topo.lmax}, block engine {s._use_blocks}")
    return hist, uni


def phase_amr(dev, card, name):
    """init + AMR_STEPS steps of an AMR route in float32 through the
    kernels, the counts set to 0 just before and gated just after from
    every composite solve's recorded cycle count (want_amr), the block
    engine's fallback warning an error and ``_use_blocks`` checked after
    the run (amr_osc); finite values of the finest levels' shape; the
    leaves against uniform; the first AMR_CHECK_STEPS steps against the
    plain versions (check_against_plain, deferred, float64 to
    AMR_F64_RTOL, U and V by the floor rule); one more step's host syncs
    (count_syncs) against its solves' reads plus AMR_SYNCS; five timed
    windows and a profile, with nothing else on the card (the gate jobs
    start after phase 3); the launch, block-engine and sync gates raise
    after the measurements.  Returns the launch counts."""
    import warnings
    import torch
    make = AMR_ROUTES[name]
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings(), recording_amr_solves() as log:
        warnings.simplefilter("error", RuntimeWarning)
        s = make(dev)
        lmin, lmax = s.topo.lmin, s.topo.lmax
        print(f"phase 3, {name}: levels {lmin}-{lmax}, finest "
              f"{s.topo.grid(lmax).shape}, float32, init + {AMR_STEPS} "
              f"steps")
        s.run(max_steps=AMR_CHECK_STEPS)
        early = {n: s.fine(n).clone() for n in s.state}
        s.run(max_steps=AMR_STEPS - AMR_CHECK_STEPS)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    counts = launch_counts()
    niters = [(x[0][0], x[1]) for x in log]
    print(f"  {name}, init + {AMR_STEPS} steps: {t_run:.3f} s; "
          f"{len(log)} solves (engine, niter) {niters}; host syncs of the "
          f"solves {sum(x[3] for x in log)}; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    # the gates' failures, raised after the run's measurements
    errors = []
    if name == "amr_osc" and not s._use_blocks:
        errors.append("amr_osc: the block engine fell back")
    for k, w in want_amr(name, [x[:3] for x in log], AMR_STEPS, lmin,
                         lmax).items():
        if counts[k] != w:
            errors.append(f"{name}: {k}: {counts[k]} launches, want {w}")
    shape = s.topo.grid(lmax).shape
    for n in s.state:
        v = s.fine(n)
        if tuple(v.shape) != shape or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{name} {n}: not finite or wrong shape")
    hist, uni = amr_leaves(name, s)
    print(f"  {name}: t {s.time.t:.6e} after {s.time.i} steps, dt "
          f"{s.dt:.6e}; max|U| {float(s.fine('U').abs().max()):.6e}, "
          f"max|V| {float(s.fine('V').abs().max()):.6e}")

    def run_of(dtype):
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            return AMRRun(make(dev, dtype=dtype))

    check_against_plain(name, run_of, AMR_CHECK_STEPS, early, AMR_F64_RTOL,
                        floor_rule=("U", "V"))
    del early
    where = []
    with recording_amr_solves() as slog:
        n, _ = count_syncs(lambda: s.run(max_steps=1), dev, where)
    own = sum(x[3] for x in slog)
    # run() reads the dt on entry too
    extra = n - own - 1
    print(f"  {name}: host syncs of one step {n - 1} = its solves' {own} + "
          f"{extra} (want {AMR_SYNCS[name]}; run's entry dt read aside)")
    if extra != AMR_SYNCS[name]:
        errors.append(f"{name}: {n - 1} host syncs a step, its solves' "
                      f"{own} + {AMR_SYNCS[name]} wanted; at {where}")
    walls_, syncs = [], []
    for _ in range(AMR_TIMED_WINDOWS):
        with recording_amr_solves() as wlog:
            h0 = s.host_syncs
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            s.run(max_steps=AMR_TIMED_STEPS)
            torch.cuda.synchronize()
            walls_.append(time.perf_counter() - t1)
        syncs.append((sum(x[3] for x in wlog) + s.host_syncs - h0)
                     / AMR_TIMED_STEPS)
    step = float(np.median(walls_)) / AMR_TIMED_STEPS
    print(f"  {name} step, timed windows of {AMR_TIMED_STEPS} steps: "
          f"{' '.join(f'{w:.4f}' for w in walls_)} s; median "
          f"{step * 1e3:.3f} ms/step, {s.n_leaves() / step / 1e6:.3f}M "
          f"leaf-updates/s ({s.n_leaves()} leaves), {uni / step / 1e6:.3f}M "
          f"uniform-cell-updates/s; host syncs per step "
          f"{' '.join(f'{x:.1f}' for x in syncs)} on {card}")
    t1 = time.perf_counter()
    phase_profile(AMRRun(s), step, card, AMR_PROFILE_STEPS,
                  shares=("rbgs_relax", "residual", "predict_xy",
                          "interp_faces"), host=False)
    print(f"  {name}: the profile took {time.perf_counter() - t1:.1f} s "
          "of wall time")
    if errors:
        raise AssertionError("; ".join(errors))
    return counts


def amr_osc_gate(dev, card, composite):
    """tests/test_amr_ns.py::test_oscillation_amr_frequency (and its
    _composite twin) at AMR_OSC_GATE_LEVEL in float64 to t = 1: the
    kinetic energy every step fitted by a exp(-b t) (1 - cos c t); c
    within JAX_RTOL of the JAX package's fit at that level
    (JAX_AMR_OSC5) and within AMR_OSC_TABLE_RTOL of the test's table,
    b > 0, mean leaves below AMR_LEAF_RATIO of uniform,
    the block engine kept."""
    import warnings
    import torch
    from scipy.optimize import curve_fit
    from gerris_tpu_torch.events.events import Event
    level = AMR_OSC_GATE_LEVEL
    h2 = (1.0 / (1 << level)) ** 2
    ke = []

    def record(sim):
        T = sim.fine("T")
        rho = OSC_RHO_G + torch.clamp(T, 0, 1) * (OSC_RHO_L - OSC_RHO_G)
        ke.append((sim.time.t, torch.sum(rho * (sim.fine("U") ** 2
                                                + sim.fine("V") ** 2)) * h2))

    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        s = amr_osc_sim(dev, level, torch.float64, composite,
                        events=[Event(action=record, istep=1)], end=1.0,
                        block_advect=False)
        s.run()
    k = np.array([(t, float(e)) for t, e in ke])
    omega0 = math.sqrt(6.0 * OSC_SIGMA / ((OSC_RHO_L + OSC_RHO_G)
                                          * (OSC_D / 2) ** 3))
    (a, b, c), _ = curve_fit(
        lambda t, a, b, c: a * np.exp(-b * t) * (1.0 - np.cos(c * t)),
        k[:, 0], k[:, 1], p0=(3e-4, 1.5, 2 * omega0), maxfev=20000)
    jax = JAX_AMR_OSC5[composite]
    rel = abs(c - jax["c"]) / jax["c"]
    rel_table = abs(c - AMR_OSC_REF_C) / AMR_OSC_REF_C
    ratio = float(np.mean(s.leaf_history)) / (1 << level) ** 2
    print(f"phase 4, AMR oscillation gate{' (composite)' * composite}: "
          f"level {level} float64, {s.time.i} steps to t = {s.time.t:.6f} "
          f"in {time.perf_counter() - t0:.1f} s on {card}: c {c:.6f} "
          f"(gerris_tpu {jax['c']:.6f}, rel {rel:.3e} < {JAX_RTOL}; the "
          f"test's table {AMR_OSC_REF_C}, rel {rel_table:.4f} < "
          f"{AMR_OSC_TABLE_RTOL:g}), b {b:.4f} "
          f"(gerris_tpu {jax['b']:.4f}), mean leaves "
          f"{np.mean(s.leaf_history):.1f} = {ratio:.4f} of uniform (< "
          f"{AMR_LEAF_RATIO}), block engine {s._use_blocks}")
    if not (rel < JAX_RTOL and rel_table < AMR_OSC_TABLE_RTOL and b > 0
            and ratio < AMR_LEAF_RATIO and s._use_blocks):
        raise AssertionError("AMR oscillation gate failed")


def amr_capwave_gate(dev, card, level):
    """test_capwave_amr_convergence at one level in float64 to
    CAPWAVE_TEND on capwave_mesh(level): the RMS of the amplitude's
    error against Prosperetti's (capwave_rms' measure) within
    AMR_CAPWAVE_RTOL of the table; prints it as a JSON line for
    amr_capwave_order, and the leaves (level 5 below
    AMR_CAPWAVE_LEAF_RATIO of uniform)."""
    import torch
    from gerris_tpu_torch.events.events import Event
    from gerris_tpu_torch.physics import vof
    from gerris_tpu_torch.utils.analytic import prosperetti_capwave
    times, amps = [], []

    def record(sim):
        grid = sim.topo.grid(sim.topo.lmax)
        T = sim.fine("T")
        mx, my = vof.normals(T, grid, sim.cfg.vof_tracers[0][1])
        _, py = vof.interface_point(T, mx, my)
        y = torch.as_tensor(grid.centers[1], dtype=T.dtype, device=T.device)
        ifc = (T > 1e-6) & (T < 1 - 1e-6)
        times.append(sim.time.t)
        amps.append(torch.where(ifc, (y + py * grid.h).abs(), 0.0).max())

    t0 = time.perf_counter()
    s = amr_capwave_sim(dev, level, torch.float64,
                        events=[Event(action=record, step=CAPWAVE_SAMPLE)],
                        end=CAPWAVE_TEND)
    s.run()
    got = torch.stack(amps).double().cpu().numpy()
    exact = np.abs(prosperetti_capwave(np.array(times), CAPWAVE_A0,
                                       2 * math.pi, CAPWAVE_NU, 1.0))
    rms = math.sqrt(float(np.mean((got - exact) ** 2))) / CAPWAVE_A0
    uni = int(np.prod(s.topo.grid(level).shape))
    e_ref = abs(rms - CAPWAVE_REF[level]) / CAPWAVE_REF[level]
    print(f"phase 4, AMR capwave gate: level {level} float64, {s.time.i} "
          f"steps to t = {s.time.t:.6f} in {time.perf_counter() - t0:.1f} "
          f"s on {card}: RMS / A0 {rms:.6g}, the table {CAPWAVE_REF[level]}"
          f" (rel {e_ref:.4f} < {AMR_CAPWAVE_RTOL}); leaves {s.n_leaves()} "
          f"of {uni} uniform ({s.n_leaves() / uni:.4f})")
    print(json.dumps({"amr_capwave_level": level, "rms": rms,
                      "leaves": s.n_leaves(), "uniform": uni}))
    if not (e_ref < AMR_CAPWAVE_RTOL and np.isfinite(got).all()):
        raise AssertionError(f"AMR capwave gate: level {level}")


def amr_capwave_order(outputs):
    """The order between the AMR capwave gate's levels 4 and 5 above
    CAPWAVE_ORDER_MIN, and the level-5 leaves below
    AMR_CAPWAVE_LEAF_RATIO of uniform, from the jobs' outputs."""
    got = {}
    for out in outputs:
        for line in out.splitlines():
            if line.startswith('{"amr_capwave_level"'):
                d = json.loads(line)
                got[d["amr_capwave_level"]] = d
    order = math.log2(got[4]["rms"] / got[5]["rms"])
    ratio = got[5]["leaves"] / got[5]["uniform"]
    print(f"phase 4, AMR capwave gate: order between levels 4 and 5 "
          f"{order:.4f} (> {CAPWAVE_ORDER_MIN}); level-5 leaves {ratio:.4f}"
          f" of uniform (< {AMR_CAPWAVE_LEAF_RATIO})")
    if not (order > CAPWAVE_ORDER_MIN and ratio < AMR_CAPWAVE_LEAF_RATIO):
        raise AssertionError("AMR capwave gate: order or leaves")


def amr_pinned_gate(dev, card):
    """tests/test_amr_ns.py::test_adaptive_twophase_interface_not_pinned
    in float64 on the card: the lid cavity (nu 5e-3) with a droplet of
    density 0.5, composite_vof, adapting every 2 steps on the velocity's
    Hessian alone (cmax 5, cfactor 2, levels 4-6) to t = 0.12: the leaf
    volume within AMR_PINNED_MASS_RTOL, interface cells on coarser
    leaves, T within [-1e-6, 1 + 1e-6], the block engine kept."""
    import warnings
    import torch
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.models import amr_ns, ns
    from gerris_tpu_torch.models.simulation import Time
    from gerris_tpu_torch.physics import vof
    from gerris_tpu_torch.solvers.poisson import MultilevelParams
    lmax = AMR_PINNED_LEVEL
    grid = Grid(level=lmax)
    proj = MultilevelParams(tolerance=1e-6, nitermax=50)
    cfg = ns.NSConfig(
        grid=grid, u_bcs=(bc.FieldBC.make(2, default=bc.Dirichlet(0.0),
                                          top=bc.Dirichlet(1.0)),
                          bc.FieldBC.uniform(bc.Dirichlet(0.0), 2)),
        nu=5e-3, beta=1.0, vof_tracers=(("T", bc.default_scalar_bc(2)),),
        composite_vof=True, density=("T", 1.0, 0.5, 1), projection=proj,
        approx_projection=proj)

    def criterion(s):
        g = s.topo.grid(s.topo.lmax)
        return None, None, amr_ns.hessian_cost(s.fine("U"), g,
                                               s.cfg.u_bcs[0], t=s.time.t)

    def mass(s):
        return sum(float(torch.where(s.leaf[l], s.state["T"][l], 0.0).sum())
                   * s.topo.grid(l).cell_volume for l in s.topo.levels)

    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        s = amr_ns.AMRSimulation(
            cfg, adapt=amr_ns.AdaptSpec(criterion=criterion, cmax=5.0,
                                        cfactor=2.0, minlevel=4,
                                        maxlevel=lmax, istep=2),
            time=Time(end=0.12), device=dev, dtype=torch.float64)
        s.init(T=vof.fraction_from_levelset(
            grid, lambda x, y: 0.15 - torch.sqrt(x ** 2 + (y + 0.15) ** 2),
            device=dev, dtype=torch.float64))
        m0 = mass(s)
        s.run()
    m1 = mass(s)
    coarse = sum(int(((s.state["T"][l] > 1e-3) & (s.state["T"][l] < 1 - 1e-3)
                      & s.leaf[l]).sum()) for l in range(s.topo.lmin, lmax))
    lo = min(float(s.state["T"][l].min()) for l in s.topo.levels)
    hi = max(float(s.state["T"][l].max()) for l in s.topo.levels)
    print(f"phase 4, AMR interface-not-pinned gate: level {lmax} float64, "
          f"{s.time.i} steps to t = {s.time.t:.6f} in "
          f"{time.perf_counter() - t0:.1f} s on {card}: volume {m0:.9e} -> "
          f"{m1:.9e} (rel {abs(m1 - m0) / m0:.3e} < {AMR_PINNED_MASS_RTOL}),"
          f" coarse-leaf interface cells {coarse}, T in [{lo:.3e}, "
          f"{hi:.6f}], leaves {s.leaf_history}, block engine "
          f"{s._use_blocks}")
    if not (coarse > 0 and abs(m1 - m0) / m0 < AMR_PINNED_MASS_RTOL
            and lo > -1e-6 and hi < 1 + 1e-6 and s._use_blocks):
        raise AssertionError("AMR interface-not-pinned gate failed")


def ring_depth(lmin, lmax, r=0.35, wcells=6.0):
    """tests/test_blockrt.py's ring: lmax within wcells finest cells of
    the circle of radius r, lmin elsewhere."""
    from gerris_tpu_torch.core.grid import Grid
    gf = Grid(level=lmax)
    x, y = gf.centers
    d = np.abs(np.sqrt(x * x + y * y) - r)
    return np.where(d < wcells * gf.h, lmax, lmin).astype(np.int32)


def phase_leaf_scaling(dev, card):
    """test_blockrt_walltime_scales_with_leaves's measure on the card in
    float32: three fixed cycles of the block solve (pure Neumann, nrelax
    4) on ring meshes at lmax 8 and 9 (lmin 4), the best of three timed
    calls each; the time may grow less than LEAF_SCALING_MAX times while
    the uniform domain grows 4x.  Also printed at lmax 10 and 11."""
    import torch
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.solvers import blockrt
    from gerris_tpu_torch.solvers.poisson import MultilevelParams
    fbc = bc.FieldBC.uniform(bc.Neumann(), 2)
    params = MultilevelParams(nrelax=4)
    times, actives = {}, {}
    for lmax in (8, 9, 10, 11):
        rt, tables, mesh = blockrt.make_blockrt(
            Grid(level=4), lmax, ring_depth(4, lmax), B=8, device=dev)
        rhs = {l: torch.full((rt.caps_dict[l], 8, 8), l % 3 - 1.0,
                             dtype=torch.float32, device=dev)
               for l in rt.caps_dict}
        rhs = blockrt.demean_leaf(rhs, tables, rt)
        best = math.inf
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            blockrt.solve(rhs, tables, rt, fbc, params, ncycles=3)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        times[lmax], actives[lmax] = best, mesh.n_active()
        print(f"  leaf scaling: lmax {lmax}: {actives[lmax]} active cells "
              f"({actives[lmax] / 4 ** lmax:.4f} of uniform), 3 cycles "
              f"{best * 1e3:.3f} ms on {card}")
    growth = times[9] / times[8]
    print(f"phase 3, leaf scaling: time x{growth:.3f} from lmax 8 to 9 (< "
          f"{LEAF_SCALING_MAX}) for active cells x"
          f"{actives[9] / actives[8]:.3f} (uniform x4); 9 -> 10 "
          f"x{times[10] / times[9]:.3f}, 10 -> 11 "
          f"x{times[11] / times[10]:.3f}")
    if not growth < LEAF_SCALING_MAX:
        raise AssertionError(f"leaf scaling: x{growth:.3f}")


def check_amr_kernels(dev, record):
    """The kernels at the AMR routes' shapes, float32, against their plain
    versions and timed (CUDA events), with bounds: K15 at amr_osc's base
    correction levels (4^2 from zero, 12 sweeps; 8^2 with the
    prolongation, 4 sweeps) and at
    its top dense level 1024^2 (one sweep, the initial projection's);
    K6 and K9 at 1024^2 and 8^2 (its top and base levels); K11 and one
    K10 sweep at amr_capwave's top and base box levels (1024, 3072) and
    (8, 24), periodic rows.  Stored in each kernel's record under
    ``amr``."""
    import torch
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.ops.cuda import predict, projops, rbgs
    f32 = torch.float32
    out = {}
    gen = torch.Generator(device=dev).manual_seed(19)

    def rnd(dtype, *shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    def hold(key, name, fn, plain, in_bytes, flops):
        got, want = fn(), plain()
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        err = max(float((a.double() - b.double()).abs().max())
                  / max(float(b.double().abs().max()), 1e-30)
                  for a, b in zip(got, want) if a is not None)
        if not err <= BOUND["float32"]:
            raise AssertionError(f"{key} {name}: {err:.3e}")
        ms, pms = cuda_ms(fn), cuda_ms(plain)
        bms, by = bound(in_bytes, got, flops)
        out.setdefault(key, {})[name] = dict(
            max_rel_err=err, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by)
        print(f"  {key} at {name}: rel err {err:.3e}, {ms:.4f} ms (plain "
              f"{pms:.4f}, bound {bms:.3e} by {by})")

    walls_ = walls()
    signs = (-1.0, -1.0, 1.0, 1.0)
    for n, nsw, coarse in ((4, 12, False), (8, 4, True), (1024, 1, False)):
        u, r = rnd(f32, n, n), rnd(f32, n, n)
        ax = 1.0 + rnd(f32, n + 1, n).abs()
        ay = 1.0 + rnd(f32, n, n + 1).abs()
        c = rnd(f32, n // 2, n // 2) if coarse else None
        kw = dict(nsweeps=nsw, h2=(1.0 / n) ** 2, signs=signs,
                  periodic=(False, False), omega=1.0, dia_cell=False,
                  coarse=c)
        u0 = None if coarse else u
        hold("rbgs_relax_alpha", f"{n}^2 x {nsw}",
             lambda: rbgs.rbgs_relax_alpha(u0, r, ax, ay, 0.0, **kw),
             lambda: rbgs.rbgs_relax_alpha_plain(u0, r, ax, ay, 0.0, **kw),
             nbytes(u0, r, ax, ay, c), alpha_flops(n, nsw, 1.0, coarse))
    # the pyramid of amr_osc's base corrections, 8^2 -> 4^2, with its
    # device time per launch (profiled)
    r8 = rnd(f32, 8, 8)
    hold("restrict_pyramid", "8^2 -> 4^2",
         lambda: rbgs.restrict_pyramid(r8, 1),
         lambda: rbgs.pyramid_plain(r8, 1), nbytes(r8), 8 * 8)
    host_us, dev_us = host_device_us(lambda: rbgs.restrict_pyramid(r8, 1),
                                     200)
    out["restrict_pyramid"]["8^2 -> 4^2"].update(host_us=host_us,
                                                  device_us=dev_us)
    print(f"  restrict_pyramid at 8^2 -> 4^2: {host_us:.2f} us of host a "
          f"call, {dev_us:.2f} us a launch on the card")
    for n in (1024, 8):
        g = Grid(level=int(math.log2(n)))
        U, V = rnd(f32, n, n), rnd(f32, n, n)
        hold("predict_xy", f"{n}^2",
             lambda: predict.predict_xy(U, V, 1e-3, g, walls_, None),
             lambda: predict.predict_xy_plain(U, V, 1e-3, g, walls_, None),
             nbytes(U, V), 120 * n * n)
        hold("interp_faces", f"{n}^2",
             lambda: projops.interp_faces(U, V, g, walls_, None, None, None),
             lambda: projops.interp_faces_plain(U, V, g, walls_, None, None,
                                                None),
             nbytes(U, V), 4 * n * n)
    per = (bc.Periodic(), bc.Periodic())
    pbc = bc.FieldBC((per, (bc.Neumann(), bc.Neumann())))
    psigns = (1.0, 1.0, 1.0, 1.0)
    for shp in ((1024, 3072), (8, 24)):
        u, r = rnd(f32, *shp), rnd(f32, *shp)
        h2 = (1.0 / shp[0]) ** 2
        kw = dict(h2=h2, signs=psigns, offs=(0.0,) * 4,
                  periodic=(True, False))
        hold("residual", f"{shp}",
             lambda: rbgs.residual(u, r, 0.0, **kw),
             lambda: rbgs.residual_plain(u, r, 0.0, **kw),
             nbytes(u, r), 8 * u.numel())
        kw = dict(nsweeps=1, h2=h2, signs=psigns, periodic=(True, False),
                  omega=1.0)
        hold("rbgs_relax", f"{shp}",
             lambda: rbgs.rbgs_relax(u, r, 0.0, **kw),
             lambda: rbgs.rbgs_relax_plain(u, r, 0.0, **kw),
             nbytes(u, r), 7 * u.numel())
    for k, v in out.items():
        record[k]["amr"] = v


# slice 6: the fork's Lagrangian particles.  The route ``particles``: the
# bench's 2048^2 lid (lid_cfg(11)) with particle coupling, float32,
# PARTICLES_N particles seeded uniformly over the box from a
# torch.Generator on the card (seed 0), at rest, of diameter h (vol pi h^3
# / 6) and density PARTICLE_RHO (a mass loading of ~6%), the five default
# forces at gravity 0, two-way through the Gaussian deposit of radius h
# over 7^2 cells (49 offsets x PARTICLES_N particles x 2 components a
# step); init + PARTICLES_STEPS steps, five timed windows and a profile
LEVEL_PARTICLES = 11
PARTICLES_N = 1 << 20
PARTICLE_RHO = 1000.0
PARTICLES_STEPS = 5
PARTICLES_TIMED_STEPS = 5
PARTICLES_PROFILE_STEPS = 3
PARTICLES_F64_RTOL = 1e-9
# the slice-6 gates on the card (phase 4, this process): the Minnaert
# period of each of BUBBLES_N bubbles (R0 in [0.009, 0.011], the liquid
# at p0) within MINNAERT_RTOL over BUBBLES_STEPS steps of about 1/64 of a
# period on the lid's grid; integrate_radius_coupled on CLOUD_N bubbles
# against the CPU within CLOUD_RTOL (float64) and the in-phase pair's
# frequency shift within MINNAERT_RTOL (tests/test_particles.py:180-235);
# the spectra (Parseval within SPECTRUM_RTOL in float32, against the
# CPU's float64 within SPECTRUM_RTOL of max E; init_solenoidal at 2048^2
# divergence-free to SOLENOIDAL_DIV of max|u_hat| with its shells within
# SOLENOIDAL_RTOL of the target); DROPLETS_SIDE^2 droplets of radius 1-3
# h through droplets_to_particles, feed_particles and particle_to_droplet
# with the volume kept to DROPLET_VOLUME_RTOL; the stream function of the
# route's last velocity (float64, tolerance STREAM_TOL); the momentum
# gate of tests/test_particles.py at 2^MOMENTUM_LEVEL cells a side in
# float64, the particles scaled with the cells (16 at 32^2), each one's
# volume cut by as much (the test's mass loading)
BUBBLES_N = 1 << 16
BUBBLES_STEPS = 200
MINNAERT_RTOL = 0.05
CLOUD_N = 64
CLOUD_STEPS = 20
CLOUD_RTOL = 1e-9
PAIR_SUBSTEPS = 4
SPECTRUM_RTOL = 1e-5
SOLENOIDAL_DIV = 1e-6
SOLENOIDAL_RTOL = 1e-5
SOLENOIDAL_BAND = (4, 256)
DROPLETS_SIDE = 64
DROPLET_VOLUME_RTOL = 1e-6
STREAM_TOL = 1e-8
MOMENTUM_LEVEL = 8
MOMENTUM_STEPS = 60
MOMENTUM_RTOL = 0.2


def profiled_system(pcfg, state):
    """A ParticleSystem whose step is a torch.profiler.record_function span
    named "particles", so that a profile reads the particle phase's
    device time."""
    from torch.profiler import record_function
    from gerris_tpu_torch.models.particle_system import ParticleSystem

    class Profiled(ParticleSystem):
        def step(self, sim):
            with record_function("particles"):
                super().step(sim)
    return Profiled(pcfg, state)


@contextlib.contextmanager
def deposit_span():
    """The reaction fields' deposit as a record_function span named
    "deposit" (particles.reaction_force_fields, which ParticleSystem
    calls through its module) while the block runs."""
    from torch.profiler import record_function
    from gerris_tpu_torch.physics import particles as parts
    fields = parts.reaction_force_fields

    def spanned(*args, **kw):
        with record_function("deposit"):
            return fields(*args, **kw)
    parts.reaction_force_fields = spanned
    try:
        yield
    finally:
        parts.reaction_force_fields = fields


def particles_sim(dev, level=None, dtype=None, n=None):
    """The particles route at 2^level cells a side (LEVEL_PARTICLES) with
    ``n`` particles (PARTICLES_N), float32 unless ``dtype``, after init;
    the positions drawn in float64 from a generator on the card, so every
    dtype starts from the same particles."""
    import dataclasses
    import torch
    from gerris_tpu_torch.models.simulation import Simulation, Time
    from gerris_tpu_torch.physics import particles as parts
    level = LEVEL_PARTICLES if level is None else level
    n = PARTICLES_N if n is None else n
    dtype = torch.float32 if dtype is None else dtype
    cfg = dataclasses.replace(lid_cfg(level), particle_coupling=True)
    g = cfg.grid
    gen = torch.Generator(device=dev).manual_seed(0)
    u = torch.rand((n, 2), generator=gen, device=dev, dtype=torch.float64)
    pos = (g.origin[0] + g.length(0) * u).to(dtype)
    vol = torch.full((n,), math.pi * g.h ** 3 / 6.0, dtype=dtype, device=dev)
    pcfg = parts.ParticleConfig(capacity=n, two_way=True, rkernel=g.h,
                                kernel_cells=3)
    state = parts.make_particles(n, 2, pos=pos, vol=vol,
                                 mass=PARTICLE_RHO * vol, device=dev,
                                 dtype=dtype)
    return Simulation(cfg, time=Time(dtmax=0.8 * g.h), device=dev,
                      dtype=dtype,
                      particle_systems=[profiled_system(pcfg, state)]).init()


class ParticleRun:
    """A coupled Simulation as check_against_plain takes a run: ``state``
    holds the fields and the particles' ``pos`` and ``vel``."""

    def __init__(self, sim):
        self.sim = sim

    def run(self, max_steps=None):
        self.sim.run(max_steps=max_steps)
        return self

    @property
    def state(self):
        p = self.sim.particle_systems[0].state
        return {**self.sim.state, "pos": p["pos"], "vel": p["vel"]}


def want_particles(steps):
    """Launches of init + ``steps`` steps of the particles route: the
    per-component route's (want_launches("per_component")) but for the
    diffusion.  The PF sources take the K14 launches' oscale fold off
    and give each component's diffusion a fused cycle of its own (K1,
    K2: its pyramid, block and CASCADE_K3 K3, then K3), so no K8a-c run
    (models/ns.py velocity_advection_diffusion).  The particle phase
    launches none of the port's kernels."""
    w = want_launches("per_component", steps)
    for k in ("residual_restrict_pair", "cascade_prolong_relax_pair",
              "cascade_pair.restrict_pyramid", "cascade_pair.coarse_block",
              "cascade_pair.prolong_relax", "prolong_relax_pair"):
        w[k] = 0
    for k, per in (("residual_restrict", 1), ("cascade_prolong_relax", 1),
                   ("prolong_relax", 1), ("cascade.restrict_pyramid", 1),
                   ("cascade.coarse_block", 1),
                   ("cascade.prolong_relax", CASCADE_K3)):
        w[k] += 2 * per * steps
    return w


def phase_particles(dev, card):
    """init + PARTICLES_STEPS steps of the particles route through the
    kernels, the counts set to 0 just before and gated just after
    (want_particles); finite values; the live particles; the steps
    against the plain versions (check_against_plain, deferred: float64
    to PARTICLES_F64_RTOL, float32 by the floor rule on U, V, P and the
    particles' pos and vel; index_add_'s float atomics make two runs
    differ in their last bits); one step's host syncs against the
    per-component lid route's step (count_syncs: the particle phase adds
    none); five timed windows and a profile with the particle phase's
    and the deposit's device time (record_function spans).  Returns
    (the launch counts, the last U and V)."""
    import torch
    n = 1 << LEVEL_PARTICLES
    print(f"phase 3, particles: the {n}^2 lid, {PARTICLES_N} two-way "
          f"coupled particles (density {PARTICLE_RHO:g}, diameter h, the "
          f"Gaussian deposit of radius h), float32, init + "
          f"{PARTICLES_STEPS} steps")
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = particles_sim(dev)
    s.run(max_steps=PARTICLES_STEPS)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    counts = launch_counts()
    print(f"  particles, init + {PARTICLES_STEPS} steps: {t_run:.3f} s; "
          f"launches { {k: v for k, v in counts.items() if v} }")
    errors = [f"particles: {k}: {counts[k]} launches, want {w}"
              for k, w in want_particles(PARTICLES_STEPS).items()
              if counts[k] != w]
    run = ParticleRun(s)
    for k, v in run.state.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"particles {k}: not finite")
    psys = s.particle_systems[0]
    mom = float((psys.state["vel"][:, 0] * psys.state["mass"]).sum())
    print(f"  particles: {psys.n_alive()} of {PARTICLES_N} alive; t "
          f"{s.time.t:.6e} after {s.time.i} steps, dt {s.dt:.6e}; "
          f"max|U| {float(s.state['U'].abs().max()):.6e}, max|PFx| "
          f"{float(s.state['PFx'].abs().max()):.6e}, particles' "
          f"x-momentum {mom:.6e}")
    early = {k: v.clone() for k, v in run.state.items()}
    check_against_plain(
        "particles", lambda dtype: ParticleRun(particles_sim(dev,
                                                             dtype=dtype)),
        PARTICLES_STEPS, early, PARTICLES_F64_RTOL,
        keys=("U", "V", "P", "pos", "vel"),
        floor_rule=("U", "V", "P", "pos", "vel"))
    del early
    lid = lid_sim(dev, "per_component").run(max_steps=2)
    base, _ = count_syncs(lambda: lid.run(max_steps=1), dev)
    del lid
    where = []
    syncs, _ = count_syncs(lambda: s.run(max_steps=1), dev, where)
    print(f"  particles: host syncs of one step {syncs}, the "
          f"per-component lid route's {base} (a run's entry dt read "
          "included in both)")
    if syncs != base:
        errors.append(f"particles: {syncs} host syncs a step, the lid's "
                      f"{base}; at {where}")
    step = timed_windows("particles", s, PARTICLES_TIMED_STEPS, card, n * n)
    with deposit_span():
        phase_profile(s, step, card, PARTICLES_PROFILE_STEPS,
                      spans=("particles", "deposit"))
    if errors:
        raise AssertionError("; ".join(errors))
    return counts, (s.state["U"].clone(), s.state["V"].clone())


def minnaert_periods(hist, R0, dt):
    """Each bubble's period from its radius history ``hist`` (steps, n;
    hist[k] after k + 1 steps of ``dt``): twice the mean time between the
    sign changes of R - R0 (0 counted positive: float32 radii meet R0
    exactly), each crossing placed by linear interpolation.  Returns
    (periods, crossings per bubble)."""
    s = hist - R0[None, :]
    up = s >= 0.0
    cross = up[:-1] != up[1:]
    frac = s[:-1] / np.where(cross, s[:-1] - s[1:], 1.0)
    tc = (np.arange(1, s.shape[0])[:, None] + frac) * dt
    count = cross.sum(axis=0)
    first = np.argmax(cross, axis=0)
    last = s.shape[0] - 2 - np.argmax(cross[::-1], axis=0)
    cols = np.arange(s.shape[1])
    span = tc[last, cols] - tc[first, cols]
    return 2.0 * span / np.maximum(count - 1, 1), count


def bubbles_gate(dev, card):
    """step_bubbles on BUBBLES_N bubbles over the lid's 2048^2 grid in
    float32 (the fluid at rest, the liquid pressure p0 = 1 everywhere,
    rho 1, gamma 1.4, R0 uniform in [0.009, 0.011], each released at
    1.001 R0), BUBBLES_STEPS steps of 1/64 of the mean Minnaert period:
    every bubble's period within MINNAERT_RTOL of 2 pi R0 sqrt(rho / (3
    gamma p0)) (tests/test_particles.py:103-129); then
    integrate_radius_coupled on CLOUD_N interacting bubbles in float64
    against the same on the CPU, and the in-phase pair's frequency shift
    (tests/test_particles.py:180-235) on the card."""
    import torch
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.physics import bubbles as bub
    from gerris_tpu_torch.physics import particles as parts
    t0 = time.perf_counter()
    g = Grid(LEVEL_PARTICLES)
    f32 = torch.float32
    n = BUBBLES_N
    gen = torch.Generator(device=dev).manual_seed(1)
    pos = torch.rand((n, 2), generator=gen, device=dev) - 0.5
    R0 = 0.009 + 0.002 * torch.rand(n, generator=gen, device=dev)
    b = bub.make_bubbles(n, 2, pos, R=R0, p0=torch.ones(n, device=dev),
                         device=dev, dtype=f32)
    b["R"] = 1.001 * R0
    zero = torch.zeros(g.shape, dtype=f32, device=dev)
    P = torch.ones(g.shape, dtype=f32, device=dev)
    gamma, rho, p0 = 1.4, 1.0, 1.0
    periods = (2 * math.pi * R0.double() * math.sqrt(rho / (3 * gamma * p0))
               ).cpu().numpy()
    dt = float(periods.mean()) / 64
    pcfg = parts.ParticleConfig(capacity=n)
    bcfg = bub.BubbleConfig(model="rp", gamma=gamma)
    hist = torch.empty((BUBBLES_STEPS, n), dtype=f32, device=dev)
    for k in range(BUBBLES_STEPS):
        b, _, _ = bub.step_bubbles(b, [zero, zero], [zero, zero], P, g,
                                   list(walls()), bc.default_scalar_bc(2),
                                   pcfg, bcfg, 1e-3, rho, dt)
        hist[k] = b["R"]
    got, count = minnaert_periods(hist.double().cpu().numpy(),
                                  R0.double().cpu().numpy(), dt)
    err = np.abs(got - periods) / periods
    alive = int(b["alive"].sum())
    print(f"phase 4, bubbles gate: {n} bubbles on the {g.shape[0]}^2 grid, "
          f"float32, {BUBBLES_STEPS} steps of {dt:.6e}, "
          f"{time.perf_counter() - t0:.1f} s on {card}: Minnaert periods "
          f"within {err.max():.4e} (mean {err.mean():.4e}, bound "
          f"{MINNAERT_RTOL}), {count.min()}-{count.max()} crossings a "
          f"bubble, {alive} alive")
    if not (err.max() < MINNAERT_RTOL and count.min() >= 3 and alive == n):
        raise AssertionError(f"bubbles gate: periods {err.max():.3e}, "
                             f"crossings {count.min()}, alive {alive}")
    t0 = time.perf_counter()
    f64 = torch.float64
    cgen = torch.Generator().manual_seed(2)
    cpos = 0.1 * torch.rand((CLOUD_N, 2), generator=cgen, dtype=f64)
    cR0 = 0.004 + 0.002 * torch.rand(CLOUD_N, generator=cgen, dtype=f64)
    alive = torch.ones(CLOUD_N, dtype=torch.bool)
    alive[5] = False
    ccfg = bub.BubbleConfig(model="rp", gamma=gamma, substeps=8,
                            interactions=True)
    runs = []
    for where in (dev, torch.device("cpu")):
        R, Rd = 1.01 * cR0.to(where), torch.zeros(CLOUD_N, dtype=f64,
                                                  device=where)
        for _ in range(CLOUD_STEPS):
            R, Rd = bub.integrate_radius_coupled(
                R, Rd, torch.full_like(R, 1e5), cR0.to(where),
                torch.full_like(R, 1e5), 1000.0, cpos.to(where),
                alive.to(where), 1.5e-5, ccfg)
        runs.append((R.cpu(), Rd.cpu()))
    cerr = max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip(*runs))
    # 4 RK4 substeps a step (omega0 h = 0.008): the card's launches pace
    # this loop, beside the gate jobs
    w1, w2, want = pair_frequencies(dev, substeps=PAIR_SUBSTEPS)
    e1 = abs(w1 - want[0]) / want[0]
    e2 = abs(w2 - want[1]) / want[1]
    print(f"phase 4, bubble interactions: {CLOUD_N} bubbles ({CLOUD_STEPS} "
          f"steps, float64) against the CPU {cerr:.3e} (bound "
          f"{CLOUD_RTOL:.0e}); {PAIR_SUBSTEPS} substeps a step, the pair's "
          f"frequency {w2:.1f} (theory "
          f"{want[1]:.1f}, rel {e2:.4f}), alone {w1:.1f} (theory "
          f"{want[0]:.1f}, rel {e1:.4f}; bound {MINNAERT_RTOL}), "
          f"{time.perf_counter() - t0:.1f} s on {card}")
    if not (cerr <= CLOUD_RTOL and e1 < MINNAERT_RTOL and
            e2 < MINNAERT_RTOL and w2 < 0.95 * w1):
        raise AssertionError("bubble interactions gate failed")


def pair_frequencies(dev, R0=0.01, d=0.05, rho=1000.0, p0=1e5, gamma=1.4,
                     dt=1.5e-5, steps=800, far=1e6, substeps=8):
    """tests/test_particles.py:180-235 in float64 on ``dev``, both of its
    runs in one system: a bubble alone (``far`` from the others: its
    coupling R0^2 / far changes its frequency by ~1e-10) and an in-phase
    pair at distance d, 800 steps of ``substeps`` RK4 substeps (the
    test's 8); their radial frequencies from the zero crossings, and
    their theories omega0 and omega0 / sqrt(1 + R0 / d)."""
    import torch
    from gerris_tpu_torch.physics import bubbles as bub
    cfg = bub.BubbleConfig(model="rp", gamma=gamma, substeps=substeps,
                           interactions=True)
    omega0 = math.sqrt(3.0 * gamma * p0 / (rho * R0 * R0))
    pos = torch.tensor([[far, 0.0], [0.0, 0.0], [d, 0.0]],
                       dtype=torch.float64, device=dev)
    alive = torch.ones(3, dtype=torch.bool, device=dev)
    full = torch.ones(3, dtype=torch.float64, device=dev)
    R, Rd = 1.01 * R0 * full, 0.0 * full
    hist = torch.empty((steps, 3), dtype=torch.float64, device=dev)
    for k in range(steps):
        R, Rd = bub.integrate_radius_coupled(R, Rd, p0 * full, R0 * full,
                                             p0 * full, rho, pos, alive, dt,
                                             cfg)
        hist[k] = R
    hist = hist.cpu().numpy()
    ts = dt * (1.0 + np.arange(steps))
    out = []
    for rs in (hist[:, 0], hist[:, 1]):
        sgn = np.sign(rs - rs.mean())
        crossings = np.nonzero(sgn[1:] * sgn[:-1] < 0)[0]
        out.append(math.pi / np.mean(np.diff(ts[crossings])))
    return out[0], out[1], (omega0, omega0 / math.sqrt(1.0 + R0 / d))


def spectra_gate(dev, card, U, V):
    """energy_spectrum of the particles route's last velocity (float32):
    Parseval within SPECTRUM_RTOL, and against the same function on the
    CPU in float64 within SPECTRUM_RTOL of max E; init_solenoidal at
    2048^2 in float64 (a k^-5/3 band, noise from a generator on the
    card): its k-space divergence within SOLENOIDAL_DIV of max|u_hat|,
    every shell of the band within SOLENOIDAL_RTOL of the target."""
    import torch
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.spectral import fft as spec
    t0 = time.perf_counter()
    g = Grid(LEVEL_PARTICLES)
    _, E = spec.energy_spectrum([U, V], g)
    ke = float((0.5 * (U.double() ** 2 + V.double() ** 2)).mean())
    pars = abs(float(E.double().sum()) - ke) / ke
    _, E64 = spec.energy_spectrum([U.double().cpu(), V.double().cpu()], g)
    dE = float((E.double().cpu() - E64).abs().max() / E64.abs().max())
    lo, hi = SOLENOIDAL_BAND
    hi = min(hi, g.shape[0] // 4)

    def target(k):
        return torch.where((k >= lo) & (k <= hi), k ** (-5.0 / 3.0), 0.0)
    Us = spec.init_solenoidal(
        g, target, generator=torch.Generator(device=dev).manual_seed(2),
        device=dev)
    uh = [torch.fft.fftn(u) for u in Us]
    n = g.shape[0]
    k = torch.fft.fftfreq(n, device=dev, dtype=torch.float64) * n
    div = k[:, None] * uh[0] + k[None, :] * uh[1]
    rdiv = float(div.abs().max() / max(float(h.abs().max()) for h in uh))
    _, Es = spec.energy_spectrum(Us, g)
    kk = torch.arange(lo, hi + 1, device=dev, dtype=torch.float64)
    shell = float(((Es[lo:hi + 1] - kk ** (-5.0 / 3.0)).abs()
                   / kk ** (-5.0 / 3.0)).max())
    print(f"phase 4, spectra gate: {n}^2, {time.perf_counter() - t0:.1f} s "
          f"on {card}: the particles route's E(k), float32, Parseval rel "
          f"{pars:.3e}, against float64 on the CPU {dE:.3e} of max E "
          f"(bounds {SPECTRUM_RTOL:.0e}); init_solenoidal float64, k-space "
          f"divergence {rdiv:.3e} of max|u_hat| (bound "
          f"{SOLENOIDAL_DIV:.0e}), shells {lo}-{hi} within {shell:.3e} of "
          f"k^-5/3 (bound {SOLENOIDAL_RTOL:.0e})")
    if not (pars <= SPECTRUM_RTOL and dE <= SPECTRUM_RTOL
            and rdiv <= SOLENOIDAL_DIV and shell <= SOLENOIDAL_RTOL):
        raise AssertionError("spectra gate failed")


def droplets_gate(dev, card):
    """A 2048^2 fraction (float64, fraction_from_levelset on the card) of
    DROPLETS_SIDE^2 discs of radius 1-3 h, one in each cell of a lattice
    at a seeded jitter: every disc a droplet; droplets_to_particles turns
    all but the largest into particles, feed_particles puts them into a
    particle state, and particle_to_droplet stamps each back; the volume
    kept within DROPLET_VOLUME_RTOL through the conversion and the
    stamps."""
    import torch
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.physics import droplets as drops
    from gerris_tpu_torch.physics import particles as parts
    from gerris_tpu_torch.physics import vof
    t0 = time.perf_counter()
    g = Grid(LEVEL_PARTICLES)
    h, m = g.h, DROPLETS_SIDE
    f64 = torch.float64
    side = g.length(0) / m
    gen = torch.Generator(device=dev).manual_seed(3)
    rad = h * (1.0 + 2.0 * torch.rand((m, m), generator=gen, device=dev,
                                      dtype=f64))
    jit = 8.0 * h * (2.0 * torch.rand((2, m, m), generator=gen, device=dev,
                                      dtype=f64) - 1.0)
    c = g.origin[0] + side * (torch.arange(m, device=dev, dtype=f64) + 0.5)
    cx, cy = c[:, None] + jit[0], c[None, :] + jit[1]

    def phi(x, y):
        i = torch.floor((x - g.origin[0]) / side).long().clamp(0, m - 1)
        j = torch.floor((y - g.origin[1]) / side).long().clamp(0, m - 1)
        return rad[i, j] ** 2 - (x - cx[i, j]) ** 2 - (y - cy[i, j]) ** 2
    f = vof.fraction_from_levelset(g, phi, device=dev, dtype=f64)
    cv = g.cell_volume
    vol0 = float(f.sum()) * cv
    f2, p = drops.droplets_to_particles(f, None, g, min_cells=64)
    k = p["vol"].shape[0]
    vol1 = float(f2.sum()) * cv + float(p["vol"].sum())
    state = parts.feed_particles(
        parts.make_particles(2 * m * m, 2, device=dev, dtype=f64), p["pos"],
        vel=p["vel"], vol=p["vol"], mass=p["mass"])
    fed = int(state["alive"].sum())
    for q in range(k):
        f2 = drops.particle_to_droplet(f2, p["pos"][q], p["vol"][q], g)
    vol2 = float(f2.sum()) * cv
    e1, e2 = abs(vol1 - vol0) / vol0, abs(vol2 - vol0) / vol0
    print(f"phase 4, droplets gate: {g.shape[0]}^2 float64, {m * m} discs, "
          f"{k} droplets to particles, {fed} fed, stamped back, "
          f"{time.perf_counter() - t0:.1f} s on {card}: volume "
          f"{vol0:.12e}, after the conversion rel {e1:.3e}, after the "
          f"stamps rel {e2:.3e} (bound {DROPLET_VOLUME_RTOL:.0e})")
    if not (k == m * m - 1 and fed == k and e1 <= DROPLET_VOLUME_RTOL
            and e2 <= DROPLET_VOLUME_RTOL):
        raise AssertionError("droplets gate failed")


def derived_gate(dev, card, U, V):
    """The stream function of the particles route's last velocity in
    float64 (derived.stream_function, tolerance STREAM_TOL): lap(psi) =
    the vorticity within STREAM_TOL of max|omega|."""
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.ops import derived
    t0 = time.perf_counter()
    cfg = lid_cfg(LEVEL_PARTICLES)
    g, ubcs = cfg.grid, list(cfg.u_bcs)
    U64 = [U.double(), V.double()]
    psi = derived.stream_function(U64, g, ubcs, tol=STREAM_TOL)
    w = derived.vorticity(U64, g, ubcs)
    lap = derived.laplacian_of(psi, g, bc.FieldBC.uniform(bc.Dirichlet(0.0)))
    res = float((lap - w).abs().max() / w.abs().max())
    print(f"phase 4, derived gate: the stream function at {g.shape[0]}^2, "
          f"float64, {time.perf_counter() - t0:.1f} s on {card}: "
          f"max|lap(psi) - omega| {res:.3e} of max|omega| (bound "
          f"{STREAM_TOL:.0e}), max|psi| {float(psi.abs().max()):.6e}")
    if not res <= STREAM_TOL:
        raise AssertionError(f"derived gate: {res:.3e}")


def momentum_gate(dev, card):
    """tests/test_particles.py's momentum gate at 2^MOMENTUM_LEVEL cells a
    side in float64 on the card: a periodic box at U = 0.3, 16 particles
    per 32^2 cells (mass loading 10, drag, two-way, bilinear), each of
    2e-4 of the box at 32^2 cut with the cell count; after MOMENTUM_STEPS
    steps the particles' gained x-momentum and the fluid's lost one agree
    within MOMENTUM_RTOL."""
    import torch
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.models import ns
    from gerris_tpu_torch.models.particle_system import ParticleSystem
    from gerris_tpu_torch.models.simulation import Simulation, Time
    from gerris_tpu_torch.physics import particles as parts
    t0 = time.perf_counter()
    g = Grid(MOMENTUM_LEVEL)
    scale = (1 << MOMENTUM_LEVEL) ** 2 // 32 ** 2
    n, vol = 16 * scale, 2e-4 / scale
    per = bc.FieldBC.uniform(bc.Periodic())
    cfg = ns.NSConfig(grid=g, u_bcs=(per, per), nu=1e-3,
                      particle_coupling=True)
    f64 = torch.float64
    gen = torch.Generator(device=dev).manual_seed(4)
    pos = 0.8 * torch.rand((n, 2), generator=gen, device=dev,
                           dtype=f64) - 0.4
    vols = torch.full((n,), vol, dtype=f64, device=dev)
    psys = ParticleSystem(
        parts.ParticleConfig(capacity=n, forces=("drag",), two_way=True),
        parts.make_particles(n, 2, pos=pos, vol=vols, mass=10.0 * vols,
                             device=dev, dtype=f64))
    sim = Simulation(cfg, time=Time(end=1.0, dtmax=0.01), device=dev,
                     dtype=f64, particle_systems=[psys]).init(U=0.3)
    mom0 = float(sim.state["U"].sum()) * g.cell_volume
    sim.run(max_steps=MOMENTUM_STEPS)
    lost = mom0 - float(sim.state["U"].sum()) * g.cell_volume
    gained = float((psys.state["vel"][:, 0] * psys.state["mass"]).sum())
    rel = abs(lost - gained) / gained
    print(f"phase 4, momentum gate: {g.shape[0]}^2 float64, {n} particles, "
          f"{MOMENTUM_STEPS} steps, {time.perf_counter() - t0:.1f} s on "
          f"{card}: the fluid lost {lost:.6e}, the particles gained "
          f"{gained:.6e} (rel {rel:.4f}, bound {MOMENTUM_RTOL})")
    if not (gained > 0.0 and lost > 0.0 and rel < MOMENTUM_RTOL):
        raise AssertionError(f"momentum gate: rel {rel:.3e}")


def phase_slice6_gates(dev, card, last, stamp):
    """The slice-6 gates in this process (phase 4), each closed by a
    ``stamp``: bubbles, spectra and the stream function of the
    particles route's last velocity ``last``, droplets, momentum."""
    bubbles_gate(dev, card)
    stamp("phase 4, bubbles gate done")
    spectra_gate(dev, card, *last)
    stamp("phase 4, spectra gate done")
    droplets_gate(dev, card)
    stamp("phase 4, droplets gate done")
    derived_gate(dev, card, *last)
    stamp("phase 4, derived gate done")
    momentum_gate(dev, card)
    stamp("phase 4, momentum gate done")


def gfs_poisson_norms(sim):
    """GfsPoisson's unbiased error norms against sin(3 pi x) sin(3 pi y)
    (test/poisson), in float64 on the host."""
    x, y = np.broadcast_arrays(*sim.grid.centers)
    P = sim.state["P"].double().cpu().numpy() if hasattr(
        sim.state["P"], "cpu") else np.asarray(sim.state["P"])
    return poisson_norms(P, x, y)


def poisson_norms(P, x, y):
    e = P - np.sin(3 * math.pi * x) * np.sin(3 * math.pi * y)
    e = e - e.mean()
    return np.array([np.abs(e).mean(), math.sqrt((e * e).mean()),
                     np.abs(e).max()])


def phase_gfs(dev, card, stamp):
    """Slice 7's user API on the card: the lid's .gfs text at 2048^2 in
    float32 through gerris_tpu_torch.cli.run and by hand from the
    configuration it states (gfs_lid_cfg), bit-identical with equal
    launches per kernel, those the adaptive route's rule gives for the
    CLI run's solves, held to the plain run; the timed windows without an
    output event, with OutputScalarNorm every step and with OutputTiming,
    and a profile; python3 -m gerris_tpu_torch on the same file in a
    process of its own (its lines the in-process run's, its end.gfs
    resumed through the reader to the same state); GfsPoisson against its
    plain run, and GfsAdvection, which launches no kernel.  Returns the
    CLI run's launch counts."""
    import os
    import tempfile
    import torch
    from gerris_tpu_torch.solvers import poisson
    t_phase = time.perf_counter()
    n = 1 << GFS_LEVEL
    dtmax = 0.8 / n
    print(f"phase 3, gfs: the lid's .gfs text at {n}^2, float32, "
          f"{GFS_STEPS} steps through the CLI and by hand")
    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(root, "build")) as wd:
        lid = os.path.join(wd, "lid.gfs")
        with open(lid, "w") as f:
            f.write(GFS_LID)
        runs = gfs_lid_runs(lid, GFS_LEVEL, dtmax, GFS_STEPS,
                            os.path.join(wd, "inproc.gfs"), dev,
                            torch.float32, counted=True)
        cli_counts, hand = runs["counts_cli"], runs["counts_hand"]
        print(f"  the reader's configuration is gfs_lid_cfg({GFS_LEVEL}); "
              f"launches (CLI) { {k: v for k, v in cli_counts.items() if v} }")
        same = all(torch.equal(runs["cli"][k], runs["hand"][k])
                   for k in runs["hand"])
        print(f"  CLI run vs hand-built Simulation: bit-identical={same}, "
              f"equal launches per kernel={cli_counts == hand}, equal "
              f"solves={runs['solves_cli'] == runs['solves_hand']}, equal "
              f"norm rows={runs['rows_cli'] == runs['rows_hand']}")
        if not (same and cli_counts == hand
                and runs["solves_cli"] == runs["solves_hand"]
                and runs["rows_cli"] == runs["rows_hand"]):
            raise AssertionError("gfs: the CLI run is not the hand-built "
                                 "one")
        want = want_adaptive(GFS_STEPS, runs["solves_cli"])
        diff = {k: (cli_counts[k], w) for k, w in want.items()
                if cli_counts[k] != w}
        print(f"  launches against the adaptive route's rule "
              f"(want_adaptive of the CLI run's solves): "
              f"{'equal' if not diff else diff}")
        if diff:
            raise AssertionError(f"gfs: launches (got, want) {diff}")
        for k in ("residual", "coarse_vcycle", "prolong_relax",
                  "restrict_pyramid", "predict_xy", "divergence_mac",
                  "correct_project", "interp_faces"):
            if not cli_counts[k]:
                raise AssertionError(f"gfs: no {k} launch on the lid's run")
        cfg = gfs_lid_cfg(GFS_LEVEL)
        from gerris_tpu_torch.models.simulation import Simulation, Time
        with plain_versions():
            ref = Simulation(cfg, time=Time(iend=GFS_STEPS, dtmax=dtmax),
                             device=dev, dtype=torch.float32).init().run()
        for k in ("U", "V", "P"):
            rel = rel_err(runs["cli"][k], ref.state[k])
            print(f"  gfs lid, kernels vs plain after {GFS_STEPS} steps, "
                  f"{k}: rel {rel:.3e} (bound {ADAPTIVE_RTOL:.0e})")
            if not rel <= ADAPTIVE_RTOL:
                raise AssertionError(f"gfs lid {k}: rel {rel:.3e}")
        del ref, hand
        stamp("phase 3, gfs lid runs done")
        # the real entry point in a process of its own
        dump = os.path.join(wd, "end.gfs")
        env = dict(os.environ, PYTHONPATH=root)
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "gerris_tpu_torch", lid, "-D",
             f"LEVEL={GFS_LEVEL}", "-D", f"DTMAX={dtmax!r}", "-D",
             f"IEND={GFS_STEPS}", "-D", f"DUMP={dump}"]
            + ([] if dev.type == "cuda" else ["--device", str(dev)]),
            cwd=root, env=env,
            capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        lines = [ln for ln in p.stdout.splitlines()
                 if ln.startswith("OutputScalarNorm")]
        want_lines = ["%s time: %g first: %g second: %g infty: %g"
                      % ("OutputScalarNorm(U)", *row)
                      for row in runs["rows_cli"]]
        print(f"  python3 -m gerris_tpu_torch lid.gfs: exit {p.returncode} "
              f"in {wall:.1f} s, {len(lines)} OutputScalarNorm lines, equal "
              f"to the in-process run's: {lines == want_lines}")
        if p.returncode != 0 or lines != want_lines:
            print(p.stderr[-4000:])
            raise AssertionError("gfs: python -m gerris_tpu_torch")
        back = gfs_resume(dump, dev, torch.float32)
        same = back.time.i == GFS_STEPS and all(
            torch.equal(back.state[k], runs["cli"][k]) for k in runs["cli"])
        print(f"  end.gfs through the reader: step {back.time.i}, state "
              f"bit-identical to the in-process run's: {same}")
        if not same:
            raise AssertionError("gfs: end.gfs does not resume the state")
        del back
    sim = runs["sim"]
    del runs
    stamp("phase 3, gfs subprocess done")
    # timed windows on the CLI's simulation: no output event, then
    # OutputScalarNorm every step (its rows only, no file), then
    # OutputTiming at each window's end (the step timer on); the profile
    # is read against the first
    from gerris_tpu_torch.events.outputs import OutputScalarNorm, OutputTiming
    sim.time.iend = 2 ** 31
    for label, events in (("no output event", []),
                          ("OutputScalarNorm every step",
                           [OutputScalarNorm("U", istep=1)]),
                          ("OutputTiming at each window's end",
                           [OutputTiming(file=os.devnull, start="end")])):
        sim.events = events
        walls = []
        for _ in range(GFS_WINDOWS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim.run(max_steps=GFS_TIMED_STEPS)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        syncs, _ = count_syncs(lambda: sim.run(max_steps=GFS_TIMED_STEPS),
                               dev)
        step = float(np.median(walls)) / GFS_TIMED_STEPS
        print(f"  gfs lid, {label}: timed windows of {GFS_TIMED_STEPS} "
              f"steps {' '.join(f'{w:.4f}' for w in walls)} s; median "
              f"{step * 1e3:.3f} ms/step; host syncs per step "
              f"{syncs / GFS_TIMED_STEPS:.1f} on {card}")
        if not events:
            bare = step
        if events and isinstance(events[0], OutputTiming):
            seconds, steps = sim.timer_totals()["step"]
            print(f"  the simulation's step timer (CUDA events, read at "
                  f"each window's end): {steps} steps, "
                  f"{1e3 * seconds / steps:.3f} ms/step")
    sim.events = []
    phase_profile(sim, bare, card, GFS_PROFILE_STEPS)
    del sim
    torch.cuda.empty_cache()
    stamp("phase 3, gfs lid timed")
    # GfsPoisson: the card against the plain versions in float32
    pn = 1 << GFS_POISSON_LEVEL
    reset_launch_counts()
    with recording_solves() as log:
        ps = gfs_build(GFS_POISSON, dev, torch.float32,
                       LEVEL=GFS_POISSON_LEVEL).run()
    counts = launch_counts()
    want = add_solves({k: 0 for k in counts},
                      [(sv, it, fx) for sv, it, fx, _ in log], ADA_PROLONGS)
    print(f"  GfsPoisson {pn}^2 float32: niter {ps.stats.niter}; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    if counts != want:
        raise AssertionError(f"GfsPoisson launches {counts}, want {want}")
    with plain_versions():
        pref = gfs_build(GFS_POISSON, dev, torch.float32,
                         LEVEL=GFS_POISSON_LEVEL).run()
    rel = rel_err(ps.state["P"] - ps.state["P"].mean(),
                  pref.state["P"] - pref.state["P"].mean())
    print(f"  GfsPoisson kernels vs plain, P mean-free: rel {rel:.3e} "
          f"(bound {MAIN_PATH_RTOL:.0e}); error norms "
          f"{gfs_poisson_norms(ps).tolist()}")
    if not rel <= MAIN_PATH_RTOL:
        raise AssertionError(f"GfsPoisson vs plain: rel {rel:.3e}")
    del ps, pref
    norms = {}
    for level in GFS_POISSON_F64:
        norms[level] = gfs_poisson_norms(gfs_build(
            GFS_POISSON, dev, torch.float64, LEVEL=level).run())
    ratios = [norms[a] / norms[b] for a, b in
              zip(GFS_POISSON_F64, GFS_POISSON_F64[1:])]
    with np.load(os.path.join(root, "tests", "data", "jax_pins",
                              "gfs_poisson.npz")) as z:
        g = 1 << GFS_POISSON_F64[0]
        c = (np.arange(g) + 0.5) / g - 0.5
        pin = poisson_norms(z["P"], *np.meshgrid(c, c, indexing="ij"))
    prel = np.abs(norms[GFS_POISSON_F64[0]] / pin - 1.0).max()
    print(f"  GfsPoisson float64 levels {GFS_POISSON_F64}: norms (first, "
          f"second, infty) {[v.tolist() for v in norms.values()]}; ratios "
          f"{[r.tolist() for r in ratios]} (want {GFS_POISSON_ORDER} for "
          f"first and second); level {GFS_POISSON_F64[0]} against the JAX "
          f"pin {pin.tolist()}: rel {prel:.3e} (bound {GFS_PIN_RTOL:.0e})")
    for r in ratios:
        if not all(GFS_POISSON_ORDER[0] <= v <= GFS_POISSON_ORDER[1]
                   for v in r[:2]):
            raise AssertionError(f"GfsPoisson order: ratios {ratios}")
    if not prel <= GFS_PIN_RTOL:
        raise AssertionError(f"GfsPoisson against the pin: rel {prel:.3e}")
    stamp("phase 3, gfs poisson done")
    # GfsAdvection: its generic advection route runs no hand-written
    # kernel, so the run is checked for that and for finite fields
    reset_launch_counts()
    t0 = time.perf_counter()
    adv = gfs_build(GFS_ADVECTION, dev, torch.float32,
                    LEVEL=GFS_ADVECTION_LEVEL).run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in launch_counts().items() if v}
    print(f"  GfsAdvection {1 << GFS_ADVECTION_LEVEL}^2 float32: {adv.i} "
          f"steps to t = {adv.t} in {wall:.2f} s; launches {counts} (the "
          f"generic advection route runs no hand-written kernel)")
    if counts:
        raise AssertionError(f"GfsAdvection launched kernels: {counts}")
    for k in ("T", "C"):
        v = adv.state[k]
        if v.shape != adv.grid.shape or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"GfsAdvection {k}: not finite or wrong "
                                 "shape")
    del adv
    torch.cuda.empty_cache()
    print(f"  phase gfs: {time.perf_counter() - t_phase:.1f} s")
    return cli_counts


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
    # the dense coarsest solves' products (the 2D periodic Poisson's 64^2,
    # the 3D path's 16^3: mat-vecs with a 4096^2 Q) stay in float32, and
    # no float32 reference could round to TF32 either
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "--gate" in sys.argv:
        # a gate job (gate_jobs), started by this script's phase 4
        torch.set_num_threads(1)
        build.library()
        for name in sys.argv[sys.argv.index("--gate") + 1].split(","):
            run_gate(name, dev, card)
        return 0
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()

    def stamp(what):
        print(f"[{time.perf_counter() - t0:.1f} s] {what}", flush=True)
    build.library()
    print(f"phase 1: kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    from gerris_tpu_torch.core import blocks
    if not blocks.native_loaded():
        raise AssertionError("the native block table did not build or load")
    print(f"phase 1: the native block table loaded from "
          f"{blocks.library_path()}")
    print_ptxas(build.ptxas_report("predict_xy_kernel", "advect2d_kernel",
                                   "residual_restrict_kernel",
                                   "rbgs3d_grid_kernel", "coarse_block_kernel",
                                   "divergence_mac_kernel"))

    record = {k: {"name": k, "route": "cuda", "source": src, "replaces": rep}
              for k, (src, rep) in KERNELS.items()}
    stamp("phase 1 done")
    global DEFERRED_PLAIN
    DEFERRED_PLAIN = []
    phase_kernels(dev, record)
    stamp("phase 2 done")
    counts, main_sim = phase_main_path(dev, card)
    stamp("phase 3, main path done")
    route_counts = phase_routes(dev, card, main_sim)
    stamp("phase 3, other lid routes done")
    route_counts.update(phase_adaptive(dev, card, main_sim))
    stamp("phase 3, uniform routes done")
    route_counts["lid3d"] = phase_lid3d(dev, card)
    stamp("phase 3, lid3d done")
    phase_poisson3d(dev)
    stamp("phase 3, poisson3d done")
    route_counts["twophase"] = phase_twophase(dev, card)
    stamp("phase 3, twophase done")
    route_counts["bubble"], bubble_ops = phase_bubble(dev, card)
    stamp("phase 3, bubble done")
    for name, (c, _) in phase_spurious(dev, card).items():
        route_counts[name] = c
    stamp("phase 3, spurious done")
    route_counts["tracer"] = phase_tracer(dev, card)
    stamp("phase 3, tracer done")
    route_counts["mgcg"] = phase_mgcg(dev, card)
    stamp("phase 3, mgcg done")
    route_counts["sessile"] = phase_sessile(dev, card)
    stamp("phase 3, lid3d to sessile done")
    route_counts["droplet3d"] = phase_droplet3d(dev, card)
    stamp("phase 3, droplet3d done")
    phase_bubble3d(dev, card)
    stamp("phase 3, bubble3d done")
    route_counts["capwave"] = phase_capwave(dev, card)
    stamp("phase 3, droplet3d to capwave done")
    route_counts["cylinder"] = phase_cylinder(dev, card)
    stamp("phase 3, cylinder done")
    route_counts.update(phase_moving(dev, card))
    stamp("phase 3, moving done")
    route_counts["rigid"] = phase_rigid(dev, card)
    route_counts["axi"] = phase_axi(dev, card)
    route_counts["stretch"] = phase_stretch(dev, card)
    stamp("phase 3, solid and metric routes done")
    check_amr_kernels(dev, record)
    stamp("phase 3, the kernels at the AMR shapes done")
    phase_leaf_scaling(dev, card)
    stamp("phase 3, leaf scaling done")
    for name in AMR_ROUTES:
        route_counts[name] = phase_amr(dev, card, name)
        stamp(f"phase 3, {name} measured")
    route_counts["particles"], last = phase_particles(dev, card)
    stamp("phase 3, particles measured")
    route_counts["gfs"] = phase_gfs(dev, card, stamp)
    stamp("phase 3, gfs done")
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
    # the pyramid's launches on the main path: K2's and K8b's, one each
    # per cascade
    pyramids = {sub: counts[f"cascade{sub}.restrict_pyramid"]
                for sub in ("", "_pair")}
    record["restrict_pyramid"].update(
        launches=sum(pyramids.values()), launches_pair=pyramids["_pair"])
    for k, sub in (("cascade_prolong_relax", ""),
                   ("cascade_prolong_relax_pair", "_pair")):
        record[k]["launches_restrict_pyramid"] = pyramids[sub]
        record[k]["launches_coarse_block"] = \
            counts[f"cascade{sub}.coarse_block"]
        record[k]["launches_prolong_relax"] = \
            counts[f"cascade{sub}.prolong_relax"]
    # the block kernel's launches on the main path: every cascade's tail
    record["coarse_block"]["launches_main"] = sum(
        counts[f"cascade{sub}.coarse_block"] for sub in ("", "_pair"))
    record["residual_restrict_div"]["launches_fold_div"] = \
        route_counts["fold_div"]["residual_restrict_div"]
    record["rbgs_relax_3d"]["launches_prolong"] = \
        route_counts["lid3d"]["rbgs_relax_3d.prolong"]
    record["rbgs_relax_3d"]["launches_droplet3d"] = \
        route_counts["droplet3d"]["rbgs_relax_3d"]
    record["rbgs_relax_alpha"]["launches_prolong"] = \
        route_counts["twophase"]["rbgs_relax_alpha.prolong"]
    # the bubble's launches (init + BUBBLE_STEPS steps) of the kernels
    # its step runs
    for k in ("predict_xy", "divergence_mac", "rbgs_relax_alpha",
              "advect2d", "interp_faces", "restrict_pyramid"):
        record[k]["launches_bubble"] = route_counts["bubble"][k]
    record["rbgs_relax_alpha"]["bubble_device_ops_per_step"] = bubble_ops
    # the slice-3c paths' launches of each kernel they run (spurious:
    # init + 20 steps per tension; tracer and sessile: init + 5 steps;
    # mgcg: one solve)
    for k in record:
        for path in ("spurious", "spurious_css", "tracer", "mgcg",
                     "sessile", "capwave", "cylinder", "moving1", "moving2",
                     "rigid", "axi", "stretch", *AMR_ROUTES,
                     "particles", "gfs"):
            if route_counts[path][k]:
                record[k][f"launches_{path}"] = route_counts[path][k]
    ada = route_counts["adaptive"]
    record["coarse_vcycle"].update(
        launches_restrict_pyramid=ada["coarse_vcycle.restrict_pyramid"],
        launches_block=ada["coarse_block"],
        launches_prolong_relax=ada["coarse_vcycle.prolong_relax"])

    # phase 4: the host-bound gate jobs in child processes, started after
    # the last timed window, beside phase 3's deferred checks against the
    # plain versions and the other gates in this process
    t_gates = time.perf_counter()
    gates = start_gates(gate_jobs())
    try:
        checks, DEFERRED_PLAIN = DEFERRED_PLAIN, None
        print(f"phase 3, the routes' checks against the plain versions "
              f"({len(checks)}, deferred to here)")
        for check in checks:
            check()
        del checks
        torch.cuda.empty_cache()
        stamp("phase 3, deferred checks against plain done")
        ok, eu, ev = phase_physics(dev, card)
        if not (ok and eu <= GHIA_LINF_U and ev <= GHIA_LINF_V):
            if not ok:
                # for the diagnosis: the same run in f64
                phase_physics(dev, card, "float64")
            raise AssertionError("Ghia phase failed")
        stamp("phase 4, Ghia done")
        phase_bubble_gate(dev, card)
        stamp("phase 4, bubble gate done")
        phase_spurious_gate(dev, card)
        stamp("phase 4, spurious gate done")
        phase_droplet3d_gate(dev, card)
        stamp("phase 4, this process's gates done")
        phase_slice6_gates(dev, card, last, stamp)
        del last
        finish_gates(gates, t_gates)
        stamp("phase 4, gate jobs done")
    finally:
        stop_gates(gates)

    print(json.dumps({"kernels": list(record.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
