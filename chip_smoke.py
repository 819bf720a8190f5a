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
     the predictor, projection and advection kernels K6, K4, K5 (with and
     without the cells), K9 (with and without gp and div_scale) and K14
     (both components, with and without the gp/oscale folds) at 2048^2
     and 64^2, plus K4's div bit-identical across two block shapes; then
     each kernel's time against its plain version's at the main-path
     shapes, float32 (CUDA events);
  3. main path: Simulation.init() + 20 steps of the 2048^2 lid cavity under
     the bench schedule, float32, through the kernels: finite values,
     launch counts, agreement with the same steps through the plain
     versions on the card, the median step rate of five timed windows,
     and a torch.profiler split of the step's device time;
  4. physics: the 64^2 lid cavity under the bench schedule to steady state
     (EventStop U 1e-4 every 10 steps, at most 20000 steps), float32,
     against Ghia, Ghia & Shin (1982) at the reference tolerances and by
     the reference's measure (tests/test_lid.py).
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
}
# launches on the main path: init + MAIN_STEPS steps.  Per step: 4 solves
# (2 projections + 2 diffusion components) of K1-K3; K6 once; K4 and K5
# once per projection; K9 once; K14 once per component.  The initial
# projection adds one solve, one K9, one K4 and one K5.
WANT_LAUNCHES = {
    "residual_restrict": 4 * MAIN_STEPS + 1,
    "cascade_prolong_relax": 4 * MAIN_STEPS + 1,
    "prolong_relax": 4 * MAIN_STEPS + 1,
    "predict_xy": MAIN_STEPS,
    "divergence_mac": 2 * MAIN_STEPS + 1,
    "correct_project": 2 * MAIN_STEPS + 1,
    "interp_faces": MAIN_STEPS + 1,
    "advect2d": 2 * MAIN_STEPS,
}
# device kernels of the port, by a substring of their names
OWN_KERNELS = ("residual_restrict_kernel", "restrict2_kernel",
               "prolong_relax_kernel", "divergence_mac_kernel",
               "correct_project_kernel", "interp_faces_kernel",
               "predict_xy_kernel", "advect2d_kernel", "sum_partials_kernel")


def lid_cfg(level):
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.core.grid import Grid
    from gerris_tpu_torch.models import ns
    from gerris_tpu_torch.solvers.poisson import MultilevelParams
    u_bc = bc.FieldBC.make(2, default=bc.Dirichlet(0.0), top=bc.Dirichlet(1.0))
    v_bc = bc.FieldBC.uniform(bc.Dirichlet(0.0), 2)
    # the bench schedule with the TPU floors applied (utils/convert):
    # projections 5 sweeps/level at omega 1.5, diffusion 1 sweep, 40
    # coarsest sweeps, one cycle per solve
    proj = MultilevelParams(nrelax=5, omega=1.5, coarsest_relax=40)
    diff = MultilevelParams(nrelax=1, omega=1.0, coarsest_relax=40)
    return ns.NSConfig(grid=Grid(level=level), u_bcs=(u_bc, v_bc), nu=1e-3,
                       beta=1.0, projection=proj, approx_projection=proj,
                       diffusion_params=diff)


def launch_counts():
    from gerris_tpu_torch.ops.cuda import bcg, predict, projops, rbgs
    return {**rbgs.LAUNCHES, **projops.LAUNCHES, **predict.LAUNCHES,
            **bcg.LAUNCHES}


def reset_launch_counts():
    from gerris_tpu_torch.ops.cuda import bcg, predict, projops, rbgs
    for mod in (rbgs, projops, predict, bcg):
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
    from gerris_tpu_torch.ops.cuda import bcg, predict, projops, rbgs
    swaps = [(rbgs, "residual_restrict"), (rbgs, "cascade_prolong_relax"),
             (rbgs, "prolong_relax"), (projops, "divergence_mac"),
             (projops, "correct_project"), (projops, "interp_faces"),
             (predict, "predict_xy"), (bcg, "advect2d")]
    saved = [getattr(mod, name) for mod, name in swaps]
    for mod, name in swaps:
        setattr(mod, name, getattr(mod, name + "_plain"))
    try:
        yield
    finally:
        for (mod, name), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def check_face_kernels(rnd, dtype, n, record):
    """K6, K4, K5, K9 and K14 against their plain versions at n^2 (the
    lid's BCs, dt = 0.8 h, the diffusion rhs scale of nu = 1e-3); errors
    go to ``record`` when it is given."""
    import torch
    from gerris_tpu_torch.ops.cuda import bcg, predict, projops
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
    if record is not None:
        for k, es in errs.items():
            record[k].update(zip(ERR_KEYS, map(max, zip(*es))))


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
        # the predictor and projection kernels at the main path's size
        # and at the Ghia phase's
        check_face_kernels(rnd, dtype, n, record if main else None)
        check_face_kernels(rnd, dtype, N_SMALL, None)

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

    # times at the main path's shapes, float32 (CUDA events).  Each entry:
    # (kernel call, plain call, input bytes, operations, library call)
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
    cascade_ops = sum(cycle_flops(m, 5, 1.5) for m in (1024, 512, 256, 128,
                                                       64, 32)) + \
        cycle_flops(16, 40, 1.5) + sum(m * m * 3 for m in (256, 128, 64, 32,
                                                           16))
    timings["cascade_prolong_relax"] = (
        lambda: rbgs.cascade_prolong_relax(r1, r2, 0.0, **kw2),
        lambda: rbgs.cascade_prolong_relax_plain(r1, r2, 0.0, **kw2),
        nbytes(r1, r2), cascade_ops, None)
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
    timings["correct_project without cells"] = (
        lambda: projops.correct_project(p, ufx, ufy, dt, grid, p_bc),
        lambda: projops.correct_project_plain(p, ufx, ufy, dt, grid, p_bc),
        nbytes(p, ufx, ufy), n * n * 16, None)
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
    print("phase 2 times (float32, main-path shapes; plain, kernel, "
          "kernel, plain)")
    for k, (kern, plain, in_bytes, ops, lib) in timings.items():
        p1 = cuda_ms(plain)
        k1 = cuda_ms(kern)
        k2 = cuda_ms(kern)
        p2 = cuda_ms(plain)
        lib_ms = None if lib is None else cuda_ms(lib)
        bms, by = bound(in_bytes, kern(), ops)
        vals = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}
        if k.endswith(" without cells"):
            record["correct_project"].update(
                {f"{key}_without_cells": v for key, v in vals.items()
                 if key in ("ms", "plain_ms", "bound_ms")})
        else:
            record[k].update(vals)
        print(f"  {k}: kernel {k1:.4f} {k2:.4f} ms, plain {p1:.4f} "
              f"{p2:.4f} ms, bound {bms:.4f} ms ({by})"
              + ("" if lib_ms is None else f", library {lib_ms:.4f} ms"))


def phase_main_path(dev, card):
    import torch
    from gerris_tpu_torch.models.simulation import Simulation, Time
    cfg = lid_cfg(11)
    h = cfg.grid.h
    print(f"phase 3: {N_MAIN}^2 lid cavity, float32, {MAIN_STEPS} steps")

    def sim():
        # dtmax = the bench's fixed dt 0.8 h; from rest the CFL bound is
        # unbounded, later steps run at 0.8 h / max|u| <= 0.8 h
        return Simulation(cfg, time=Time(dtmax=0.8 * h), device=dev,
                          dtype=torch.float32).init()

    s = sim()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.run(max_steps=MAIN_STEPS)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    counts = launch_counts()
    print(f"  run incl. initial projection: {t_run:.3f} s; launches {counts}")
    for k, want in WANT_LAUNCHES.items():
        if counts[k] != want:
            raise AssertionError(f"{k}: {counts[k]} launches, want {want}")
    for k in ("restrict2", "cascade.prolong_relax"):
        if counts[k] == 0:
            raise AssertionError(f"{k}: never launched on the main path")
    for k, v in s.state.items():
        if v.shape != cfg.grid.shape or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{k}: not finite or wrong shape")
    state = {k: s.state[k].clone() for k in ("U", "V", "P")}

    with plain_versions():
        ref = sim().run(max_steps=MAIN_STEPS)
    if launch_counts() != counts:
        raise AssertionError("the plain reference run launched kernels")
    for k, v in state.items():
        rel = float((v - ref.state[k]).abs().max() / ref.state[k].abs().max())
        print(f"  kernels vs plain after {MAIN_STEPS} steps, {k}: "
              f"rel {rel:.3e} (bound {MAIN_PATH_RTOL:.0e})")
        if not rel <= MAIN_PATH_RTOL:
            raise AssertionError(f"main path {k}: rel {rel:.3e}")

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
    return counts


def phase_profile(s, step_s, card):
    """torch.profiler over PROFILE_STEPS steps of the running simulation:
    device time by kernel, the port's kernels against the plain torch
    ops, and the device's busy share of an unprofiled step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        s.run(max_steps=PROFILE_STEPS)
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
    busy = total / 1e6 / PROFILE_STEPS
    print(f"  profile, {PROFILE_STEPS} steps on {card}: device {total / 1e3:.3f}"
          f" ms ({busy * 1e3:.3f} ms/step); {launches / PROFILE_STEPS:.0f} "
          f"device ops per step")
    print(f"  port kernels {own / 1e3:.3f} ms ({100 * own / total:.1f}%), "
          f"plain torch {(total - own) / 1e3:.3f} ms "
          f"({100 * (total - own) / total:.1f}%); unprofiled step "
          f"{step_s * 1e3:.3f} ms, device busy {100 * busy / step_s:.1f}% "
          f"of it")
    for us, count, key in rows[:16]:
        print(f"    {us / 1e3:9.3f} ms {100 * us / total:5.1f}% "
              f"{count / PROFILE_STEPS:6.1f}/step  {key[:90]}")


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
    # no matrix product or convolution runs in this slice; TF32 is pinned
    # off all the same, so no float32 reference could round to it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.library()
    print(f"phase 1: kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")

    record = {k: {"name": k, "route": "cuda", "source": src, "replaces": rep}
              for k, (src, rep) in KERNELS.items()}
    phase_kernels(dev, record)
    counts = phase_main_path(dev, card)
    for k in record:
        record[k]["launches"] = counts[k]
    record["cascade_prolong_relax"]["launches_prolong_relax"] = \
        counts["cascade.prolong_relax"]

    ok, eu, ev = phase_physics(dev, card)
    if not (ok and eu <= GHIA_LINF_U and ev <= GHIA_LINF_V):
        if not ok:
            # for the diagnosis: the same run in f64
            phase_physics(dev, card, "float64")
        raise AssertionError("Ghia phase failed")

    print(json.dumps({"kernels": list(record.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
