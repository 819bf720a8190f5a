#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gerris_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result):
  1. setup: the card's name and power limit, torch/CUDA versions, the
     kernels' build from gerris_tpu_torch/csrc;
  2. kernel checks: every kernel wrapper against its plain version on the
     card, at the 2048^2 main-path shapes and its coarser levels, float64
     and float32, plus K3's tile invariance;
  3. main path: Simulation.init() + 20 steps of the 2048^2 lid cavity under
     the bench schedule, float32, through the kernels: finite values,
     launch counts, agreement with the same steps through the plain
     versions on the card, and the step rate of a timed window;
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
MAIN_STEPS = 20
TIMED_STEPS = 20
# main path, kernels vs plain versions after MAIN_STEPS float32 steps,
# max|a - b| / max|b| over U, V, P.  Each kernel agrees with its plain
# version to ~1e-7 of max|ref| (float32 rounding, FMA contraction); the
# solves carry that into P, measured at 7.5e-6 on an H100 (PERF.md).
# 1e-4 leaves 13x for other cards and inputs, and stays far below what
# a wrong sweep, ghost or colour gives (1e-2 and up)
MAIN_PATH_RTOL = 1e-4
GHIA_LINF_U, GHIA_LINF_V = 2e-2, 1.7e-2

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

SOURCE = "gerris_tpu_torch/csrc/rbgs.cu"
ERR_KEYS = ("max_abs_err", "max_rel_err")
REPLACES = {
    "residual_restrict": "gerris_tpu/ops/pallas/rbgs.py:1234",
    "cascade_prolong_relax": "gerris_tpu/ops/pallas/rbgs.py:1446",
    "restrict2": "gerris_tpu/ops/pallas/rbgs.py:1446",
    "prolong_relax": "gerris_tpu/ops/pallas/rbgs.py:468",
}


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
    worst = worst_rel = 0.0
    for g, r in zip(got, ref):
        err = float((g - r).abs().max())
        scale = float(r.abs().max())
        rel = err / scale
        print(f"  {name}: max_abs_err={err:.3e} max|ref|={scale:.3e} "
              f"rel={rel:.3e} bound={bound:.0e}")
        if not rel <= bound:
            raise AssertionError(f"{name}: rel {rel:.3e} > {bound:.0e}")
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
    return worst, worst_rel


@contextlib.contextmanager
def plain_versions():
    """Route the cycle through the plain versions (the card-side
    reference run)."""
    from gerris_tpu_torch.ops.cuda import rbgs
    saved = (rbgs.residual_restrict, rbgs.cascade_prolong_relax,
             rbgs.prolong_relax)
    rbgs.residual_restrict = rbgs.residual_restrict_plain
    rbgs.cascade_prolong_relax = rbgs.cascade_prolong_relax_plain
    rbgs.prolong_relax = rbgs.prolong_relax_plain
    try:
        yield
    finally:
        (rbgs.residual_restrict, rbgs.cascade_prolong_relax,
         rbgs.prolong_relax) = saved


def phase_kernels(dev, record):
    import torch
    from gerris_tpu_torch.ops.cuda import rbgs
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
        b13 = 1e-12 if dtype == torch.float64 else 1e-5
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

    # times at the main path's shapes, float32 (CUDA events)
    f32 = torch.float32
    u, rhs, sub = rnd(f32, n, n), rnd(f32, n, n), rnd(f32, 1)
    kw = dict(h2=h2, signs=signs, offs=offs, per_y=False)
    timings = {
        "residual_restrict": (
            lambda: rbgs.residual_restrict(u, rhs, 0.0, sub, **kw),
            lambda: rbgs.residual_restrict_plain(u, rhs, 0.0, sub, **kw)),
    }
    r512 = rnd(f32, 512, 512)
    timings["restrict2"] = (lambda: rbgs.restrict2(r512),
                            lambda: rbgs.pool_plain(r512))
    c = rnd(f32, n // 2, n // 2)
    kw3 = dict(nsweeps=5, h2=h2, signs=signs, per_y=False, omega=1.5)
    timings["prolong_relax"] = (
        lambda: rbgs.prolong_relax(c, rhs, 0.0, u, **kw3),
        lambda: rbgs.prolong_relax_plain(c, rhs, 0.0, u, **kw3))
    r1, r2 = rnd(f32, n // 2, n // 2), rnd(f32, n // 4, n // 4)
    kw2 = dict(nsweeps=5, coarsest=40, h2_half=4 * h2, signs=signs,
               per_y=False, omega=1.5)
    timings["cascade_prolong_relax"] = (
        lambda: rbgs.cascade_prolong_relax(r1, r2, 0.0, **kw2),
        lambda: rbgs.cascade_prolong_relax_plain(r1, r2, 0.0, **kw2))
    print("phase 2 times (float32, main-path shapes; plain, kernel, "
          "kernel, plain)")
    for k, (kern, plain) in timings.items():
        p1 = cuda_ms(plain)
        k1 = cuda_ms(kern)
        k2 = cuda_ms(kern)
        p2 = cuda_ms(plain)
        record[k]["ms"] = min(k1, k2)
        record[k]["plain_ms"] = min(p1, p2)
        print(f"  {k}: kernel {k1:.4f} {k2:.4f} ms, plain {p1:.4f} "
              f"{p2:.4f} ms")


def phase_main_path(dev, card):
    import torch
    from gerris_tpu_torch.models.simulation import Simulation, Time
    from gerris_tpu_torch.ops.cuda import rbgs
    cfg = lid_cfg(11)
    h = cfg.grid.h
    print(f"phase 3: {N_MAIN}^2 lid cavity, float32, {MAIN_STEPS} steps")

    def sim():
        # dtmax = the bench's fixed dt 0.8 h; from rest the CFL bound is
        # unbounded, later steps run at 0.8 h / max|u| <= 0.8 h
        return Simulation(cfg, time=Time(dtmax=0.8 * h), device=dev,
                          dtype=torch.float32).init()

    s = sim()
    rbgs.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.run(max_steps=MAIN_STEPS)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    counts = dict(rbgs.LAUNCHES)
    print(f"  run incl. initial projection: {t_run:.3f} s; launches {counts}")
    want = 4 * MAIN_STEPS + 1
    for k in ("residual_restrict", "cascade_prolong_relax", "prolong_relax"):
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
    if rbgs.LAUNCHES != counts:
        raise AssertionError("the plain reference run launched kernels")
    worst = 0.0
    for k, v in state.items():
        rel = float((v - ref.state[k]).abs().max() / ref.state[k].abs().max())
        worst = max(worst, rel)
        print(f"  kernels vs plain after {MAIN_STEPS} steps, {k}: "
              f"rel {rel:.3e} (bound {MAIN_PATH_RTOL:.0e})")
        if not rel <= MAIN_PATH_RTOL:
            raise AssertionError(f"main path {k}: rel {rel:.3e}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.run(max_steps=TIMED_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    sps = TIMED_STEPS / dt
    print(f"  timed window: {TIMED_STEPS} steps in {dt:.4f} s = "
          f"{sps:.3f} steps/s, {sps * N_MAIN ** 2 / 1e6:.2f}M "
          f"cell-updates/s on {card}")
    return counts


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

    record = {k: {"name": k, "route": "cuda", "source": SOURCE,
                  "replaces": v} for k, v in REPLACES.items()}
    phase_kernels(dev, record)
    counts = phase_main_path(dev, card)
    for k in record:
        record[k]["launches"] = counts[k]
    record["cascade_prolong_relax"]["launches_prolong_relax"] = \
        counts["cascade.prolong_relax"]

    ok, eu, ev = phase_physics(dev, card)
    if not (ok and eu <= GHIA_LINF_U and ev <= GHIA_LINF_V):
        if not ok:
            # the finding the instructions ask for: the same run in f64
            phase_physics(dev, card, "float64")
        raise AssertionError("Ghia phase failed")

    print(json.dumps({"kernels": list(record.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
