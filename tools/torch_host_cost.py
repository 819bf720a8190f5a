#!/usr/bin/env python3
"""Host and device cost of the port's multigrid wrappers, and the bench's
2048^2 lid step, for one checkout of gerris_tpu_torch on a card.

    python3 tools/torch_host_cost.py [ROOT] [--digests | --warps]

ROOT is the checkout to measure (default: the one holding this script);
its gerris_tpu_torch and chip_smoke.py are imported, its kernels built.
To compare two commits, unpack one into a directory that .gitignore
lists (git archive) and run the script on both in one session, in turns.
With ``--digests`` it prints the card and the digests only; with
``--warps`` the card and the block kernel's device time per launch at
the main path's two cascade tails (chip_smoke.main_tails) for each of
its launch shapes (rbgs.CB_WARPS_SHAPES: warps at 16^2 and below x
warps at 32^2), where the checkout has them.

Prints one JSON line, float32 throughout:
* per wrapper, ``host_us``: time.perf_counter over 1000 calls with no
  synchronisation, per call (the card's queue absorbs the launches, so
  this is the host's own time), and ``device_ms``: CUDA events around
  100 back-to-back calls after a warm-up, per call (the larger of the
  kernels' time and the host's); restrict2 and F.avg_pool2d at 512^2,
  prolong_relax at 2048^2 (5 sweeps, omega 1.5, + u),
  cascade_prolong_relax at n/2 = 1024 (5 sweeps, 40 coarsest), and the
  BCG kernels at 2048^2 with the lid's BCs as the main path runs them:
  predict_xy (K6), advect2d_pair (K7, g, gp and oscale) and advect2d
  (K14, u with the same folds); the two-phase smoother K15 at 1024^2
  (cell dia, 8 sweeps) from a given u and with a coarse correction
  (``rbgs_relax_alpha_coarse``: one launch where K15 takes the coarse
  correction, else the plain prolongation then K15, as the 2D alpha
  correction ran them); K10 at 2048^2 (4 sweeps, walls and doubly
  periodic);
* ``digests``: SHA-256 of the outputs of K3, K8c, K17, K2, K8b and K12
  (each cascade's own K3 launches) and of K15 (from u, cell and scalar
  dia, walls and doubly periodic; and a coarse correction + u: the fold
  where K15 takes it, else prolong_plain, K15 and the sum), of K1, K8a
  and K16 (sub a device tensor, periodic columns or not) and of K13
  (from u, and from a coarse correction with and without + u: the fold
  where K13 takes it, else poisson.prolong, K13 and the sum; walls and
  Neumann) on fixed inputs, float32 and float64, and of chip_smoke's
  twophase state after init + 5 steps and lid3d's U, V, W, P after init
  + 5 steps, to hold two checkouts bit for bit; of K4 (div and total,
  2048^2 and a ragged 100 x 72 grid), of the block kernel's function
  where both checkouts compute it (a cascade at n/2 = 64, omega 1.5 and
  per_y, single and as a pair with two dias: the whole cascade is its
  tail; K12 with dia 3 at 512^2 and its 64^2 block alone) and of the
  2048^2 main path's U, V, P after init + 5 steps (``main_5``);
* ``device_us``: torch.profiler's device time per call of K1 and K4 at
  2048^2, of K12 at 512^2 (``coarse_vcycle``: the pyramid, the block
  kernel and the K3 launches above 64^2, counted together) and of its
  block route alone (``coarse_block``, 64^2, 5 sweeps, 40 coarsest at
  16^2: where the block kernel restricts in the block, one launch, else
  one pyramid launch and the block kernel), of a cascade's tail as the main path runs it
  (its levels 64^2 to 16^2: K2's 5 sweeps at omega 1.5, K8b's pair at 1
  sweep; the parent's three K3 launches counted together), and of K13
  at each level of a lid3d projection's correction (32^3,
  64^3, 128^3: 4 sweeps at omega 1.5, Neumann, the coarser correction
  prolonged, + u at 128^3; the parent's prolongation, K13 and add
  counted together);
* ``step_ms``: the lid step of chip_smoke.lid_cfg(11) (the bench's
  route), the median of five 20-step windows closed by a synchronize,
  after init and 20 steps;
* ``main``, ``twophase``, ``adaptive_relax``, ``adaptive`` and ``lid3d``:
  chip_smoke's main path step (2048^2, the bench's route), twophase
  step (1024^2), adaptive_relax and adaptive steps (2048^2) and lid3d
  step (128^3),
  ms/step as the median of three timed windows after init and a few
  steps, and from torch.profiler over a few more steps the device
  ms/step, the device ops per step and, for twophase and lid3d, the ops
  per step of the kinds the plain prolongations ran (roll, where, cat,
  mul, add, arange, ==);
* the card's name and power limit (nvidia-smi).
"""
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

CALLS = 1000
EVENT_CALLS = 100
WINDOWS, WINDOW_STEPS = 5, 20
# (warm-up steps, windows, steps per window, profiled steps) of the
# twophase and adaptive_relax steps
ROUTE_STEPS = {"twophase": (3, 3, 4, 3), "adaptive_relax": (5, 3, 10, 5),
               "adaptive": (5, 3, 10, 5), "main": (20, 5, 20, 10),
               "lid3d": (3, 3, 5, 3)}
PROLONG_OPS = ("roll", "where", "CatArray", "MulFunctor", "CUDAFunctor_add",
               "arange", "CompareEqFunctor")


def host_us(fn, calls=CALLS):
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    out = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return out


def device_ms(fn, calls=EVENT_CALLS):
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def route_cost(sim, warm, windows, steps, profiled, watch=()):
    """ms/step (median of ``windows`` windows of ``steps`` steps after
    ``warm`` steps), device ms/step and device ops/step (torch.profiler
    over ``profiled`` steps), and the ops per step whose kernel names
    hold each substring of ``watch``."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sim.run(max_steps=warm)
    walls = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run(max_steps=steps)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sim.run(max_steps=profiled)
        torch.cuda.synchronize()
    us, ops, kinds = 0.0, 0, {w: 0 for w in watch}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        t = getattr(evt, "self_device_time_total", None)
        us += evt.self_cuda_time_total if t is None else t
        ops += evt.count
        for w in watch:
            if w in evt.key:
                kinds[w] += evt.count
    return {"step_ms": float(np.median(walls)) / steps * 1e3,
            "windows_s": walls, "device_ms": us / 1e3 / profiled,
            "device_ops": ops / profiled,
            "ops_by_kind": {w: c / profiled for w, c in kinds.items()}}


def device_us(fn, calls=100):
    """torch.profiler's device time per call of ``fn`` (every kernel it
    launches), after a warm-up."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            t = getattr(evt, "self_device_time_total", None)
            us += evt.self_cuda_time_total if t is None else t
    return us / calls


def k13_call(rbgs3d, poisson, bc, rhs, nsweeps, h2, signs, omega=1.0,
             u=None, coarse=None, add=None):
    """K13 from u, or from a coarse correction (+ add): the fold where K13
    takes it, else poisson.prolong, K13 and the sum as the parent's 3D
    correction ran them."""
    kw = dict(nsweeps=nsweeps, h2=h2, signs=signs, omega=omega)
    if u is not None:
        return rbgs3d.rbgs_relax_3d(u, rhs, 0.0, **kw)
    if "coarse" in inspect.signature(rbgs3d.rbgs_relax_3d).parameters:
        return rbgs3d.rbgs_relax_3d(None, rhs, 0.0, coarse=coarse, add=add,
                                    **kw)
    kind = bc.Neumann() if signs[0] > 0 else bc.Dirichlet(0.0)
    du = rbgs3d.rbgs_relax_3d(poisson.prolong(
        coarse, bc.FieldBC.uniform(kind, 3)), rhs, 0.0, **kw)
    return du if add is None else add + du


def sha(*ts):
    import hashlib
    h = hashlib.sha256()
    for t in ts:
        if t is not None:
            h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def digests(rbgs, dev, chip_smoke):
    """SHA-256 of the K3-family kernels', K15's and the twophase step's
    outputs on fixed inputs."""
    import torch
    fold = "coarse" in inspect.signature(rbgs.rbgs_relax_alpha).parameters
    out = {}
    for dtype in (torch.float32, torch.float64):
        gen = torch.Generator(device=dev).manual_seed(11)

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

        n = 1024
        sg = (-1.0, -1.0, 1.0, -1.0)
        c, rhs, u, v = rnd(n // 2, n // 2), rnd(n, n), rnd(n, n), rnd(n, n)
        ufx, ufy = rnd(n + 1, n), rnd(n, n + 1)
        kw = dict(nsweeps=5, h2=1.0 / n ** 2, signs=sg, omega=1.5)
        outs = {
            "k3": rbgs.prolong_relax(c, rhs, 0.0, u, **kw),
            "k3_per_y": rbgs.prolong_relax(c, rhs, 0.0, u, per_y=True, **kw),
            "k3_zero": rbgs.prolong_relax(None, rhs[:16, :16].contiguous(),
                                          0.0, **dict(kw, nsweeps=40)),
            "k8c": rbgs.prolong_relax_pair([c, c], [rhs, v], [0.0, 3.0],
                                           [u, None], **kw),
            "k17": rbgs.prolong_relax_correct(
                c, rhs, 0.0, u, ufx, ufy, 1e-3, 1.0 / n, (u, v),
                offs=(0.0, 0.0, 0.0, 0.5), **kw),
            "k2": rbgs.cascade_prolong_relax(
                rhs[:512, :512].contiguous(), c[:256, :256].contiguous(),
                0.0, nsweeps=5, coarsest=40, h2_half=4.0 / n ** 2,
                signs=sg, omega=1.5),
            "k8b": rbgs.cascade_prolong_relax_pair(
                [rhs[:512, :512].contiguous(), v[:512, :512].contiguous()],
                [c[:256, :256].contiguous(), c[256:, 256:].contiguous()],
                [0.0, 2.0], nsweeps=1, coarsest=40, h2_half=4.0 / n ** 2,
                signs=sg),
            "k12": rbgs.coarse_vcycle(c, 0.0, nsweeps=5, coarsest=40,
                                      h2=4.0 / n ** 2, signs=(1.0,) * 4),
        }
        ax, ay = 0.2 + rnd(n + 1, n).abs(), 0.2 + rnd(n, n + 1).abs()
        dia = 0.5 + rnd(n, n).abs()
        for per in ((False, False), (True, True)):
            if per[0]:
                ax[n], ay[:, n] = ax[0], ay[:, 0]
            kw = dict(nsweeps=8, h2=1.0 / n ** 2, periodic=per, omega=1.5,
                      signs=(1.0,) * 4 if per[0] else sg)
            tag = "per_xy" if per[0] else "walls"
            outs[f"k15_u_{tag}"] = rbgs.rbgs_relax_alpha(
                u, rhs, ax, ay, dia, dia_cell=True, **kw)
            outs[f"k15_scalar_{tag}"] = rbgs.rbgs_relax_alpha(
                u, rhs, ax, ay, 0.3, **kw)
            outs[f"k15_fold_{tag}"] = rbgs.rbgs_relax_alpha(
                None, rhs, ax, ay, dia, dia_cell=True, coarse=c, add=u,
                **kw) if fold else u + rbgs.rbgs_relax_alpha(
                rbgs.prolong_plain(c, kw["signs"], per), rhs, ax, ay, dia,
                dia_cell=True, **kw)
        for k, o in outs.items():
            out[f"{k}_{str(dtype)[6:]}"] = sha(
                *(o if isinstance(o, (tuple, list)) else (o,)))
    s = chip_smoke.twophase_sim(dev).run(max_steps=5)
    out["twophase_5"] = sha(*(s.state[k] for k in ("U", "V", "T", "P")))
    s = chip_smoke.lid_sim(dev, "pair").run(max_steps=5)
    out["main_5"] = sha(*(s.state[k] for k in ("U", "V", "P")))
    s = chip_smoke.lid3d_sim(dev).run(max_steps=5)
    out["lid3d_5"] = sha(*(s.state[k] for k in ("U", "V", "W", "P")))
    return out


def digests_k4_tail(rbgs, projops, dev):
    """SHA-256 of K4's outputs and of the block kernel's function on fixed
    inputs, computed through wrappers that both checkouts have."""
    import torch
    out = {}
    for dtype in (torch.float32, torch.float64):
        gen = torch.Generator(device=dev).manual_seed(13)

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

        tag = str(dtype)[6:]
        for n0, n1 in ((2048, 2048), (100, 72)):
            ufx, ufy = rnd(n0 + 1, n1), rnd(n0, n1 + 1)
            out[f"k4_{n0}x{n1}_{tag}"] = sha(
                *projops.divergence_mac(ufx, ufy, 0.3 / n1, 1.0 / n1))
        r1, r2, v1, v2 = rnd(64, 64), rnd(32, 32), rnd(64, 64), rnd(32, 32)
        sg = (-1.0, 1.0, 1.0, -1.0)
        kw = dict(nsweeps=5, coarsest=40, h2_half=1.0 / 64 ** 2, signs=sg,
                  omega=1.5)
        out[f"tail_{tag}"] = sha(rbgs.cascade_prolong_relax(
            r1, r2, 0.7, **kw))
        out[f"tail_per_y_{tag}"] = sha(rbgs.cascade_prolong_relax(
            r1, r2, 0.0, per_y=True, **dict(kw, signs=(1.0,) * 4)))
        out[f"tail_pair_{tag}"] = sha(*rbgs.cascade_prolong_relax_pair(
            [r1, v1], [r2, v2], [0.0, 2.5], **kw))
        r512, r64 = rnd(512, 512), rnd(64, 64)
        kw12 = dict(nsweeps=5, coarsest=40, signs=sg)
        out[f"k12_dia_{tag}"] = sha(rbgs.coarse_vcycle(
            r512, 3.0, h2=1.0 / 512 ** 2, **kw12))
        out[f"k12_block_dia_{tag}"] = sha(rbgs.coarse_block(
            r64, 3.0, h2=1.0 / 64 ** 2, **kw12))
    return out


def warps_sweep(rbgs, chip_smoke, dev):
    """Device us per launch of the block kernel at the main path's cascade
    tails, K2's and K8b's, for each launch shape it takes."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(12)

    def rnd(dtype, *shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    dia = 1.0 / (0.8 / chip_smoke.N_MAIN * 1e-3)
    tails = chip_smoke.main_tails(rnd, torch.float32, dia)
    return {"x".join(map(str, w)): {
        name: device_us(lambda a=a, w=w: rbgs._coarse_block_cuda(
            *a[:6], False, a[6], "coarse_block", warps=w))
        for name, a in tails.items()} for w in rbgs.CB_WARPS_SHAPES}


def digests_k1_k13(rbgs, rbgs3d, poisson, bc, dev):
    """SHA-256 of K1, K8a, K16 and K13's outputs on fixed inputs."""
    import torch
    out = {}
    for dtype in (torch.float32, torch.float64):
        gen = torch.Generator(device=dev).manual_seed(12)

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

        n = 1024
        u, v, rhs, w = rnd(n, n), rnd(n, n), rnd(n, n), rnd(n, n)
        ufx, ufy, sub = rnd(n + 1, n), rnd(n, n + 1), rnd(1)
        offs = (0.0, 0.0, 0.0, 2.0)
        for per_y in (False, True):
            kw = dict(h2=1.0 / n ** 2, signs=(-1.0,) * 4, offs=offs,
                      per_y=per_y)
            tag = "per_y" if per_y else "walls"
            outs = {
                "k1": rbgs.residual_restrict(u, rhs, 0.6, sub, **kw),
                "k8a": [x for xs in rbgs.residual_restrict_pair(
                    [u, v], [rhs, w], [0.6, 2.0], [sub, 0.0], h2=1.0 / n ** 2,
                    signs=(-1.0,) * 4, offss=[offs, (0.0,) * 4],
                    per_y=per_y) for x in xs],
                "k16": rbgs.residual_restrict_div(u, ufx, ufy, 0.3 / n ** 2,
                                                  0.0, sub, **kw),
            }
            for k, o in outs.items():
                out[f"{k}_{tag}_{str(dtype)[6:]}"] = sha(*o)
        m = 128
        c, r3, u3 = rnd(m // 2, m // 2, m // 2), rnd(m, m, m), rnd(m, m, m)
        for signs, tag in (((-1.0,) * 6, "walls"), ((1.0,) * 6, "neumann")):
            kw = dict(nsweeps=4, h2=1.0 / m ** 2, signs=signs, omega=1.5)
            for name, extra in (("u", dict(u=u3)), ("fold", dict(coarse=c)),
                                ("fold_add", dict(coarse=c, add=u3))):
                o = k13_call(rbgs3d, poisson, bc, r3, **kw, **extra)
                out[f"k13_{name}_{tag}_{str(dtype)[6:]}"] = sha(o)
    return out


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    root = Path(args[0] if args
                else Path(__file__).resolve().parents[1]).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    import torch.nn.functional as F
    import chip_smoke
    from gerris_tpu_torch.models.simulation import Simulation, Time
    from gerris_tpu_torch.core import bc
    from gerris_tpu_torch.ops.cuda import (bcg, build, predict, projops,
                                           rbgs, rbgs3d)
    from gerris_tpu_torch.solvers import poisson
    if not torch.cuda.is_available():
        print("torch_host_cost: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    build.library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if "--warps" in sys.argv:
        print(json.dumps({"root": str(root), "card": card,
                          "warps_us": warps_sweep(rbgs, chip_smoke, dev)}))
        return 0
    if "--digests" in sys.argv:
        out = {"root": str(root), "card": card,
               "digests": digests(rbgs, dev, chip_smoke)}
        out["digests"].update(digests_k4_tail(rbgs, projops, dev))
        out["digests"].update(digests_k1_k13(rbgs, rbgs3d, poisson, bc, dev))
        print(json.dumps(out))
        return 0
    gen = torch.Generator(device=dev).manual_seed(8)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    n = 2048
    signs = (-1.0, -1.0, -1.0, -1.0)
    r512 = rnd(512, 512)
    r512_4d = r512.view(1, 1, 512, 512)
    c, rhs, u = rnd(n // 2, n // 2), rnd(n, n), rnd(n, n)
    r1, r2 = rnd(n // 2, n // 2), rnd(n // 4, n // 4)
    cfg = chip_smoke.lid_cfg(11)
    grid, u_bcs = cfg.grid, cfg.u_bcs
    dt = 0.8 * grid.h
    osc = -1.0 / (dt * cfg.nu)
    U, V, gx, gy, px, py = (rnd(n, n) for _ in range(6))
    ufx, ufy = rnd(n + 1, n), rnd(n, n + 1)
    calls = {
        "restrict2": lambda: rbgs.restrict2(r512),
        "avg_pool2d": lambda: F.avg_pool2d(r512_4d, 2),
        "prolong_relax": lambda: rbgs.prolong_relax(
            c, rhs, 0.0, u, nsweeps=5, h2=1.0 / n ** 2, signs=signs,
            omega=1.5),
        "cascade_prolong_relax": lambda: rbgs.cascade_prolong_relax(
            r1, r2, 0.0, nsweeps=5, coarsest=40, h2_half=4.0 / n ** 2,
            signs=signs, omega=1.5),
        "predict_xy": lambda: predict.predict_xy(U, V, dt, grid, u_bcs),
        "advect2d_pair": lambda: bcg.advect2d_pair(
            U, V, ufx, ufy, dt, grid, u_bcs, g=(gx, gy), gp=(px, py),
            oscale=osc),
        "advect2d": lambda: bcg.advect2d(U, 0, ufx, ufy, dt, grid, u_bcs[0],
                                         g=gx, gp=px, oscale=osc),
        "rbgs_relax": lambda: rbgs.rbgs_relax(
            u, rhs, 1e3, nsweeps=4, h2=1.0 / n ** 2, signs=signs),
        "rbgs_relax_periodic": lambda: rbgs.rbgs_relax(
            u, rhs, 0.0, nsweeps=4, h2=1.0 / n ** 2, signs=(1.0,) * 4,
            periodic=(True, True)),
    }
    # K15 at 1024^2, cell dia, 8 sweeps: from u, and with a coarse
    # correction (the fold where K15 takes it, else prolong + K15)
    na = 1024
    ua, ra, da = rnd(na, na), rnd(na, na), 0.5 + rnd(na, na).abs()
    axa, aya = 0.2 + rnd(na + 1, na).abs(), 0.2 + rnd(na, na + 1).abs()
    ca = rnd(na // 2, na // 2)
    kw15 = dict(nsweeps=8, h2=1.0 / na ** 2, signs=signs, dia_cell=True)
    calls["rbgs_relax_alpha"] = lambda: rbgs.rbgs_relax_alpha(
        ua, ra, axa, aya, da, **kw15)
    if "coarse" in inspect.signature(rbgs.rbgs_relax_alpha).parameters:
        calls["rbgs_relax_alpha_coarse"] = lambda: rbgs.rbgs_relax_alpha(
            None, ra, axa, aya, da, coarse=ca, **kw15)
    else:
        calls["rbgs_relax_alpha_coarse"] = lambda: rbgs.rbgs_relax_alpha(
            rbgs.prolong_plain(ca, signs, (False, False)), ra, axa, aya, da,
            **kw15)
    out = {"root": str(root)}
    for name, fn in calls.items():
        out[name] = {"host_us": host_us(fn), "device_ms": device_ms(fn)}
    sim = Simulation(cfg, time=Time(dtmax=0.8 * cfg.grid.h), device=dev,
                     dtype=torch.float32).init()
    sim.run(max_steps=WINDOW_STEPS)
    walls = []
    for _ in range(WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run(max_steps=WINDOW_STEPS)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out["step_ms"] = float(np.median(walls)) / WINDOW_STEPS * 1e3
    out["step_windows_s"] = walls
    del sim
    # device time per call: K1 at 2048^2, K13 per level of a lid3d
    # projection's correction
    sub = rnd(1)
    dev_us = {"residual_restrict": device_us(lambda: rbgs.residual_restrict(
        u, rhs, 0.0, sub, h2=1.0 / n ** 2, signs=signs)),
        "divergence_mac": device_us(lambda: projops.divergence_mac(
            ufx, ufy, dt, grid.h))}
    # the block kernel at K12's shape, and a cascade's tail as the main
    # path's K2 and K8b run it (at n/2 = 64 the whole cascade is the tail)
    r64, r32 = rnd(64, 64), rnd(32, 32)
    dev_us["coarse_vcycle"] = device_us(lambda: rbgs.coarse_vcycle(
        r512, 0.0, nsweeps=5, coarsest=40, h2=1.0 / 512 ** 2,
        signs=(1.0,) * 4))
    dev_us["coarse_block"] = device_us(lambda: rbgs.coarse_block(
        r64, 0.0, nsweeps=5, coarsest=40, h2=1.0 / 64 ** 2,
        signs=(1.0,) * 4))
    kwt = dict(coarsest=40, h2_half=1.0 / 64 ** 2, signs=signs)
    dev_us["tail_k2"] = device_us(lambda: rbgs.cascade_prolong_relax(
        r64, r32, 0.0, nsweeps=5, omega=1.5, **kwt))
    dev_us["tail_k8b"] = device_us(lambda: rbgs.cascade_prolong_relax_pair(
        [r64, r64], [r32, r32], [3.0, 3.0], nsweeps=1, **kwt))
    for m in (32, 64, 128):
        cl, rl = rnd(m // 2, m // 2, m // 2), rnd(m, m, m)
        al = rnd(m, m, m) if m == 128 else None
        dev_us[f"rbgs_relax_3d_{m}"] = device_us(
            lambda: k13_call(rbgs3d, poisson, bc, rl, 4, 1.0 / m ** 2,
                             (1.0,) * 6, 1.5, coarse=cl, add=al))
        dev_us[f"rbgs_relax_3d_{m}_u"] = device_us(
            lambda: k13_call(rbgs3d, poisson, bc, rl, 4, 1.0 / m ** 2,
                             (1.0,) * 6, 1.5, u=rl))
    out["device_us"] = dev_us
    out["digests"] = digests(rbgs, dev, chip_smoke)
    out["digests"].update(digests_k4_tail(rbgs, projops, dev))
    out["digests"].update(digests_k1_k13(rbgs, rbgs3d, poisson, bc, dev))
    out["main"] = route_cost(chip_smoke.lid_sim(dev, "pair"),
                             *ROUTE_STEPS["main"])
    out["twophase"] = route_cost(chip_smoke.twophase_sim(dev),
                                 *ROUTE_STEPS["twophase"], watch=PROLONG_OPS)
    out["adaptive_relax"] = route_cost(
        chip_smoke.ada_sim(dev, "relax").init(),
        *ROUTE_STEPS["adaptive_relax"])
    out["adaptive"] = route_cost(chip_smoke.ada_sim(dev, "adaptive").init(),
                                 *ROUTE_STEPS["adaptive"])
    out["lid3d"] = route_cost(chip_smoke.lid3d_sim(dev),
                              *ROUTE_STEPS["lid3d"], watch=PROLONG_OPS)
    out["card"] = card
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
