#!/usr/bin/env python3
"""Host and device cost of the port's 2D multigrid wrappers, and the
bench's 2048^2 lid step, for one checkout of gerris_tpu_torch on a card.

    python3 tools/torch_host_cost.py [ROOT]

ROOT is the checkout to measure (default: the one holding this script);
its gerris_tpu_torch and chip_smoke.py are imported, its kernels built.
To compare two commits, unpack one into a directory that .gitignore
lists (git archive) and run the script on both in one session, in turns.

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
  (K14, u with the same folds);
* ``step_ms``: the lid step of chip_smoke.lid_cfg(11) (the bench's
  route), the median of five 20-step windows closed by a synchronize,
  after init and 20 steps;
* the card's name and power limit (nvidia-smi).
"""
import json
import subprocess
import sys
import time
from pathlib import Path

CALLS = 1000
EVENT_CALLS = 100
WINDOWS, WINDOW_STEPS = 5, 20


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


def main():
    root = Path(sys.argv[1] if len(sys.argv) > 1
                else Path(__file__).resolve().parents[1]).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    import torch.nn.functional as F
    import chip_smoke
    from gerris_tpu_torch.models.simulation import Simulation, Time
    from gerris_tpu_torch.ops.cuda import bcg, build, predict, rbgs
    if not torch.cuda.is_available():
        print("torch_host_cost: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    build.library()
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
    }
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
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
