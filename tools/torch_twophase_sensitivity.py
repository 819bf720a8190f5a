#!/usr/bin/env python3
"""How the two-phase step's kernels-vs-plain agreement depends on each
kernel's rounding, for one checkout of gerris_tpu_torch on a card.

    python3 tools/torch_twophase_sensitivity.py [ROOT] [--save DIR [Kn]]

ROOT is the checkout to measure (default: the one holding this script);
its gerris_tpu_torch and chip_smoke.py are imported, its kernels built.
Runs chip_smoke's twophase configuration (1024^2, float32) for init + 5
steps through the plain versions, then through the kernels with subsets
of the two-phase path's wrappers (K15, K4, K6, K14, K9) swapped to their
plain versions, and prints for each run max|a - b| / max|b| of U, V, T
and the mean-free P against the plain run: the quantity and the steps
of chip_smoke's phase-3 gate (bound 2e-3).  A kernel that agrees with
its plain version to float32 rounding can still move the result past
the gate through the VOF and curvature code's discrete decisions (the
interface mask, the height-function choices), so the runs fall into a
few discrete outcomes.

With ``--save DIR`` it also steps the kernels' run (with ``Kn``, that
kernel alone, the others' plain versions: the "Kn alone" case) and the
plain run side by side, prints their distance after each step, and at
the first step after which U differs by more than 1e-3 of max|U| (half
the chip_smoke gate's bound: the jump) writes DIR/twophase_flip.npz: the
plain run's state before that step (float32, every field), the step's t,
dt and index, and U and T after the step from both runs, for replaying
that step elsewhere (tools/twophase_flip_replay.py: the JAX package's
step on the CPU, the port's in float32 and float64).
"""
import contextlib
import sys
from pathlib import Path

STEPS = 5
# U's kernels-vs-plain distance that marks the jump (--save)
JUMP = 1e-3


@contextlib.contextmanager
def swapped(pairs):
    """The wrappers of ``pairs`` (module, name) routed to their plain
    versions for the block."""
    saved = [getattr(m, n) for m, n in pairs]
    for m, n in pairs:
        setattr(m, n, getattr(m, n + "_plain"))
    try:
        yield
    finally:
        for (m, n), f in zip(pairs, saved):
            setattr(m, n, f)


def save_flip(cs, dev, out_dir, plain_pairs):
    """Step a run through the kernels, with ``plain_pairs`` swapped to
    their plain versions, beside the plain run (the --save mode of the
    module's docstring); returns the step of the jump, or None."""
    import numpy as np
    with swapped(plain_pairs):
        sk = cs.twophase_sim(dev)
    with cs.plain_versions():
        sp = cs.twophase_sim(dev)
    for step in range(STEPS):
        before = {k: v.cpu().numpy() for k, v in sp.state.items()}
        meta = dict(t=sp.time.t, i=sp.time.i, dt_plain=sp.dt or 0.0,
                    dt_kernels=sk.dt or 0.0)
        with swapped(plain_pairs):
            sk.run(max_steps=1)
        with cs.plain_versions():
            sp.run(max_steps=1)
        rels = {k: cs.rel_err(sk.state[k], sp.state[k])
                for k in ("U", "V", "T", "P")}
        print(f"twophase step {step + 1} (t {meta['t']:.6e}, dt "
              f"{sp.dt:.6e}), kernels vs plain: " +
              ", ".join(f"{k} {v:.3e}" for k, v in rels.items()),
              flush=True)
        if rels["U"] <= JUMP:
            continue
        if step == 0:
            # the initial projection runs inside Simulation.run, so a
            # replay would start before it
            print("twophase: the jump at step 1, not saved", flush=True)
            return 1
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            Path(out_dir) / "twophase_flip.npz",
            **{f"before_{k}": v for k, v in before.items()},
            **{f"{run}_{k}": s.state[k].cpu().numpy()
               for run, s in (("kernels", sk), ("plain", sp))
               for k in ("U", "T")},
            **{k: np.float64(v) for k, v in meta.items()})
        print(f"twophase: the jump at step {step + 1}; the state before it "
              f"in {out_dir}/twophase_flip.npz", flush=True)
        return step + 1
    print("twophase: no jump", flush=True)
    return None


def main():
    args = sys.argv[1:]
    save = alone = None
    if "--save" in args:
        k = args.index("--save")
        save = args[k + 1]
        del args[k:k + 2]
        if args and args[-1].startswith("K"):
            alone = args.pop()
    root = Path(args[0] if args
                else Path(__file__).resolve().parents[1]).resolve()
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke as cs
    from gerris_tpu_torch.ops.cuda import bcg, build, predict, projops, rbgs
    if not torch.cuda.is_available():
        print("torch_twophase_sensitivity: no CUDA device", file=sys.stderr)
        return 1
    build.library()
    dev = torch.device("cuda", 0)
    kernels = {"K15": [(rbgs, "rbgs_relax_alpha")],
               "K4": [(projops, "divergence_mac")],
               "K6": [(predict, "predict_xy")],
               "K14": [(bcg, "advect2d")],
               "K9": [(projops, "interp_faces")]}
    if save:
        save_flip(cs, dev, save, [p for k, v in kernels.items()
                                  if alone and k != alone for p in v])

    def run(ctx):
        with ctx:
            s = cs.twophase_sim(dev).run(max_steps=STEPS)
        return {k: v.clone() for k, v in s.state.items()}

    with cs.plain_versions():
        ref = run(contextlib.nullcontext())
    cases = {"kernels": []}
    for k in kernels:
        cases[f"{k} alone"] = [p for kk, v in kernels.items() if kk != k
                               for p in v]
        cases[f"all but {k}"] = kernels[k]
    for name, pairs in cases.items():
        got = run(swapped(pairs))
        rels = []
        for k in ("U", "V", "T", "P"):
            a, b = got[k], ref[k]
            if k == "P":
                a, b = a - a.mean(), b - b.mean()
            rels.append(f"{k} {cs.rel_err(a, b):.3e}")
        print(f"{root.name or root} {name}: " + ", ".join(rels), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
