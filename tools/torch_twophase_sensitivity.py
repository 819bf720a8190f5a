#!/usr/bin/env python3
"""How the two-phase step's kernels-vs-plain agreement depends on each
kernel's rounding, for one checkout of gerris_tpu_torch on a card.

    python3 tools/torch_twophase_sensitivity.py [ROOT]

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
"""
import contextlib
import sys
from pathlib import Path

STEPS = 5


def main():
    root = Path(sys.argv[1] if len(sys.argv) > 1
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

    @contextlib.contextmanager
    def swapped(pairs):
        saved = [getattr(m, n) for m, n in pairs]
        for m, n in pairs:
            setattr(m, n, getattr(m, n + "_plain"))
        try:
            yield
        finally:
            for (m, n), f in zip(pairs, saved):
                setattr(m, n, f)

    def run(ctx):
        with ctx:
            s = cs.twophase_sim(dev).run(max_steps=STEPS)
        return {k: v.clone() for k, v in s.state.items()}

    with cs.plain_versions():
        ref = run(contextlib.nullcontext())
    kernels = {"K15": [(rbgs, "rbgs_relax_alpha")],
               "K4": [(projops, "divergence_mac")],
               "K6": [(predict, "predict_xy")],
               "K14": [(bcg, "advect2d")],
               "K9": [(projops, "interp_faces")]}
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
