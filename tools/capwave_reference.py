#!/usr/bin/env python3
"""The capillary wave (Gerris test/capwave; Popinet, J. Comput. Phys. 228
(2009) 5838-5866, section 5.3, against Prosperetti's 1981 solution) on
the JAX package, gerris_tpu, on the CPU in float64: the reference values
that chip_smoke.py's capwave gate holds the port to.

    python3 tools/capwave_reference.py LEVEL [OUT.json]

Runs tests/test_capwave.py's configuration (the 1 x 3 box at origin
(-0.5, -1.5), periodic in x, u Neumann and v Dirichlet 0 on y, nu
0.0182571749236, sigma 1, equal densities, T from y - 0.01 cos(2 pi x),
every solve to 1e-6 in at most 100 / 100 / 20 cycles) at 2^LEVEL x
3 2^LEVEL cells to t = 2.2426211256, the amplitude sampled every
3.04290519077e-3 as that test samples it, and prints the relative RMS
error against Prosperetti's amplitude (the test's measure), the steps,
the samples and the seconds; with OUT.json it writes them there.
Level 4 and level 5 each take about a minute on the CPU.  It imports jax
and gerris_tpu; the port and chip_smoke.py import neither.
"""
import json
import os
import sys
import time


def main():
    level = int(sys.argv[1])
    out = sys.argv[2] if len(sys.argv) > 2 else None
    os.environ["JAX_PLATFORMS"] = "cpu"
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "tests"))
    import jax
    jax.config.update("jax_enable_x64", True)
    import test_capwave

    t0 = time.time()
    samples = []
    orig = test_capwave.amplitude

    def amplitude(sim):
        a = orig(sim)
        samples.append((sim.time.t, a, sim.time.i))
        return a

    test_capwave.amplitude = amplitude
    rms = test_capwave.run_level(level)
    res = dict(level=level, rms=rms, steps=samples[-1][2],
               samples=len(samples), t_last=samples[-1][0],
               amp_last=samples[-1][1], seconds=time.time() - t0)
    print(json.dumps(res), flush=True)
    if out:
        with open(out, "w") as f:
            json.dump(res, f)


if __name__ == "__main__":
    main()
