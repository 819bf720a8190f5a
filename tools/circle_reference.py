#!/usr/bin/env python3
"""Gerris test/circle (Poisson around an embedded disk, the natural
Neumann condition on its surface) on the JAX package, gerris_tpu, on the
CPU in float64: the reference values that chip_smoke.py's circle gate
holds the port to.

    python3 tools/circle_reference.py LEVEL [OUT.json]

Runs tests/test_circle.py's richardson_error(LEVEL): the disk of radius
0.25 at the origin (fluid outside), the rhs of test/poisson with K = 3,
Neumann box walls, 10 cycles with erelax 2 at LEVEL and LEVEL + 1
(gerris_tpu.physics.solid.poisson_solid_solve), and the L1, L2 and Linf
norms of the difference between the level's solution and the next
level's, volume-weighted restricted, both less their fluid means, on
the cells fluid at both.  It prints them as one JSON line and writes
them to OUT.json when given.  At LEVEL 6 it takes about a minute on the
CPU.  It imports jax and gerris_tpu; the port and chip_smoke.py import
neither.
"""
import json
import os
import sys
import time


def main():
    level = int(sys.argv[1])
    os.environ["JAX_PLATFORMS"] = "cpu"
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "tests"))
    import jax
    jax.config.update("jax_enable_x64", True)
    import test_circle

    t0 = time.perf_counter()
    l1, l2, linf = test_circle.richardson_error(level)
    res = dict(level=level, l1=l1, l2=l2, linf=linf,
               seconds=time.perf_counter() - t0)
    print(json.dumps(res))
    if len(sys.argv) > 2:
        with open(sys.argv[2], "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
