"""The ``gerris`` command line on the card (port of gerris_tpu/cli.py).

Reference: src/gerris.c -- option parsing:200-300, -D defines:245-259
(the m4 pipeline reduced to NAME=VALUE substitution), the one-shot -e
event:300-316, and -s box splitting.

Usage:
    python -m gerris_tpu_torch [options] file.gfs
    -D NAME=VALUE    define a macro (repeatable)
    -e EVENT         a one-shot event after the run, e.g.
                     "OutputScalarNorm P"
    -s N             what -s would do (the dense grid is already the
                     split layout; informational)
    -V               versions and the device
    --dry-run        parse and build, print a summary, run no step
    -3               run in 3D (the reference's gerris3D)
    --device DEV     cuda (the default) or cpu
    --dtype DTYPE    float32 (the default, as gerris_tpu runs) or float64
"""
from __future__ import annotations

import argparse
import sys

import torch

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def main(argv=None):
    run(argv)
    return 0


def run(argv=None):
    """Parse the options, build the simulation on its device and run it
    (the -e events after); returns the simulation, None with -V or
    --dry-run."""
    ap = argparse.ArgumentParser(
        prog="gerris_tpu_torch",
        description="Gerris on the card: run a .gfs simulation file")
    ap.add_argument("file", nargs="?", help=".gfs simulation file")
    ap.add_argument("-D", dest="defines", action="append", default=[],
                    metavar="NAME=VALUE", help="define a macro")
    ap.add_argument("-e", dest="events", action="append", default=[],
                    metavar="EVENT", help="one-shot event after the run")
    ap.add_argument("-s", dest="split", type=int, default=0,
                    help="box splitting (informational: the dense grid "
                    "is the split layout)")
    ap.add_argument("-V", action="store_true", dest="version",
                    help="print the versions and the device")
    ap.add_argument("--dry-run", action="store_true",
                    help="parse and build only, print a summary, no steps")
    ap.add_argument("-3", "--dim3", action="store_true", dest="dim3",
                    help="run in 3D (the reference's gerris3D binary)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    ap.add_argument("--dtype", default="float32", choices=sorted(_DTYPES),
                    help="floating-point type (default float32)")
    args = ap.parse_args(argv)

    if args.version:
        print("gerris_tpu_torch (Gerris-compatible solver on PyTorch)")
        card = torch.cuda.get_device_name(0) \
            if torch.cuda.is_available() else "none"
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"card {card}")
        return None
    if not args.file:
        ap.error("no simulation file given")
    from .core.device import default_device
    device = default_device(None if args.device == "cuda" else args.device)

    defines = {}
    for d in args.defines:
        if "=" not in d:
            ap.error(f"bad -D '{d}' (want NAME=VALUE)")
        k, v = d.split("=", 1)
        try:
            defines[k] = float(v)
        except ValueError:
            defines[k] = v

    from .utils import gfs_config
    with open(args.file) as f:
        text = f.read()
    parsed = gfs_config.parse_gfs(text, defines=defines)
    sim = gfs_config.build_simulation(parsed, dim=3 if args.dim3 else 2,
                                      device=device,
                                      dtype=_DTYPES[args.dtype])
    for e in getattr(sim, "errors", []):
        print(f"warning: {e}", file=sys.stderr)
    if args.dry_run:
        print(f"{parsed.sim_class}: level {parsed.level}, "
              f"{len(parsed.events)} events, time {parsed.time}, "
              f"{device} {args.dtype}", file=sys.stderr)
        return None
    sim.run()
    for spec in args.events:
        _one_shot_event(sim, spec)
    return sim


def _one_shot_event(sim, spec: str):
    """-e EVENT: one output event on the final state (src/gerris.c:
    300-316)."""
    from .events import outputs as out
    toks = spec.split()
    name = toks[0]
    arg = toks[1] if len(toks) > 1 else "P"
    if name == "OutputScalarNorm":
        ev = out.OutputScalarNorm(arg, sink=_print_sink(name))
    elif name == "OutputScalarSum":
        ev = out.OutputScalarSum(arg, sink=_print_sink(name))
    elif name == "OutputTime":
        ev = out.OutputTime()
    else:
        print(f"warning: unsupported -e event '{name}'", file=sys.stderr)
        return
    ev.fire(sim, sim.time.t, sim.time.i)


def _print_sink(name):
    def sink(sim, row):
        print(name, *row)
    return sink


if __name__ == "__main__":
    sys.exit(main())
