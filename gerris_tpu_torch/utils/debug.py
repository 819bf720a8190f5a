"""Debug and assertion layer (port of gerris_tpu/utils/debug.py).

The reference traps floating-point exceptions (src/utils.c
gfs_catch_floating_point_exceptions) and checks the domain's
consistency (src/solid.c:990-1169).  Here ``catch_fpe`` checks the
tensors that the simulation produces for non-finite values, and
``check_state`` asserts the solver's invariants on a state dict.
"""
from __future__ import annotations

import contextlib

import torch

from ..events.events import Event


def _finite_report(state: dict, nans: bool, infs: bool, where: str) -> list:
    """The fields with NaN (``nans``) or infinite (``infs``) values, each
    count read from the device in one read for the whole state."""
    names, counts = [], []
    for name, v in state.items():
        if not isinstance(v, torch.Tensor) or not v.is_floating_point():
            continue
        bad = torch.zeros((), dtype=torch.int64, device=v.device)
        if nans:
            bad = bad + torch.isnan(v).sum()
        if infs:
            bad = bad + torch.isinf(v).sum()
        names.append(name)
        counts.append(bad)
    if not counts:
        return []
    got = torch.stack(counts).tolist()
    return [f"{where}{n}: {c} non-finite values"
            for n, c in zip(names, got) if c]


class FloatingPointCheck(Event):
    """An event that raises FloatingPointError when a field of the state
    holds a NaN or an infinity.  It reads the device only when it fires
    (one read for the whole state), so a step it does not fire on takes
    no synchronisation."""

    def __init__(self, nans: bool = True, infs: bool = True, **kw):
        kw.setdefault("istep", 1)
        super().__init__(name="CatchFPE", **kw)
        self.nans = nans
        self.infs = infs

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        bad = _finite_report(sim.state, self.nans, self.infs,
                             f"step {sim.time.i}: ")
        if bad:
            raise FloatingPointError("; ".join(bad))


@contextlib.contextmanager
def catch_fpe(sim=None, nans: bool = True, infs: bool = True,
              istep: int = 1):
    """A scope in which a non-finite value raises FloatingPointError (the
    analogue of feenableexcept(FE_DIVBYZERO | FE_INVALID) in
    gfs_catch_floating_point_exceptions).  With a simulation, a
    FloatingPointCheck joins its events for the scope (every ``istep``
    steps) and the state is checked once more on leaving; without one,
    the scope checks the tensors of the dict it yields when it closes:

        with catch_fpe() as watch:
            watch["x"] = x / x          # raises on leaving the scope
    """
    watched = {}
    ev = None
    if sim is not None:
        ev = FloatingPointCheck(nans=nans, infs=infs, istep=istep)
        sim.events.append(ev)
    try:
        yield watched
    finally:
        if ev is not None:
            sim.events.remove(ev)
    state = dict(sim.state) if sim is not None else {}
    state.update(watched)
    bad = _finite_report(state, nans, infs, "")
    if bad:
        raise FloatingPointError("; ".join(bad))


def check_state(state: dict, cfg=None, where: str = "") -> list:
    """The solver invariants a state violates, as messages (none: the
    state is consistent): every field finite; VOF and solid fractions
    (T, A, T_*) in [0, 1] (vof.c clamps, solid.c:990-1169).  The
    fields' extrema come to the host in one read per field."""
    bad = []
    for name, v in state.items():
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(v)
        if not v.is_floating_point() or v.numel() == 0:
            continue
        frac = name in ("T", "A") or name.startswith("T_")
        fin = torch.isfinite(v)
        nbad, lo, hi = torch.stack([
            (~fin).sum().to(v.dtype),
            torch.where(fin, v, torch.inf).min(),
            torch.where(fin, v, -torch.inf).max()]).tolist()
        if nbad:
            bad.append(f"{where}{name}: {int(nbad)} non-finite values")
        if frac and (lo < -1e-6 or hi > 1.0 + 1e-6):
            bad.append(f"{where}{name}: fraction outside [0,1] "
                       f"({lo:.3g}..{hi:.3g})")
    return bad


def assert_consistent(state: dict, cfg=None, where: str = ""):
    """Raise AssertionError listing every violated invariant."""
    bad = check_state(state, cfg, where)
    assert not bad, "; ".join(bad)


def CheckEvent(istep: int = 1):
    """A per-step consistency check as an event (Simulation(events=[...]);
    the analogue of running the reference under its asserts)."""
    return Event(action=lambda sim: assert_consistent(
        sim.state, sim.cfg, where=f"step {sim.time.i}: "),
        istep=istep, name="CheckConsistency")
