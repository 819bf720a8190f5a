"""Event scheduling on the host (port of gerris_tpu/events/events.py).

Reference: src/event.{h,c} — start/end/step/istep scheduling, the
gfs_event_next feed into timestep clamping, and EventStop's steady-state
test (event.h:228-246).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional


@dataclasses.dataclass
class Event:
    """Fires at t >= start, then every ``step`` time units or ``istep``
    iterations, until ``end``.  start='end' fires once at the end."""
    action: Optional[Callable] = None     # action(sim) -> None
    start: float = 0.0
    end: float = math.inf
    step: Optional[float] = None
    istep: Optional[int] = None
    name: str = ""
    _t_next: float = dataclasses.field(default=None, repr=False)
    _i_last: int = dataclasses.field(default=None, repr=False)
    at_end: bool = False

    def __post_init__(self):
        if self.start == "end":
            self.at_end = True
            self.start = math.inf

    def next_time(self, t: float) -> float:
        """Next firing time strictly after t (timestep clamping)."""
        if self.at_end or self.step is None:
            return math.inf
        if t < self.start:
            return self.start
        n = math.floor((t - self.start) / self.step) + 1
        return self.start + n * self.step

    def should_fire(self, t: float, i: int) -> bool:
        if self.at_end:
            return False
        if t < self.start - 1e-12 or t > self.end:
            return False
        if self.istep is not None:
            return self._i_last is None or i - self._i_last >= self.istep
        if self.step is not None:
            if self._t_next is None:
                self._t_next = max(self.start, t)
            return t >= self._t_next - 1e-9
        return self._i_last is None       # one-shot

    def fire(self, sim, t: float, i: int):
        self._i_last = i
        if self.step is not None:
            if self._t_next is None:
                self._t_next = max(self.start, t)
            while self._t_next <= t + 1e-9:
                self._t_next += self.step
        if self.action is not None:
            self.action(sim)


class EventStop(Event):
    """Stop when max|v - v_prev| < tolerance, checked every ``istep``.
    The previous field stays on the device; each check reads back one
    number."""

    def __init__(self, var: str, tolerance: float, istep: int = 1, **kw):
        super().__init__(istep=istep, name=f"EventStop({var})", **kw)
        self.var = var
        self.tolerance = tolerance
        self._prev = None
        self.last_change = None

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        if self.var not in sim.state:
            raise KeyError(f"EventStop: no field {self.var!r} (derived "
                           "variables are ROADMAP Queue 1, slice 7)")
        cur = sim.state[self.var]
        if self._prev is not None and cur.shape == self._prev.shape:
            self.last_change = float((cur - self._prev).abs().max())
            if self.last_change < self.tolerance:
                sim.stop = True
        self._prev = cur.clone()
