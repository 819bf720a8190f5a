"""GfsEventBalance on one device (port of gerris_tpu/parallel/balance.py,
its event).

The reference moves boxes between processes when the imbalance of
their cell counts exceeds a ratio (src/balance.c:262-297).  On one
device the whole domain is one partition, whose imbalance is 1, so the
JAX package's event never re-partitions there; this one records its
schedule and ratio and does nothing.  Across devices it waits for the
port's parallel/mesh.py (ROADMAP Queue 1, slice 9).
"""
from __future__ import annotations

import dataclasses

from ..events.events import Event


@dataclasses.dataclass
class EventBalance(Event):
    """``EventBalance { istep = N } max_ratio`` on one device."""
    max_ratio: float = 1.1
