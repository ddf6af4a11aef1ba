"""Weighted-fair scheduling core: virtual token counters + per-class queues,
the port's copy of ``dynamo_tpu/qos/fair.py``.

VTC-style fairness: each tenant carries a virtual token counter that
advances by ``served_tokens / weight`` whenever the engine computes KV for
one of its sequences. Admission picks the backlogged tenant with the
smallest counter; a tenant that went idle re-enters at the floor of the
active counters. With a single tenant and class the drain order is exact
FIFO.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Iterator, Optional

from dynamo_tpu_torch.qos import CLASS_RANK, QosConfig


class QosBook:
    """Per-scheduler fairness ledger: one virtual counter per tenant."""

    def __init__(self, cfg: Optional[QosConfig] = None):
        self.cfg = cfg or QosConfig.load()
        self.vt: dict[str, float] = {}
        #: tenants with live sequences, by count
        self._active: dict[str, int] = {}

    def weight(self, tenant: str, cls: str) -> float:
        return self.cfg.weight_for(tenant, cls)

    def vt_of(self, tenant: str) -> float:
        return self.vt.get(tenant, 0.0)

    def enter(self, seq) -> None:
        """A sequence joined the scheduler; an idle tenant's counter is
        lifted to the active floor (no banked credit)."""
        if getattr(seq, "_qos_entered", False):
            return
        seq._qos_entered = True
        t = seq.tenant
        n = self._active.get(t, 0)
        if n == 0:
            others = [self.vt.get(o, 0.0)
                      for o, c in self._active.items() if c > 0 and o != t]
            if others:
                self.vt[t] = max(self.vt.get(t, 0.0), min(others))
        self._active[t] = n + 1

    def leave(self, seq) -> None:
        """A sequence finished/cancelled — drop it from the active set."""
        if not getattr(seq, "_qos_entered", False):
            return
        seq._qos_entered = False
        t = seq.tenant
        n = self._active.get(t, 1) - 1
        if n <= 0:
            self._active.pop(t, None)
            # prune counters whose removal cannot forgive debt
            if not self._active:
                self.vt.clear()
            elif self.vt.get(t, 0.0) <= min(
                    self.vt.get(o, 0.0) for o in self._active):
                self.vt.pop(t, None)
        else:
            self._active[t] = n

    def charge(self, tenant: str, cls: str, tokens: int) -> None:
        if tokens <= 0:
            return
        self.vt[tenant] = (self.vt.get(tenant, 0.0)
                           + tokens / self.weight(tenant, cls))


class ClassQueues:
    """The scheduler's waiting queue: per-(class, tenant) FIFO lanes with a
    deque surface (append/appendleft/remove/iteration/truthiness).
    ``pick()`` returns — without removing — the next sequence to admit:
    an aged sequence first, else the head of the least-virtual-time lane,
    else (``fifo``) strict arrival order."""

    def __init__(self, book: QosBook, fifo: bool = False,
                 clock=time.monotonic):
        self.book = book
        self.fifo = fifo
        self._clock = clock
        self._lanes: dict[tuple, deque] = {}
        self._arrival = 0
        self._n = 0

    def _lane(self, seq) -> deque:
        key = (seq.priority, seq.tenant)
        lane = self._lanes.get(key)
        if lane is None:
            lane = self._lanes[key] = deque()
        return lane

    def _stamp(self, seq) -> None:
        if getattr(seq, "qos_arrival", None) is None:
            seq.qos_arrival = self._arrival
            self._arrival += 1

    def append(self, seq) -> None:
        self._stamp(seq)
        self._lane(seq).append(seq)
        self._n += 1

    def appendleft(self, seq) -> None:
        """Requeue at the front of its lane, keeping its arrival stamp."""
        self._stamp(seq)
        self._lane(seq).appendleft(seq)
        self._n += 1

    def remove(self, seq) -> None:
        key = (seq.priority, seq.tenant)
        lane = self._lanes.get(key)
        if lane is None:
            raise ValueError("sequence not queued")
        lane.remove(seq)
        self._n -= 1
        if not lane:
            del self._lanes[key]

    def __len__(self) -> int:
        return self._n

    def __bool__(self) -> bool:
        return self._n > 0

    def __iter__(self) -> Iterator:
        return (s for lane in self._lanes.values() for s in lane)

    def pick(self, now: Optional[float] = None):
        """The sequence admission should take next; None when empty."""
        heads = [lane[0] for lane in self._lanes.values() if lane]
        if not heads:
            return None
        now = self._clock() if now is None else now
        aging = self.book.cfg.aging_s
        if not self.fifo and aging > 0:
            aged = [s for s in heads
                    if now - getattr(s, "qos_enqueue_t", now) >= aging]
            if aged:
                return min(aged, key=lambda s: s.qos_arrival)
        if self.fifo:
            return min(heads, key=lambda s: s.qos_arrival)
        return min(heads, key=lambda s: (self.book.vt_of(s.tenant),
                                         CLASS_RANK[s.priority],
                                         s.qos_arrival))
