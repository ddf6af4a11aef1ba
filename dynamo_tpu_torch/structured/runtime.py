"""Engine-side structured-decoding runtime: the device FSM arena.

The port's copy of ``dynamo_tpu/structured/runtime.py``; its tables are
torch tensors on the engine's device.

One worker serves many constraints concurrently, and a decode batch may
mix rows under DIFFERENT constraints. Every compiled machine is uploaded
into ONE pair of fixed-shape arena tables, so a step's operands keep their
shapes whatever the batch holds:

  mask_arena  int32 [S_cap, ceil(V/32)]   (the uint32 words' bits)
  next_arena  int32 [S_cap, V]

Row 0 is the global FREE state: all tokens allowed, self-loop — an
unconstrained row carries state 0 and the fused mask is an exact identity
for it. A compiled machine occupies a contiguous segment at ``offset``;
its local DONE row 0 lands at ``offset`` and every local transition
shifts by ``offset`` uniformly, so a row's per-step state is one int32
riding the step's staged operands (and the pipelined loop's device-to-
device feed) with a single gather per step.

Segments are refcounted by live sequences and LRU-evicted at zero refs;
an arena too full for a new machine falls back to the host oracle for
that request (never an error). ``S_cap`` derives from the
``DYN_STRUCTURED_TABLE_MB`` byte budget (default 64 MiB) — the next
table costs 4·V bytes per state, so huge-vocab models get a small arena
and big schemas fall back.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

import numpy as np

import torch

from dynamo_tpu_torch.structured.compiler import CompiledFsm

logger = logging.getLogger("dynamo_torch.structured")

#: arena row ceiling regardless of budget (tiny vocabs would otherwise
#: allocate absurdly tall tables)
MAX_ARENA_STATES = 4096
#: below this many rows the arena is useless (a trivial choice constraint
#: needs a handful of states; give up and run host-side)
MIN_ARENA_STATES = 32


def env_enabled() -> bool:
    return os.environ.get("DYN_STRUCTURED", "1").lower() not in (
        "0", "false", "off", "no")


def table_budget_bytes(override_mb: Optional[float] = None) -> int:
    if override_mb is None:
        raw = os.environ.get("DYN_STRUCTURED_TABLE_MB", "")
        if raw:
            try:
                override_mb = float(raw)
            except ValueError:
                raise ValueError(
                    f"bad DYN_STRUCTURED_TABLE_MB={raw!r}") from None
        else:
            override_mb = 64.0
    return int(override_mb * (1 << 20))


def arena_states(vocab_size: int, budget_bytes: int) -> int:
    """States the byte budget buys at this logits width (0 = disabled)."""
    row_bytes = 4 * vocab_size + 4 * ((vocab_size + 31) // 32)
    cap = min(MAX_ARENA_STATES, budget_bytes // max(1, row_bytes))
    return int(cap) if cap >= MIN_ARENA_STATES else 0


class FsmSegment:
    __slots__ = ("offset", "size", "key", "fsm", "refs", "last_use")

    def __init__(self, offset: int, size: int, key, fsm: CompiledFsm):
        self.offset = offset
        self.size = size
        self.key = key
        self.fsm = fsm
        self.refs = 0
        self.last_use = 0.0


class FsmCursor:
    """Per-sequence constraint cursor over a compiled machine — the
    drop-in replacement for ``GuidedState`` on the device path. Same
    interface (``done``/``exhausted``/``eos_ids``/``advance``/
    ``allowed_token_ids``) but ``advance`` is one numpy table lookup, so
    every path (the serial step, the pipelined commit) can
    afford it inline. ``state`` is the GLOBAL arena index the device
    kernels gather with.
    """

    __slots__ = ("seg", "runtime", "state", "done", "exhausted", "eos_ids",
                 "_eos_set", "_released")

    #: engines key their fast-path eligibility on this (duck-typed so the
    #: scheduler never imports structured)
    device = True

    def __init__(self, seg: FsmSegment, runtime: "StructuredRuntime"):
        self.seg = seg
        self.runtime = runtime
        self.state = seg.offset + seg.fsm.start
        self.done = False
        self.exhausted = False
        self.eos_ids = list(seg.fsm.eos_ids)
        self._eos_set = set(self.eos_ids)
        self._released = False

    @property
    def _local(self) -> int:
        return self.state - self.seg.offset

    def advance(self, token_id: int) -> None:
        if self.done:
            return
        t = int(token_id)
        if t in self._eos_set:
            self.done = True
            return
        fsm = self.seg.fsm
        nxt = int(fsm.next[self._local, t]) if 0 <= t < fsm.V else 0
        if nxt == 0:
            # off-mask token (shouldn't happen when masked) or constraint
            # completed into DONE via an EOS-mapped transition
            self.done = True
            return
        self.state = self.seg.offset + nxt
        if fsm.exhausted[nxt]:
            self.exhausted = True

    def allowed_token_ids(self, max_id: Optional[int] = None) -> list[int]:
        """Host-side unpack of the current mask row (the host edit of a
        logprob row, and tests; the device path never calls this)."""
        return self.seg.fsm.allowed_ids(self._local if not self.done else 0,
                                        max_id)

    def release(self) -> None:
        """Drop this sequence's arena reference (scheduler.finish)."""
        if not self._released:
            self._released = True
            self.runtime.release(self.seg)


class StructuredRuntime:
    """Per-engine arena of compiled constraint tables."""

    def __init__(self, vocab_size: int, capacity: int, device="cpu"):
        self.V = vocab_size
        self.device = torch.device(device)
        self.W32 = (vocab_size + 31) // 32
        self.cap = capacity
        self._mask_np = np.zeros((capacity, self.W32), np.uint32)
        self._mask_np[0] = np.uint32(0xFFFFFFFF)  # FREE: all allowed
        self._next_np = np.zeros((capacity, vocab_size), np.int32)  # FREE: 0
        self._segments: dict = {}     # key -> FsmSegment
        self._lock = threading.Lock()
        #: (offset, rows) of segments placed since the tables were last
        #: brought up to date on the device
        self._dirty: list = []
        self._mask_dev = None
        self._next_dev = None
        self._clock = 0
        #: telemetry: admissions that landed on the device path vs fell
        #: back to the host oracle (budget/arena-full/min_tokens)
        self.rows_device = 0
        self.rows_host = 0
        self.evictions = 0

    # ---------------------------------------------------------- allocation

    def _gaps(self):
        """Free extents as (offset, size), FREE row 0 excluded."""
        used = sorted((s.offset, s.size) for s in self._segments.values())
        gaps, cur = [], 1
        for off, size in used:
            if off > cur:
                gaps.append((cur, off - cur))
            cur = off + size
        if cur < self.cap:
            gaps.append((cur, self.cap - cur))
        return gaps

    def _try_place(self, size: int) -> Optional[int]:
        for off, gap in self._gaps():
            if gap >= size:
                return off
        return None

    def acquire(self, key, fsm: CompiledFsm) -> Optional[FsmSegment]:
        """Place (or ref) a compiled machine; None = doesn't fit even
        after evicting every idle segment (host-oracle fallback)."""
        with self._lock:
            self._clock += 1
            seg = self._segments.get(key)
            if seg is not None:
                seg.refs += 1
                seg.last_use = self._clock
                return seg
            if fsm.n_states + 1 > self.cap:
                return None
            off = self._try_place(fsm.n_states)
            while off is None:
                idle = [s for s in self._segments.values() if s.refs == 0]
                if not idle:
                    return None
                victim = min(idle, key=lambda s: s.last_use)
                del self._segments[victim.key]
                self.evictions += 1
                off = self._try_place(fsm.n_states)
            self._mask_np[off:off + fsm.n_states] = fsm.mask
            # uniform shift: local DONE 0 lands at the segment's own row,
            # so global = local + offset holds for every entry
            self._next_np[off:off + fsm.n_states] = (
                fsm.next + np.int32(off))
            seg = FsmSegment(off, fsm.n_states, key, fsm)
            seg.refs = 1
            seg.last_use = self._clock
            self._segments[key] = seg
            self._dirty.append((off, fsm.n_states))
            return seg

    def release(self, seg: FsmSegment) -> None:
        with self._lock:
            seg.refs = max(0, seg.refs - 1)
            seg.last_use = self._clock

    # ------------------------------------------------------------- device

    def device_tables(self):
        """(mask_arena, next_arena) as int32 tensors on the engine's
        device. They are allocated once, at capacity, and stay the same
        tensors: the rows of segments placed since the last call are
        copied into them in place, on the current stream, so a captured
        sampler reads the new rows at its next replay. No row a live
        sequence uses is rewritten: a segment is evicted only at zero
        references."""
        with self._lock:
            if self._mask_dev is None:
                self._mask_dev = torch.from_numpy(
                    self._mask_np.view(np.int32)).to(self.device, copy=True)
                self._next_dev = torch.from_numpy(self._next_np).to(
                    self.device, copy=True)
            else:
                for off, n in self._dirty:
                    self._mask_dev[off:off + n].copy_(torch.from_numpy(
                        self._mask_np[off:off + n].view(np.int32)))
                    self._next_dev[off:off + n].copy_(
                        torch.from_numpy(self._next_np[off:off + n]))
            self._dirty = []
            return self._mask_dev, self._next_dev

    def stats(self) -> dict:
        with self._lock:
            return {
                "segments": len(self._segments),
                "states_used": sum(s.size for s in self._segments.values()),
                "states_cap": self.cap,
                "rows_device": self.rows_device,
                "rows_host": self.rows_host,
                "evictions": self.evictions,
            }
