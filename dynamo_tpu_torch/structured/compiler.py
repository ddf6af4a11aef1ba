"""Constraint-FSM compiler: TokenMachine → dense device tables.

The port's copy of ``dynamo_tpu/structured/compiler.py`` (numpy only):
its tables must equal the JAX package's, byte for byte.

The host guided-decoding path (dynamo_tpu_torch/llm/guided.py) walks a lazily-determinized
token DFA in Python and edits logits sparsely on the host — correct, but it
forces host-visible logits, kicks the row off the pipelined decode loop,
and costs one ``asyncio.to_thread`` hop per sampled token. This module
lowers the SAME machine into two dense numpy tables a device kernel can
gather from inside the sampling dispatch:

  mask  uint32 [S, ceil(V/32)]  — packed allowed-token bitmask per state
  next  int32  [S, V]           — state transition per (state, token)

with the exact semantics of ``GuidedState`` (dynamo_tpu_torch/llm/guided.py):

  * local state 0 is DONE: mask = EOS-only, every transition self-loops.
    ``advance`` lands there on EOS, on constraint completion via EOS, and
    on any off-mask token (which masked sampling never produces).
  * a state's mask is its token-live allowed set clamped to the logits
    width V, plus EOS when the state accepts or the set is empty —
    byte-for-byte the ids ``GuidedState.allowed_token_ids(V)`` returns.
  * ``exhausted[s]`` mirrors ``has_live_continuation``: landing on a
    flagged state must finish the sequence before another sample.

States are enumerated by BFS over mask transitions only. A machine whose
reachable closure exceeds ``max_states`` raises :class:`FsmBudgetError`
and the request falls back to the host oracle — the budget is the rule,
not a failure. Tokens that are char-alive but token-dead (masked out by
liveness filtering) transition to DONE here while the host oracle would
walk into the dead branch; the divergence is unobservable because neither
path can ever SAMPLE such a token.

Compiled tables are cached per (constraint pattern, vocab identity, EOS
set, logits width) — N sessions sharing a JSON schema compile once;
:data:`COMPILE_STATS` counts the admissions that hit and missed.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

import numpy as np

logger = logging.getLogger("dynamo_torch.structured")

#: compile-cache outcomes across host machine + device table caches (an
#: admission is a "hit" only when NO DFA/table compile work ran for it)
COMPILE_STATS = {"hit": 0, "miss": 0}


class FsmBudgetError(ValueError):
    """Reachable state closure exceeds the device-table budget — the
    request must use the host oracle instead."""


class CompiledFsm:
    """Dense table view of one TokenMachine over a fixed logits width."""

    __slots__ = ("mask", "next", "exhausted", "start", "eos_ids", "V",
                 "n_states", "pattern")

    def __init__(self, mask, nxt, exhausted, start, eos_ids, V, pattern=""):
        self.mask = mask              # uint32 [S, W32]
        self.next = nxt               # int32 [S, V]; 0 = DONE
        self.exhausted = exhausted    # bool [S]
        self.start = start            # local start index (>= 1)
        self.eos_ids = list(eos_ids)
        self.V = V
        self.n_states = mask.shape[0]
        self.pattern = pattern

    def allowed_ids(self, local_state: int, max_id: Optional[int] = None
                    ) -> list[int]:
        """Unpack one state's bitmask row (host fallback / verification)."""
        words = self.mask[local_state]
        bits = (words[np.arange(self.V) // 32]
                >> (np.arange(self.V, dtype=np.uint32) % 32)) & 1
        ids = np.nonzero(bits)[0]
        if max_id is not None:
            ids = ids[ids < max_id]
        return [int(t) for t in ids]


def _set_bits(row: np.ndarray, ids) -> None:
    for t in ids:
        row[t // 32] |= np.uint32(1) << np.uint32(t % 32)


def compile_fsm(machine, eos_ids: list[int], V: int,
                max_states: int) -> CompiledFsm:
    """Enumerate the machine's reachable token-DFA closure and pack it.

    Each newly-visited state costs one O(vocab) token walk through the
    char DFA — the same walk the host oracle would pay lazily over the
    request's lifetime; here it is paid once at compile and shared by
    every request with the same constraint (the walks themselves are also
    memoized on the machine, so a host-oracle fallback reuses them).
    """
    eos = [e for e in eos_ids if 0 <= e < V]
    idx: dict = {machine.start: 1}
    order = [machine.start]
    queue = [machine.start]
    while queue:
        st = queue.pop()
        trans = machine.allowed(st)
        for tid in machine.allowed_ids_below(st, V):
            nxt = trans[tid]
            if nxt not in idx:
                if len(order) + 2 > max_states:
                    raise FsmBudgetError(
                        f"constraint needs > {max_states} device-FSM "
                        f"states — host oracle fallback")
                idx[nxt] = len(order) + 1
                order.append(nxt)
                queue.append(nxt)
    S = len(order) + 1  # + DONE row at local 0
    W32 = (V + 31) // 32
    mask = np.zeros((S, W32), np.uint32)
    nxt_tab = np.zeros((S, V), np.int32)  # default: everything → DONE
    exhausted = np.zeros((S,), bool)
    _set_bits(mask[0], eos)  # DONE: EOS-only, self-loop
    for st, li in idx.items():
        allowed = machine.allowed_ids_below(st, V)
        ids = list(allowed)
        if machine.is_accepting(st) or not allowed:
            ids = ids + eos
        _set_bits(mask[li], ids)
        trans = machine.allowed(st)
        for t in allowed:
            nxt_tab[li, t] = idx[trans[t]]
        # EOS always advances to DONE, even when the EOS token's text
        # happens to walk the pattern (GuidedState.advance checks EOS
        # first)
        for e in eos:
            nxt_tab[li, e] = 0
        exhausted[li] = not machine.has_live_continuation(st)
    return CompiledFsm(mask, nxt_tab, exhausted, 1, eos, V)


#: (pattern, vocab identity, eos tuple, V) → CompiledFsm | FsmBudgetError
#: marker. Budget refusals are cached too: a schema that blew the budget
#: once must not re-walk its closure on every admission.
_COMPILED_CACHE: dict = {}
_COMPILED_CACHE_CAP = 64
_COMPILED_LOCK = threading.Lock()
_BUDGET_REFUSED = "<budget>"


def get_compiled(machine, pattern: str, vocab, eos_ids: list[int], V: int,
                 max_states: int) -> tuple[Optional[CompiledFsm], bool]:
    """(compiled | None, cache_hit). None = over budget (host fallback)."""
    key = (pattern, id(vocab), tuple(sorted(eos_ids)), V)
    with _COMPILED_LOCK:
        hit = _COMPILED_CACHE.get(key)
    if hit is not None:
        return (None if hit == _BUDGET_REFUSED else hit), True
    try:
        compiled = compile_fsm(machine, eos_ids, V, max_states)
    except FsmBudgetError as e:
        logger.info("structured: %s (pattern %.60r)", e, pattern)
        compiled = None
    with _COMPILED_LOCK:
        if len(_COMPILED_CACHE) >= _COMPILED_CACHE_CAP:
            _COMPILED_CACHE.pop(next(iter(_COMPILED_CACHE)))
        _COMPILED_CACHE[key] = (compiled if compiled is not None
                                else _BUDGET_REFUSED)
    return compiled, False
