"""Structured decoding: guided-decoding constraints (regex, JSON schema,
choice) compiled into dense device tables, the FSM run inside the
sampling step.

The port of ``dynamo_tpu/structured`` without ``tools.py``, whose only
caller is the frontend. Constrained rows ride the ragged step and the
pipelined decode loop with no host sync. The host DFA
(``dynamo_tpu_torch/llm/guided.py``) stays the semantic oracle and the
fallback for constraints whose tables exceed the byte budget.
"""

from __future__ import annotations

from typing import Optional

from dynamo_tpu_torch.structured.compiler import (  # noqa: F401
    COMPILE_STATS,
    CompiledFsm,
    FsmBudgetError,
    compile_fsm,
    get_compiled,
)
from dynamo_tpu_torch.structured.runtime import (  # noqa: F401
    FsmCursor,
    FsmSegment,
    StructuredRuntime,
    arena_states,
    env_enabled,
    table_budget_bytes,
)


def build_guided_state(guided: dict, vocab: list, eos_ids: list,
                       runtime: Optional[StructuredRuntime] = None,
                       want_device: bool = True):
    """The engine's ONE entry for attaching a constraint to a sequence.

    Returns an :class:`FsmCursor` (device path: the table mask fused into
    the sampling step, an O(1) host mirror advance) when the runtime can
    hold the compiled machine, else the host-oracle ``GuidedState``. Every
    admission counts one ``hit``/``miss`` into :data:`COMPILE_STATS` — a
    hit means NO DFA or table compile work ran (both caches warm). An
    unsatisfiable constraint raises ``InvalidRequestError``: every worker
    serves the same vocabulary, so retrying elsewhere cannot help.
    """
    from dynamo_tpu_torch.llm.guided import (
        GuidedState, get_machine, guided_pattern,
    )
    from dynamo_tpu_torch.runtime.context import InvalidRequestError

    pattern = guided_pattern(guided)
    machine, hit = get_machine(pattern, vocab)
    if not machine.token_live(machine.start):
        raise InvalidRequestError(
            "guided constraint cannot be satisfied by any token sequence "
            "over this model's vocabulary")
    cursor = None
    if want_device and runtime is not None and runtime.cap > 0:
        compiled, c_hit = get_compiled(machine, pattern, vocab, eos_ids,
                                       runtime.V, runtime.cap - 1)
        hit = hit and c_hit
        if compiled is not None:
            seg = runtime.acquire((pattern, tuple(sorted(
                e for e in eos_ids if 0 <= e < runtime.V))), compiled)
            if seg is not None:
                cursor = FsmCursor(seg, runtime)
    COMPILE_STATS["hit" if hit else "miss"] += 1
    if cursor is not None:
        runtime.rows_device += 1
        return cursor
    if runtime is not None:
        runtime.rows_host += 1
    return GuidedState(machine, eos_ids)
