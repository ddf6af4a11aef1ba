"""Request context: id, cancellation, deadline, annotations, trace
propagation, and the stream error taxonomy, the port's copy of
``dynamo_tpu/runtime/context.py``.

Every request carries a stable id end to end (it doubles as the
``x-request-id`` correlation header), a cooperative cancellation token that
propagates across process hops, a deadline carried on the wire as the
remaining budget, and free-form annotations.
"""

from __future__ import annotations

import asyncio
import contextvars
import secrets
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Optional

#: task-local current request — set by the endpoint pump (worker side) and
#: the HTTP handler (frontend side) so every log line in between can carry
#: the request id / trace id (ref: logging.rs:150-215 span parenting)
CURRENT_REQUEST: contextvars.ContextVar[Optional["Context"]] = (
    contextvars.ContextVar("dyn_current_request", default=None))

#: Sentinel emitted into a response stream when the producing worker died
#: mid-stream; the migration operator keys off it
#: (ref: lib/runtime/src/pipeline/network.rs:31).
STREAM_ERR_MSG = "stream disconnected"


class StreamError(Exception):
    """A response stream terminated abnormally (worker died / transport lost).

    Root of the error taxonomy (docs/robustness.md): ``retryable`` tells the
    migration layer whether re-issuing the request can help. Transport loss
    is retryable (another worker can finish the stream); typed terminal
    conditions (overload shedding, deadline expiry) are not — retrying them
    burns the migration budget against a fleet that will reject again.
    """

    #: taxonomy code carried on the wire ("overloaded", "deadline", None)
    code: Optional[str] = None
    retryable: bool = True

    def __init__(self, msg: str = STREAM_ERR_MSG,
                 code: Optional[str] = None,
                 retryable: Optional[bool] = None):
        super().__init__(msg)
        if code is not None:
            self.code = code
        if retryable is not None:
            self.retryable = retryable


class TerminalStreamError(StreamError):
    """A stream failure that re-sending cannot fix; Migration must not retry."""

    retryable = False


class OverloadedError(TerminalStreamError):
    """The worker (or fleet) shed this request at admission (bounded queue)."""

    code = "overloaded"


class DeadlineExceededError(TerminalStreamError):
    """The request's end-to-end deadline expired before/while serving it."""

    code = "deadline"


class InvalidRequestError(TerminalStreamError):
    """The request itself is invalid for this model/fleet — a
    DETERMINISTIC rejection (e.g. a guided constraint no token sequence
    over the model's vocabulary can satisfy, docs/structured.md), so
    retrying or migrating burns budget against the same answer. The
    frontend maps the code to a 400."""

    code = "invalid_request"


def stream_error_from_wire(msg: str, code: Optional[str],
                           retryable: bool) -> StreamError:
    """Rehydrate a typed stream error from an err-frame's fields so the
    class (and therefore Migration's retry decision) survives the hop."""
    if code == "overloaded":
        return OverloadedError(msg)
    if code == "deadline":
        return DeadlineExceededError(msg)
    if code == "invalid_request":
        return InvalidRequestError(msg)
    return StreamError(msg, code=code, retryable=retryable)


@dataclass
class Context:
    id: str = field(default_factory=lambda: uuid.uuid4().hex)
    annotations: dict[str, Any] = field(default_factory=dict)
    traceparent: Optional[str] = None
    #: True when ensure_traceparent minted the value (absent or malformed
    #: inbound header) — the trust-boundary root span keys off this to
    #: adopt the wire span id instead of parenting to a phantom. Local
    #: state, never serialized.
    traceparent_synthesized: bool = field(default=False, repr=False)
    #: absolute end-to-end deadline on the LOCAL monotonic clock, or None.
    #: Never serialized as an absolute value: to_wire/from_wire carry the
    #: REMAINING budget in ms and re-anchor it to the receiver's clock, so
    #: cross-host clock skew cannot poison downstream hops.
    deadline: Optional[float] = None
    #: multi-tenant QoS (docs/qos.md): tenant id + priority class stamped
    #: by the frontend, consulted by the engine scheduler (weighted-fair
    #: admission, victim selection) and the KV router (class-biased cost).
    #: None = unspecified — peers that predate QoS omit both fields and
    #: every consumer applies defaults ("default" tenant, "standard"
    #: class), so the wire stays backward-compatible in both directions.
    tenant: Optional[str] = None
    priority: Optional[str] = None
    _cancel_event: asyncio.Event = field(default_factory=asyncio.Event, repr=False)

    def cancel(self) -> None:
        self._cancel_event.set()

    @property
    def cancelled(self) -> bool:
        return self._cancel_event.is_set()

    async def wait_cancelled(self) -> None:
        await self._cancel_event.wait()

    # -- deadline ------------------------------------------------------------

    def set_timeout_ms(self, timeout_ms: float) -> None:
        """Anchor the deadline ``timeout_ms`` from now (local monotonic)."""
        self.deadline = time.monotonic() + max(0.0, timeout_ms) / 1000.0

    def remaining_s(self) -> Optional[float]:
        """Seconds of budget left (may be negative); None = no deadline."""
        if self.deadline is None:
            return None
        return self.deadline - time.monotonic()

    @property
    def expired(self) -> bool:
        return self.deadline is not None and time.monotonic() >= self.deadline

    def child(self) -> "Context":
        """A child context sharing the cancellation token, deadline and id."""
        c = Context(id=self.id, annotations=dict(self.annotations),
                    traceparent=self.traceparent, deadline=self.deadline,
                    tenant=self.tenant, priority=self.priority)
        c._cancel_event = self._cancel_event
        return c

    @staticmethod
    def _traceparent_valid(tp: str) -> bool:
        parts = tp.split("-")
        # W3C: version 00 has exactly 4 fields; HIGHER versions may append
        # extra dash-separated fields and parsers must still accept the
        # first four — rejecting them would sever the caller's trace
        if len(parts) < 4 or (parts[0] == "00" and len(parts) != 4):
            return False
        return (len(parts[1]) == 32 and len(parts[2]) == 16
                and all(c in "0123456789abcdef"
                        for c in parts[1] + parts[2]))

    def ensure_traceparent(self) -> str:
        """Return a W3C traceparent, synthesizing one if the caller didn't
        send one (the request id doubles as the 128-bit trace id). A
        malformed inbound value is REPLACED, per the W3C ignore-invalid
        rule — otherwise it would silently disable span recording for the
        whole request."""
        if not self.traceparent or not self._traceparent_valid(self.traceparent):
            trace_id = (self.id if len(self.id) == 32
                        and all(c in "0123456789abcdef" for c in self.id)
                        else uuid.uuid4().hex)
            self.traceparent = f"00-{trace_id}-{secrets.token_hex(8)}-01"
            self.traceparent_synthesized = True
        return self.traceparent

    def child_traceparent(self) -> Optional[str]:
        """traceparent for the next hop: same trace id, fresh span id.
        Future-version values (extra trailing fields) are rewritten to the
        4-field form we understand — the W3C-sanctioned downgrade when a
        propagator mutates the header."""
        if not self.traceparent:
            return None
        parts = self.traceparent.split("-")
        if len(parts) < 4:
            return self.traceparent
        return f"{parts[0]}-{parts[1]}-{secrets.token_hex(8)}-{parts[3]}"

    def to_wire(self) -> dict:
        d = {"id": self.id, "annotations": self.annotations,
             "traceparent": self.child_traceparent()}
        rem = self.remaining_s()
        if rem is not None:
            # remaining-ms, floored at 0: the receiver re-anchors to its own
            # monotonic clock, so skew between hosts cannot extend or
            # retro-expire the budget
            d["deadline_ms"] = max(0, int(rem * 1000))
        # QoS fields ride the wire only when set: a pre-QoS peer never sees
        # keys it does not understand, and one that omits them round-trips
        # to the unspecified (defaulted) state
        if self.tenant is not None:
            d["tenant"] = self.tenant
        if self.priority is not None:
            d["priority"] = self.priority
        return d

    @staticmethod
    def from_wire(d: dict) -> "Context":
        priority = d.get("priority")
        if priority is not None:
            # a malformed class from a peer degrades to the default WITH a
            # warning instead of failing the request (same rule the
            # frontend applies to the x-dynamo-priority header)
            from dynamo_tpu_torch.qos import normalize_priority

            priority = normalize_priority(priority)
        tenant = d.get("tenant")
        ctx = Context(
            id=d.get("id") or uuid.uuid4().hex,
            annotations=d.get("annotations") or {},
            traceparent=d.get("traceparent"),
            tenant=str(tenant) if tenant is not None else None,
            priority=priority,
        )
        if d.get("deadline_ms") is not None:
            ctx.set_timeout_ms(float(d["deadline_ms"]))
        return ctx
