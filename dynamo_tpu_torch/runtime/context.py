"""Request context: the cancellation and deadline surface the engine reads,
and the stream error it raises — the port's copy of the part of
``dynamo_tpu/runtime/context.py`` that ``generate()`` uses.
"""

from __future__ import annotations

import asyncio
import time
import uuid
from dataclasses import dataclass, field
from typing import Optional

#: sentinel message of a stream whose producer died mid-stream
STREAM_ERR_MSG = "stream disconnected"


class StreamError(Exception):
    """A response stream terminated abnormally. ``retryable`` tells the
    migration layer whether re-issuing the request can help."""

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


@dataclass
class Context:
    """Per-request id, cooperative cancellation, deadline and QoS fields."""

    id: str = field(default_factory=lambda: uuid.uuid4().hex)
    #: absolute deadline on the local monotonic clock, or None
    deadline: Optional[float] = None
    tenant: Optional[str] = None
    priority: Optional[str] = None
    _cancel_event: asyncio.Event = field(default_factory=asyncio.Event,
                                         repr=False)

    def cancel(self) -> None:
        self._cancel_event.set()

    @property
    def cancelled(self) -> bool:
        return self._cancel_event.is_set()

    @property
    def expired(self) -> bool:
        return self.deadline is not None and time.monotonic() >= self.deadline
