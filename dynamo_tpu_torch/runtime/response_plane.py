"""Direct worker→requester TCP response streaming, the port's copy of
``dynamo_tpu/runtime/response_plane.py`` on the same wire.

The token hot path does not transit the control-plane hub: the requester
registers a pending stream and hands ``ConnectionInfo`` to the worker inside
the request envelope; the worker connects back, sends a prologue naming
the stream, then pumps framed data until a ``complete`` or ``err``
sentinel. The same connection carries ``cancel`` frames upstream, which
trip the worker-side request context. In-process callers short-circuit
through an asyncio queue (no sockets). Chaos injection is not ported
(ROADMAP A12).
"""

from __future__ import annotations

import asyncio
import logging
import socket
import uuid
from dataclasses import dataclass
from typing import Any, AsyncIterator, Optional

from dynamo_tpu_torch.runtime.codec import pack_frame, read_frame, write_frame
from dynamo_tpu_torch.runtime.context import (
    STREAM_ERR_MSG,
    Context,
    StreamError,
    stream_error_from_wire,
)

logger = logging.getLogger("dynamo.response_plane")

_COMPLETE = {"t": "complete"}

#: per-stream buffer cap: beyond this the server stops reading the worker's
#: socket, letting TCP flow control throttle the producer (backpressure)
STREAM_QUEUE_MAX = 1024


def _put_sentinel(q: asyncio.Queue, frame: dict) -> None:
    """Deliver a terminal frame even when the queue is full (drop oldest data)."""
    while True:
        try:
            q.put_nowait(frame)
            return
        except asyncio.QueueFull:
            try:
                q.get_nowait()
            except asyncio.QueueEmpty:
                pass


@dataclass(frozen=True)
class ConnectionInfo:
    host: str
    port: int
    stream_id: str
    #: set for in-process short-circuit streams
    local: bool = False

    def to_wire(self) -> dict:
        return {"host": self.host, "port": self.port, "stream_id": self.stream_id, "local": self.local}

    @staticmethod
    def from_wire(d: dict) -> "ConnectionInfo":
        return ConnectionInfo(d["host"], d["port"], d["stream_id"], d.get("local", False))


class ResponseReceiver:
    """Requester-side view of one response stream.

    The queue carries *frames* ({"t": "data"/"complete"/"err"}), never raw
    payloads, so user data can never collide with the stream sentinels.
    """

    def __init__(self, queue: "asyncio.Queue[Any]", on_cancel=None):
        self._queue = queue
        self._on_cancel = on_cancel
        #: fired once when the stream terminates (complete/err) or the
        #: consumer abandons it — lets a Client deregister this stream
        #: from its per-instance liveness tracking (proactive death
        #: handling, docs/robustness.md)
        self.on_done = None
        #: frames CONSUMED so far; with the queue depth this gives a
        #: monotonic arrived-frame counter (activity()) — the liveness
        #: signal the worker-lost grace window compares across time
        self._consumed = 0

    def activity(self) -> int:
        """Monotonic count of frames that have ARRIVED on this stream
        (consumed + still queued) — unchanged across a grace window means
        the producer is dead, not draining."""
        return self._consumed + self._queue.qsize()

    def __aiter__(self) -> AsyncIterator[Any]:
        return self._iter()

    def _done(self):
        cb, self.on_done = self.on_done, None
        if cb is not None:
            try:
                cb()
            except Exception:
                logger.exception("stream on_done callback failed")

    def fail(self, msg: str, retryable: bool = True,
             code: Optional[str] = None) -> None:
        """Terminate the stream from the REQUESTER side with a typed error
        frame (e.g. the producing instance's lease expired — the worker
        will never send a terminal frame itself). Sentinel delivery drops
        buffered data if the queue is full; exact token accounting is the
        Migration layer's job via its accumulated-token replay."""
        frame = {"t": "err", "msg": msg, "retryable": retryable}
        if code is not None:
            frame["code"] = code
        _put_sentinel(self._queue, frame)

    async def _iter(self):
        try:
            while True:
                frame = await self._queue.get()
                self._consumed += 1
                t = frame.get("t")
                if t == "data":
                    yield frame.get("d")
                elif t == "complete":
                    return
                elif t == "err":
                    # typed rehydration: the error class (and so Migration's
                    # retry decision) survives the wire hop
                    raise stream_error_from_wire(
                        frame.get("msg", STREAM_ERR_MSG), frame.get("code"),
                        frame.get("retryable", True))
        finally:
            self._done()

    async def cancel(self):
        """Tell the producing worker to stop."""
        if self._on_cancel:
            await self._on_cancel()


class ResponseStreamServer:
    """Per-process TCP server accepting worker response connections."""

    def __init__(self, host: Optional[str] = None):
        self._host = host or _default_host()
        self._server: Optional[asyncio.base_events.Server] = None
        self._port = 0
        self._pending: dict[str, tuple[asyncio.Queue, Context]] = {}

    async def start(self):
        if self._server is not None:
            return
        self._server = await asyncio.start_server(self._on_conn, "0.0.0.0", 0)
        self._port = self._server.sockets[0].getsockname()[1]
        logger.debug("response plane listening on %s:%d", self._host, self._port)

    async def stop(self):
        if self._server:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        for q, _ in self._pending.values():
            _put_sentinel(q, {"t": "err", "msg": STREAM_ERR_MSG})
        self._pending.clear()

    def register_stream(self, ctx: Context) -> tuple[ConnectionInfo, ResponseReceiver]:
        """Register a pending stream; returns (info for the worker, receiver)."""
        assert self._server is not None, "ResponseStreamServer not started"
        stream_id = uuid.uuid4().hex
        q: asyncio.Queue = asyncio.Queue(maxsize=STREAM_QUEUE_MAX)
        self._pending[stream_id] = (q, ctx)
        info = ConnectionInfo(self._host, self._port, stream_id)

        async def on_cancel():
            ctx.cancel()

        return info, ResponseReceiver(q, on_cancel)

    def abandon_stream(self, info: ConnectionInfo):
        self._pending.pop(info.stream_id, None)

    async def _on_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            prologue = await read_frame(reader)
            stream_id = prologue.get("stream_id")
            entry = self._pending.pop(stream_id, None)
            if entry is None:
                await write_frame(writer, {"t": "err", "msg": f"unknown stream {stream_id}"})
                writer.close()
                return
            q, ctx = entry
            await write_frame(writer, {"t": "ok"})

            async def cancel_pump():
                # Push a cancel frame upstream when our local context cancels.
                try:
                    await ctx.wait_cancelled()
                    await write_frame(writer, {"t": "cancel"})
                except Exception:
                    pass

            cancel_task = asyncio.get_running_loop().create_task(cancel_pump())
            try:
                while True:
                    frame = await read_frame(reader)
                    t = frame.get("t")
                    if t == "data":
                        await q.put(frame)  # blocks when full -> TCP backpressure
                    elif t in ("complete", "err"):
                        _put_sentinel(q, frame)
                        return
            except (asyncio.IncompleteReadError, ConnectionError):
                _put_sentinel(q, {"t": "err", "msg": STREAM_ERR_MSG})
            except Exception:
                # a frame the codec refuses (over MAX_FRAME, undecodable):
                # the stream ends in an error instead of leaving its
                # consumer waiting forever
                logger.exception("response stream %s failed", stream_id)
                _put_sentinel(q, {"t": "err", "msg": STREAM_ERR_MSG})
            finally:
                cancel_task.cancel()
        except Exception:
            logger.exception("response connection failed")
        finally:
            try:
                writer.close()
            except Exception:
                pass


class StreamSender:
    """Worker-side handle for pushing response frames back to the requester.

    Sends are CORKED: frames are written to the transport without awaiting
    ``drain()`` (the event loop flushes writes to the socket on its own —
    drain is only backpressure), and the drain round trip is paid once per
    ``SEND_HIGH_WATER`` bytes or on flush/complete instead of once per
    token frame. ``send_many()`` packs a whole batch into one write.
    """

    #: unflushed bytes after which send()/send_many() await one drain —
    #: bounds worker-side memory when the requester reads slowly (TCP flow
    #: control then throttles us through the paused transport)
    SEND_HIGH_WATER = 64 * 1024

    def __init__(self):
        self._queue: Optional[asyncio.Queue] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._reader_task: Optional[asyncio.Task] = None
        self._closed = False
        self._unflushed = 0

    @staticmethod
    async def connect(info: ConnectionInfo, ctx: Optional[Context] = None) -> "StreamSender":
        s = StreamSender()
        reader, writer = await asyncio.open_connection(info.host, info.port)
        await write_frame(writer, {"stream_id": info.stream_id})
        ack = await read_frame(reader)
        if ack.get("t") != "ok":
            writer.close()
            raise StreamError(ack.get("msg", "handshake rejected"))
        s._writer = writer

        async def cancel_listener():
            # Watch for upstream cancel frames and trip the worker context.
            try:
                while True:
                    frame = await read_frame(reader)
                    if frame.get("t") == "cancel" and ctx is not None:
                        ctx.cancel()
            except (asyncio.IncompleteReadError, ConnectionError):
                # Requester went away: cancel generation.
                if ctx is not None and not s._closed:
                    ctx.cancel()

        s._reader_task = asyncio.get_running_loop().create_task(cancel_listener())
        return s

    @staticmethod
    def local(queue: asyncio.Queue) -> "StreamSender":
        s = StreamSender()
        s._queue = queue
        return s

    async def send(self, data: Any) -> None:
        if self._queue is not None:
            await self._queue.put({"t": "data", "d": data})
        else:
            self._write_corked(pack_frame({"t": "data", "d": data}))
            await self._maybe_drain()

    async def send_many(self, items: list) -> None:
        """Send a batch of data frames as ONE transport write (and at most
        one drain) — the coalesced path for per-step token batches."""
        if not items:
            return
        if self._queue is not None:
            for d in items:
                await self._queue.put({"t": "data", "d": d})
        else:
            self._write_corked(b"".join(
                pack_frame({"t": "data", "d": d}) for d in items))
            await self._maybe_drain()

    def _write_corked(self, buf: bytes) -> None:
        self._writer.write(buf)
        self._unflushed += len(buf)

    async def _maybe_drain(self) -> None:
        if self._unflushed >= self.SEND_HIGH_WATER:
            await self.flush()

    async def flush(self) -> None:
        """Pay the backpressure drain now (no-op when nothing is corked)."""
        if self._writer is not None and self._unflushed:
            self._unflushed = 0
            await self._writer.drain()

    async def complete(self) -> None:
        self._closed = True
        if self._queue is not None:
            _put_sentinel(self._queue, _COMPLETE)
        else:
            try:
                self._unflushed = 0
                await write_frame(self._writer, _COMPLETE)
            finally:
                self._teardown()

    async def error(self, msg: str, code: Optional[str] = None,
                    retryable: bool = True) -> None:
        """Terminate the stream with a typed error frame. ``retryable``
        False marks the failure terminal (overload/deadline): the receiver
        raises a TerminalStreamError and Migration will not re-send."""
        self._closed = True
        frame = {"t": "err", "msg": msg, "retryable": retryable}
        if code is not None:
            frame["code"] = code
        if self._queue is not None:
            _put_sentinel(self._queue, frame)
        else:
            try:
                await write_frame(self._writer, frame)
            finally:
                self._teardown()

    def _teardown(self):
        if self._reader_task:
            self._reader_task.cancel()
        if self._writer:
            try:
                self._writer.close()
            except Exception:
                pass


def make_local_stream(ctx: Context) -> tuple[ConnectionInfo, ResponseReceiver, asyncio.Queue]:
    """In-process short-circuit stream (no sockets)."""
    q: asyncio.Queue = asyncio.Queue(maxsize=STREAM_QUEUE_MAX)
    info = ConnectionInfo("", 0, uuid.uuid4().hex, local=True)

    async def on_cancel():
        ctx.cancel()

    return info, ResponseReceiver(q, on_cancel), q


def _default_host() -> str:
    """Best-effort routable address of this host (TPU-VM DCN interface).

    Override with ``DYN_RESPONSE_HOST`` when autodetection picks the wrong
    interface; a loopback fallback is logged loudly since it breaks
    cross-host response streams.
    """
    import os

    override = os.environ.get("DYN_RESPONSE_HOST")
    if override:
        return override
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.connect(("10.255.255.255", 1))
        ip = s.getsockname()[0]
        s.close()
        return ip
    except Exception:
        pass
    try:
        ip = socket.gethostbyname(socket.gethostname())
        if not ip.startswith("127."):
            return ip
    except Exception:
        pass
    logger.warning(
        "could not detect a routable host address; advertising 127.0.0.1 "
        "(cross-host response streams will fail — set DYN_RESPONSE_HOST)"
    )
    return "127.0.0.1"
