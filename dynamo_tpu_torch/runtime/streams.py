"""Async-stream micro-batching for the worker pump, the port's copy of
``dynamo_tpu/runtime/streams.py``.
"""

from __future__ import annotations

import asyncio
from typing import Any, AsyncIterator


async def batched(stream: AsyncIterator[Any],
                  maxsize: int = 256) -> AsyncIterator[list]:
    """Re-chunk an async stream into LISTS: the awaited head item plus
    everything the producer had already queued by the time it landed.

    Consumers write/send once per list, so items that pile up while the
    previous write is in flight coalesce into one downstream operation.
    The queue is BOUNDED: a slow consumer stalls the pump, which stops
    reading ``stream``, so upstream backpressure still propagates.
    Exceptions from the producer re-raise here after buffered items flush;
    closing this generator cancels the pump.
    """
    q: asyncio.Queue = asyncio.Queue(maxsize=maxsize)

    async def pump():
        try:
            async for item in stream:
                await q.put(("item", item))
        except asyncio.CancelledError:
            raise
        except BaseException as e:  # noqa: BLE001 — relayed to the consumer
            await q.put(("exc", e))
            return
        await q.put(("end", None))

    task = asyncio.get_running_loop().create_task(pump())
    try:
        while True:
            batch = [await q.get()]
            while not q.empty():
                batch.append(q.get_nowait())
            items = []
            for kind, val in batch:
                if kind == "item":
                    items.append(val)
                    continue
                if items:
                    yield items
                if kind == "exc":
                    raise val
                return
            yield items
    finally:
        task.cancel()
