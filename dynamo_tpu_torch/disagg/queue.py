"""The global prefill queue, the port's copy of ``dynamo_tpu/disagg/queue.py``:
backlog-controlled dispatch to the prefill fleet.

The queue carries small job tickets only; the KV pages flow over the
direct response plane. Flow:

  decode worker:  subscribe claim.<job> → queue_push(ticket) → wait claim
                  → client.generate(mode="direct", instance_id=claimed)
  prefill worker: [capacity gate] → queue_pop → publish claim.<job>

A claim timeout on the decode side falls back to round-robin dispatch.
Tickets are class-split by the request's priority and workers drain
best class first; the standard class rides the plain queue, so a fleet of
JAX and torch workers shares one pool. Tickets and claims are msgpack, as
the JAX package writes them.
"""

from __future__ import annotations

import asyncio
import logging
import time
import uuid
from typing import Optional

from dynamo_tpu_torch.runtime.codec import packb, unpackb

logger = logging.getLogger("dynamo_torch.prefill_queue")

PREFILL_QUEUE = "prefill_queue"
CLAIM_SUBJECT = "prefill_claim"

#: class-split queues; the standard class (and unknown ones) ride the plain
#: queue. Pop order is interactive → plain/standard → batch.
QOS_QUEUE_CLASSES = ("interactive", "batch")


def qos_queue_name(queue: str, priority) -> str:
    """Queue a ticket of this priority class lands on."""
    if priority in QOS_QUEUE_CLASSES:
        return f"{queue}.{priority}"
    return queue


def pop_order(queue: str) -> list[str]:
    """Queues a worker drains, best class first."""
    return [f"{queue}.interactive", queue, f"{queue}.batch"]


async def prefill_queue_depth(plane, queue: str = PREFILL_QUEUE) -> int:
    """Total backlog across the class-split queues."""
    total = 0
    for q in pop_order(queue):
        total += await plane.queue_depth(q)
    return total


class PrefillQueueClient:
    """Decode-worker side: acquire a prefill worker through the queue."""

    def __init__(self, plane, queue: str = PREFILL_QUEUE,
                 claim_timeout: float = 10.0, metrics=None):
        self.plane = plane
        self.queue = queue
        self.claim_timeout = claim_timeout
        #: claim waits that timed out (fell back to round robin), mirrored
        #: to ``dynamo_prefill_claim_timeouts_total`` given a registry
        self.claim_timeouts = 0
        self._timeout_counter = (
            metrics.counter("prefill_claim_timeouts_total",
                            "prefill queue claim waits that timed out")
            if metrics is not None else None)

    def _budget_s(self, ctx) -> float:
        """Claim wait and ticket lifetime: the flat default, cut to the
        request's remaining deadline."""
        budget = self.claim_timeout
        remaining = ctx.remaining_s() if ctx is not None and hasattr(
            ctx, "remaining_s") else None
        if remaining is not None:
            budget = max(0.0, min(budget, remaining))
        return budget

    async def acquire(self, ctx=None) -> Optional[int]:
        """Enqueue a ticket; the claiming prefill worker's instance id, or
        None on timeout (the caller falls back to round robin)."""
        budget = self._budget_s(ctx)
        if budget <= 0:
            return None
        job_id = uuid.uuid4().hex
        priority = getattr(ctx, "priority", None)
        tenant = getattr(ctx, "tenant", None)
        sub = await self.plane.subscribe(f"{CLAIM_SUBJECT}.{job_id}")
        try:
            # expires_at lets workers discard tickets whose decode side has
            # already fallen back
            ticket = {"job_id": job_id, "expires_at": time.time() + budget}
            if priority:
                ticket["qos"] = priority
            if tenant:
                ticket["tenant"] = tenant
            await self.plane.queue_push(qos_queue_name(self.queue, priority),
                                        packb(ticket))

            async def first_claim():
                async for _subject, payload in sub:
                    return unpackb(payload)
                return None

            try:
                claim = await asyncio.wait_for(first_claim(), budget)
            except asyncio.TimeoutError:
                logger.warning("prefill queue claim timed out after %.1fs; "
                               "falling back to round robin", budget)
                self.claim_timeouts += 1
                if self._timeout_counter is not None:
                    self._timeout_counter.inc()
                return None
            return claim["instance_id"] if claim else None
        finally:
            await sub.cancel()

    async def depth(self) -> int:
        return await prefill_queue_depth(self.plane, self.queue)


class PrefillQueueWorker:
    """Prefill-worker side: pop tickets while the engine has capacity.

    ``capacity_gate`` is a plain callable returning True when this worker
    should take more work; a saturated worker stops popping and tickets
    wait in the queue, where the planner sees them."""

    def __init__(self, plane, instance_id: int, capacity_gate=None,
                 queue: str = PREFILL_QUEUE, poll: float = 0.2,
                 metrics=None):
        self.plane = plane
        self.instance_id = instance_id
        self.capacity_gate = capacity_gate
        self.queue = queue
        self.poll = poll
        self._task: Optional[asyncio.Task] = None
        self._stop = False
        #: last time a class-split ticket was popped (governs the blocking
        #: tail of _pop_best_class)
        self._class_seen_at = 0.0
        self.claims = 0
        #: expired tickets popped and dropped, mirrored to
        #: ``dynamo_prefill_tickets_discarded_total`` given a registry
        self.discarded = 0
        self._discard_counter = (
            metrics.counter("prefill_tickets_discarded_total",
                            "expired prefill queue tickets discarded")
            if metrics is not None else None)

    async def start(self) -> "PrefillQueueWorker":
        self._task = asyncio.get_running_loop().create_task(self._loop())
        return self

    async def stop(self):
        self._stop = True
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    async def _pop_best_class(self) -> Optional[bytes]:
        """Sweep interactive → plain → batch with near-nonblocking pops,
        then block on the plain queue: briefly while class-split traffic
        was seen in the last minute, long otherwise."""
        for i, q in enumerate(pop_order(self.queue)):
            item = await self.plane.queue_pop(q, timeout=0.02)
            if item is not None:
                if i != 1:
                    self._class_seen_at = time.time()
                return item
        recent = time.time() - self._class_seen_at < 60.0
        return await self.plane.queue_pop(self.queue,
                                          timeout=1.0 if recent else 5.0)

    async def _loop(self):
        while not self._stop:
            try:
                if self.capacity_gate is not None and not self.capacity_gate():
                    await asyncio.sleep(self.poll)
                    continue
                item = await self._pop_best_class()
                if item is None:
                    continue
                ticket = unpackb(item)
                exp = ticket.get("expires_at")
                if exp is not None and exp < time.time():
                    self.discarded += 1
                    if self._discard_counter is not None:
                        self._discard_counter.inc()
                    logger.warning(
                        "discarding expired prefill ticket %s (%.1fs stale; "
                        "%d discarded total)", ticket.get("job_id", "?")[:16],
                        time.time() - exp, self.discarded)
                    continue
                await self.plane.publish(
                    f"{CLAIM_SUBJECT}.{ticket['job_id']}",
                    packb({"instance_id": self.instance_id}))
                self.claims += 1
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("prefill queue worker loop error; retrying")
                await asyncio.sleep(1.0)


def engine_capacity_gate(engine, max_waiting: int = 0):
    """Default gate: take work only while the engine's waiting queue holds
    at most ``max_waiting`` sequences (the port has no swapped queue)."""

    def gate() -> bool:
        return engine.scheduler.num_waiting() <= max_waiting

    return gate
