"""Worker-side publishers: KV cache events and load metrics, the port's
copy of ``dynamo_tpu/router/publisher.py`` on the same wire.

Engines report block stored/removed/cleared to the ``kv_events`` durable
stream and ``ForwardPassMetrics`` on the ``kv_metrics`` subject; the JAX
package's routers and metrics aggregator consume them.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from dynamo_tpu_torch.router.protocols import (
    KV_EVENTS_STREAM,
    KV_METRICS_SUBJECT,
    KV_RESYNC_SUBJECT,
    ForwardPassMetrics,
    KvCacheEvent,
    RouterEvent,
    StoredBlock,
)
from dynamo_tpu_torch.runtime.codec import packb, unpackb

logger = logging.getLogger("dynamo.kv_publisher")


def _spawn_publish(owner, coro) -> None:
    """Task-spawn that survives GC (asyncio keeps only weak task refs) and
    logs failures instead of dropping them as never-retrieved exceptions."""
    tasks = getattr(owner, "_inflight_publishes", None)
    if tasks is None:
        tasks = owner._inflight_publishes = set()
    task = asyncio.get_running_loop().create_task(coro)
    tasks.add(task)

    def _done(t):
        tasks.discard(t)
        if not t.cancelled() and t.exception() is not None:
            logger.warning("publish failed: %r", t.exception())

    task.add_done_callback(_done)


def reachable_chain(entries: dict[int, tuple[Optional[int], int]]
                    ) -> list[tuple[int, Optional[int], int]]:
    """Root-anchored ordered subset of a publisher mirror: the blocks a
    resync replay can re-announce, parents before children.

    ``entries`` is ``{block_hash: (parent_hash | None, tokens_hash)}``.
    Iterates to fixpoint: mirror order USUALLY has parents first, but a
    remove-then-re-store moves a parent behind its children (dict
    re-insertion), so one pass could drop valid chains. Entries never
    reached are dangling (ancestor evicted while the child survives),
    unroutable anyway, since a router's match walks from the root."""
    reachable: set[int] = set()
    pending = list(entries.items())
    ordered: list[tuple[int, Optional[int], int]] = []
    while True:
        still = []
        for bh, (parent, tokens_hash) in pending:
            if parent is None or parent in reachable:
                reachable.add(bh)
                ordered.append((bh, parent, tokens_hash))
            else:
                still.append((bh, (parent, tokens_hash)))
        if len(still) == len(pending):
            break  # the rest are genuinely dangling
        pending = still
    return ordered


class KvEventPublisher:
    """Publishes KV cache deltas to the durable stream AND mirrors what it
    has announced, so a router that detects a stream gap can ask for a full
    re-announcement instead of serving a silently-stale radix index. (The
    JAX package's publisher also reconciles a replay against the KV audit
    ledger; the port has no ledger yet, ROADMAP A12.)"""

    def __init__(self, plane, worker_id: int, kv_block_size: int,
                 stream: str = KV_EVENTS_STREAM):
        self.plane = plane
        self.worker_id = worker_id
        self.kv_block_size = kv_block_size
        self.stream = stream
        self._event_id = 0
        # block_hash -> (parent_block_hash | None, tokens_hash), insertion-
        # ordered so a replay announces parents before children
        self._announced: dict[int, tuple[Optional[int], int]] = {}
        self._resync_sub = None
        self._resync_task = None
        self.resyncs_served = 0
        # Serializes stream appends so a resync replay is atomic w.r.t.
        # concurrent delta publishes: without it, a removed(h) landing
        # between two replay chains that re-announce h would leave the
        # router believing h exists after the worker evicted it (the
        # mirror is mutated synchronously, so snapshot-then-replay under
        # the lock always converges to the worker's true state).
        self._publish_lock = asyncio.Lock()

    def _next_id(self) -> int:
        self._event_id += 1
        return self._event_id

    async def publish(self, event: KvCacheEvent) -> None:
        async with self._publish_lock:
            await self._publish_unlocked(event)

    async def _publish_unlocked(self, event: KvCacheEvent) -> None:
        wire = RouterEvent(self.worker_id, event).to_wire()
        await self.plane.stream_publish(self.stream, packb(wire))

    async def publish_stored(
        self,
        parent_hash: Optional[int],
        blocks: list[StoredBlock],
    ) -> None:
        prev = parent_hash
        for b in blocks:
            self._announced[b.block_hash] = (prev, b.tokens_hash)
            prev = b.block_hash
        await self.publish(KvCacheEvent.stored(self._next_id(), parent_hash, blocks))

    async def publish_removed(self, block_hashes: list[int]) -> None:
        for h in block_hashes:
            self._announced.pop(h, None)
        await self.publish(KvCacheEvent.removed(self._next_id(), block_hashes))

    async def publish_cleared(self) -> None:
        self._announced.clear()
        await self.publish(KvCacheEvent.clear(self._next_id()))

    def publish_sync(self, event: KvCacheEvent) -> None:
        """Fire-and-forget adapter for engines' synchronous event callbacks."""
        # keep the mirror coherent for events routed around the typed helpers
        if event.stored_blocks:
            prev = event.stored_parent_hash
            for b in event.stored_blocks:
                self._announced[b.block_hash] = (prev, b.tokens_hash)
                prev = b.block_hash
        elif event.removed_hashes:
            for h in event.removed_hashes:
                self._announced.pop(h, None)
        elif event.cleared:
            self._announced.clear()
        _spawn_publish(self, self.publish(event))

    # -- resync (gap recovery) ------------------------------------------
    async def start_resync_responder(self) -> "KvEventPublisher":
        """Answer router gap-resync requests by re-announcing every block
        this worker currently holds. Stored events are idempotent upserts in
        the radix tree, so healthy routers consuming the same stream just
        re-confirm what they already know."""
        self._resync_sub = await self.plane.subscribe(f"{KV_RESYNC_SUBJECT}.{self.stream}")
        self._resync_task = asyncio.get_running_loop().create_task(self._resync_loop())
        return self

    async def stop(self):
        if self._resync_task:
            self._resync_task.cancel()
        if self._resync_sub:
            await self._resync_sub.cancel()

    async def _resync_loop(self):
        try:
            async for _subject, _payload in self._resync_sub:
                try:
                    await self._replay_announced()
                    self.resyncs_served += 1
                except Exception:
                    logger.exception("kv resync replay failed")
        except asyncio.CancelledError:
            pass

    def announced_chain(self) -> dict[int, tuple[Optional[int], int]]:
        """Snapshot of the announce mirror (block → (parent, tokens_hash))
        — the chain structure the kv_digest diff op serves."""
        return dict(self._announced)

    async def _replay_announced(self):
        """Re-publish the mirror as chained stored events. Consecutive blocks
        whose parent is the previous block collapse into one event. Holds the
        publish lock for the WHOLE replay: the mirror snapshot and its stream
        appends form one atomic unit, and any delta publish racing with the
        replay lands after it — so the stream's final word on every block
        matches the mirror's."""
        async with self._publish_lock:
            # Only replay blocks REACHABLE from a root-anchored chain
            # (see reachable_chain): a dangling entry can't be routed to
            # anyway, and emitting it would be an eternal orphan at every
            # indexer, re-triggering a fleet-wide replay each time.
            items = reachable_chain(dict(self._announced))
            chain_parent: Optional[int] = None
            chain: list[StoredBlock] = []
            prev_hash: Optional[int] = None
            for bh, parent, tokens_hash in items:
                if chain and parent != prev_hash:
                    await self._publish_unlocked(
                        KvCacheEvent.stored(self._next_id(), chain_parent, chain))
                    chain = []
                if not chain:
                    chain_parent = parent
                chain.append(StoredBlock(block_hash=bh, tokens_hash=tokens_hash))
                prev_hash = bh
            if chain:
                await self._publish_unlocked(
                    KvCacheEvent.stored(self._next_id(), chain_parent, chain))


class WorkerMetricsPublisher:
    def __init__(self, plane, worker_id: int, subject: str = KV_METRICS_SUBJECT):
        self.plane = plane
        self.worker_id = worker_id
        self.subject = subject

    async def publish(self, metrics: ForwardPassMetrics) -> None:
        wire = {"worker_id": self.worker_id, "metrics": metrics.to_wire()}
        await self.plane.publish(self.subject, packb(wire))

    def publish_sync(self, metrics: ForwardPassMetrics) -> None:
        _spawn_publish(self, self.publish(metrics))


def parse_load_event(payload: bytes) -> tuple[int, ForwardPassMetrics]:
    """Decode one ``kv_metrics`` message → (worker_id, metrics). The ONE
    place that knows the wire shape — MetricsAggregator and the runtime's
    WorkerMonitor both ride it, so a format change can't silently diverge."""
    d = unpackb(payload)
    return d["worker_id"], ForwardPassMetrics.from_wire(d["metrics"])
