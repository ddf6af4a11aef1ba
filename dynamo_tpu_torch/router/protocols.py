"""KV-router wire types a worker emits, the port's copy of the part of
``dynamo_tpu/router/protocols.py`` the engine and its publishers need: KV
cache events (attributed to a worker as ``RouterEvent`` on the
``kv_events`` stream) and per-step load metrics. Hashes:

- ``tokens_hash``: salted xxh3 of the block's tokens (the radix edge key);
- ``block_hash``: the engine's chained sequence hash (the removal key).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field, fields
from typing import Optional

#: durable stream carrying RouterEvents
KV_EVENTS_STREAM = "kv_events"
#: pub/sub subject carrying ForwardPassMetrics
KV_METRICS_SUBJECT = "kv_metrics"
#: subject prefix a gapped router publishes on to ask workers to re-announce
KV_RESYNC_SUBJECT = "kv_resync"


@dataclass
class StoredBlock:
    block_hash: int  # external sequence hash (engine identity)
    tokens_hash: int  # local block hash (router identity)


@dataclass
class KvCacheEvent:
    """One engine cache mutation: stored / removed / cleared."""

    event_id: int = 0
    stored_parent_hash: Optional[int] = None
    stored_blocks: list[StoredBlock] = field(default_factory=list)
    removed_hashes: list[int] = field(default_factory=list)
    cleared: bool = False

    @staticmethod
    def stored(event_id: int, parent_hash: Optional[int],
               blocks: list[StoredBlock]) -> "KvCacheEvent":
        return KvCacheEvent(event_id=event_id, stored_parent_hash=parent_hash,
                            stored_blocks=blocks)

    @staticmethod
    def removed(event_id: int, hashes: list[int]) -> "KvCacheEvent":
        return KvCacheEvent(event_id=event_id, removed_hashes=hashes)

    @staticmethod
    def clear(event_id: int) -> "KvCacheEvent":
        return KvCacheEvent(event_id=event_id, cleared=True)

    def to_wire(self) -> dict:
        d: dict = {"event_id": self.event_id}
        if self.stored_blocks:
            d["stored"] = {
                "parent_hash": self.stored_parent_hash,
                "blocks": [{"block_hash": b.block_hash,
                            "tokens_hash": b.tokens_hash}
                           for b in self.stored_blocks],
            }
        elif self.removed_hashes:
            d["removed"] = {"block_hashes": self.removed_hashes}
        elif self.cleared:
            d["cleared"] = True
        return d

    @staticmethod
    def from_wire(d: dict) -> "KvCacheEvent":
        ev = KvCacheEvent(event_id=d.get("event_id", 0))
        if "stored" in d:
            s = d["stored"]
            ev.stored_parent_hash = s.get("parent_hash")
            ev.stored_blocks = [StoredBlock(b["block_hash"], b["tokens_hash"])
                                for b in s.get("blocks", [])]
        elif "removed" in d:
            ev.removed_hashes = list(d["removed"].get("block_hashes", []))
        elif d.get("cleared"):
            ev.cleared = True
        return ev


@dataclass
class RouterEvent:
    """A KvCacheEvent attributed to a worker."""

    worker_id: int
    event: KvCacheEvent

    def to_wire(self) -> dict:
        return {"worker_id": self.worker_id, "event": self.event.to_wire()}

    @staticmethod
    def from_wire(d: dict) -> "RouterEvent":
        return RouterEvent(d["worker_id"], KvCacheEvent.from_wire(d["event"]))


@dataclass
class WorkerStats:
    request_active_slots: int = 0
    request_total_slots: int = 0
    num_requests_waiting: int = 0
    data_parallel_rank: Optional[int] = None
    moe_dropped_tokens: int = 0
    warmed_up: Optional[bool] = None


@dataclass
class KvStats:
    kv_active_blocks: int = 0
    kv_total_blocks: int = 0
    gpu_cache_usage_perc: float = 0.0
    gpu_prefix_cache_hit_rate: float = 0.0


@dataclass
class SpecDecodeStats:
    num_spec_tokens: int = 0
    num_drafts: int = 0
    num_draft_tokens: int = 0
    num_accepted_tokens: int = 0


@dataclass
class ForwardPassMetrics:
    """Per-forward-pass load report."""

    worker_stats: WorkerStats = field(default_factory=WorkerStats)
    kv_stats: KvStats = field(default_factory=KvStats)
    spec_decode_stats: Optional[SpecDecodeStats] = None

    def to_wire(self) -> dict:
        ws = asdict(self.worker_stats)
        if ws.get("warmed_up") is None:
            ws.pop("warmed_up", None)
        d = {"worker_stats": ws, "kv_stats": asdict(self.kv_stats)}
        if self.spec_decode_stats:
            d["spec_decode_stats"] = asdict(self.spec_decode_stats)
        return d

    @staticmethod
    def from_wire(d: dict) -> "ForwardPassMetrics":
        def known(cls, payload):
            # a newer peer's extra fields must not crash this receiver
            names = {f.name for f in fields(cls)}
            return {k: v for k, v in (payload or {}).items() if k in names}

        return ForwardPassMetrics(
            worker_stats=WorkerStats(**known(WorkerStats,
                                             d.get("worker_stats"))),
            kv_stats=KvStats(**known(KvStats, d.get("kv_stats"))),
            spec_decode_stats=(SpecDecodeStats(**d["spec_decode_stats"])
                               if d.get("spec_decode_stats") else None),
        )
