"""KvbmManager: offload and onboarding across the local tiers, the port's
copy of ``dynamo_tpu/kvbm/manager.py`` without G4.

Offload: when the engine registers full blocks, their pages are copied to
the host once and put into G2; G2's evictions cascade into G3 when a disk
tier is configured. Onboarding: at admission, prompt blocks missing from
the device pool but found in G2 are written into fresh device blocks,
extending the prefix hit without recompute (the reference's "KV offload
TTFT win"); blocks found only on disk are promoted to G2 in the
background.

Left for the distributed block manager (ROADMAP A8e part 3): the G4
object-store tier and its flow-up, and the KV audit ledger (A12e);
``stats()`` reports ``remote_*`` as 0.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from dynamo_tpu_torch.kvbm.tiers import DiskTier, HostTier

logger = logging.getLogger("dynamo_torch.kvbm")


class KvbmManager:
    """Thread-safe: disk promotion and offload run in worker threads while
    the engine's event loop reads the host tier, so every tier access
    takes the lock. Tier order: G2 host memory, then G3 disk."""

    def __init__(self, host_bytes: int, disk_dir: Optional[str] = None,
                 disk_bytes: int = 0, on_change=None):
        self.host = HostTier(host_bytes)
        self.disk = (DiskTier(disk_dir, disk_bytes)
                     if (disk_dir and disk_bytes) else None)
        self.offloaded_blocks = 0
        self.onboarded_blocks = 0
        self._lock = threading.Lock()
        #: on_change(stored_hashes, removed_hashes); removed None means
        #: every tier was cleared
        self.on_change = on_change

    def _notify(self, stored: list, removed) -> None:
        """Fire on_change, with the lock held: mutation and notification
        stay in tier-state order, so the callback must not block."""
        if self.on_change is not None and (stored or removed
                                           or removed is None):
            try:
                self.on_change(stored, removed)
            except Exception:
                logger.exception("kvbm on_change callback failed")

    # -- queries -------------------------------------------------------------

    def __contains__(self, h: int) -> bool:
        with self._lock:
            return h in self.host or (self.disk is not None
                                      and h in self.disk)

    def in_disk(self, h: int) -> bool:
        with self._lock:
            return self.disk is not None and h in self.disk

    def in_host(self, h: int) -> bool:
        """Host-tier residency without an LRU touch."""
        with self._lock:
            return h in self.host

    def in_local(self, h: int) -> bool:
        """In a tier this worker can serve from (host or disk)."""
        with self._lock:
            return h in self.host or (self.disk is not None
                                      and h in self.disk)

    def host_resident(self, hashes) -> set:
        """The subset of ``hashes`` in the host tier, under one lock."""
        with self._lock:
            return {h for h in hashes if h in self.host}

    def filter_not_local(self, hashes) -> list[int]:
        """The subset of ``hashes`` in no local tier, under one lock (the
        engine's eviction-event filter runs on its hot loop)."""
        with self._lock:
            return [h for h in hashes
                    if h not in self.host
                    and (self.disk is None or h not in self.disk)]

    def in_lower_tier(self, h: int) -> bool:
        """Resident below the host tier: admission schedules a background
        promotion for these instead of blocking."""
        with self._lock:
            return self.disk is not None and h in self.disk

    def match_prefix(self, seq_hashes: list[int]) -> int:
        """Longest leading run of hashes resident in any tier."""
        n = 0
        for h in seq_hashes:
            if h not in self:
                break
            n += 1
        return n

    # -- offload (G1 → G2 → G3) ----------------------------------------------

    def put(self, h: int, k, v) -> None:
        with self._lock:
            if h in self.host:
                return
            self.offloaded_blocks += 1
            removed = self._cascade(self.host.put(h, k, v))
            self._notify([h], removed)

    def resident_hashes(self) -> list[int]:
        """A snapshot of the host tier's hashes."""
        with self._lock:
            return list(self.host._store)

    def _cascade(self, host_evicted) -> list[int]:
        """Push host evictions down to disk; return the hashes gone from
        every tier (lock held). A promoted block lives in both tiers, so a
        disk eviction is checked against the host tier."""
        removed: list[int] = []
        for eh, ek, ev in host_evicted:
            if self.disk is None:
                removed.append(eh)
                continue
            removed.extend(d for d in self.disk.put(eh, ek, ev)
                           if d not in self.host)
            if eh not in self.disk:  # too big for the disk budget
                removed.append(eh)
        return removed

    # -- the controller's surface --------------------------------------------

    def clear(self) -> None:
        """Drop every tier (the admin reset)."""
        with self._lock:
            self.host.clear()
            if self.disk is not None:
                self.disk.clear()
            self._notify([], None)

    def make_host_room(self, target_bytes: int) -> None:
        """Evict host-tier LRU entries (cascading like any eviction) until
        ``used <= target_bytes``, keeping the configured capacity. A swap
        reservation that does not fit the shared allowance calls this: the
        tier's entries are copies, a victim's KV is not."""
        with self._lock:
            removed = self._cascade(
                self.host.evict_to_capacity(max(0, int(target_bytes))))
            self._notify([], removed)

    def resize_host(self, capacity_bytes: int) -> None:
        """Change the host tier's budget; shrinking evicts LRU entries."""
        with self._lock:
            self.host.capacity = max(0, int(capacity_bytes))
            removed = self._cascade(
                self.host.evict_to_capacity(self.host.capacity))
            self._notify([], removed)

    # -- onboarding (G2/G3 → the caller) -------------------------------------

    def get_host(self, h: int) -> Optional[tuple]:
        """Host tier only: cheap enough for the admission path."""
        with self._lock:
            return self.host.get(h)

    def get_local(self, h: int) -> Optional[tuple]:
        """Host, then disk, for serving a peer's pull; a disk hit is not
        promoted (a peer's restore must not churn the local host tier)."""
        with self._lock:
            e = self.host.get(h)
            if e is None and self.disk is not None:
                e = self.disk.get(h)
            return e

    def get(self, h: int) -> Optional[tuple]:
        """Host, then disk; a disk hit is promoted back to the host tier
        (it is hot again), and what that evicts out of every tier is
        announced."""
        with self._lock:
            e = self.host.get(h)
            if e is not None or self.disk is None:
                return e
            e = self.disk.get(h)
            if e is not None:
                removed = self._cascade(self.host.put(h, e[0], e[1]))
                self._notify([], removed)
            return e

    def stats(self) -> dict:
        return {
            "host_blocks": len(self.host),
            "host_bytes": self.host.used,
            "disk_blocks": len(self.disk) if self.disk is not None else 0,
            "disk_bytes": self.disk.used if self.disk is not None else 0,
            "remote_blocks": 0,
            "remote_bytes": 0,
            "offloaded_blocks": self.offloaded_blocks,
            "onboarded_blocks": self.onboarded_blocks,
        }
