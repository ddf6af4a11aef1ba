"""Storage tiers of the KV block manager: host memory (G2) and disk (G3),
each an LRU by byte budget; the port's copy of the local part of
``dynamo_tpu/kvbm/tiers.py``.

An entry is one full block: its k and v pages, [L, bs, KV, hd] each (an
int8 cache's packed uint8 rows [L, X]), keyed by the block's chained
sequence hash, the identity the prefix cache and the router use. Both tiers
hold torch CPU tensors. The engine puts pinned ones into G2 on the card (so
that onboarding copies to the device without staging) and plain ones on
the CPU; G3 reads back plain ones. G3's files are the JAX package's: one
``{hash:016x}.npz`` a block with the raw bytes of k and v, their shapes,
and the dtype's name ("bfloat16" too, written without ``ml_dtypes``). The
G4 object-store tier waits for the distributed block manager.
"""

from __future__ import annotations

import logging
import os
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from dynamo_tpu_torch.disagg.protocols import dtype_name
from dynamo_tpu_torch.kvbm.distributed import resolve_dtype

logger = logging.getLogger("dynamo_torch.kvbm")


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class HostTier:
    """G2: a host-memory LRU block store with a byte budget.

    ``external_used`` (a callable giving bytes) shares the budget with
    preempt-to-swap's reservations: puts evict down to capacity − external,
    as ``SwapStore.reserve`` subtracts this tier's ``used``.
    """

    def __init__(self, capacity_bytes: int, external_used=None):
        self.capacity = capacity_bytes
        self.used = 0
        self.external_used = external_used
        self._store: "OrderedDict[int, tuple]" = OrderedDict()

    def _external(self) -> int:
        if self.external_used is None:
            return 0
        try:
            return int(self.external_used())
        except Exception:  # a broken probe must not wedge offload
            logger.exception("host tier external_used probe failed")
            return 0

    def __contains__(self, h: int) -> bool:
        return h in self._store

    def __len__(self) -> int:
        return len(self._store)

    def put(self, h: int, k: torch.Tensor, v: torch.Tensor) -> list[tuple]:
        """Insert; returns the evicted (hash, k, v) entries (what cascades
        to the next tier)."""
        if h in self._store:
            self._store.move_to_end(h)
            return []
        size = nbytes(k) + nbytes(v)
        budget = self.capacity - self._external()
        if size > budget:
            return []  # cannot fit now: drop it without flushing the tier
        evicted = self.evict_to_capacity(budget - size)
        self._store[h] = (k, v)
        self.used += size
        return evicted

    def evict_to_capacity(self, capacity: int) -> list[tuple]:
        """Pop LRU entries until ``used <= capacity``; returns the evicted
        (hash, k, v) entries."""
        evicted = []
        while self._store and self.used > capacity:
            eh, (ek, ev) = self._store.popitem(last=False)
            self.used -= nbytes(ek) + nbytes(ev)
            evicted.append((eh, ek, ev))
        return evicted

    def get(self, h: int) -> Optional[tuple]:
        e = self._store.get(h)
        if e is not None:
            self._store.move_to_end(h)
        return e

    def clear(self) -> None:
        self._store.clear()
        self.used = 0


def _raw(t: torch.Tensor) -> np.ndarray:
    """``t``'s bytes as uint8, the last axis widened by the item size (what
    numpy's ``view(np.uint8)`` gives)."""
    return t.contiguous().view(torch.uint8).numpy()


class DiskTier:
    """G3: one .npz file a block in ``directory``, LRU by byte budget.
    Files left in the directory by an earlier run are unreachable (the
    index starts empty) and are deleted at start."""

    def __init__(self, directory: str, capacity_bytes: int):
        self.dir = directory
        self.capacity = capacity_bytes
        self.used = 0
        self._index: "OrderedDict[int, int]" = OrderedDict()  # hash → bytes
        os.makedirs(directory, exist_ok=True)
        for name in os.listdir(directory):
            if name.endswith(".npz"):
                try:
                    os.unlink(os.path.join(directory, name))
                except OSError:
                    pass

    def _path(self, h: int) -> str:
        return os.path.join(self.dir, f"{h & 0xFFFFFFFFFFFFFFFF:016x}.npz")

    def __contains__(self, h: int) -> bool:
        return h in self._index

    def __len__(self) -> int:
        return len(self._index)

    def put(self, h: int, k: torch.Tensor, v: torch.Tensor) -> list[int]:
        """Insert; returns the hashes evicted out of the tier."""
        if h in self._index:
            self._index.move_to_end(h)
            return []
        size = nbytes(k) + nbytes(v)
        if size > self.capacity:
            return []  # can never fit: drop it without flushing the tier
        evicted = []
        while self._index and self.used + size > self.capacity:
            eh, esize = self._index.popitem(last=False)
            self.used -= esize
            evicted.append(eh)
            try:
                os.unlink(self._path(eh))
            except OSError:
                pass
        # raw bytes and the dtype's name (numpy has no bf16); k's and v's
        # shapes apart (an MLA block's parts differ)
        np.savez(self._path(h), k=_raw(k), v=_raw(v),
                 k_shape=np.asarray(k.shape), v_shape=np.asarray(v.shape),
                 dtype=dtype_name(k))
        self._index[h] = size
        self.used += size
        return evicted

    def get(self, h: int) -> Optional[tuple]:
        if h not in self._index:
            return None
        try:
            with np.load(self._path(h), allow_pickle=False) as z:
                dtype = resolve_dtype(str(z["dtype"]))
                k = torch.from_numpy(z["k"]).view(dtype).reshape(
                    tuple(int(x) for x in z["k_shape"]))
                v = torch.from_numpy(z["v"]).view(dtype).reshape(
                    tuple(int(x) for x in z["v_shape"]))
        except Exception:
            logger.exception("disk tier read failed for %x", h)
            n = self._index.pop(h, None)
            if n is not None:
                self.used -= n
            return None
        self._index.move_to_end(h)
        return k, v

    def clear(self) -> None:
        for h in list(self._index):
            try:
                os.unlink(self._path(h))
            except OSError:
                pass
        self._index.clear()
        self.used = 0
