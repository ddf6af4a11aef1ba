"""Paged KV cache: device tensors + host-side block pool with prefix cache,
the port's copy of ``dynamo_tpu/engine/cache.py``.

Device side: two tensors [L, num_slots, KV, hd] (num_slots = num_blocks *
block_size; MLA: the latent [L, num_slots, 1, kv_lora_rank] and the padded
rope part [L, num_slots, 1, rope_cache_dim], ``ModelConfig.kv_cache_spec``),
or two int8 ``{"q", "s"}`` pairs (see the int8 notes below),
flat slot addressing; block 0 is the reserved NULL block —
padding slot-maps and block tables point at it and its contents are
garbage by design (attention masks it out). This is the JAX package's
interchange format, so pages move between the two engines unchanged.

Host side: ``BlockPool`` refcounts blocks while sequences use them; on
release, hash-identified full blocks park in an LRU prefix cache for
reuse, and eviction emits the KV-removed events the router relies on.
``SwapStore`` is the host-byte budget of preempt-to-swap, shared with the
KVBM host tier when one is configured.
"""

from __future__ import annotations

import logging
import math
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from dynamo_tpu_torch.tokens import SequenceHash

logger = logging.getLogger("dynamo_torch.engine.cache")

NULL_BLOCK = 0


class SwapStore:
    """Byte budget of the KV that preempt-to-swap keeps in host memory.

    Only the arithmetic lives here: the bundles live on the engine's swap
    entries. The scheduler's swap-out asks ``reserve()`` first and falls
    back to recompute preemption when the answer is no.

    ``external_used`` shares the budget with the KVBM host tier: swap may
    reserve budget − swap-reserved − G2-resident bytes, and the tier's puts
    evict down to budget − swap-reserved (``HostTier.external_used``, wired
    by the engine). ``make_room(target_bytes)`` asks the tier to shrink to
    ``target_bytes`` when a reservation does not fit: its entries are
    copies, a victim's KV would otherwise be recomputed. Thread-safe: the
    reserve runs on the event loop, a release may come from a copy's
    completion.
    """

    def __init__(self, budget_bytes: int,
                 external_used: Optional[Callable[[], int]] = None,
                 make_room: Optional[Callable[[int], None]] = None):
        self.budget = max(0, int(budget_bytes))
        self.external_used = external_used
        self.make_room = make_room
        self.used = 0  # bytes reserved by live swap entries
        self._lock = threading.Lock()

    def _external(self) -> int:
        # an attribute read on the host tier, never its lock: a race with a
        # concurrent put is bounded by one block, because the tier enforces
        # the shared budget from its side too
        if self.external_used is None:
            return 0
        try:
            return int(self.external_used())
        except Exception:  # a broken probe must not wedge swap
            logger.exception("swap external_used probe failed")
            return 0

    def reserve(self, nbytes: int) -> bool:
        with self._lock:
            ext = self._external()
            avail = self.budget - self.used - ext
            if avail < nbytes and self.make_room is not None and ext > 0:
                # the tier takes its own lock and never ours: no cycle
                try:
                    self.make_room(max(0, ext - (nbytes - avail)))
                except Exception:
                    logger.exception("swap make_room failed")
                avail = self.budget - self.used - self._external()
            if avail < nbytes:
                return False
            self.used += nbytes
            return True

    def release(self, nbytes: int) -> None:
        with self._lock:
            self.used = max(0, self.used - nbytes)


@dataclass
class BlockMeta:
    block_id: int
    ref_count: int = 0
    #: chained sequence hash once the block is full + registered
    seq_hash: Optional[SequenceHash] = None


class BlockPool:
    """Refcounted block allocator with an inactive LRU prefix cache.

    ``on_removed(seq_hashes)`` fires when cached blocks are evicted (reused
    for new data), ``on_removed(None)`` when ``clear()`` drops them all;
    ``on_freed()`` fires whenever release() returns
    capacity to the pool.
    """

    def __init__(self, num_blocks: int, enable_prefix_caching: bool = True,
                 on_removed: Optional[Callable[[list[int]], None]] = None):
        self.num_blocks = num_blocks
        self.enable_prefix_caching = enable_prefix_caching
        self.on_removed = on_removed
        self.on_freed: Optional[Callable[[], None]] = None
        # block 0 reserved as NULL
        self._free: list[int] = list(range(num_blocks - 1, 0, -1))
        self._meta: dict[int, BlockMeta] = {}
        #: seq_hash -> block_id for all registered full blocks
        self._by_hash: dict[SequenceHash, int] = {}
        #: inactive (refcount 0) cached blocks, LRU order (oldest first)
        self._lru: "OrderedDict[SequenceHash, int]" = OrderedDict()
        #: blocks' worth of KV parked in host memory by preempt-to-swap:
        #: not device-resident (their ids were released), but their
        #: sequences are live and allocate again at swap-in
        self.swapped_blocks = 0

    def note_swapped_out(self, n: int) -> None:
        self.swapped_blocks += n

    def note_swapped_in(self, n: int) -> None:
        self.swapped_blocks = max(0, self.swapped_blocks - n)

    @property
    def num_free_blocks(self) -> int:
        """Blocks allocatable right now (free list + evictable LRU)."""
        return len(self._free) + len(self._lru)

    @property
    def num_active_blocks(self) -> int:
        return len(self._meta) - len(self._lru)

    def usage(self) -> float:
        usable = self.num_blocks - 1
        return (usable - self.num_free_blocks) / max(1, usable)

    def allocate(self, n: int) -> Optional[list[int]]:
        """Allocate n blocks, evicting LRU-cached blocks if needed; None
        (allocating nothing) if capacity is insufficient."""
        if self.num_free_blocks < n:
            return None
        out = []
        evicted: list[int] = []
        for _ in range(n):
            if self._free:
                bid = self._free.pop()
            else:
                h, bid = self._lru.popitem(last=False)
                meta = self._meta.pop(bid)
                self._by_hash.pop(h, None)
                evicted.append(meta.seq_hash)
            self._meta[bid] = BlockMeta(block_id=bid, ref_count=1)
            out.append(bid)
        if evicted and self.on_removed:
            self.on_removed(evicted)
        return out

    def match_prefix(self, seq_hashes: list[SequenceHash]) -> list[int]:
        """Longest cached prefix: block ids for leading seq hashes, increffed."""
        if not self.enable_prefix_caching:
            return []
        out = []
        for h in seq_hashes:
            bid = self._by_hash.get(h)
            if bid is None:
                break
            meta = self._meta[bid]
            if meta.ref_count == 0:
                self._lru.pop(h, None)
            meta.ref_count += 1
            out.append(bid)
        return out

    def lookup(self, seq_hash: SequenceHash) -> Optional[int]:
        """Block id currently holding ``seq_hash``'s KV (active or LRU-
        cached), or None. Read-only: no incref, no LRU touch; a caller that
        gathers asynchronously pins with acquire()/release()."""
        if not self.enable_prefix_caching:
            return None
        return self._by_hash.get(seq_hash)

    def acquire(self, block_ids: list[int]) -> None:
        """Incref blocks (pin them for an asynchronous gather); pairs with
        release(). Cached refcount-0 blocks leave the LRU."""
        for bid in block_ids:
            meta = self._meta.get(bid)
            if meta is None:
                continue
            if meta.ref_count == 0 and meta.seq_hash is not None:
                self._lru.pop(meta.seq_hash, None)
            meta.ref_count += 1

    def register(self, block_id: int, seq_hash: SequenceHash) -> bool:
        """Mark a full block as identified by its sequence hash (→
        reusable). False if an identical block is already registered
        elsewhere."""
        meta = self._meta[block_id]
        meta.seq_hash = seq_hash
        if not self.enable_prefix_caching:
            return True
        if seq_hash in self._by_hash and self._by_hash[seq_hash] != block_id:
            return False
        self._by_hash[seq_hash] = block_id
        return True

    def release(self, block_ids: list[int]) -> None:
        """Decref; refcount-0 blocks go to the LRU cache (if hashed) or free."""
        freed = False
        for bid in block_ids:
            if bid == NULL_BLOCK:
                continue
            meta = self._meta.get(bid)
            if meta is None:
                continue
            meta.ref_count -= 1
            if meta.ref_count > 0:
                continue
            freed = True
            if (meta.seq_hash is not None and self.enable_prefix_caching
                    and self._by_hash.get(meta.seq_hash) == bid):
                self._lru[meta.seq_hash] = bid
                self._lru.move_to_end(meta.seq_hash)
            else:
                self._meta.pop(bid)
                self._free.append(bid)
        if freed and self.on_freed:
            self.on_freed()

    def clear(self) -> None:
        """Drop the entire prefix cache (the admin ``clear_kv_blocks``):
        every cached block not held by a sequence goes back to the free
        list, and ``on_removed(None)`` reports the whole cache cleared."""
        for h, bid in list(self._lru.items()):
            self._meta.pop(bid, None)
            self._by_hash.pop(h, None)
            self._free.append(bid)
        self._lru.clear()
        if self.on_removed:
            self.on_removed(None)  # None = cleared-all sentinel
        if self.on_freed:
            self.on_freed()


def kv_block_bytes(cfg, block_size: int, dtype: torch.dtype,
                   kv_cache_dtype: Optional[str] = None) -> int:
    """Bytes of one block across both caches and every layer, from
    ``cfg.kv_cache_spec`` (an MLA block holds the latent and the padded
    rope part). An int8 cache costs one byte per element plus a 4-byte f32
    scale per (slot, head)."""
    per_slot = 0
    for heads, dim in cfg.kv_cache_spec:
        per_slot += heads * ((dim + 4) if kv_cache_dtype == "int8"
                             else dim * dtype.itemsize)
    return cfg.num_layers * block_size * per_slot


def memory_sized_num_blocks(cfg, block_size: int, fraction: float,
                            device: torch.device, dtype: torch.dtype,
                            kv_cache_dtype: Optional[str] = None) -> int:
    """Block count from the card's free memory, read after the weights are
    resident: ``fraction`` of what is free goes to the KV pool."""
    if device.type != "cuda":
        raise ValueError("sizing the KV pool from free memory needs a CUDA "
                         "device; pass EngineArgs.num_blocks on the CPU")
    free, _total = torch.cuda.mem_get_info(device)
    n = int(free * fraction) // kv_block_bytes(cfg, block_size, dtype,
                                               kv_cache_dtype)
    return max(16, n)


def allocate_device_cache(cfg, num_blocks: int, block_size: int,
                          device: torch.device, dtype: torch.dtype,
                          kv_cache_dtype: Optional[str] = None):
    """Zeroed k/v caches of ``cfg.kv_cache_spec``: each [L, num_blocks *
    block_size, KV, hd] for GQA; for MLA k is the latent [L, slots, 1,
    kv_lora_rank] and v the rope part [L, slots, 1, rope_cache_dim]. With
    ``kv_cache_dtype="int8"`` each is ``{"q": int8 [L, slots, heads, dim],
    "s": f32 [L, slots, heads]}``."""
    def one(heads, dim):
        shape = (cfg.num_layers, num_blocks * block_size, heads, dim)
        if kv_cache_dtype == "int8":
            return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
                    "s": torch.zeros(shape[:-1], dtype=torch.float32,
                                     device=device)}
        return torch.zeros(shape, dtype=dtype, device=device)

    (kh, kd), (vh, vd) = cfg.kv_cache_spec
    return one(kh, kd), one(vh, vd)


# ---------------------------------------------------------------- int8 cache
#
# A quantized cache is {"q": int8 [L, slots, KV, hd], "s": f32 [L, slots,
# KV]}: symmetric scales per (slot, kv-head), the JAX package's layout.
# Requantizing a dequantized block gives the same bytes back: the scale
# keeps 8 mantissa bits, so 127·s is exact and the amax of a dequantized
# block recovers s.


def is_quant_cache(cache) -> bool:
    return isinstance(cache, dict) and "q" in cache and "s" in cache


def cache_shape(cache) -> tuple:
    """[L, slots, KV, hd] of a plain or an int8 cache."""
    return tuple(cache["q"].shape if is_quant_cache(cache) else cache.shape)


def quantize_kv(x):
    """[..., KV, hd] → (int8 [..., KV, hd], f32 scales [..., KV]), bit for
    bit the JAX package's: s = max(amax, 1e-8) / 127 rounded to bf16
    (nearest even) and kept in f32, q = clip(round_half_even(x / s))."""
    xf = x.float()
    amax = torch.linalg.vector_norm(xf, ord=math.inf, dim=-1)  # max |x|
    s = (torch.clamp_min(amax, 1e-8) / 127.0).to(torch.bfloat16).float()
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def dequantize_kv(q, s, dtype=None):
    """The exact inverse in f32, with an optional final cast."""
    out = q.float() * s[..., None]
    return out if dtype is None else out.to(dtype)


def gather_pages(cache, lidx: int, slot_idx):
    """Pages [*slot_idx.shape, KV, hd] of layer ``lidx`` from a plain or an
    int8 cache; int8 pages come back dequantized in f32."""
    if is_quant_cache(cache):
        return dequantize_kv(cache["q"][lidx][slot_idx],
                             cache["s"][lidx][slot_idx])
    return cache[lidx][slot_idx]


def write_kv(k_cache, v_cache, lidx: int, slots, k, v) -> None:
    """Write ``k`` and ``v`` [N, heads, dim] in place at the flat ``slots``
    [N] of layer ``lidx``. Int8 caches store ``quantize_kv`` of both: GQA
    k and v in one pass over the pair (each (token, head) row is quantized
    on its own, so the bytes are those of two calls, in half the launches);
    MLA's latent and rope part, whose widths differ, in one pass each, as
    the JAX package's ``_mla_attention`` writes them."""
    if is_quant_cache(k_cache):
        if k.shape == v.shape:
            q, s = quantize_kv(torch.stack((k, v)))
            pairs = ((q[0], s[0]), (q[1], s[1]))
        else:
            pairs = (quantize_kv(k), quantize_kv(v))
        for cache, (q, s) in zip((k_cache, v_cache), pairs):
            cache["q"][lidx].index_copy_(0, slots, q)
            cache["s"][lidx].index_copy_(0, slots, s)
    else:
        k_cache[lidx].index_copy_(0, slots, k)
        v_cache[lidx].index_copy_(0, slots, v)


def layer_pages(cache, lidx: int):
    """(pages [slots, KV, hd], scales [slots, KV] or None) of one layer:
    views, no copy."""
    if is_quant_cache(cache):
        return cache["q"][lidx], cache["s"][lidx]
    return cache[lidx], None


# ----------------------------------------------------------- packed bundles
#
# The native bundle of an int8 cache (the disagg wire and the KV pulls):
# each block's q bytes then its scale bytes, uint8 [..., bs·KV·(hd+4)],
# byte for byte the JAX package's ``pack_kv_blocks`` (little-endian f32).


def packed_block_width(block_size: int, KV: int, hd: int) -> int:
    """Trailing byte width of a packed int8 bundle row."""
    return block_size * KV * (hd + 4)


def pack_kv_blocks(q, s):
    """(int8 [..., bs, KV, hd], f32 [..., bs, KV]) → uint8 [..., X] with
    X = bs·KV·(hd+4): q bytes then scale bytes, per leading index."""
    bs, KV, hd = q.shape[-3:]
    lead = tuple(q.shape[:-3])
    qb = q.contiguous().view(torch.uint8).reshape(*lead, bs * KV * hd)
    sb = s.contiguous().view(torch.uint8).reshape(*lead, bs * KV * 4)
    return torch.cat([qb, sb], dim=-1)


def unpack_kv_blocks(buf, block_size: int, KV: int, hd: int):
    """Inverse of :func:`pack_kv_blocks`: uint8 [..., X] →
    (int8 [..., bs, KV, hd], f32 [..., bs, KV])."""
    bs = block_size
    lead = tuple(buf.shape[:-1])
    nq = bs * KV * hd
    q = buf[..., :nq].contiguous().view(torch.int8).reshape(*lead, bs, KV, hd)
    s = buf[..., nq:].contiguous().view(torch.float32).reshape(*lead, bs, KV)
    return q, s
