"""Paged-KV block gather and scatter, the port's copy of
``dynamo_tpu/ops/block_copy.py``.

The JAX package moves whole blocks with XLA gathers and scatters (no
Pallas kernel); here they are torch indexing copies on the engine's
stream:

  gather_blocks:  cache [L, slots, KV, hd] + ids [n] → [L, n, bs, KV, hd]
                  (an int8 {"q", "s"} cache → packed uint8 [L, n, X])
  scatter_blocks: writes such a bundle into blocks of a cache IN PLACE
  blocks_digest:  a checksum of blocks' bytes, left on the device

The JAX scatter returns a new (donated) cache; the port writes into the
tensors it was given and never rebinds them, because the engine's CUDA
graphs hold their addresses. Nor does it pad the id list to a power of
two: a torch copy compiles nothing per shape. ``reshard_bundle`` (a mesh
re-layout) waits for multi-device serving (ROADMAP A11).
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.engine.cache import (
    dequantize_kv, is_quant_cache, pack_kv_blocks, quantize_kv,
    unpack_kv_blocks,
)


def _ids(block_ids, device) -> torch.Tensor:
    return torch.as_tensor(list(block_ids), dtype=torch.long, device=device)


def gather_blocks(cache, block_ids, *, block_size: int) -> torch.Tensor:
    """Whole blocks out of the flat paged cache, on the cache's device:
    [L, n, block_size, KV, hd], or for an int8 cache the PACKED uint8
    bundle [L, n, bs·KV·(hd+4)] (``engine.cache.pack_kv_blocks``): one
    byte an element plus the scales, bit-exact through a round trip. The
    copy is enqueued on the current stream, so it reads the cache as
    every step launched before it left it."""
    if is_quant_cache(cache):
        L, slots, KV, hd = cache["q"].shape
        ids = _ids(block_ids, cache["q"].device)
        qp = cache["q"].view(L, slots // block_size, block_size, KV, hd)
        sp = cache["s"].view(L, slots // block_size, block_size, KV)
        return pack_kv_blocks(qp[:, ids], sp[:, ids])
    L, slots, KV, hd = cache.shape
    ids = _ids(block_ids, cache.device)
    return cache.view(L, slots // block_size, block_size, KV, hd)[:, ids]


def blocks_digest(caches, block_ids, *, block_size: int,
                  group: int = 64) -> torch.Tensor:
    """A checksum of blocks ``block_ids`` in each cache of ``caches``, as
    an int64 scalar on their device (enqueued, not waited for): the sum of
    each (cache, layer, block)'s 32-bit words, weighted by its place in
    that order. Two workers' digests of one prompt's blocks are equal when
    they hold the same bytes in the same order; a block, layer or request
    placed elsewhere changes it. Blocks are read ``group`` at a time, so a
    long prompt's digest needs no copy of all its pages."""
    ids = list(block_ids)
    n = len(ids)
    total = None
    for c, cache in enumerate(caches):
        for i in range(0, n, group):
            b = gather_blocks(cache, ids[i:i + group], block_size=block_size)
            L, m = b.shape[:2]
            x = b.reshape(L, m, -1).view(torch.uint8)
            if x.shape[-1] % 4 == 0:
                x = x.view(torch.int32)
            s = x.sum(-1, dtype=torch.int64)
            rows = torch.arange(L, dtype=torch.int64, device=s.device)
            cols = torch.arange(m, dtype=torch.int64, device=s.device)
            w = c * L * n + n * rows[:, None] + i + cols + 1
            d = (s * w).sum()
            total = d if total is None else total + d
    return total


def _is_packed(bundle) -> bool:
    return bundle.dtype == torch.uint8 and bundle.dim() == 3


def scatter_blocks(cache, block_ids, bundle, *, block_size: int,
                   start_layer=None):
    """Write a bundle into blocks ``block_ids`` of ``cache`` in place and
    return ``cache`` (the same tensors).

    ``bundle``: values [nL, n, bs, KV, hd] or a packed uint8 int8 bundle
    [nL, n, X], on any device (it is copied to the cache's). The cross-
    layout pairs work as in the JAX package: a packed bundle into a plain
    cache dequantizes, a value bundle into an int8 cache quantizes (bit-
    exact for bundles that started as int8 pages). ``start_layer`` (int)
    means the bundle is a LAYER SLICE covering layers [start_layer,
    start_layer + nL) only; None = full depth."""
    quant = is_quant_cache(cache)
    ref = cache["q"] if quant else cache
    L, slots, KV, hd = ref.shape
    dev = ref.device
    ids = _ids(block_ids, dev)
    if bundle.shape[1] != len(ids):
        raise ValueError(f"bundle of {bundle.shape[1]} blocks for "
                         f"{len(ids)} block ids")
    bundle = bundle.to(dev, non_blocking=True)
    nL = bundle.shape[0]
    lo = 0 if start_layer is None else int(start_layer)
    if lo < 0 or lo + nL > L:
        raise ValueError(f"layers [{lo}, {lo + nL}) outside a {L}-layer "
                         "cache")
    nb = slots // block_size
    if quant:
        if _is_packed(bundle):
            q, s = unpack_kv_blocks(bundle, block_size, KV, hd)
        else:
            q, s = quantize_kv(bundle)
        cache["q"].view(L, nb, block_size, KV, hd)[lo:lo + nL, ids] = q
        cache["s"].view(L, nb, block_size, KV)[lo:lo + nL, ids] = s
        return cache
    if _is_packed(bundle):  # an int8 prefill worker into a plain cache
        bundle = dequantize_kv(*unpack_kv_blocks(bundle, block_size, KV, hd))
    cache.view(L, nb, block_size, KV, hd)[lo:lo + nL, ids] = \
        bundle.to(cache.dtype)
    return cache
