"""Paged-attention decode: one query token per sequence over its pages.

Port of ``dynamo_tpu/ops/paged_attention.py``'s Pallas kernel
``_decode_kernel`` (wrapper ``paged_attention_decode``). Contract, per
layer:

  q            [B, H, hd]       one query per row, the row's last token
  k/v cache    [slots, KV, hd]  flat paged layout; the q dtype, or int8
  block_tables [B, W] int32     per row (block 0 is the null block)
  kv_lens      [B] int32        keys of each row
  window       int or None      0/None = full, else keys >= kv_len - window
  sinks        [H] or None      per-head sink logits, cast to q's dtype
                                (as the JAX wrapper does before its kernel)
  softcap      float            0 = off; else scaled scores s become
                                softcap·tanh(s/softcap) before the mask
  k/v scales   [sc_slots, KV]   f32, int8 pages only: slot s dequantizes
                                with scales[s - scale_slot_base]
  → out        [B, H, hd]

Scale 1/sqrt(hd), f32 accumulation; a row with kv_len 0 gets zeros.

This is the all-decode case of ragged paged attention, so
:func:`paged_attention_decode` runs the ragged Hopper kernel
(``csrc/ragged_attention.cu``) on CUDA tensors with rows3 = (b, 1, kv_len)
built on the device: the query of row b is token b at position
kv_len - 1, whose ragged window ``key > pos - window`` is this contract's
``key >= kv_len - window``. A kv_len 0 row is a one-token row that sees no
key, which the kernel writes as zeros. It counts its launches apart from
the ragged wrapper's. CPU tensors take :func:`paged_attention_decode_ref`.
A caller that runs many layers over one ``kv_lens`` (the dense forward)
makes those rows once with :func:`decode_rows` and passes them as
``rows3``; the plain version reads ``kv_lens`` and ignores them.
"""

from __future__ import annotations

import math

import torch

from dynamo_tpu_torch.ops.ragged_attention import launch_ragged

_NEG = -1e30


def decode_rows(kv_lens):
    """The kernel's rows3 for B one-query rows, (b, 1, kv_len), made on the
    device: no host read."""
    B = kv_lens.shape[0]
    rows3 = torch.ones((B, 3), dtype=torch.int32, device=kv_lens.device)
    rows3[:, 0] = torch.arange(B, dtype=torch.int32, device=kv_lens.device)
    rows3[:, 2] = kv_lens
    return rows3


def paged_attention_decode_ref(q, k_cache, v_cache, block_tables, kv_lens, *,
                               block_size: int, window=None, sinks=None,
                               k_scales=None, v_scales=None,
                               scale_slot_base=None, rows3=None,
                               softcap: float = 0.0):
    """Plain PyTorch version: the JAX package's ``paged_attention_decode_xla``
    (a dense gather of every row's table width, int8 pages dequantized in
    the gather), except that a row with no visible key gets zeros, as the
    kernels give, and sinks round to q's dtype first."""
    B, H, hd = q.shape
    KV = k_cache.shape[1]
    G = H // KV
    T = block_tables.shape[1] * block_size
    dev = q.device
    slot_idx = (block_tables.long()[:, :, None] * block_size
                + torch.arange(block_size, device=dev)).reshape(B, T)
    k = k_cache[slot_idx].float()  # [B, T, KV, hd]
    v = v_cache[slot_idx].float()
    if k_scales is not None:
        sidx = slot_idx - (scale_slot_base or 0)
        k = k * k_scales[sidx].float()[..., None]
        v = v * v_scales[sidx].float()[..., None]
    qg = q.reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, k) / math.sqrt(hd)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    key_pos = torch.arange(T, device=dev)[None]
    lens = kv_lens.long()[:, None]
    mask = key_pos < lens  # [B, T]
    if window:
        mask &= key_pos >= lens - window
    mask = mask[:, None, None, :]
    s = s.masked_fill(~mask, _NEG)
    m = s.amax(-1, keepdim=True)
    if sinks is not None:
        sk = sinks.to(q.dtype).float().reshape(KV, G)[None, :, :, None]
        m = torch.maximum(m, sk)
    e = torch.exp(s - m) * mask
    denom = e.sum(-1, keepdim=True)
    if sinks is not None:
        denom = denom + torch.exp(sk - m)
    p = e / denom.clamp_min(1e-30)
    # keys past kv_len may hold anything (the null block collects padding
    # tokens' K/V, which the ragged step leaves unspecified): keep them
    # out of P·V, as the kernels never load them
    o = torch.einsum("bkgt,btkd->bkgd", p, v.masked_fill(
        ~mask[:, 0, 0, :, None, None], 0.0))
    return o.reshape(B, H, hd).to(q.dtype)


def paged_attention_decode(q, k_cache, v_cache, block_tables, kv_lens, *,
                           block_size: int, window=None, sinks=None,
                           k_scales=None, v_scales=None,
                           scale_slot_base=None, rows3=None,
                           softcap: float = 0.0):
    """Paged decode attention (see the module docstring for the contract).
    CUDA tensors launch the ragged Hopper kernel on the current stream;
    CPU tensors take :func:`paged_attention_decode_ref`."""
    kw = dict(block_size=block_size, window=window, sinks=sinks,
              k_scales=k_scales, v_scales=v_scales,
              scale_slot_base=scale_slot_base, softcap=softcap)
    if q.device.type == "cpu":
        return paged_attention_decode_ref(q, k_cache, v_cache, block_tables,
                                          kv_lens, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"no paged decode kernel for {q.device}")
    B = q.shape[0]
    if kv_lens.dtype != torch.int32 or tuple(kv_lens.shape) != (B,):
        raise ValueError("kv_lens must be int32 [B]")
    if rows3 is None:
        rows3 = decode_rows(kv_lens)
    if sinks is not None:
        # the JAX wrapper's rounding to q's dtype, then the kernel's f32
        sinks = sinks.to(q.dtype).float()
    kw.update(window=int(window or 0), sinks=sinks,
              scale_slot_base=int(scale_slot_base or 0))
    return launch_ragged(q, k_cache, v_cache, block_tables, rows3, **kw,
                         counter=paged_attention_decode)


#: kernel launches since the count was last set to 0, all page dtypes
paged_attention_decode.launches = 0
