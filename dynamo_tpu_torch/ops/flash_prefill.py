"""Flash prefill attention over dense, already gathered K/V.

Port of ``dynamo_tpu/ops/flash_prefill.py`` (the Pallas kernel
``_prefill_kernel``). Contract:

  q         [B, S, H, hd]    row b's token s at position pos_base[b] + s
  k         [B, T, KV, hd]   gathered keys, logically ordered
  v         [B, T, KV, hdv]  values (hdv may differ from hd: MLA)
  pos_base  [B] int32        position of each row's first query
  kv_lens   [B] int32        valid keys of the row
  → out     [B, S, H, hdv]

A query sees the keys at or before its position and below kv_len; an
optional window keeps keys > pos - window, optional per-head sink logits
enter the softmax denominator with no value, ``scale`` defaults to
1/sqrt(hd), and ``softcap`` > 0 turns each scaled score s into
softcap·tanh(s/softcap) before the mask (Gemma-2). A query that sees no
key gets zeros.

:func:`flash_prefill` launches the hand-written Hopper kernel
(``csrc/flash_prefill.cu``) for CUDA tensors (bf16 or f32, hd == hdv in
{64, 128, 256}, H / KV <= 64) and uses the plain version
:func:`flash_prefill_ref` only for tensors that lie on the CPU.
:func:`flash_prefill_paged` gathers a layer's pages (dequantizing an int8
cache) and calls it. The MLA geometry has its own kernel
(``csrc/mla_prefill.cu``) behind :func:`flash_mla_prefill` (dense keys) and
:func:`flash_mla_prefill_paged` (a layer's latent pages through block
tables), with the plain versions :func:`flash_mla_prefill_ref` and
:func:`flash_mla_prefill_paged_ref`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from dynamo_tpu_torch.engine.cache import gather_pages
from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.ops.mla_decode import (
    PAGE_KINDS, check_pages, gather_latent,
)
from dynamo_tpu_torch.ops.ragged_attention import HEAD_DIMS, MAX_GROUP

_NEG = -1e30


def flash_prefill_ref(q, k, v, pos_base, kv_lens, *, sliding_window=None,
                      sinks=None, scale=None, softcap: float = 0.0):
    """Plain PyTorch version: dense masked softmax in f32, one batch row at
    a time (so its score tensor stays [KV, G, S, T])."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    hdv = v.shape[3]
    G = H // KV
    scale = 1.0 / math.sqrt(hd) if scale is None else float(scale)
    dev = q.device
    keys = torch.arange(T, device=dev)
    out = torch.empty((B, S, H, hdv), dtype=q.dtype, device=dev)
    for b in range(B):
        qpos = pos_base[b].long() + torch.arange(S, device=dev)
        mask = (keys[None, :] <= qpos[:, None]) & (keys[None, :]
                                                    < kv_lens[b].long())
        if sliding_window:
            mask &= keys[None, :] > qpos[:, None] - sliding_window
        qg = q[b].float().reshape(S, KV, G, hd)
        s = torch.einsum("skgd,tkd->kgst", qg, k[b].float()) * scale
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        s = s.masked_fill(~mask, _NEG)
        m = s.amax(-1, keepdim=True)
        if sinks is not None:
            sk = sinks.float().reshape(KV, G)[:, :, None, None]
            m = torch.maximum(m, sk)
        e = torch.exp(s - m) * mask
        denom = e.sum(-1, keepdim=True)
        if sinks is not None:
            denom = denom + torch.exp(sk - m)
        p = e / denom.clamp_min(1e-30)
        o = torch.einsum("kgst,tkd->skgd", p, v[b].float())
        out[b] = o.reshape(S, H, hdv).to(q.dtype)
    return out


def _kernel():
    """(launch, scratch-size query) of the kernel library, typed: left
    undeclared, ctypes would pass each pointer as a 32-bit int and cut it."""
    lib = _build.load("flash_prefill")
    fn = lib.dtt_flash_prefill
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    size = lib.dtt_flash_prefill_scratch_floats
    size.argtypes = [ctypes.c_int] * 6
    size.restype = ctypes.c_longlong
    return fn, size


def _check(q, k, v, pos_base, kv_lens, sinks, window,
           softcap: float = 0.0) -> None:
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v), ("pos_base", pos_base),
                    ("kv_lens", kv_lens), ("sinks", sinks)):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q dtype {q.dtype}: the kernel takes bf16 or f32")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("k and v dtype must equal q's")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q must be [B, S, H, hd], k and v [B, T, KV, hd]")
    B, S, H, hd = q.shape
    if k.shape[0] != B or v.shape[:3] != k.shape[:3] or k.shape[3] != hd:
        raise ValueError("q, k and v shapes disagree")
    if v.shape[3] != hd or hd not in HEAD_DIMS:
        raise ValueError(f"the kernel takes hd == hdv in {HEAD_DIMS}, got "
                         f"hd {hd}, hdv {v.shape[3]} (the MLA geometry is "
                         f"flash_mla_prefill's kernel)")
    KV = k.shape[2]
    if H % KV or H // KV > MAX_GROUP:
        raise ValueError(f"H={H}, KV={KV}: need H % KV == 0 and "
                         f"H / KV <= {MAX_GROUP}")
    if (pos_base.dtype != torch.int32 or kv_lens.dtype != torch.int32
            or tuple(pos_base.shape) != (B,) or tuple(kv_lens.shape) != (B,)):
        raise ValueError("pos_base and kv_lens must be int32 [B]")
    if sinks is not None and tuple(sinks.shape) != (H,):
        raise ValueError(f"sinks must be [H={H}]")
    if not isinstance(window, int) or window < 0:
        raise ValueError("sliding_window must be an int >= 0 or None")
    if not softcap >= 0.0:
        raise ValueError("softcap must be >= 0 (0 = off)")


def flash_prefill(q, k, v, pos_base, kv_lens, *, sliding_window=None,
                  sinks=None, scale=None, softcap: float = 0.0):
    """Flash prefill attention (see the module docstring for the contract).
    CUDA tensors launch the Hopper kernel on the current stream; CPU
    tensors take :func:`flash_prefill_ref`."""
    if q.device.type == "cpu":
        return flash_prefill_ref(q, k, v, pos_base, kv_lens,
                                 sliding_window=sliding_window, sinks=sinks,
                                 scale=scale, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"no flash prefill kernel for {q.device}")
    window = 0 if sliding_window is None else sliding_window
    _check(q, k, v, pos_base, kv_lens, sinks, window, softcap)
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    if sinks is not None:
        sinks = sinks.to(torch.float32).contiguous()
    launch, scratch_floats = _kernel()
    # split-K partials, when the query tiles alone cannot fill the card
    n = scratch_floats(B, S, T, H, KV, hd)
    scratch = (torch.empty(n, dtype=torch.float32, device=q.device)
               if n else None)
    err = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_base.data_ptr(),
        kv_lens.data_ptr(), sinks.data_ptr() if sinks is not None else None,
        out.data_ptr(), scratch.data_ptr() if scratch is not None else None,
        B, S, T, H, KV, hd, window,
        1.0 / math.sqrt(hd) if scale is None else float(scale),
        float(softcap), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash prefill kernel launch failed (code {err})")
    flash_prefill.launches += 1
    return out


#: kernel launches since the count was last set to 0
flash_prefill.launches = 0


def flash_prefill_paged(q, k_cache, v_cache, lidx: int, block_tables,
                        positions, kv_lens, *, block_size: int,
                        sliding_window=None, sinks=None, softcap: float = 0.0,
                        attention=flash_prefill):
    """Gather layer ``lidx``'s pages of each row — [B, W·bs, KV, hd], an
    int8 cache dequantized there — and flash-attend. q [B, S, H, hd];
    caches [L, slots, KV, hd] or int8 ``{"q", "s"}``; positions [B, S]
    (row b's first query at positions[b, 0]). ``attention`` is the dense
    call: the kernel wrapper, or :func:`flash_prefill_ref`."""
    B = q.shape[0]
    W = block_tables.shape[1]
    slot_idx = (block_tables.long()[:, :, None] * block_size
                + torch.arange(block_size, device=q.device)).reshape(
                    B, W * block_size)
    k = gather_pages(k_cache, lidx, slot_idx).to(q.dtype)
    v = gather_pages(v_cache, lidx, slot_idx).to(q.dtype)
    return attention(q, k, v, positions[:, 0].to(torch.int32).contiguous(),
                     kv_lens.to(torch.int32).contiguous(),
                     sliding_window=sliding_window, sinks=sinks,
                     softcap=softcap)


# ------------------------------------------------------------ MLA geometry
#
# The same TPU kernel at the MLA geometry (JAX ``flash_mla_prefill``: KV 1,
# G = H, hd = r + pr, hdv = r) is a kernel of its own here,
# ``csrc/mla_prefill.cu``: all H heads share one latent stream, so its CTA
# puts 4 tokens x 16 heads on the MMA rows and reads each key tile (latent
# and rope part) once for both products. Contract:
#
#   q_eff     [B, S, H, r]   absorbed queries (f32 on the card)
#   q_rot     [B, S, H, prl] post-RoPE query part, zero-padded to prl
#   keys      dense: c [B, T, r], k_rot [B, T, pr]; paged: the layer's
#             latent [slots, r] and rope [slots, pr] pages (bf16, f32, or
#             int8 with the c/r scales of mla_paged_decode) read through
#             block_tables [B, W]
#   pos_base  [B] int32      position of row b's token 0
#   kv_lens   [B] int32
#   → out     [B, S, H, r] f32
#
# Token s sees key t when t <= pos_base[b] + s and t < kv_lens[b]; scores
# (q_eff·c + q_rot·k_rot)·scale over the first prl rope columns (q_rot's
# width: the engine's pad past the rope dimension need not be read; the
# kernel takes a multiple of 64 up to pr), value c; a token that sees no
# key gets zeros (ROADMAP C1). The output is f32 because every caller continues in
# f32 (the JAX package casts the kernel's output to f32 at once).


def flash_mla_prefill_ref(q_eff, q_rot, c, k_rot, pos_base, kv_lens, *,
                          scale: float):
    """Plain PyTorch version of the dense entry: masked softmax in f32, one
    batch row at a time (scores [H, S, T])."""
    B, S, H, r = q_eff.shape
    T = c.shape[1]
    dev = q_eff.device
    keys = torch.arange(T, device=dev)
    out = torch.empty((B, S, H, r), dtype=torch.float32, device=dev)
    for b in range(B):
        qpos = pos_base[b].long() + torch.arange(S, device=dev)
        live = keys < kv_lens[b].long()
        mask = (keys[None, :] <= qpos[:, None]) & live[None, :]  # [S, T]
        cb = c[b].float()
        s = (torch.einsum("shr,tr->hst", q_eff[b].float(), cb)
             + torch.einsum("shd,td->hst", q_rot[b].float(),
                            k_rot[b, :, :q_rot.shape[-1]].float())) * scale
        s = s.masked_fill(~mask, _NEG)
        e = torch.exp(s - s.amax(-1, keepdim=True)) * mask
        p = e / e.sum(-1, keepdim=True).clamp_min(1e-30)
        # keys past kv_len may hold anything (the null block): keep them
        # out of P·V
        out[b] = torch.einsum("hst,tr->shr", p,
                              cb.masked_fill(~live[:, None], 0.0))
    return out


def flash_mla_prefill_paged_ref(q_eff, q_rot, latent, rope, block_tables,
                                pos_base, kv_lens, *, block_size: int,
                                scale: float, c_scales=None, r_scales=None,
                                scale_slot_base: int = 0):
    """Plain PyTorch version of the paged entry: every row's table width
    gathered (int8 pages dequantized in f32), then
    :func:`flash_mla_prefill_ref`."""
    B, W = block_tables.shape
    slot_idx = (block_tables.long()[:, :, None] * block_size
                + torch.arange(block_size, device=q_eff.device)).reshape(
                    B, W * block_size)
    c, kr = gather_latent(latent, rope, slot_idx, c_scales, r_scales,
                          scale_slot_base)
    return flash_mla_prefill_ref(q_eff, q_rot, c, kr, pos_base, kv_lens,
                                 scale=scale)


def _mla_kernel():
    """The MLA prefill launch of its kernel library, typed: left
    undeclared, ctypes would pass each pointer as a 32-bit int and cut it."""
    fn = _build.load("mla_prefill").dtt_mla_prefill
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_mla_prefill_paged(q_eff, q_rot, latent, rope, block_tables,
                            pos_base, kv_lens, *, block_size: int,
                            scale: float, c_scales=None, r_scales=None,
                            scale_slot_base: int = 0):
    """MLA flash prefill over a layer's pages (see the contract above), the
    entry the engine's chunk grid and dense forward call. CUDA tensors
    launch the Hopper kernel on the current stream; CPU tensors take
    :func:`flash_mla_prefill_paged_ref`."""
    if q_eff.device.type == "cpu":
        return flash_mla_prefill_paged_ref(
            q_eff, q_rot, latent, rope, block_tables, pos_base, kv_lens,
            block_size=block_size, scale=scale, c_scales=c_scales,
            r_scales=r_scales, scale_slot_base=scale_slot_base)
    if q_eff.device.type != "cuda":
        raise ValueError(f"no MLA prefill kernel for {q_eff.device}")
    check_pages(q_eff, q_rot, latent, rope, c_scales, r_scales,
                scale_slot_base, block_tables, kv_lens)
    if q_eff.dim() != 4:
        raise ValueError("q_eff/q_rot must be [B, S, H, r]/[B, S, H, prl]")
    B, S, H, r = q_eff.shape
    if (pos_base.dtype != torch.int32 or tuple(pos_base.shape) != (B,)
            or pos_base.device != q_eff.device
            or not pos_base.is_contiguous()):
        raise ValueError("pos_base must be a contiguous int32 [B] on q's "
                         "device")
    out = torch.empty((B, S, H, r), dtype=torch.float32, device=q_eff.device)
    if B == 0 or S == 0:
        return out
    err = _mla_kernel()(
        q_eff.data_ptr(), q_rot.data_ptr(), latent.data_ptr(),
        rope.data_ptr(),
        c_scales.data_ptr() if c_scales is not None else None,
        r_scales.data_ptr() if r_scales is not None else None,
        int(scale_slot_base), block_tables.data_ptr(), pos_base.data_ptr(),
        kv_lens.data_ptr(), out.data_ptr(), B, S, H, r, rope.shape[1],
        q_rot.shape[3],
        block_tables.shape[1], block_size, float(scale),
        PAGE_KINDS[latent.dtype],
        torch.cuda.current_stream(q_eff.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"MLA prefill kernel launch failed (code {err})")
    flash_mla_prefill_paged.launches += 1
    return out


#: kernel launches since the count was last set to 0 (both entries)
flash_mla_prefill_paged.launches = 0


def flash_mla_prefill(q_eff, q_rot, c, k_rot, pos_base, kv_lens, *,
                      scale: float):
    """MLA flash prefill over dense keys, the JAX ``flash_mla_prefill``
    contract: q_eff [B,S,H,r], q_rot [B,S,H,pr], c [B,T,r], k_rot [B,T,pr]
    → [B,S,H,r] f32 (q_rot [B,S,H,prl], prl <= pr). CPU tensors take
    :func:`flash_mla_prefill_ref`. On the card the dense keys are a paged
    cache of one T-slot page a row (table [[0], [1], ...], block size T),
    so :func:`flash_mla_prefill_paged` launches the kernel on them without
    a copy; queries of another float type become f32 first."""
    if q_eff.device.type == "cpu":
        return flash_mla_prefill_ref(q_eff, q_rot, c, k_rot, pos_base,
                                     kv_lens, scale=scale)
    B, T = c.shape[:2]
    table = torch.arange(B, dtype=torch.int32,
                         device=q_eff.device)[:, None]
    return flash_mla_prefill_paged(
        q_eff.float().contiguous(), q_rot.float().contiguous(),
        c.reshape(B * T, -1).contiguous(),
        k_rot.reshape(B * T, -1).contiguous(), table, pos_base,
        kv_lens, block_size=T, scale=scale)
