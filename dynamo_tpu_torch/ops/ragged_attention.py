"""Ragged paged attention: mixed prefill + decode rows in one launch.

Port of ``dynamo_tpu/ops/ragged_attention.py`` (the Pallas kernel
``_ragged_kernel``: bf16/f32 pages and its int8 branch). Contract, per
layer:

  q            [T, H, hd]       packed queries; row r's tokens are
                                q_start .. q_start+q_len-1, token j of the
                                row at position kv_len - q_len + j
  k/v cache    [slots, KV, hd]  flat paged layout (slot = block*bs + off),
                                e.g. one layer's view of [L, slots, KV, hd];
                                the q dtype, or int8 with scales
  k/v scales   [sc_slots, KV]   f32, int8 pages only: slot s dequantizes
                                with scales[s - scale_slot_base]
  block_tables [R, W] int32     per row (block 0 = the null block)
  rows3        [R, 3] int32     (q_start, q_len, kv_len); q_len 0 = padding
  window       int              0 = full attention, else keys > pos - window
  sinks        [H] or None      per-head sink logits (f32 on the card; a
                                caller converts them once, not per launch)
  softcap      float            0 = off; else each scaled score s becomes
                                softcap·tanh(s/softcap) before the mask
                                (Gemma-2's attention logit softcap)
  → out        [T, H, hd]

Causal and below kv_len, scale 1/sqrt(hd), f32 accumulation, hd in
``HEAD_DIMS``. The output of tokens outside every row (the packed batch's
padding) is unspecified.

:func:`ragged_paged_attention` launches the hand-written Hopper kernel
(``csrc/ragged_attention.cu``) for CUDA tensors and uses the plain version
:func:`ragged_attention_ref` only for tensors that lie on the CPU.
"""

from __future__ import annotations

import ctypes
import math

import torch

from dynamo_tpu_torch.ops import _build

_NEG = -1e30
#: largest GQA group (H / KV) one CTA holds; see the kernel source
MAX_GROUP = 64
HEAD_DIMS = (64, 128, 256)


def ragged_attention_ref(q, k_cache, v_cache, block_tables, rows3, *,
                         block_size: int, window: int = 0, sinks=None,
                         k_scales=None, v_scales=None,
                         scale_slot_base: int = 0, softcap: float = 0.0):
    """Plain PyTorch version: a dense gather of each row's keys with the
    masking of the JAX package's ``ragged_attention_xla``; int8 pages
    dequantize in the gather. Tokens outside every row come back as zeros.
    Reads ``rows3`` on the host."""
    T, H, hd = q.shape
    KV = k_cache.shape[1]
    G = H // KV
    bs = block_size
    out = torch.zeros_like(q)
    dev = q.device
    for r, (q_start, q_len, kv_len) in enumerate(rows3.tolist()):
        if q_len == 0 or kv_len == 0:  # no key: zeros, as the kernel writes
            continue
        keys = torch.arange(kv_len, device=dev)
        pos = torch.arange(kv_len - q_len, kv_len, device=dev)
        slots = block_tables[r, keys // bs].long() * bs + keys % bs
        k = k_cache[slots].float()  # [S, KV, hd]
        v = v_cache[slots].float()
        if k_scales is not None:
            sidx = slots - scale_slot_base
            k = k * k_scales[sidx].float()[..., None]
            v = v * v_scales[sidx].float()[..., None]
        qg = q[q_start:q_start + q_len].float().reshape(q_len, KV, G, hd)
        s = torch.einsum("tkgd,skd->tkgs", qg, k) / math.sqrt(hd)
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        mask = keys[None, :] <= pos[:, None]
        if window and window > 0:
            mask &= keys[None, :] > pos[:, None] - window
        s = s.masked_fill(~mask[:, None, None, :], _NEG)
        if sinks is not None:
            sk = sinks.float().reshape(KV, G)[None, :, :, None]
            m = torch.maximum(s.amax(-1, keepdim=True), sk)
            e = torch.exp(s - m)
            p = e / (e.sum(-1, keepdim=True) + torch.exp(sk - m))
        else:
            p = torch.softmax(s, dim=-1)
        o = torch.einsum("tkgs,skd->tkgd", p, v)
        out[q_start:q_start + q_len] = o.reshape(q_len, H, hd).to(q.dtype)
    return out


def _kernel():
    """(launch, scratch-size query) of the kernel library, typed: left
    undeclared, ctypes would pass each pointer as a 32-bit int and cut it."""
    lib = _build.load("ragged_attention")
    fn = lib.dtt_ragged_paged_attention
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_float] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    size = lib.dtt_ragged_scratch_floats
    size.argtypes = [ctypes.c_int] * 7
    size.restype = ctypes.c_longlong
    return fn, size


def _check(q, k_cache, v_cache, block_tables, rows3, sinks, window,
           k_scales, v_scales, softcap: float = 0.0) -> None:
    dev = q.device
    named = [("k_cache", k_cache), ("v_cache", v_cache),
             ("block_tables", block_tables), ("rows3", rows3),
             ("sinks", sinks), ("k_scales", k_scales),
             ("v_scales", v_scales)]
    for name, t in named:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q dtype {q.dtype}: the kernel takes bf16 or f32")
    if k_cache.dtype == torch.int8:
        if (v_cache.dtype != torch.int8 or k_scales is None
                or v_scales is None):
            raise ValueError("int8 k/v caches need both k_scales and "
                             "v_scales")
        if (k_scales.dtype != torch.float32 or v_scales.dtype != torch.float32
                or k_scales.dim() != 2 or k_scales.shape != v_scales.shape
                or k_scales.shape[1] != k_cache.shape[1]):
            raise ValueError("k/v scales must be f32 [sc_slots, KV]")
    elif k_scales is not None or v_scales is not None:
        raise ValueError("scales are for int8 caches only")
    elif k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError("k/v cache dtype must equal q's, or be int8")
    if q.dim() != 3 or k_cache.dim() != 3 or k_cache.shape != v_cache.shape:
        raise ValueError("q must be [T, H, hd] and k/v cache [slots, KV, hd]")
    T, H, hd = q.shape
    KV = k_cache.shape[1]
    if k_cache.shape[2] != hd:
        raise ValueError("q and cache head_dim differ")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if H % KV or H // KV > MAX_GROUP:
        raise ValueError(f"H={H}, KV={KV}: need H % KV == 0 and "
                         f"H / KV <= {MAX_GROUP}")
    if block_tables.dtype != torch.int32 or rows3.dtype != torch.int32:
        raise ValueError("block_tables and rows3 must be int32")
    if (block_tables.dim() != 2 or rows3.dim() != 2 or rows3.shape[1] != 3
            or rows3.shape[0] != block_tables.shape[0]):
        raise ValueError("block_tables must be [R, W] and rows3 [R, 3]")
    if sinks is not None and tuple(sinks.shape) != (H,):
        raise ValueError(f"sinks must be [H={H}]")
    if not isinstance(window, int) or window < 0:
        raise ValueError("window must be an int >= 0")
    if not softcap >= 0.0:
        raise ValueError("softcap must be >= 0 (0 = off)")


def ragged_paged_attention(q, k_cache, v_cache, block_tables, rows3, *,
                           block_size: int, window: int = 0, sinks=None,
                           k_scales=None, v_scales=None,
                           scale_slot_base: int = 0, softcap: float = 0.0):
    """Ragged paged attention (see the module docstring for the contract).
    CUDA tensors launch the Hopper kernel on the current stream; CPU
    tensors take :func:`ragged_attention_ref`."""
    if q.device.type == "cpu":
        return ragged_attention_ref(
            q, k_cache, v_cache, block_tables, rows3, block_size=block_size,
            window=window, sinks=sinks, k_scales=k_scales, v_scales=v_scales,
            scale_slot_base=scale_slot_base, softcap=softcap)
    return launch_ragged(q, k_cache, v_cache, block_tables, rows3,
                         block_size=block_size, window=window, sinks=sinks,
                         k_scales=k_scales, v_scales=v_scales,
                         scale_slot_base=scale_slot_base, softcap=softcap,
                         counter=ragged_paged_attention)


def launch_ragged(q, k_cache, v_cache, block_tables, rows3, *,
                  block_size: int, window: int, sinks, k_scales, v_scales,
                  scale_slot_base: int, softcap: float, counter):
    """Check the CUDA operands and launch the ragged kernel, adding one to
    ``counter.launches`` (the calling wrapper's count: this module's, or
    ``paged_attention_decode``'s) when it launches."""
    if q.device.type != "cuda":
        raise ValueError(f"no ragged attention kernel for {q.device}")
    _check(q, k_cache, v_cache, block_tables, rows3, sinks, window,
           k_scales, v_scales, softcap)
    T, H, hd = q.shape
    R, W = block_tables.shape
    out = torch.empty_like(q)
    if T == 0 or R == 0:
        return out
    if sinks is not None:
        sinks = sinks.to(torch.float32).contiguous()
    launch, scratch_floats = _kernel()
    KV = k_cache.shape[1]
    # split-K partials of tiles whose keys span several chunks
    n = scratch_floats(T, H, KV, hd, R, W, block_size)
    scratch = (torch.empty(n, dtype=torch.float32, device=q.device)
               if n else None)
    quant = k_cache.dtype == torch.int8
    err = launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scales.data_ptr() if quant else None,
        v_scales.data_ptr() if quant else None, int(scale_slot_base),
        block_tables.data_ptr(), rows3.data_ptr(),
        sinks.data_ptr() if sinks is not None else None, out.data_ptr(),
        scratch.data_ptr() if scratch is not None else None,
        T, H, KV, hd, R, W, block_size, window, float(softcap),
        int(q.dtype == torch.bfloat16), int(quant),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ragged attention kernel launch failed (code "
                           f"{err})")
    counter.launches += 1
    return out


#: kernel launches since the count was last set to 0, both page dtypes
ragged_paged_attention.launches = 0
