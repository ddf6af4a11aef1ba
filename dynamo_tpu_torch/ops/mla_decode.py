"""MLA decode in latent space over the paged latent cache.

Port of ``dynamo_tpu/ops/paged_attention.py``'s Pallas kernel
``_mla_decode_kernel`` (wrapper ``mla_paged_decode``), with its int8
branch. Contract, per layer:

  q_eff         [B, H, R] f32    queries absorbed through W_UK
  q_rot         [B, H, PRL] f32  post-RoPE query part, zero-padded to PRL
  latent_cache  [slots, R]       normalised latent c per slot (bf16, f32 or
                                 int8)
  rope_cache    [slots, PR]      post-RoPE k_rot per slot, zero-padded;
                                 only its first PRL columns (q_rot's
                                 width, PRL <= PR) enter the scores
  block_tables  [B, W] int32     per row (block 0 is the null block)
  kv_lens       [B] int32        keys of each row
  scale         float            softmax scale of the scores
  c_scales,     [sc_slots] or    int8 pages only: f32 scales of each
  r_scales      [sc_slots, 1]    stream, slot s at s - scale_slot_base
  → out         [B, H, R] f32    softmax(scale·(q_eff·c + q_rot·k_rot))·c

Every key below kv_len is visible; a row with kv_len 0 gets zeros. The
caller expands the output through W_UV. With int8 pages the two score
parts dequantize apart (c·c_scale, k_rot·r_scale) and the value is
c·c_scale.

:func:`mla_paged_decode` launches the hand-written Hopper kernel
(``csrc/mla_decode.cu`` over ``csrc/mla_core.cuh``) for CUDA tensors and
uses the plain version :func:`mla_paged_decode_ref` only for tensors that
lie on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from dynamo_tpu_torch.ops import _build

_NEG = -1e30
#: heads one CTA holds (16 of the MMA's rows); H must be a multiple of it
HEAD_TILE = 16
#: largest latent rank and rope width the kernel takes (multiples of 64)
MAX_RANK = 512
MAX_ROPE = 256
#: bf16 and int8 pages: the kernel rounds q and P (int8: p·c_scale) to
#: fp16 for the tensor cores where the plain version keeps both in f32.
#: Each row's output agrees with the plain version's within this share of
#: the row's largest magnitude: the output is a softmax-weighted mean of
#: latents, whose scale falls as the row grows, so one absolute limit
#: cannot serve short and long rows
BF16_ROW_RTOL = 1e-2
#: the C entry points' page kinds
PAGE_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def geometry_error(H: int, R: int, PR: int, PRL=None):
    """Why the MLA kernels (decode and prefill) cannot take H heads, latent
    rank R, rope page width PR and q_rot width PRL (None: PR), or None."""
    if H % HEAD_TILE:
        return f"H {H} is not a multiple of {HEAD_TILE}"
    for name, v, top in (("R", R, MAX_RANK), ("PR", PR, MAX_ROPE),
                         ("q_rot width", PR if PRL is None else PRL, PR)):
        if v % 64 or not 64 <= v <= top:
            return f"{name} {v} is not a multiple of 64 in [64, {top}]"
    return None


def gather_latent(latent_cache, rope_cache, slot_idx, c_scales=None,
                  r_scales=None, scale_slot_base: int = 0):
    """(c [*, R], k_rot [*, PR]) f32 at the flat ``slot_idx``; int8 pages
    dequantize in f32 with their stream's scale, as the JAX package's
    ``gather_pages`` does."""
    c = latent_cache[slot_idx].float()
    kr = rope_cache[slot_idx].float()
    if c_scales is not None:
        sidx = slot_idx - scale_slot_base
        c = c * c_scales.reshape(-1)[sidx].float()[..., None]
        kr = kr * r_scales.reshape(-1)[sidx].float()[..., None]
    return c, kr


def mla_paged_decode_ref(q_eff, q_rot, latent_cache, rope_cache,
                         block_tables, kv_lens, *, block_size: int,
                         scale: float, c_scales=None, r_scales=None,
                         scale_slot_base: int = 0):
    """Plain PyTorch version: a dense gather of every row's table width
    (int8 pages dequantized in f32), masked softmax in f32."""
    B, H, R = q_eff.shape
    W = block_tables.shape[1]
    T = W * block_size
    dev = q_eff.device
    slot_idx = (block_tables.long()[:, :, None] * block_size
                + torch.arange(block_size, device=dev)).reshape(B, T)
    c, kr = gather_latent(latent_cache, rope_cache, slot_idx, c_scales,
                          r_scales, scale_slot_base)  # [B, T, R], [B, T, PR]
    s = (torch.einsum("bhr,btr->bht", q_eff.float() * scale, c)
         + torch.einsum("bhd,btd->bht", q_rot.float() * scale,
                        kr[..., :q_rot.shape[-1]]))
    mask = (torch.arange(T, device=dev)[None, :]
            < kv_lens.long()[:, None])[:, None, :]  # [B, 1, T]
    s = s.masked_fill(~mask, _NEG)
    e = torch.exp(s - s.amax(-1, keepdim=True)) * mask
    p = e / e.sum(-1, keepdim=True).clamp_min(1e-30)
    # slots past kv_len may hold anything: keep them out of P·V, as the
    # kernel never loads them
    c = c.masked_fill(~mask[:, 0, :, None], 0.0)
    return torch.einsum("bht,btr->bhr", p, c).to(q_eff.dtype)


def _kernel():
    """(launch, scratch-size query) of the kernel library, typed: left
    undeclared, ctypes would pass each pointer as a 32-bit int and cut it."""
    lib = _build.load("mla_decode")
    fn = lib.dtt_mla_paged_decode
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    size = lib.dtt_mla_decode_scratch_floats
    size.argtypes = [ctypes.c_int] * 5
    size.restype = ctypes.c_longlong
    return fn, size


def check_pages(q_eff, q_rot, latent_cache, rope_cache, c_scales, r_scales,
                scale_slot_base: int, block_tables, kv_lens) -> None:
    """Raise for operands the MLA kernels do not take: q_eff/q_rot f32
    [..., H, R]/[..., H, PRL] on one device with contiguous pages of one
    dtype (bf16, f32, or int8 with both streams' scales), int32 tables
    [B, W] and kv_lens [B]."""
    dev = q_eff.device
    named = [("q_eff", q_eff), ("q_rot", q_rot),
             ("latent_cache", latent_cache), ("rope_cache", rope_cache),
             ("block_tables", block_tables), ("kv_lens", kv_lens),
             ("c_scales", c_scales), ("r_scales", r_scales)]
    for name, t in named:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q_eff on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q_eff.dtype != torch.float32 or q_rot.dtype != torch.float32:
        raise ValueError("q_eff and q_rot must be f32")
    if (latent_cache.dtype not in PAGE_KINDS
            or rope_cache.dtype != latent_cache.dtype):
        raise ValueError("latent and rope caches must both be bf16, f32 or "
                         "int8")
    quant = latent_cache.dtype == torch.int8
    if quant != (c_scales is not None) or quant != (r_scales is not None):
        raise ValueError("int8 pages need c_scales and r_scales, and only "
                         "int8 pages take them")
    if quant:
        if c_scales.dtype != torch.float32 or r_scales.dtype != torch.float32:
            raise ValueError("c_scales and r_scales must be f32")
        n = latent_cache.shape[0] - scale_slot_base
        if (scale_slot_base < 0 or c_scales.numel() < n
                or r_scales.numel() < n):
            raise ValueError(f"the scale tables must cover slots "
                             f"{scale_slot_base} .. {latent_cache.shape[0]}")
    if latent_cache.dim() != 2 or rope_cache.dim() != 2:
        raise ValueError("the caches must be [slots, R] and [slots, PR]")
    H, R = q_eff.shape[-2:]
    PR = rope_cache.shape[1]
    if (q_rot.shape[:-1] != q_eff.shape[:-1] or latent_cache.shape[1] != R
            or rope_cache.shape[0] != latent_cache.shape[0]):
        raise ValueError("q and cache shapes disagree")
    why = geometry_error(H, R, PR, q_rot.shape[-1])
    if why:
        raise ValueError(f"MLA kernel geometry: {why}")
    if block_tables.dtype != torch.int32 or kv_lens.dtype != torch.int32:
        raise ValueError("block_tables and kv_lens must be int32")
    B = q_eff.shape[0]
    if (block_tables.dim() != 2 or block_tables.shape[0] != B
            or tuple(kv_lens.shape) != (B,)):
        raise ValueError("block_tables must be [B, W] and kv_lens [B]")


def mla_paged_decode(q_eff, q_rot, latent_cache, rope_cache, block_tables,
                     kv_lens, *, block_size: int, scale: float,
                     c_scales=None, r_scales=None, scale_slot_base: int = 0):
    """MLA latent decode (see the module docstring for the contract). CUDA
    tensors launch the Hopper kernel on the current stream; CPU tensors take
    :func:`mla_paged_decode_ref`."""
    if q_eff.device.type == "cpu":
        return mla_paged_decode_ref(
            q_eff, q_rot, latent_cache, rope_cache, block_tables, kv_lens,
            block_size=block_size, scale=scale, c_scales=c_scales,
            r_scales=r_scales, scale_slot_base=scale_slot_base)
    if q_eff.device.type != "cuda":
        raise ValueError(f"no MLA decode kernel for {q_eff.device}")
    check_pages(q_eff, q_rot, latent_cache, rope_cache, c_scales, r_scales,
                scale_slot_base, block_tables, kv_lens)
    if q_eff.dim() != 3:
        raise ValueError("q_eff/q_rot must be [B, H, R]/[B, H, PRL]")
    B, H, R = q_eff.shape
    W = block_tables.shape[1]
    out = torch.empty((B, H, R), dtype=torch.float32, device=q_eff.device)
    if B == 0:
        return out
    launch, scratch_floats = _kernel()
    # split-K partials of rows whose keys span several chunks
    n = scratch_floats(B, H, R, W, block_size)
    scratch = (torch.empty(n, dtype=torch.float32, device=q_eff.device)
               if n else None)
    err = launch(
        q_eff.data_ptr(), q_rot.data_ptr(), latent_cache.data_ptr(),
        rope_cache.data_ptr(),
        c_scales.data_ptr() if c_scales is not None else None,
        r_scales.data_ptr() if r_scales is not None else None,
        int(scale_slot_base), block_tables.data_ptr(), kv_lens.data_ptr(),
        out.data_ptr(), scratch.data_ptr() if scratch is not None else None,
        B, H, R, rope_cache.shape[1], q_rot.shape[2], W, block_size,
        float(scale),
        PAGE_KINDS[latent_cache.dtype],
        torch.cuda.current_stream(q_eff.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"MLA decode kernel launch failed (code {err})")
    mla_paged_decode.launches += 1
    return out


#: kernel launches since the count was last set to 0
mla_paged_decode.launches = 0
