"""The dequant-GEMM: ``x @ W`` with ``W`` a quantized weight ``{"q", "s"[,
"z"]}`` (``engine/quant.py``'s layout), read quantized from device memory.

No TPU kernel stands behind it: the JAX package leaves the product to XLA,
which fuses ``materialize``'s dequant chain into the dot's operand read
(``dynamo_tpu/engine/quant.py:14-17``). PyTorch's eager ops would build a
bf16 copy of the weight on every call, so :func:`quant_matmul` launches a
hand kernel for Hopper (``csrc/qmm.cu``) on CUDA tensors, and takes
:func:`quant_matmul_ref`, the JAX formula in torch, for CPU tensors.

Forms (the shapes the forward uses):

- 2-D weight: ``x [..., I]`` @ ``q [I, O]`` → ``[..., O]``, the JAX
  ``qmm``: per-channel scales without a zero point scale the product's
  output, every other format multiplies by the materialized weight;
- a leading batch dim on ``q``/``s``/``z`` (a MoE expert stack ``[E, I,
  O]``): ``x [M, I]`` shared by every expert, or ``x [E, M, I]``, →
  ``[E, M, O]`` (``torch.matmul``'s broadcast), through the materialized
  weight at every format, as the JAX package's expert einsums.

The kernel takes bf16 ``x`` (contiguous; the wrapper makes it so),
``I % 16 == 0``, ``O % 8 == 0`` and groups that divide ``I``, and raises
for anything else. At decode widths it splits the contraction over more
CTAs (as many whole waves of the card's resident CTAs as finish soonest)
and adds the splits in a second kernel, in a fixed order, through an f32
workspace of :func:`workspace_bytes` that the wrapper allocates.

Tolerances of the kernel against the plain version in bf16, each of a
row's largest |value| (``ROW_RTOL``): grouped scales or a zero point 1e-2
(both round the same f32 products to bf16 once; they differ in summation
order, which moves a rounding by at most one bf16 step, 2^-7 of a value);
per-channel 2e-2 (the plain version rounds ``x @ q`` to bf16 before its
f32 scale and rounds again after it; the kernel scales the f32 sum and
rounds once: three half-steps apart at most, 1.2e-2).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from dynamo_tpu_torch.engine.quant import is_qtensor, materialize, qmm
from dynamo_tpu_torch.ops import _build

#: the kernel's output tile width and contraction step (csrc/qmm.cu)
BN, BK = 128, 64
#: kernel against plain version, bf16, of each row's largest |value|:
#: grouped or with a zero point / per-channel (see the module docstring)
ROW_RTOL = {"grouped": 1e-2, "per_channel": 2e-2}


def quant_matmul_ref(x, w):
    """Plain PyTorch version of the dequant-GEMM, the JAX formulas: a 2-D
    weight through ``qmm``, a batched (expert) stack through
    ``torch.matmul`` with the materialized weight."""
    if w["q"].dim() == 2:
        return qmm(x, w)
    return torch.matmul(x, materialize(w, x.dtype))


def _per_channel(w) -> bool:
    """The kernel scales the output (per-channel, 2-D, no zero point)."""
    return w["q"].dim() == 2 and w["s"].shape[-2] == 1 and "z" not in w


def geometry_error(I: int, O: int, G: int) -> Optional[str]:
    """Why the kernel cannot take a weight of contraction dim ``I``, ``O``
    columns and ``G`` groups, or None."""
    if I % 16 or O % 8:
        return f"I % 16 == 0 and O % 8 == 0 (got I {I}, O {O})"
    if G <= 0 or I % G:
        return f"a group count dividing I (got I {I}, G {G})"
    return None


@functools.lru_cache(maxsize=None)
def _slots(index: int, M_tile: int, z: bool) -> int:
    """CTAs the card runs at once: SMs times the kernel's resident CTAs an
    SM for the row tile of ``M_tile`` rows."""
    fn = _build.load("qmm").qmm_resident
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    n = fn(M_tile, int(z))
    if n <= 0:
        raise RuntimeError(f"quant_matmul: occupancy query failed ({n})")
    return torch.cuda.get_device_properties(index).multi_processor_count * n


def _row_tile(M: int) -> int:
    return 16 if M <= 16 else (64 if M <= 64 else 128)  # csrc/qmm.cu's


def splits_for(M: int, I: int, O: int, batch: int, slots: int) -> tuple:
    """(splits, k-steps a split) of the contraction: when the output tiles
    fill less than one wave of the ``slots`` CTAs the card runs at once,
    as many splits as still fit in that wave (each at least two 64-row
    steps), so the weight read spreads over every SM in one wave; else
    none."""
    base = -(-O // BN) * -(-M // _row_tile(M)) * batch
    nk = -(-I // BK)
    splits = max(1, min(slots // base, nk // 2))
    kps = -(-nk // splits)
    return -(-nk // kps), kps


def workspace_bytes(M: int, I: int, O: int, batch: int = 1,
                    slots: int = 4 * 132) -> int:
    """Bytes of the f32 workspace one call allocates (0 without a split):
    each split's partial sums of the [batch, M, O] output. ``slots``: the
    CTAs the card runs at once (:func:`resident_slots`)."""
    splits, _ = splits_for(M, I, O, batch, slots)
    return 0 if splits == 1 else 4 * splits * batch * M * O


def resident_slots(M: int, z: bool = False, device=None) -> int:
    """The CTAs the card runs at once for M rows (built on first use)."""
    dev = torch.device(device if device is not None else "cuda")
    return _slots(dev.index if dev.index is not None
                  else torch.cuda.current_device(), _row_tile(M), z)


def quant_matmul(x, w):
    """``x @ W`` for a quantized weight ``w`` (see the module docstring).
    CUDA tensors launch the kernel on the current stream; CPU tensors take
    :func:`quant_matmul_ref`."""
    if not is_qtensor(w):
        raise ValueError("quant_matmul takes a quantized weight "
                         "{'q', 's'[, 'z']}")
    if x.device.type == "cpu":
        return quant_matmul_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"no quant_matmul kernel for {x.device}")
    q, s, z = w["q"], w["s"], w.get("z")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the dequant-GEMM takes bf16 x, got {x.dtype}")
    if q.dtype not in (torch.int8, torch.uint8):
        raise ValueError(f"q must be int8 or packed int4 uint8, got "
                         f"{q.dtype}")
    int4 = q.dtype == torch.uint8
    batched = q.dim() == 3
    if q.dim() not in (2, 3) or s.dim() != q.dim() or s.dtype != torch.float32:
        raise ValueError("q [(E,) I, O] with f32 s [(E,) G, O]")
    E = q.shape[0] if batched else 1
    I = q.shape[-2] * (2 if int4 else 1)
    O, G = q.shape[-1], s.shape[-2]
    why = geometry_error(I, O, G)
    if why:
        raise ValueError(f"the dequant-GEMM needs {why}")
    if s.shape[-1] != O or (batched and s.shape[0] != E):
        raise ValueError(f"s shape {tuple(s.shape)} for q {tuple(q.shape)}")
    if z is not None and (z.shape != s.shape or z.dtype != torch.float32):
        raise ValueError("z must be f32 shaped like s")
    if x.shape[-1] != I:
        raise ValueError(f"x [..., {x.shape[-1]}] against I {I}")
    if batched:
        if x.dim() not in (2, 3) or (x.dim() == 3 and x.shape[0] != E):
            raise ValueError(f"x {tuple(x.shape)} for an expert stack of "
                             f"{E}")
        x = x.contiguous()
        M = x.shape[-2]
        x_bs = M * I if x.dim() == 3 else 0  # 0: every expert reads one x
        out_shape = (E, M, O)
    else:
        lead = x.shape[:-1]
        x = x.reshape(-1, I).contiguous()
        M, x_bs = x.shape[0], 0
        out_shape = (*lead, O)
    tensors = [q, s] + ([z] if z is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, q, s and z must share a device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("q, s and z must be contiguous")
    out = torch.empty(out_shape, dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return out
    splits, kps = splits_for(M, I, O, E,
                             resident_slots(M, z is not None, x.device))
    ws = (torch.empty((splits * E * M * O,), dtype=torch.float32,
                      device=x.device) if splits > 1 else None)
    err = _kernel()(
        x.data_ptr(), q.data_ptr(), s.data_ptr(),
        z.data_ptr() if z is not None else None, out.data_ptr(),
        ws.data_ptr() if ws is not None else None,
        x_bs, q[0].numel() if batched else 0, G * O if batched else 0,
        M * O, E, M, I, O, G, int(int4), int(not _per_channel(w)), splits,
        kps, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed (code {err})")
    quant_matmul.launches += 1
    return out


#: kernel launches since the count was last set to 0
quant_matmul.launches = 0


def _kernel():
    fn = _build.load("qmm").qmm_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 4
                   + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn
