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
for anything else. It has two bodies (``csrc/qmm.cu``): a decode body for
``M`` up to :data:`DECODE_MAX_M` (the swapped product, the weight
dequantized in registers) and a ``wgmma`` prefill body above it.
:func:`make_plan` is the one place that decides a launch: the body, its
tile, the k-step, the scale window, and the split of the contraction
(when the output tiles fill less than one wave of the card's resident
CTAs, as many splits as fill it; the splits are added in a second kernel,
in a fixed order, through an f32 workspace of :meth:`Plan.workspace_bytes`
that the wrapper allocates). The kernel takes the plan as it is.

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
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from dynamo_tpu_torch.engine.quant import is_qtensor, materialize, qmm
from dynamo_tpu_torch.ops import _build

#: the decode body's row tiles: 1 or 2 n8 tiles of outᵀ = Wᵀ·xᵀ
DECODE_ROWS = (8, 16)
#: M up to which the plan takes the decode body: the crossover measured on
#: the card (``tune_attention.py --crossover``, PERF.md §6)
DECODE_MAX_M = 16
#: the decode body's output columns a CTA (4 warps of 128) and its k-step
#: of contraction rows
DECODE_COLS, DECODE_STEP = 512, 64
#: the prefill body's row tiles (the N of its wgmma m64nNk16), output
#: columns a CTA and k-step
PREFILL_ROWS, PREFILL_COLS, PREFILL_STEP = (64, 128, 256), 128, 64
#: scale rows a k-step's window may hold, by body (beyond: read in place)
MAX_SROWS = {"decode": 4, "prefill": 5}
#: k-steps a split at least
MIN_STEPS = 4
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


def window_rows(step: int, g: int) -> int:
    """The groups of ``g`` rows that a k-step of ``step`` rows, starting at
    a multiple of ``step``, can touch (csrc/qmm.cu's ``window_rows``)."""
    if g % step == 0:
        return 1
    return step // g if step % g == 0 else (step - 1) // g + 2


@dataclass(frozen=True)
class Plan:
    """One launch of the dequant-GEMM: ``body`` "decode" or "prefill", a
    CTA's ``rows`` x ``cols`` output tile, a k-step of ``step`` contraction
    rows, ``srows`` rows of scales in each k-step's window (0: scales read
    in place), and the contraction cut into ``splits`` splits of ``kps``
    k-steps (the last may be shorter, none is empty)."""

    body: str
    rows: int
    cols: int
    step: int
    srows: int
    splits: int
    kps: int

    def workspace_bytes(self, M: int, O: int, batch: int = 1) -> int:
        """Bytes of the f32 workspace of the split's partial sums (0
        without a split)."""
        return 0 if self.splits == 1 else 4 * self.splits * batch * M * O


def make_plan(M: int, I: int, O: int, G: int = 1, *, batch: int = 1,
              int4: bool = False, z: bool = False, dequant: bool = True,
              slots: Optional[int] = None, body: Optional[str] = None,
              device=None) -> Plan:
    """The launch for ``M`` rows of x against a weight of contraction ``I``,
    ``O`` columns and ``G`` groups (``dequant`` False: per-channel scales,
    applied in the epilogue). The decode body up to :data:`DECODE_MAX_M`
    rows, the prefill body above (``body`` forces one, for measurement).
    When the output tiles fill less than one wave of the ``slots`` CTAs
    the card runs at once (default: asked of the card for this body and
    tile), as many splits as still fit in that wave, each at least
    :data:`MIN_STEPS` k-steps."""
    if body is None:
        body = "decode" if M <= DECODE_MAX_M else "prefill"
    if body == "decode":
        if M > DECODE_ROWS[-1]:
            raise ValueError(f"the decode body takes M <= {DECODE_ROWS[-1]}, "
                             f"got {M}")
        rows = next(r for r in DECODE_ROWS if r >= M)
        cols, step = DECODE_COLS, DECODE_STEP
    elif body == "prefill":
        rows = next((r for r in PREFILL_ROWS if r >= M), PREFILL_ROWS[-1])
        cols, step = PREFILL_COLS, PREFILL_STEP
    else:
        raise ValueError(f"no dequant-GEMM body {body!r}")
    g = I // G
    srows = 0
    if dequant:
        need = window_rows(step, g)
        srows = need if need <= MAX_SROWS[body] else 0
    if slots is None:
        slots = resident_slots(body, rows, cols, step, int4, z, srows,
                               dequant, g, device)
    tiles = -(-O // cols) * -(-M // rows) * batch
    nk = -(-I // step)
    splits = 1
    if tiles < slots:
        splits = max(1, min(slots // tiles, nk // MIN_STEPS))
    kps = -(-nk // splits)
    return Plan(body, rows, cols, step, srows, -(-nk // kps), kps)


def workspace_bytes(M: int, I: int, O: int, G: int = 1, batch: int = 1,
                    int4: bool = False, z: bool = False, dequant: bool = True,
                    slots: Optional[int] = None, device=None) -> int:
    """Bytes of the f32 workspace one call allocates (0 without a split):
    :func:`make_plan`'s, for these shapes and this format."""
    return make_plan(M, I, O, G, batch=batch, int4=int4, z=z,
                     dequant=dequant, slots=slots,
                     device=device).workspace_bytes(M, O, batch)


@functools.lru_cache(maxsize=None)
def _slots(index: int, key: tuple) -> int:
    fn = _build.load("qmm").qmm_resident
    fn.argtypes = [ctypes.c_int] * 9
    fn.restype = ctypes.c_int
    n = fn(*key)
    if n <= 0:
        raise RuntimeError(f"quant_matmul: occupancy query failed ({n})")
    return torch.cuda.get_device_properties(index).multi_processor_count * n


def resident_slots(body: str, rows: int, cols: int, step: int, int4: bool,
                   z: bool, srows: int, dequant: bool, g: int,
                   device=None) -> int:
    """The CTAs of a plan's kernel that the card runs at once: SMs times
    the CTAs an SM holds (the library is built on first use)."""
    dev = torch.device(device if device is not None else "cuda")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return _slots(index, ({"decode": 0, "prefill": 1}[body], rows, cols,
                          step, int(int4), int(z), srows, int(dequant), g))


class Call(NamedTuple):
    """What one launch takes: the plan, the output and the workspace (None
    without a split) allocated on x's device, and the kernel's arguments
    before the stream."""

    plan: Plan
    out: torch.Tensor
    ws: Optional[torch.Tensor]
    args: tuple


def prepare_call(x, w, *, body: Optional[str] = None,
                 slots: Optional[int] = None) -> Call:
    """Check ``x`` and ``w`` against the kernel's contract, plan the
    launch and allocate its output and workspace on x's device (any
    device: the CPU tests read the plan and the allocations)."""
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
    dequant = not _per_channel(w)
    plan = make_plan(max(M, 1), I, O, G, batch=E, int4=int4,
                     z=z is not None, dequant=dequant, slots=slots,
                     body=body, device=x.device)
    out = torch.empty(out_shape, dtype=torch.bfloat16, device=x.device)
    nws = plan.workspace_bytes(M, O, E) // 4
    ws = (torch.empty((nws,), dtype=torch.float32, device=x.device)
          if nws else None)
    args = (x.data_ptr(), q.data_ptr(), s.data_ptr(),
            z.data_ptr() if z is not None else None, out.data_ptr(),
            ws.data_ptr() if ws is not None else None,
            x_bs, q[0].numel() if batched else 0, G * O if batched else 0,
            M * O, E, M, I, O, G, int(int4), int(dequant),
            {"decode": 0, "prefill": 1}[plan.body], plan.rows, plan.cols,
            plan.step, plan.srows, plan.splits, plan.kps)
    return Call(plan, out, ws, args)


def quant_matmul(x, w, *, body: Optional[str] = None):
    """``x @ W`` for a quantized weight ``w`` (see the module docstring).
    CUDA tensors launch the kernel on the current stream (``body`` forces
    the decode or the prefill body, for measurement); CPU tensors take
    :func:`quant_matmul_ref`."""
    if not is_qtensor(w):
        raise ValueError("quant_matmul takes a quantized weight "
                         "{'q', 's'[, 'z']}")
    if x.device.type == "cpu":
        return quant_matmul_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"no quant_matmul kernel for {x.device}")
    call = prepare_call(x, w, body=body)
    if call.out.numel() == 0:
        return call.out
    err = _kernel()(*call.args,
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed (code {err})")
    quant_matmul.launches += 1
    return call.out


#: kernel launches since the count was last set to 0
quant_matmul.launches = 0


def _kernel():
    fn = _build.load("qmm").qmm_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 4
                   + [ctypes.c_int] * 14 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn
