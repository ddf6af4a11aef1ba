"""On-device quantized weights: int8 or int4 resident on the card,
dequantized inside the matmul (the port of ``dynamo_tpu/engine/quant.py``).

A quantized weight is a plain dict ``{"q", "s"[, "z"]}`` in the JAX
package's layout: the logical weight ``w[..., I, O]`` (the model's ``[in,
out]``), ``s`` (and the optional zero point ``z``) f32 ``[..., G, O]`` with
``G = I // group`` (``G == 1``: one scale an output channel), and
``w = q·s − z``. The formats are the JAX package's:

- ``int8``: ``q`` int8 ``[..., I, O]``, one scale an output channel;
- ``int8-gN``: the same with one scale for every N rows of the contraction
  dim and output channel;
- ``int4-gN``: grouped int4. torch has no int4 dtype, so ``q`` is uint8
  ``[..., I/2, O]`` holding two two's-complement nibbles a byte along the
  contraction dim: byte ``[k, o]`` holds row ``2k`` in its low nibble and
  row ``2k+1`` in its high nibble (:func:`pack_int4`, :func:`unpack_int4`).
  ``q.dtype == torch.uint8`` is how every reader tells packed int4 from
  int8.

:func:`quantize` runs on a tensor wherever it lies (on the card for a
full-width model) with the reference's f32 arithmetic — ``max|grp| /
qmax``, ``max(s, 1e-12)``, round half to even, clip — so on either device
it gives the JAX ``quantize``'s bits. It quantizes a stacked weight one
leading slice (a layer, an expert) at a time, so its f32 scratch is one
matrix's.

:func:`materialize`, :func:`dequantize` and :func:`qmm` are the plain
formulas; on the card the forward sends every quantized product through the
hand dequant-GEMM (``ops/qmm.py``) instead, which dequantizes tiles in
shared memory and never writes a full-width weight.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

_logger = logging.getLogger("dynamo_torch.engine.quant")

#: weight names eligible for quantization (matmul weights only — norms,
#: biases, sinks, router and embeddings stay at model dtype; embed doubles
#: as the tied head and feeds a gather, which wants full width)
QUANT_KEYS = frozenset({
    "wq", "wk", "wv", "wo", "q_a", "q_b", "kv_a",
    "w_gate", "w_up", "w_down", "ws_gate", "ws_up", "ws_down",
    "lm_head",
})


def is_qtensor(w) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def parse_spec(spec: str) -> tuple[int, Optional[int]]:
    """``"int8"`` → (8, None); ``"int8-g128"`` → (8, 128); ``"int4-g32"``
    → (4, 32). Grouping is required for int4 — per-channel 4-bit is too
    coarse to hold parity."""
    base, _, g = spec.partition("-g")
    if base not in ("int8", "int4"):
        raise ValueError(f"unsupported quantization spec '{spec}' "
                         "(int8[-gN] / int4-gN)")
    bits = int(base[3:])
    group = int(g) if g else None
    if group is not None and group <= 0:
        raise ValueError(f"unsupported quantization spec '{spec}' "
                         "(group size must be positive)")
    if bits == 4 and group is None:
        raise ValueError("int4 requires a group size (e.g. 'int4-g32')")
    return bits, group


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 ``[..., I, O]`` holding values in [-8, 7] → uint8 ``[..., I/2,
    O]``: row 2k in the low nibble of byte k, row 2k+1 in its high nibble."""
    if q.shape[-2] % 2:
        raise ValueError(f"int4 packing needs an even contraction dim, got "
                         f"{q.shape[-2]}")
    n = q.contiguous().view(torch.uint8) & 0xF  # two's-complement nibbles
    return n[..., 0::2, :] | (n[..., 1::2, :] << 4)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """uint8 ``[..., I/2, O]`` of :func:`pack_int4` → int8 ``[..., I, O]``
    (bytes only: no wider scratch than the result)."""
    lo = ((p & 0xF).view(torch.int8) ^ 8) - 8  # sign-extend the nibble
    hi = ((p >> 4).view(torch.int8) ^ 8) - 8
    return torch.stack([lo, hi], dim=-2).reshape(
        *p.shape[:-2], 2 * p.shape[-2], p.shape[-1])


def int_values(q: torch.Tensor) -> torch.Tensor:
    """The integer weights of ``q`` as int8 ``[..., I, O]`` (packed int4
    unpacked)."""
    return unpack_int4(q) if q.dtype == torch.uint8 else q


def _quantize_matrix(w: torch.Tensor, bits: int, group: int):
    qmax = (1 << (bits - 1)) - 1  # 127 / 7
    I, O = w.shape
    grp = w.float().reshape(I // group, group, O)
    lo, hi = torch.aminmax(grp, dim=-2, keepdim=True)
    amax = torch.maximum(hi, -lo)  # max |grp|, [G, 1, O]
    # a tensor divisor: CUDA multiplies by the reciprocal of a scalar one,
    # which rounds differently from the reference's division
    s = amax / torch.full_like(amax, qmax)
    s = torch.clamp_min(s, 1e-12)
    q = torch.div(grp, s).round_().clamp_(-qmax, qmax).to(torch.int8)
    q = q.view(I, O)
    return (pack_int4(q) if bits == 4 else q), s[:, 0, :]


def quantize(w: torch.Tensor, bits: int = 8,
             group: Optional[int] = None) -> dict:
    """Symmetric quantization of ``w[..., I, O]`` along the contraction dim,
    on ``w``'s device. group=None → one scale per output channel; group=g →
    one scale per (g-chunk of I, output channel). A stacked ``w`` is
    quantized one ``[I, O]`` slice at a time into preallocated stacks."""
    I, O = w.shape[-2], w.shape[-1]
    if group is None:
        group = I
    if I % group:
        raise ValueError(f"contraction dim {I} not divisible by group {group}")
    lead = w.shape[:-2]
    q_rows = I // 2 if bits == 4 else I
    q = torch.empty((*lead, q_rows, O), device=w.device,
                    dtype=torch.uint8 if bits == 4 else torch.int8)
    s = torch.empty((*lead, I // group, O), device=w.device,
                    dtype=torch.float32)
    flat_w, flat_q, flat_s = (t.reshape(-1, *t.shape[-2:])
                              for t in (w, q, s))
    for i in range(flat_w.shape[0]):
        flat_q[i], flat_s[i] = _quantize_matrix(flat_w[i], bits, group)
    return {"q": q, "s": s}


def materialize(w, dtype):
    """The weight as a matmul operand: a passthrough for plain tensors, the
    dequantized weight for QTensors — ``q·s − z`` in f32 with ONE final cast
    to ``dtype``, as the JAX package's (a dequantize-at-load weight, bit for
    bit). The plain version of the dequant-GEMM; the forward never calls it
    on the card."""
    if not is_qtensor(w):
        return w
    q = int_values(w["q"])
    G = w["s"].shape[-2]
    *lead, I, O = q.shape
    out = q.to(torch.float32).view(*lead, G, I // G, O)
    out.mul_(w["s"].float().unsqueeze(-2))
    if "z" in w:
        out.sub_(w["z"].float().unsqueeze(-2))
    return out.view(*lead, I, O).to(dtype)


def dequantize(qt: dict, dtype=torch.float32):
    """Full-width dequantized weight (tests / host-side checks)."""
    return materialize(qt, dtype)


def qmm(x, w):
    """``x[..., I] @ w[I, O]`` with a maybe-quantized ``w``, the JAX
    package's formula: per-out-channel QTensors apply the f32 scale to the
    dot's output (``x @ q`` rounded to x's dtype first); grouped ones, or
    any with a zero point, multiply by the materialized weight."""
    if not is_qtensor(w):
        return x @ w
    q, s = w["q"], w["s"]
    if s.shape[-2] == 1 and "z" not in w:
        out = (x @ int_values(q).to(x.dtype)).float()
        return (out * s[..., 0, :].float()).to(x.dtype)
    return x @ materialize(w, x.dtype)


def stack_layers(xs: list):
    """Stack per-layer weights onto a leading layer axis — QTensor-aware
    (stacks each field)."""
    if isinstance(xs[0], dict):
        return {k: torch.stack([x[k] for x in xs]) for k in xs[0]}
    return torch.stack(xs)


def slice_layers(w, n: int):
    """The first ``n`` layers of a stacked weight (views), QTensor-aware."""
    if isinstance(w, dict):
        return {k: v[:n] for k, v in w.items()}
    return w[:n]


def leaf_group(name: str, in_dim: int, bits: int,
               group: Optional[int]) -> tuple[bool, Optional[int]]:
    """How weight ``name`` with contraction dim ``in_dim`` quantizes:
    (False, None) keeps it at full width (not a matmul weight, or an int4
    weight whose dim does not divide the group), (True, g) quantizes it
    with group g (None: per channel). Narrow projections that do not divide
    the group fall back to per-channel int8, with the JAX walk's
    warnings."""
    if name not in QUANT_KEYS:
        return False, None
    if group is not None and in_dim % group:
        # narrow projections (e.g. MLA kv_a with small D) may not divide;
        # fall back to per-channel rather than fail
        if bits == 4:
            _logger.warning(
                "quantize_params: %s dim %d not divisible by group %d — "
                "kept at FULL width (int4 needs groups)", name, in_dim, group)
            return False, None
        _logger.warning(
            "quantize_params: %s dim %d not divisible by group %d — "
            "per-channel int8 instead", name, in_dim, group)
        return True, None
    return True, group


def empty_qtensor(lead: tuple, shape: tuple, bits: int,
                  group: Optional[int], device) -> dict:
    """An uninitialised stacked ``{"q", "s"}`` of ``lead`` weights
    ``shape`` = [I, O] (group None: per channel), for
    :func:`quantize_into`."""
    I, O = shape
    return {"q": torch.empty((*lead, I // 2 if bits == 4 else I, O),
                             dtype=torch.uint8 if bits == 4 else torch.int8,
                             device=device),
            "s": torch.empty((*lead, I // (group or I), O),
                             dtype=torch.float32, device=device)}


def quantize_into(dst: dict, index, w: torch.Tensor) -> None:
    """Quantize the [I, O] matrix ``w`` into slot ``index`` (a layer, or a
    (layer, expert) pair) of the stacked QTensor ``dst``, in ``dst``'s
    format."""
    bits = 4 if dst["q"].dtype == torch.uint8 else 8
    qt = quantize(w, bits, w.shape[-2] // dst["s"].shape[-2])
    dst["q"][index].copy_(qt["q"])
    dst["s"][index].copy_(qt["s"])


def _quant_walk(tree: dict, bits: int, group: Optional[int]) -> dict:
    """Every eligible weight of ``tree`` quantized (:func:`leaf_group`);
    QTensors already in the tree pass through."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _quant_walk(v, bits, group)
            continue
        ok, g = leaf_group(k, v.shape[-2], bits, group) if v.dim() >= 2 \
            else (False, None)
        out[k] = quantize(v, bits=bits, group=g) if ok else v
    return out


def quantize_params(params: dict, spec: str) -> dict:
    """Quantize every eligible matmul weight of a param tree, on the
    device each leaf lies on, one layer (and one expert) at a time.

    Stacked-layer tensors ([n_layers, I, O]) and MoE expert stacks
    ([n, E, I, O]) both quantize along their second-to-last dim. Leaves
    already quantized pass through. The caller's tree is not changed."""
    bits, group = parse_spec(spec)
    return _quant_walk(params, bits, group)
