"""Disagg wire types, the port's copy of ``dynamo_tpu/disagg/protocols.py``:
the KV bundle and its frames, the prefill response, the live threshold.

A ``KvBundle`` carries its pages as torch tensors on the host (the card's
machine has no ``ml_dtypes``, so bf16 cannot live in numpy there). Its
wire dict is byte for byte the JAX package's: the same keys in the same
order, the raw little-endian bytes of k and v, and the numpy name of the
dtype ("bfloat16", "float32", "uint8" for a packed int8 bundle), so a
torch worker and a JAX worker read each other's frames.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

#: dtype names on the wire (numpy's, ``ml_dtypes``' for bf16) ↔ torch
WIRE_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16,
    "float16": torch.float16, "uint8": torch.uint8, "int8": torch.int8,
}
_NAMES = {v: k for k, v in WIRE_DTYPES.items()}


def dtype_name(t: torch.Tensor) -> str:
    """The wire name of ``t``'s dtype."""
    return _NAMES[t.dtype]


def tensor_bytes(t: torch.Tensor) -> bytes:
    """The raw bytes of a host tensor in C order (bf16 through its 16-bit
    pattern: numpy has no bf16)."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def tensor_from_bytes(buf: bytes, name: str, shape) -> torch.Tensor:
    """A host tensor of dtype ``name`` and ``shape`` holding a copy of
    ``buf``."""
    dtype = WIRE_DTYPES.get(name)
    if dtype is None:
        raise ValueError(f"unknown KV dtype {name!r} on the wire")
    shape = tuple(int(x) for x in shape)
    if not buf:
        return torch.empty(shape, dtype=dtype)
    raw = torch.from_numpy(np.frombuffer(buf, np.uint8).copy())
    return raw.view(dtype).reshape(shape)


@dataclass
class DisaggConfig:
    """Conditional-disaggregation knobs."""

    #: prompts at or below this length prefill locally on the decode engine
    max_local_prefill_length: int = 512
    #: control-plane key watched for runtime updates
    KEY = "public/components/disagg_router/max_local_prefill_length"


@dataclass
class KvBundle:
    """KV pages: k and v [L, n_blocks, bs, KV, hd] (packed int8: uint8
    [L, n_blocks, X]) on the host.

    ``start_block`` is the logical block ordinal of the first page (a
    pipelined transfer ships several bundles a request). ``total_layers``
    set means the bundle is a LAYER SLICE holding layers [start_layer,
    start_layer + k.shape[0]) of a ``total_layers``-deep cache; None is a
    full-depth bundle, whose wire carries no layer keys."""

    k: torch.Tensor
    v: torch.Tensor
    num_tokens: int  # valid tokens covered (may end mid-block)
    block_size: int
    start_block: int = 0
    start_layer: int = 0
    total_layers: Optional[int] = None  # None = full depth

    @property
    def num_blocks(self) -> int:
        return self.k.shape[1]

    @property
    def nbytes(self) -> int:
        return (self.k.numel() * self.k.element_size()
                + self.v.numel() * self.v.element_size())

    def to_wire(self) -> dict:
        d = {
            "shape": list(self.k.shape),
            "dtype": dtype_name(self.k),
            "k": tensor_bytes(self.k),
            "v": tensor_bytes(self.v),
            "num_tokens": self.num_tokens,
            "block_size": self.block_size,
            "start_block": self.start_block,
        }
        if self.total_layers is not None:
            d["start_layer"] = self.start_layer
            d["total_layers"] = self.total_layers
        return d

    @staticmethod
    def from_wire(d: dict) -> "KvBundle":
        shape = d["shape"]
        return KvBundle(k=tensor_from_bytes(d["k"], d["dtype"], shape),
                        v=tensor_from_bytes(d["v"], d["dtype"], shape),
                        num_tokens=d["num_tokens"],
                        block_size=d["block_size"],
                        start_block=d.get("start_block", 0),
                        start_layer=d.get("start_layer", 0),
                        total_layers=d.get("total_layers"))


@dataclass
class KvChunkFrame:
    """A mid-prefill transfer frame: the pages of blocks whose KV is final,
    streamed while the prefill worker computes later chunks."""

    bundle: KvBundle

    def to_wire(self) -> dict:
        return {"kv_chunk": self.bundle.to_wire()}

    @staticmethod
    def is_wire(d: dict) -> bool:
        return "kv_chunk" in d

    @staticmethod
    def from_wire(d: dict) -> "KvChunkFrame":
        return KvChunkFrame(bundle=KvBundle.from_wire(d["kv_chunk"]))


@dataclass
class KvLayerFrame:
    """A layer slice of the TAIL chunk: the wire and scatter of layer group
    g overlap the host staging of group g + 1. Sent only to a decode
    worker that advertised ``kv_layers``."""

    bundle: KvBundle

    def to_wire(self) -> dict:
        return {"kv_layer": self.bundle.to_wire()}

    @staticmethod
    def is_wire(d: dict) -> bool:
        return isinstance(d, dict) and "kv_layer" in d

    @staticmethod
    def from_wire(d: dict) -> "KvLayerFrame":
        return KvLayerFrame(bundle=KvBundle.from_wire(d["kv_layer"]))


@dataclass
class PrefillResponse:
    """First token + the transfer's tail, the last frame of a prefill
    worker's stream."""

    token_id: int
    logprob: Optional[float]
    bundle: Optional[KvBundle]

    def to_wire(self) -> dict:
        return {
            "token_id": self.token_id,
            "logprob": self.logprob,
            "kv": self.bundle.to_wire() if self.bundle else None,
        }

    @staticmethod
    def from_wire(d: dict) -> "PrefillResponse":
        kv = d.get("kv")
        return PrefillResponse(
            token_id=d["token_id"], logprob=d.get("logprob"),
            bundle=KvBundle.from_wire(kv) if kv else None)
