"""The block frame of the ``kv_pull`` endpoint, the port's copy of
``dynamo_tpu/kvbm/distributed.py``'s ``_pack_block`` / ``_unpack_block``
and ``kvbm/tiers.py``'s ``resolve_dtype``. The distributed block manager
itself (leader, ownership map, the G4 tier) waits for ROADMAP A8e part
3; the local G2 and G3 tiers are ``tiers.py``.

One frame is one full block: its chained sequence hash and its k and v
pages, [L, bs, KV, hd] each (packed int8: uint8 [L, X]), as raw bytes with
their shapes and the numpy name of the dtype, byte for byte the JAX
package's frame.
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.disagg.protocols import (
    WIRE_DTYPES, dtype_name, tensor_bytes, tensor_from_bytes,
)


def resolve_dtype(name: str) -> torch.dtype:
    """The torch dtype of a wire dtype name ("bfloat16" included)."""
    try:
        return WIRE_DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown KV dtype {name!r}") from None


def _pack_block(h: int, k: torch.Tensor, v: torch.Tensor) -> dict:
    return {
        "hash": h,
        "k": tensor_bytes(k), "v": tensor_bytes(v),
        "k_shape": list(k.shape), "v_shape": list(v.shape),
        "dtype": dtype_name(k),
    }


def _unpack_block(d: dict) -> tuple[int, torch.Tensor, torch.Tensor]:
    resolve_dtype(d["dtype"])
    k = tensor_from_bytes(d["k"], d["dtype"], d["k_shape"])
    v = tensor_from_bytes(d["v"], d["dtype"], d["v_shape"])
    return d["hash"], k, v
