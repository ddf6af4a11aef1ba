"""Weights from the JAX package's parameter layout.

``params_from_jax`` takes the pytree that the JAX package's ``init_params``
returns (or a checkpoint loaded into it), with its leaves already turned
into numpy arrays, and gives the port's params: the same nested dict of
tensors, stacked ``[L, ...]`` layers and ``[in, out]`` weights included,
so both packages compute the same step from the same numbers.

Quantized subtrees (``{"q", "s"[, "z"]}``, ``dynamo_tpu/engine/quant.py``)
carry over in the port's layout (``engine/quant.py``): int8 ``q`` as it
is, ml_dtypes ``int4`` ``q`` packed two nibbles a byte (``pack_int4``;
found by its dtype's name, so ml_dtypes is never imported), ``s`` and
``z`` as f32.
"""

from __future__ import annotations

import numpy as np
import torch

from dynamo_tpu_torch.engine.quant import is_qtensor, pack_int4


def _tensor(a: np.ndarray, device):
    a = np.asarray(a)
    if a.dtype.name == "int4":  # ml_dtypes int4: a QTensor's q
        return pack_int4(torch.from_numpy(a.astype(np.int8))).to(device)
    if a.dtype.name == "bfloat16":  # ml_dtypes: no numpy-native torch path
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_jax(tree: dict, device=None) -> dict:
    """Numpy pytree → dict of tensors on ``device`` (None = "cuda")."""
    device = torch.device(device or "cuda")
    out = {k: (params_from_jax(v, device) if isinstance(v, dict)
               else _tensor(v, device))
           for k, v in tree.items()}
    if is_qtensor(out):
        for k in ("s", "z"):
            if k in out:
                out[k] = out[k].float()
    return out
