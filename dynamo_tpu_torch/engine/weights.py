"""Weights from the JAX package's parameter layout.

``params_from_jax`` takes the pytree that the JAX package's ``init_params``
returns (or a checkpoint loaded into it), with its leaves already turned
into numpy arrays, and gives the port's params: the same nested dict of
tensors, stacked ``[L, ...]`` layers and ``[in, out]`` weights included,
so both packages compute the same step from the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a: np.ndarray, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: no numpy-native torch path
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_jax(tree: dict, device=None) -> dict:
    """Numpy pytree → dict of tensors on ``device`` (None = "cuda")."""
    device = torch.device(device or "cuda")
    return {k: (params_from_jax(v, device) if isinstance(v, dict)
                else _tensor(v, device))
            for k, v in tree.items()}
