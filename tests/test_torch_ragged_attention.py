"""The torch port's ragged paged attention, held against the JAX package.

The plain PyTorch version (``ragged_attention_ref``, what the kernel wrapper
runs for CPU tensors) must agree with the JAX XLA oracle and with the
Pallas kernel in interpret mode on the same numpy-seeded operands: mixed
decode + prefill rows, decode-only rows, trailing padding rows, windows and
sinks. Tolerance atol = rtol = 2e-5 in f32 (three implementations sum the
same products in different orders), on real tokens only: padding tokens'
output is unspecified by the contract.

The CUDA kernel itself is compared with the plain version on the card by
``chip_smoke.py`` and by ``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops.ragged_attention import (
    ragged_attention_xla, ragged_paged_attention as jax_ragged,
)
from dynamo_tpu_torch.ops.ragged_attention import (
    ragged_attention_ref, ragged_paged_attention,
)

TOL = dict(atol=2e-5, rtol=2e-5)


def make_case(seed, rows, H=8, KV=4, hd=32, bs=8, num_blocks=64, W=6,
              pad_rows=1, pad_tokens=3):
    """rows: (q_len, kv_len) each. Returns numpy operands and the count of
    real tokens."""
    rng = np.random.default_rng(seed)
    kc = rng.standard_normal((num_blocks * bs, KV, hd), np.float32)
    vc = rng.standard_normal((num_blocks * bs, KV, hd), np.float32)
    R = len(rows) + pad_rows
    rows3 = np.zeros((R, 3), np.int32)
    bt = np.zeros((R, W), np.int32)
    t = 0
    for i, (ql, kl) in enumerate(rows):
        rows3[i] = (t, ql, kl)
        used = (kl + bs - 1) // bs
        bt[i, :used] = rng.choice(np.arange(1, num_blocks), size=used,
                                  replace=False)
        t += ql
    q = rng.standard_normal((t + pad_tokens, H, hd), np.float32)
    sinks = rng.standard_normal((H,), np.float32)
    return dict(q=q, kc=kc, vc=vc, bt=bt, rows3=rows3, sinks=sinks), t


MIXED = [(1, 20), (6, 24), (1, 9), (11, 11)]
DECODE = [(1, 13), (1, 40), (1, 1)]


def _torch(case, window, sinks):
    return ragged_attention_ref(
        torch.from_numpy(case["q"]), torch.from_numpy(case["kc"]),
        torch.from_numpy(case["vc"]), torch.from_numpy(case["bt"]),
        torch.from_numpy(case["rows3"]), block_size=8, window=window or 0,
        sinks=torch.from_numpy(case["sinks"]) if sinks else None).numpy()


def _jax(fn, case, window, sinks, **kw):
    return np.asarray(fn(
        jnp.asarray(case["q"]), jnp.asarray(case["kc"]),
        jnp.asarray(case["vc"]), jnp.asarray(case["bt"]),
        jnp.asarray(case["rows3"]), block_size=8, window=window,
        sinks=jnp.asarray(case["sinks"]) if sinks else None, **kw))


@pytest.mark.parametrize("rows,pad_rows", [(MIXED, 4), (DECODE, 0)])
@pytest.mark.parametrize("window,sinks", [(None, False), (7, False),
                                          (None, True), (5, True)])
def test_ref_matches_xla_oracle(rows, pad_rows, window, sinks):
    case, t = make_case(0, rows, pad_rows=pad_rows)
    got = _torch(case, window, sinks)
    want = _jax(ragged_attention_xla, case, window, sinks)
    np.testing.assert_allclose(got[:t], want[:t], **TOL)


@pytest.mark.parametrize("window,sinks", [(None, False), (7, True)])
def test_ref_matches_pallas_interpret(window, sinks):
    case, t = make_case(1, MIXED, pad_rows=4)
    got = _torch(case, window, sinks)
    want = _jax(jax_ragged, case, window, sinks, interpret=True)
    np.testing.assert_allclose(got[:t], want[:t], **TOL)


def test_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors the wrapper is the plain version and launches
    nothing."""
    case, t = make_case(2, MIXED)
    args = [torch.from_numpy(case[k])
            for k in ("q", "kc", "vc", "bt", "rows3")]
    before = ragged_paged_attention.launches
    got = ragged_paged_attention(*args, block_size=8, window=7)
    assert ragged_paged_attention.launches == before
    np.testing.assert_array_equal(
        got.numpy(), ragged_attention_ref(*args, block_size=8,
                                          window=7).numpy())
