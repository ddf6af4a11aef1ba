"""The torch port's CUDA kernel against its plain version, on the card.

Marked ``gpu``: each test skips without a CUDA device. The module imports
neither JAX nor the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.ops.ragged_attention import (
    ragged_attention_ref, ragged_paged_attention,
)


def make_case(seed, rows, H, KV, hd, bs, W, num_blocks=160, pad_rows=1,
              pad_tokens=3):
    """rows: (q_len, kv_len) each; numpy operands and the real-token
    count."""
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


#: short rows (one key chunk per tile) and long rows whose tiles split
#: their keys over several CTAs (split-K)
CASES = {
    "short": ([(1, 20), (6, 24), (1, 9), (11, 11), (37, 60)], 4),
    "split": ([(1, 700), (40, 530), (1, 9), (130, 130)], 48),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case_name", sorted(CASES))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_kernel_matches_plain_on_card(dtype, tol, case_name):
    """The CUDA kernel against the plain version: f32 differs by summation
    order; in bf16 both round the output to 8 mantissa bits and the kernel
    rounds P to bf16 before P.V, a step or two apart."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rows, W = CASES[case_name]
    case, t = make_case(3, rows, H=8, KV=2, hd=64, bs=16, W=W)
    args = [torch.from_numpy(case[k]).cuda()
            for k in ("q", "kc", "vc", "bt", "rows3")]
    args[:3] = [a.to(dtype) for a in args[:3]]
    sinks = torch.from_numpy(case["sinks"]).cuda()
    for window, sk in ((0, None), (7, sinks), (300, sinks)):
        got = ragged_paged_attention(*args, block_size=16, window=window,
                                     sinks=sk)
        want = ragged_attention_ref(*args, block_size=16, window=window,
                                    sinks=sk)
        torch.testing.assert_close(got[:t].float(), want[:t].float(),
                                   atol=tol, rtol=tol)
