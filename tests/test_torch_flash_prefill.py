"""The torch port's flash prefill attention, held against the JAX package.

The plain PyTorch version (``flash_prefill_ref``, what the kernel wrapper
runs for CPU tensors) against JAX ``flash_prefill`` with the Pallas kernel
in interpret mode, on the same numpy-seeded operands: causal rows with
``pos_base > 0`` and rows past ``kv_len``, a sliding window, sinks, a value
width other than the key width and an explicit scale, several key tiles;
then ``flash_prefill_paged`` on a plain and an int8 cache, and the MLA
concat form. Tolerance atol = rtol = 1e-4 in f32 (the two sum the same
products in other orders; Pallas interpret runs its f32 HIGHEST path).

The CUDA kernel itself is compared with the plain version on the card by
``chip_smoke.py`` and by ``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.cache import quantize_kv as jax_quantize_kv
from dynamo_tpu.ops import flash_prefill as J
from dynamo_tpu_torch.ops import flash_prefill as P

TOL = dict(atol=1e-4, rtol=1e-4)


def make_inputs(B=2, S=24, H=8, KV=2, hd=64, hdv=None, T=64, seed=0,
                pos_base=(30, 0), kv_lens=(54, 10)):
    rng = np.random.default_rng(seed)
    return dict(
        q=rng.standard_normal((B, S, H, hd)).astype(np.float32),
        k=rng.standard_normal((B, T, KV, hd)).astype(np.float32),
        v=rng.standard_normal((B, T, KV, hdv or hd)).astype(np.float32),
        pos_base=np.asarray(pos_base[:B], np.int32),
        kv_lens=np.asarray(kv_lens[:B], np.int32),
        sinks=rng.standard_normal((H,)).astype(np.float32))


def _both(case, **kw):
    names = ("q", "k", "v", "pos_base", "kv_lens")
    sinks = kw.pop("sinks", False)
    got = P.flash_prefill(*(torch.from_numpy(case[n]) for n in names),
                          sinks=torch.from_numpy(case["sinks"]) if sinks
                          else None, **kw).numpy()
    want = np.asarray(J.flash_prefill(
        *(jnp.asarray(case[n]) for n in names),
        sinks=jnp.asarray(case["sinks"]) if sinks else None, interpret=True,
        **kw))
    return got, want


@pytest.mark.parametrize("kw", [
    {},
    {"sliding_window": 16},
    {"sinks": True},
    {"sliding_window": 5, "sinks": True, "scale": 0.3},
], ids=["causal", "window", "sinks", "window-sinks-scale"])
def test_ref_matches_pallas_interpret(kw):
    got, want = _both(make_inputs(), **kw)
    np.testing.assert_allclose(got, want, **TOL)


def test_ref_value_width_and_several_key_tiles():
    """hdv != hd (MLA's latent attention) over more than one 512-key tile,
    a chunk deep into its context."""
    case = make_inputs(B=1, S=32, H=4, KV=1, hd=48, hdv=32, T=1024, seed=1,
                       pos_base=(900,), kv_lens=(932,))
    got, want = _both(case, sliding_window=600)
    assert got.shape == (1, 32, 4, 32)
    np.testing.assert_allclose(got, want, **TOL)


def test_row_without_keys_is_zero():
    """A padding row (kv_len 0) gets zeros, with and without sinks."""
    case = make_inputs(kv_lens=(54, 0))
    for sinks in (False, True):
        got = P.flash_prefill_ref(
            *(torch.from_numpy(case[n]) for n in ("q", "k", "v", "pos_base",
                                                  "kv_lens")),
            sinks=torch.from_numpy(case["sinks"]) if sinks else None)
        assert torch.isfinite(got).all() and not got[1].any()


def _paged_case(seed):
    rng = np.random.default_rng(seed)
    B, S, H, KV, hd, bs, L = 2, 16, 4, 2, 16, 4, 2
    W = S // bs
    slots = (B * W + 2) * bs
    kc = rng.standard_normal((L, slots, KV, hd)).astype(np.float32)
    vc = rng.standard_normal((L, slots, KV, hd)).astype(np.float32)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    bt = rng.permutation(np.arange(1, B * W + 2))[:B * W].reshape(B, W)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    lens = np.asarray([S, 11], np.int32)
    return q, kc, vc, bt.astype(np.int32), pos, lens, bs


@pytest.mark.parametrize("int8", [False, True])
def test_paged_matches_jax(int8):
    """Layer 1's pages gathered through random block tables; an int8 cache
    dequantizes in the gather on both sides."""
    q, kc, vc, bt, pos, lens, bs = _paged_case(2)
    if int8:
        jk = dict(zip("qs", map(np.asarray, jax_quantize_kv(kc))))
        jv = dict(zip("qs", map(np.asarray, jax_quantize_kv(vc))))
        tk = {n: torch.from_numpy(a) for n, a in jk.items()}
        tv = {n: torch.from_numpy(a) for n, a in jv.items()}
        jk = {n: jnp.asarray(a) for n, a in jk.items()}
        jv = {n: jnp.asarray(a) for n, a in jv.items()}
    else:
        jk, jv = jnp.asarray(kc), jnp.asarray(vc)
        tk, tv = torch.from_numpy(kc), torch.from_numpy(vc)
    got = P.flash_prefill_paged(
        torch.from_numpy(q), tk, tv, 1, torch.from_numpy(bt),
        torch.from_numpy(pos), torch.from_numpy(lens), block_size=bs).numpy()
    want = np.asarray(J.flash_prefill_paged(
        jnp.asarray(q), jk, jv, 1, jnp.asarray(bt), jnp.asarray(pos),
        jnp.asarray(lens), block_size=bs, interpret=True))
    np.testing.assert_allclose(got, want, **TOL)


def test_mla_concat_form_matches_jax():
    rng = np.random.default_rng(3)
    B, S, H, r, pr, T = 1, 8, 4, 32, 16, 16
    arrs = dict(q_eff=(B, S, H, r), q_rot=(B, S, H, pr), c=(B, T, r),
                k_rot=(B, T, pr))
    a = {n: rng.standard_normal(s).astype(np.float32)
         for n, s in arrs.items()}
    pb, kl = np.zeros((B,), np.int32), np.full((B,), 12, np.int32)
    got = P.flash_mla_prefill(*(torch.from_numpy(a[n]) for n in arrs),
                              torch.from_numpy(pb), torch.from_numpy(kl),
                              scale=0.2).numpy()
    want = np.asarray(J.flash_mla_prefill(
        *(jnp.asarray(a[n]) for n in arrs), jnp.asarray(pb), jnp.asarray(kl),
        scale=0.2, interpret=True))
    np.testing.assert_allclose(got, want, **TOL)


def test_wrapper_takes_plain_version_on_cpu():
    case = make_inputs(seed=4)
    args = [torch.from_numpy(case[n])
            for n in ("q", "k", "v", "pos_base", "kv_lens")]
    before = P.flash_prefill.launches
    got = P.flash_prefill(*args, sliding_window=9)
    assert P.flash_prefill.launches == before
    assert torch.equal(got, P.flash_prefill_ref(*args, sliding_window=9))


@pytest.mark.parametrize("hd,hdv,KV,match", [
    (48, 32, 1, "hd == hdv"), (576, 512, 1, "flash_mla_prefill"),
    (64, 64, 3, "H % KV")])
def test_kernel_shape_check_refuses(hd, hdv, KV, match):
    """The checks the wrapper runs before a launch on a CUDA tensor: the
    MLA geometry (its own kernel, flash_mla_prefill's) and other shapes the
    kernel does not take raise."""
    case = make_inputs(B=1, S=4, H=8, KV=KV, hd=hd, hdv=hdv, T=8)
    with pytest.raises(ValueError, match=match):
        P._check(*(torch.from_numpy(case[n]) for n in
                   ("q", "k", "v", "pos_base", "kv_lens")), None, 0)
