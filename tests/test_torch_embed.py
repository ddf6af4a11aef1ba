"""The torch port's dense forward and embeddings, held against the JAX
package.

On identical tiny-model weights (``params_from_jax``) and numpy-seeded
tokens:

- ``make_embed_fn`` gives JAX ``make_embed_fn``'s vectors within atol 1e-4
  (f32; matmul orders differ between XLA and PyTorch);
- ``make_forward_fn`` over an int8 cache gives JAX ``forward(ragged=None)``
  logits within atol 1e-4, and int8 pages and scales that it wrote equal
  to JAX's but for one quantization step where x / s lands on a rounding
  tie after the two frameworks' float differences;
- ``AsyncTorchEngine.embed`` is unit-norm and padding-invariant, refuses
  inputs past ``max_model_len`` or the batch budget, and its handler turns
  those into error frames.
"""

import asyncio
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import model as M
from dynamo_tpu.engine.cache import allocate_device_cache as jax_alloc
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu_torch.engine import model as TM
from dynamo_tpu_torch.engine.cache import allocate_device_cache
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.engine.weights import params_from_jax

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def weights():
    jparams = M.init_params(JaxModelConfig.tiny(), jax.random.key(0))
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


def test_embed_fn_matches_jax(weights):
    jparams, tparams = weights
    cfg, jcfg, bs = ModelConfig.tiny(), JaxModelConfig.tiny(), 4
    rng = np.random.default_rng(0)
    B, S = 4, 16
    tokens = rng.integers(1, 256, (B, S)).astype(np.int32)
    lengths = np.asarray([16, 7, 1, 0], np.int32)  # last: a padding row
    kc, vc = jax_alloc(jcfg, B * S // bs + 1, bs)
    want = np.asarray(M.make_embed_fn(jcfg, bs)(
        jparams, jnp.asarray(tokens), jnp.asarray(lengths), kc, vc))
    tk, tv = allocate_device_cache(cfg, B * S // bs + 1, bs, "cpu",
                                   torch.float32)
    got = TM.make_embed_fn(cfg, bs)(tparams, torch.from_numpy(tokens),
                                    torch.from_numpy(lengths), tk, tv)
    assert got.dtype == torch.float32 and got.shape == (B, cfg.hidden_size)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got[3].any()  # the padding row pools to zeros


def test_dense_forward_int8_cache_matches_jax(weights):
    """A [2, 8] prefill batch, the second row shorter and continuing at
    position 4 after context already in the cache, written to and read
    from an int8 cache."""
    jparams, tparams = weights
    cfg, jcfg, bs = ModelConfig.tiny(), JaxModelConfig.tiny(), 4
    rng = np.random.default_rng(1)
    B, S, W, nb = 2, 8, 4, 12
    tokens = rng.integers(1, 256, (B, S)).astype(np.int32)
    starts = np.asarray([0, 4], np.int32)
    kv_lens = np.asarray([8, 10], np.int32)
    positions = (starts[:, None] + np.arange(S)).astype(np.int32)
    bt = np.asarray([[1, 2, 0, 0], [3, 4, 5, 0]], np.int32)
    slot_map = np.zeros((B, S), np.int32)  # padding → the null block
    for b in range(B):
        for s in range(S):
            p = positions[b, s]
            if p < kv_lens[b]:
                slot_map[b, s] = bt[b, p // bs] * bs + p % bs
    last_idx = kv_lens - starts - 1
    jk, jv = jax_alloc(jcfg, nb, bs, dtype="int8")
    # earlier context of row 1 (positions 0-3) in the cache
    ctx_q = rng.integers(-127, 128, (cfg.num_layers, 4, 2, 16)).astype(
        np.int8)
    ctx_s = rng.uniform(0.01, 0.02, (cfg.num_layers, 4, 2)).astype(
        np.float32)
    ctx = slice(3 * bs, 4 * bs)
    jk = {"q": jk["q"].at[:, ctx].set(ctx_q),
          "s": jk["s"].at[:, ctx].set(ctx_s)}
    jv = {"q": jv["q"].at[:, ctx].set(-ctx_q),
          "s": jv["s"].at[:, ctx].set(ctx_s)}
    tk = {n: torch.from_numpy(np.asarray(a).copy()) for n, a in jk.items()}
    tv = {n: torch.from_numpy(np.asarray(a).copy()) for n, a in jv.items()}
    ops = (tokens, positions, slot_map, bt, kv_lens, last_idx)
    jfn = jax.jit(functools.partial(M.forward, cfg=jcfg, block_size=bs))
    jl, jk2, jv2 = jfn(jparams, *(jnp.asarray(a) for a in ops), jk, jv)
    tl, tk2, tv2 = TM.make_forward_fn(cfg, bs)(
        tparams, *(torch.from_numpy(a) for a in ops), tk, tv)
    assert tk2 is tk and tl.shape == (B, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for got, want in ((tk, jk2), (tv, jv2)):
        # the null block (padding writes) excepted; int8 pages may differ
        # by one step where x / s lands on a rounding tie after the
        # projections' float differences
        dq = got["q"].numpy()[:, bs:].astype(int) - np.asarray(
            want["q"])[:, bs:]
        assert np.abs(dq).max() <= 1 and (dq != 0).mean() < 1e-3
        np.testing.assert_allclose(got["s"].numpy()[:, bs:],
                                   np.asarray(want["s"])[:, bs:], rtol=1e-2)


SETTINGS = dict(block_size=4, num_blocks=64, max_num_seqs=8,
                max_num_batched_tokens=64, max_model_len=256)


def test_engine_embed_normalized_padding_invariant_and_limits():
    eng = AsyncTorchEngine(ModelConfig.tiny(), EngineArgs(**SETTINGS),
                           device="cpu")
    a = list(range(1, 9))
    b = list(range(20, 45))

    async def drive():
        joint = await eng.embed([a, b])  # padded batch (other lengths)
        solo = await eng.embed([a])
        frames = [f async for f in eng.embed_handler(
            {"token_ids": [list(range(300))]})]
        budget = [f async for f in eng.embed_handler(
            {"token_ids": [list(range(200))] * 30})]
        return joint, solo, frames, budget

    joint, solo, frames, budget = asyncio.run(drive())
    assert abs(float(np.linalg.norm(joint[0])) - 1.0) < 1e-5
    np.testing.assert_allclose(joint[0], solo[0], atol=1e-5, rtol=1e-5)
    assert abs(float(np.dot(joint[0], joint[1]))) < 0.999
    assert "max_model_len" in frames[0]["error"]
    assert "budget" in budget[0]["error"]
    assert asyncio.run(eng.embed([])) == []
    # one scratch cache, for the last (B, S) bucket, apart from the pool
    assert eng._embed_cache[0] == (1, 8)
    assert eng._embed_cache[1][0] is not eng.k_cache


def test_kernel_geometry_checked_when_a_card_engine_is_built():
    """The CUDA kernels take head_dim 64/128 and GQA groups up to 64: an
    engine on the card refuses other models when it is built."""
    TM.check_kernel_geometry(ModelConfig.llama3_8b())
    TM.check_kernel_geometry(ModelConfig.llama3_1b())
    with pytest.raises(ValueError, match="head_dim"):
        TM.check_kernel_geometry(ModelConfig.tiny())
