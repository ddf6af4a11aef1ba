"""The torch port's int8 latent pool (MLA with ``kv_cache_dtype="int8"``)
against the JAX package on the CPU:

- ``mla_paged_decode_ref`` on int8 pages against the Pallas
  ``mla_paged_decode(c_scales=, r_scales=, interpret=True)``, on a
  layer-stacked flat cache whose tables step over layer 0 and whose scale
  table is layer 1's slice (``scale_slot_base``), atol 1e-5.
- The int8 MLA write: the latent and the rope part quantized as two
  streams, bit for bit the bytes and scales of JAX ``quantize_kv`` per
  stream, as ``_mla_attention`` writes them.
- The MLA + MoE ragged step pair of tests/test_torch_mla.py on int8 caches
  against JAX ``make_ragged_step_fn``: logits within atol 1e-4 (f32), the
  written pages within one quantization step.
- ``AsyncTorchEngine(kv_cache_dtype="int8")`` against the JAX int8 engine
  on ``mla_tiny``: greedy streams and KV-event hashes equal (mirrors
  tests/test_int8_kv.py::test_mla_engine_serves_with_int8_kv across
  engines).
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dynamo_tpu.engine import model as M
from dynamo_tpu.engine.cache import allocate_device_cache as jax_cache
from dynamo_tpu.engine.cache import quantize_kv as jax_quantize
from dynamo_tpu.engine.config import EngineArgs as JaxEngineArgs
from dynamo_tpu.engine.engine import AsyncJaxEngine
from dynamo_tpu.models import get_model_config as jax_preset
from dynamo_tpu.ops.paged_attention import mla_paged_decode as jax_mla_decode
from dynamo_tpu.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols import StopConditions as JaxStop
from dynamo_tpu_torch.engine import model as TM
from dynamo_tpu_torch.engine.cache import (
    allocate_device_cache, quantize_kv, write_kv,
)
from dynamo_tpu_torch.engine.config import EngineArgs
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.models import get_model_config
from dynamo_tpu_torch.ops.mla_decode import mla_paged_decode_ref
from dynamo_tpu_torch.protocols import PreprocessedRequest, StopConditions
from tests.test_torch_mla import BS, BT, STEPS, _pack


def _mla_tiny_params(seed):
    """mla_tiny's weights in both packages: drawn by the port's
    ``init_params`` (the JAX layout) and handed to JAX as the same
    numbers."""
    cfg = get_model_config("mla_tiny")
    tp = TM.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    return cfg, jax_preset("mla_tiny"), jax.tree.map(
        lambda t: jnp.asarray(t.numpy()), tp), tp


def test_mla_int8_decode_ref_matches_pallas():
    rng = np.random.default_rng(6)
    B, H, R, PR, bs, nb = 3, 4, 128, 128, 8, 12
    slots = nb * bs
    q_eff = rng.standard_normal((B, H, R), np.float32)
    q_rot = rng.standard_normal((B, H, PR), np.float32)
    q_rot[..., 64:] = 0  # the rope part is zero-padded, as in the engine
    lat = rng.standard_normal((2, slots, 1, R), np.float32)
    rope = rng.standard_normal((2, slots, 1, PR), np.float32)
    rope[..., 64:] = 0
    cq, cs = (np.asarray(a) for a in jax_quantize(jnp.asarray(lat)))
    rq, rs = (np.asarray(a) for a in jax_quantize(jnp.asarray(rope)))
    kv_lens = np.asarray([37, 0, 8], np.int32)  # a kv_len 0 row, one page
    bt = np.zeros((B, 6), np.int32)
    bt[0, :5] = rng.choice(np.arange(1, nb), 5, replace=False)
    bt[2, 0] = 3
    bt = bt + nb  # layer 1 of the flat two-layer cache
    ops = (q_eff, q_rot, cq.reshape(2 * slots, R), rq.reshape(2 * slots, PR),
           bt, kv_lens)
    kw = dict(block_size=bs, scale=0.0625)
    want = np.asarray(jax_mla_decode(
        *(jnp.asarray(a) for a in ops), interpret=True,
        c_scales=jnp.asarray(cs[1, :, 0]), r_scales=jnp.asarray(rs[1, :, 0]),
        scale_slot_base=slots, **kw))
    got = mla_paged_decode_ref(
        *(torch.from_numpy(a) for a in ops),
        c_scales=torch.from_numpy(cs[1]), r_scales=torch.from_numpy(rs[1]),
        scale_slot_base=slots, **kw)
    assert got.dtype == torch.float32 and got.shape == (B, H, R)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert not got[1].any()  # kv_len 0: zeros


def test_mla_int8_write_matches_jax():
    """The latent [N, 1, r] and the padded rope part [N, 1, pr] of mla_tiny
    written into an int8 latent pool: each stream's int8 values and scales
    equal JAX ``quantize_kv`` of that stream, and the slots not written
    stay zero."""
    cfg = get_model_config("mla_tiny")
    r, pr = cfg.kv_lora_rank, cfg.rope_cache_dim
    rng = np.random.default_rng(2)
    N = 7
    c = rng.standard_normal((N, 1, r)).astype(np.float32) * 3
    rot = np.zeros((N, 1, pr), np.float32)
    rot[..., :cfg.qk_rope_head_dim] = rng.standard_normal(
        (N, 1, cfg.qk_rope_head_dim))
    slots = np.asarray([5, 6, 7, 8, 13, 14, 2])
    kc, vc = allocate_device_cache(cfg, 5, 4, "cpu", torch.float32, "int8")
    write_kv(kc, vc, 1, torch.from_numpy(slots), torch.from_numpy(c),
             torch.from_numpy(rot))
    for cache, x in ((kc, c), (vc, rot)):
        q, s = (np.asarray(a) for a in jax_quantize(jnp.asarray(x)))
        np.testing.assert_array_equal(cache["q"][1, slots].numpy(), q)
        np.testing.assert_array_equal(cache["s"][1, slots].numpy(), s)
        assert not cache["q"][0].any() and not cache["s"][2].any()
    q, s = quantize_kv(torch.from_numpy(c))
    assert torch.equal(kc["q"][1, slots], q) and torch.equal(kc["s"][1, slots],
                                                             s)


def test_mla_int8_ragged_step_matches_jax():
    cfg, jcfg, jp, tp = _mla_tiny_params(3)
    jfn = M.make_ragged_step_fn(jcfg, BS)
    tfn = TM.make_ragged_step_fn(cfg, BS)
    jk, jv = jax_cache(jcfg, 18, BS, dtype="int8")
    tk, tv = allocate_device_cache(cfg, 18, BS, "cpu", torch.float32, "int8")
    for work in STEPS:
        ops = _pack(work)
        jl, jk, jv = jfn(jp, *(jnp.asarray(a) for a in ops), jnp.asarray(BT),
                         jk, jv)
        tl, tk2, tv2 = tfn(tp, *(torch.from_numpy(a) for a in ops),
                           torch.from_numpy(BT), tk, tv)
        assert tk2 is tk and tv2 is tv  # updated in place
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                                   atol=1e-4, rtol=1e-4)
        # the null block excepted: padding tokens write into it
        for g, w in ((tk, jk), (tv, jv)):
            dq = np.abs(g["q"].numpy()[:, BS:].astype(np.int32)
                        - np.asarray(w["q"])[:, BS:].astype(np.int32))
            assert dq.max() <= 1, dq.max()
            np.testing.assert_allclose(g["s"].numpy()[:, BS:],
                                       np.asarray(w["s"])[:, BS:],
                                       rtol=1e-2)


def test_mla_int8_engine_streams_match_jax_engine():
    settings = dict(block_size=4, num_blocks=64, max_num_seqs=4,
                    max_num_batched_tokens=32, max_model_len=128,
                    decode_batch_buckets=(1, 2, 4), kv_cache_dtype="int8")
    cfg, jcfg, jp, tp = _mla_tiny_params(0)
    rng = np.random.default_rng(12)
    prompts = [list(map(int, rng.integers(1, 256, n))) for n in (23, 11, 9)]
    prompts.append(prompts[1] + [5, 6])  # shares prompts[1]'s blocks
    max_toks = (6, 5, 7, 4)

    async def serve(eng, reqs):
        async def one(r):
            toks = []
            async for out in eng.generate(r):
                toks.extend(out.token_ids)
            return toks

        try:
            return await asyncio.gather(*(one(r) for r in reqs))
        finally:
            await eng.close()

    def stored(events):
        return [[(b.block_hash, b.tokens_hash) for b in e.stored_blocks]
                for e in events if e.stored_blocks]

    jev, tev = [], []
    jeng = AsyncJaxEngine(jcfg, JaxEngineArgs(prefill_buckets=(8, 16, 32),
                                              **settings),
                          params=jp, event_cb=jev.append)
    assert jeng._kv_quant
    jout = asyncio.run(serve(jeng, [
        JaxRequest(model="mla", token_ids=p,
                   stop_conditions=JaxStop(max_tokens=m, ignore_eos=True))
        for p, m in zip(prompts, max_toks)]))
    teng = AsyncTorchEngine(cfg, EngineArgs(**settings), params=tp,
                            device="cpu", event_cb=tev.append)
    assert teng.k_cache["q"].dtype == torch.int8
    tout = asyncio.run(serve(teng, [
        PreprocessedRequest(model="mla", token_ids=p,
                            stop_conditions=StopConditions(
                                max_tokens=m, ignore_eos=True))
        for p, m in zip(prompts, max_toks)]))
    assert tout == jout
    assert [len(t) for t in tout] == list(max_toks)
    assert stored(tev) and stored(tev) == stored(jev)
