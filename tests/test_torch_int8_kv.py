"""The torch port's int8 KV cache, held against the JAX package.

- ``quantize_kv`` gives JAX's bytes bit for bit (scales rounded to bf16,
  half-to-even rounding of x / s), an all-zero block included, and
  requantizing a dequantized block gives the same (q, s) back.
- The int8 branch of the plain ragged attention (``ragged_attention_ref``
  with scales) agrees with JAX ``ragged_paged_attention`` on int8 pages
  (the Pallas kernel in interpret mode), with and without window and
  sinks, atol = rtol = 2e-5 in f32 on real tokens; with the layer-rebased
  scale table (``scale_slot_base``) it is bit-equal to the unshifted call.
- ``AsyncTorchEngine`` with ``kv_cache_dtype="int8"`` gives the JAX int8
  engine's greedy streams and KV stored-event hashes on the tiny model.
- Pool sizing: an int8 block costs (hd + 4) / (2·hd) of a bf16 one.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import model as M
from dynamo_tpu.engine.cache import quantize_kv as jax_quantize_kv
from dynamo_tpu.engine.config import EngineArgs as JaxEngineArgs
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import AsyncJaxEngine
from dynamo_tpu.ops.ragged_attention import (
    ragged_paged_attention as jax_ragged,
)
from dynamo_tpu.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols import StopConditions as JaxStop
from dynamo_tpu_torch.engine import cache as C
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.engine.weights import params_from_jax
from dynamo_tpu_torch.ops.ragged_attention import (
    ragged_attention_ref, ragged_paged_attention,
)
from dynamo_tpu_torch.protocols import PreprocessedRequest, StopConditions

TOL = dict(atol=2e-5, rtol=2e-5)


# ------------------------------------------------------------------ numerics


@pytest.mark.parametrize("seed,shape,mult", [
    (0, (64, 4, 32), 3.0), (1, (3, 16, 2, 64), 1e-3), (2, (8, 2, 128), 40.0)])
def test_quantize_bit_equal_to_jax(seed, shape, mult):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * mult).astype(np.float32)
    x[0] = 0.0  # an all-zero block: scale 1e-8/127, q all zero
    want_q, want_s = jax_quantize_kv(jnp.asarray(x))
    got_q, got_s = C.quantize_kv(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert not got_q[0].any()


def test_requantize_roundtrip_exact_and_error_bounded():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((32, 4, 64)).astype(np.float32))
    q, s = C.quantize_kv(x)
    deq = C.dequantize_kv(q, s)
    q2, s2 = C.quantize_kv(deq)
    assert torch.equal(q, q2) and torch.equal(s, s2)
    assert bool(((deq - x).abs() <= s[..., None] / 2 + 1e-7).all())
    assert C.dequantize_kv(q, s, torch.bfloat16).dtype == torch.bfloat16


# ------------------------------------------------------ ragged int8 branch


def make_int8_case(seed, rows, H=8, KV=2, hd=64, bs=8, num_blocks=24, W=6,
                   pad_rows=2, pad_tokens=3):
    """Mixed decode/prefill rows over an int8 paged cache quantized by the
    JAX package (numpy in, numpy out)."""
    rng = np.random.default_rng(seed)
    kq, ks = (np.asarray(a) for a in jax_quantize_kv(
        rng.standard_normal((num_blocks * bs, KV, hd)).astype(np.float32)))
    vq, vs = (np.asarray(a) for a in jax_quantize_kv(
        rng.standard_normal((num_blocks * bs, KV, hd)).astype(np.float32)))
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
    q = rng.standard_normal((t + pad_tokens, H, hd)).astype(np.float32)
    sinks = rng.standard_normal((H,)).astype(np.float32)
    return dict(q=q, kq=kq, vq=vq, ks=ks, vs=vs, bt=bt, rows3=rows3,
                sinks=sinks), t


STAGGERED = [(1, 20), (6, 24), (1, 9), (11, 11)]


def _port(case, window, sinks, base=0, bt_shift=0, kq=None, vq=None):
    return ragged_attention_ref(
        torch.from_numpy(case["q"]),
        torch.from_numpy(case["kq"] if kq is None else kq),
        torch.from_numpy(case["vq"] if vq is None else vq),
        torch.from_numpy(case["bt"] + bt_shift),
        torch.from_numpy(case["rows3"]), block_size=8, window=window or 0,
        sinks=torch.from_numpy(case["sinks"]) if sinks else None,
        k_scales=torch.from_numpy(case["ks"]),
        v_scales=torch.from_numpy(case["vs"]),
        scale_slot_base=base).numpy()


def _jax(fn, case, window, sinks, base=None, bt_shift=0, kq=None, vq=None,
         **kw):
    return np.asarray(fn(
        jnp.asarray(case["q"]), jnp.asarray(case["kq"] if kq is None else kq),
        jnp.asarray(case["vq"] if vq is None else vq),
        jnp.asarray(case["bt"] + bt_shift), jnp.asarray(case["rows3"]),
        block_size=8, window=window,
        sinks=jnp.asarray(case["sinks"]) if sinks else None,
        k_scales=jnp.asarray(case["ks"]), v_scales=jnp.asarray(case["vs"]),
        scale_slot_base=base, **kw))


@pytest.mark.parametrize("window,sinks", [(None, False), (7, True)])
def test_int8_ref_matches_jax(window, sinks):
    case, t = make_int8_case(0, STAGGERED)
    got = _port(case, window, sinks)
    want = _jax(jax_ragged, case, window, sinks, interpret=True)
    np.testing.assert_allclose(got[:t], want[:t], **TOL)


def test_int8_scale_slot_base_rebases_layer_slice():
    """A junk layer in front of the pages, block tables shifted past it and
    ``scale_slot_base`` = its slots: bit-equal to the unshifted call, and
    equal to JAX's rebased call within the tolerance."""
    case, t = make_int8_case(1, STAGGERED)
    slots = case["kq"].shape[0]
    junk = np.full_like(case["kq"], 7)
    kq2 = np.concatenate([junk, case["kq"]])
    vq2 = np.concatenate([junk, case["vq"]])
    base = _port(case, None, False)
    got = _port(case, None, False, base=slots, bt_shift=slots // 8, kq=kq2,
                vq=vq2)
    np.testing.assert_array_equal(got, base)
    want = _jax(jax_ragged, case, None, False, base=slots,
                bt_shift=slots // 8, kq=kq2, vq=vq2, interpret=True)
    np.testing.assert_allclose(got[:t], want[:t], **TOL)


def test_wrapper_takes_plain_int8_version_on_cpu():
    case, t = make_int8_case(2, STAGGERED)
    before = ragged_paged_attention.launches
    got = ragged_paged_attention(
        *(torch.from_numpy(case[k]) for k in ("q", "kq", "vq", "bt",
                                              "rows3")),
        block_size=8, k_scales=torch.from_numpy(case["ks"]),
        v_scales=torch.from_numpy(case["vs"]))
    assert ragged_paged_attention.launches == before
    np.testing.assert_array_equal(got.numpy(), _port(case, None, False))


# ------------------------------------------------------------------ engine

SETTINGS = dict(block_size=4, num_blocks=128, max_num_seqs=8,
                max_num_batched_tokens=64, max_model_len=256,
                decode_batch_buckets=(1, 2, 4, 8), kv_cache_dtype="int8")


async def _serve(eng, reqs):
    async def one(r):
        toks = []
        async for out in eng.generate(r):
            toks.extend(out.token_ids)
        return toks

    try:
        return await asyncio.gather(*(one(r) for r in reqs))
    finally:
        await eng.close()


def _stored(events):
    return [[(b.block_hash, b.tokens_hash) for b in e.stored_blocks]
            for e in events if e.stored_blocks]


def test_int8_engine_matches_jax_int8_engine():
    """Greedy streams and KV stored-event hashes of the port's int8 engine
    equal the JAX int8 engine's: three concurrent requests, one of them
    long enough for chunked prefill beside decode rows."""
    jparams = M.init_params(JaxModelConfig.tiny(), jax.random.key(0))
    rng = np.random.default_rng(11)
    prompts = [list(map(int, rng.integers(1, 256, n))) for n in (70, 9, 23)]
    max_toks = (6, 8, 5)

    jev, tev = [], []
    jeng = AsyncJaxEngine(JaxModelConfig.tiny(),
                          JaxEngineArgs(prefill_buckets=(8, 16, 32, 64),
                                        **SETTINGS),
                          params=jparams, event_cb=jev.append)
    jout = asyncio.run(_serve(jeng, [
        JaxRequest(model="tiny", token_ids=p,
                   stop_conditions=JaxStop(max_tokens=m, ignore_eos=True))
        for p, m in zip(prompts, max_toks)]))
    teng = AsyncTorchEngine(
        ModelConfig.tiny(), EngineArgs(**SETTINGS),
        params=params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"),
        device="cpu", event_cb=tev.append)
    assert C.is_quant_cache(teng.k_cache)
    assert teng.k_cache["q"].dtype == torch.int8
    assert teng.k_cache["s"].shape == teng.k_cache["q"].shape[:-1]
    tout = asyncio.run(_serve(teng, [
        PreprocessedRequest(model="tiny", token_ids=p,
                            stop_conditions=StopConditions(
                                max_tokens=m, ignore_eos=True))
        for p, m in zip(prompts, max_toks)]))
    assert tout == jout
    assert [len(t) for t in tout] == list(max_toks)
    assert _stored(tev) and _stored(tev) == _stored(jev)
    # the pool really holds int8 pages of the served tokens
    assert bool(teng.k_cache["q"].any()) and bool(teng.k_cache["s"].any())


# ---------------------------------------------------------- sizing, config


def test_int8_block_bytes_and_pool_sizing(monkeypatch):
    cfg = ModelConfig.llama3_8b()
    bf16 = C.kv_block_bytes(cfg, 16, torch.bfloat16)
    int8 = C.kv_block_bytes(cfg, 16, torch.bfloat16, "int8")
    hd = cfg.head_dim
    assert int8 * 2 * hd == bf16 * (hd + 4)
    # 32 layers x 8 KV heads: 131072 vs 67584 bytes a token (K and V)
    assert (bf16 // 16, int8 // 16) == (131072, 67584)
    free = 40 << 30
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (free, 80 << 30))
    dev = torch.device("cuda")
    n_bf16 = C.memory_sized_num_blocks(cfg, 16, 0.6, dev, torch.bfloat16)
    n_int8 = C.memory_sized_num_blocks(cfg, 16, 0.6, dev, torch.bfloat16,
                                       "int8")
    assert n_bf16 == int(free * 0.6) // bf16
    assert n_int8 == int(free * 0.6) // int8
    assert 1.9 < n_int8 / n_bf16 < 1.95


def test_int8_cache_allocation_and_config():
    cfg = ModelConfig.tiny()
    k, v = C.allocate_device_cache(cfg, 8, 4, "cpu", torch.float32, "int8")
    assert C.is_quant_cache(k) and C.is_quant_cache(v)
    assert C.cache_shape(k) == (cfg.num_layers, 32, cfg.num_kv_heads,
                                cfg.head_dim)
    assert k["s"].shape == (cfg.num_layers, 32, cfg.num_kv_heads)
    plain, _ = C.allocate_device_cache(cfg, 8, 4, "cpu", torch.float32)
    assert not C.is_quant_cache(plain)
    for ok in (None, "auto", "int8"):
        assert EngineArgs(kv_cache_dtype=ok).kv_cache_dtype == ok
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        EngineArgs(kv_cache_dtype="fp8")


def test_kernel_check_refuses_int8_pages_without_scales():
    from dynamo_tpu_torch.ops.ragged_attention import _check

    case, _ = make_int8_case(3, STAGGERED)
    q, kq, vq, bt, rows3 = (torch.from_numpy(case[k]) for k in
                            ("q", "kq", "vq", "bt", "rows3"))
    ks, vs = torch.from_numpy(case["ks"]), torch.from_numpy(case["vs"])
    _check(q, kq, vq, bt, rows3, None, 0, ks, vs)
    with pytest.raises(ValueError, match="need both"):
        _check(q, kq, vq, bt, rows3, None, 0, None, None)
    with pytest.raises(ValueError, match="int8 caches only"):
        _check(q, q, q, bt, rows3, None, 0, ks, vs)
    with pytest.raises(ValueError, match="f32"):
        _check(q, kq, vq, bt, rows3, None, 0, ks.double(), vs)
