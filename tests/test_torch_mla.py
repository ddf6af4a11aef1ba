"""The torch port's MLA (DeepSeek) path against the JAX package's.

- One MLA + MoE ragged step pair (two prefill chunks in one launch, then a
  decode row beside a chunk, or two decode rows with no chunk grid) on ``mla_tiny`` (q compression, sigmoid +
  group-limited routing) and on a DeepSeek-V2-Lite-shaped tiny config (no q
  compression, softmax routing, ``norm_topk_prob`` off, two shared
  experts), identical weights from ``params_from_jax``: logits and caches
  within atol 1e-4 (f32; matmul and reduction orders differ).
- ``AsyncTorchEngine`` against ``AsyncJaxEngine`` on ``mla_tiny``: greedy
  streams and KV-event hashes equal.
- ``mla_paged_decode_ref`` against the Pallas ``mla_paged_decode`` in
  interpret mode (R = PR = 128, a kv_len 0 row), atol 1e-5.
- ``make_forward_fn`` with S == 1 against JAX ``forward(use_pallas=True)``
  on a lane-aligned MLA config (the Pallas latent decode, interpret mode).
- Presets, latent pool sizing, the MLA paths that need the MLA kernels
  (S > 1, embeddings, int8 latents), and the card's geometry check.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import model as M
from dynamo_tpu.engine.cache import allocate_device_cache as jax_cache
from dynamo_tpu.engine.config import EngineArgs as JaxEngineArgs
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import AsyncJaxEngine
from dynamo_tpu.models import get_model_config as jax_preset
from dynamo_tpu.ops.paged_attention import mla_paged_decode as jax_mla_decode
from dynamo_tpu.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols import StopConditions as JaxStop
from dynamo_tpu_torch.engine import model as TM
from dynamo_tpu_torch.engine.cache import (
    allocate_device_cache, kv_block_bytes,
)
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.engine.weights import params_from_jax
from dynamo_tpu_torch.models import get_model_config
from dynamo_tpu_torch.ops.mla_decode import mla_paged_decode_ref
from dynamo_tpu_torch.protocols import PreprocessedRequest, StopConditions

#: DeepSeek-V2-Lite's switches at test widths
V2_LITE_TINY = dict(
    vocab_size=128, hidden_size=64, intermediate_size=96, num_layers=3,
    num_heads=4, num_kv_heads=4, dtype="float32",
    max_position_embeddings=256, kv_lora_rank=32, q_lora_rank=None,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    num_experts=8, num_experts_per_tok=3, moe_intermediate_size=32,
    n_shared_experts=2, first_k_dense_replace=1, scoring_func="softmax",
    norm_topk_prob=False, routed_scaling_factor=1.0)
#: lane-aligned MLA (the Pallas latent decode's geometry), as in
#: tests/test_mla.py
LANE_MLA = dict(
    vocab_size=128, hidden_size=64, intermediate_size=96, num_layers=2,
    num_heads=4, num_kv_heads=4, dtype="float32",
    max_position_embeddings=256, kv_lora_rank=128, q_lora_rank=None,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)


def _configs(name):
    if name == "mla_tiny":
        return get_model_config(name), jax_preset(name)
    fields = V2_LITE_TINY if name == "v2_lite_tiny" else LANE_MLA
    return ModelConfig(**fields), JaxModelConfig(**fields)


def _params(jcfg, seed):
    jp = M.init_params(jcfg, jax.random.key(seed))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _to_torch(a):
    return torch.from_numpy(np.array(a))


BS, W, T, R = 4, 8, 16, 4
#: two sequences' tokens and block tables
ROWS = [[5, 9, 17, 23, 42, 77, 101, 3], [7, 11, 13]]
BT = np.zeros((R, W), np.int32)
BT[0], BT[1] = np.arange(1, 9), np.arange(9, 17)
#: two prefill chunks in one launch, then a decode row beside a chunk
STEPS = ([(0, ROWS[0], list(range(8))), (1, ROWS[1], list(range(3)))],
         [(0, [54], [8]), (1, [15, 16], [3, 4])])


def _pack(work):
    """(row, tokens, positions) per row, padded to T tokens and R rows (one
    compiled bucket for every launch), with the engine's chunk grid."""
    C, S_C = M.ragged_grid_shape(T)
    ints5 = np.zeros((5, T), np.int32)
    ints5[3] = C
    rows3 = np.zeros((R, 3), np.int32)
    grid_rows = np.zeros((C,), np.int32)
    t = tile = 0
    for i, (b, toks, poss) in enumerate(work):
        q = len(toks)
        rows3[i] = (t, q, poss[-1] + 1)
        ints5[0, t:t + q] = toks
        ints5[1, t:t + q] = poss
        ints5[2, t:t + q] = [int(BT[b, p // BS]) * BS + p % BS for p in poss]
        if q > 1:
            for off in range(0, q, S_C):
                w = min(S_C, q - off)
                grid_rows[tile] = i
                ints5[3, t + off:t + off + w] = tile
                ints5[4, t + off:t + off + w] = np.arange(w)
                tile += 1
        t += q
    return ints5, rows3, grid_rows


def _steps(name, steps, decode_only_grid=False):
    """The steps through the JAX ragged step and the port's on identical
    weights; yields both logits and caches after each. With
    ``decode_only_grid``, a step without chunks passes the port no grid
    (``grid_rows`` None), as the engine does."""
    cfg, jcfg = _configs(name)
    jp, tp = _params(jcfg, 3)
    jfn = M.make_ragged_step_fn(jcfg, BS)
    tfn = TM.make_ragged_step_fn(cfg, BS)
    jk, jv = jax_cache(jcfg, 18, BS, dtype=jnp.float32)
    tk, tv = allocate_device_cache(cfg, 18, BS, "cpu", torch.float32)
    assert tk.shape == jk.shape and tv.shape == jv.shape
    for work in steps:
        ops = _pack(work)
        jl, jk, jv = jfn(jp, *(jnp.asarray(a) for a in ops), jnp.asarray(BT),
                         jk, jv)
        tops = [torch.from_numpy(a) for a in ops]
        if decode_only_grid and all(len(toks) == 1 for _, toks, _ in work):
            tops[2] = None
        tl, tk2, tv2 = tfn(tp, *tops, torch.from_numpy(BT), tk, tv)
        assert tk2 is tk and tv2 is tv  # updated in place
        yield (tl, tk, tv), (jl, jk, jv)


def _assert_step_close(got, want):
    (tl, tk, tv), (jl, jk, jv) = got, want
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                               atol=1e-4, rtol=1e-4)
    # the null block excepted: padding tokens write into it
    for g, w in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(g.numpy()[:, BS:], np.asarray(w)[:, BS:],
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["mla_tiny", "v2_lite_tiny"])
def test_mla_ragged_step_matches_jax(name):
    for got, want in _steps(name, STEPS):
        _assert_step_close(got, want)


@pytest.mark.parametrize("name", ["mla_tiny", "v2_lite_tiny"])
def test_mla_decode_only_step_without_grid_matches_jax(name):
    """A step of decode rows only, which the engine runs with no chunk grid
    (the port skips its chunk walk), against the JAX step with its grid."""
    steps = STEPS[:1] + ([(0, [54], [8]), (1, [15], [3])],)
    for got, want in _steps(name, steps, decode_only_grid=True):
        _assert_step_close(got, want)


def test_mla_engine_streams_match_jax_engine():
    """mirrors tests/test_mla.py::test_mla_engine_generate across engines"""
    settings = dict(block_size=4, num_blocks=64, max_num_seqs=4,
                    max_num_batched_tokens=32, max_model_len=128,
                    decode_batch_buckets=(1, 2, 4))
    jp, tp = _params(jax_preset("mla_tiny"), 0)
    rng = np.random.default_rng(11)
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
    jeng = AsyncJaxEngine(jax_preset("mla_tiny"),
                          JaxEngineArgs(prefill_buckets=(8, 16, 32),
                                        **settings),
                          params=jp, event_cb=jev.append)
    jout = asyncio.run(serve(jeng, [
        JaxRequest(model="mla", token_ids=p,
                   stop_conditions=JaxStop(max_tokens=m, ignore_eos=True))
        for p, m in zip(prompts, max_toks)]))
    teng = AsyncTorchEngine(get_model_config("mla_tiny"),
                            EngineArgs(**settings), params=tp, device="cpu",
                            event_cb=tev.append)
    tout = asyncio.run(serve(teng, [
        PreprocessedRequest(model="mla", token_ids=p,
                            stop_conditions=StopConditions(
                                max_tokens=m, ignore_eos=True))
        for p, m in zip(prompts, max_toks)]))
    assert tout == jout
    assert [len(t) for t in tout] == list(max_toks)
    assert stored(tev) and stored(tev) == stored(jev)


def test_mla_decode_ref_matches_pallas():
    rng = np.random.default_rng(5)
    B, H, R, PR, bs, nb = 3, 4, 128, 128, 8, 24
    q_eff = rng.standard_normal((B, H, R), np.float32)
    q_rot = rng.standard_normal((B, H, PR), np.float32)
    q_rot[..., 64:] = 0  # the rope part is zero-padded, as in the engine
    lat = rng.standard_normal((nb * bs, R), np.float32)
    rope = rng.standard_normal((nb * bs, PR), np.float32)
    rope[:, 64:] = 0
    kv_lens = np.asarray([37, 0, 8], np.int32)  # a kv_len 0 row, one page
    bt = np.zeros((B, 6), np.int32)
    bt[0, :5] = rng.choice(np.arange(1, nb), 5, replace=False)
    bt[2, 0] = 3
    kw = dict(block_size=bs, scale=0.0625)
    want = np.asarray(jax_mla_decode(
        *(jnp.asarray(a) for a in (q_eff, q_rot, lat, rope, bt, kv_lens)),
        interpret=True, **kw))
    got = mla_paged_decode_ref(*(torch.from_numpy(a) for a in (
        q_eff, q_rot, lat, rope, bt, kv_lens)), **kw)
    assert got.dtype == torch.float32 and got.shape == (B, H, R)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert not got[1].any()  # kv_len 0: zeros


def test_mla_forward_s1_matches_jax():
    """mirrors tests/test_mla.py::test_mla_pallas_decode_matches_xla: a
    9-token prefill through the JAX forward, then one decode step through
    both packages (JAX: the Pallas latent decode in interpret mode)."""
    cfg, jcfg = _configs("lane_mla")
    jp, tp = _params(jcfg, 3)
    bs, nb = 4, 8
    bt = np.asarray([[1, 2, 3, 4]], np.int32)
    n = 9
    toks = np.asarray([[5, 9, 17, 23, 42, 77, 101, 3, 54]], np.int32)
    pos = np.arange(n, dtype=np.int32)[None]
    slot = (bt[0, pos // bs] * bs + pos % bs).astype(np.int32)
    kc, vc = jax_cache(jcfg, nb, bs, dtype=jnp.float32)
    _, kc, vc = M.forward(jp, jnp.asarray(toks), jnp.asarray(pos),
                          jnp.asarray(slot), jnp.asarray(bt),
                          jnp.asarray([n], jnp.int32),
                          jnp.asarray([n - 1], jnp.int32), kc, vc,
                          cfg=jcfg, block_size=bs)
    tk, tv = _to_torch(kc), _to_torch(vc)
    step = [np.asarray([[61]], np.int32), np.asarray([[9]], np.int32),
            np.asarray([[int(bt[0, 2]) * bs + 1]], np.int32), bt,
            np.asarray([10], np.int32), np.asarray([0], np.int32)]
    jl, jk, jv = M.forward(jp, *(jnp.asarray(a) for a in step), kc, vc,
                           cfg=jcfg, block_size=bs, use_pallas=True)
    tl, _, _ = TM.make_forward_fn(cfg, bs)(
        tp, *(torch.from_numpy(a) for a in step), tk, tv)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)


@pytest.mark.parametrize("name", ["mla_tiny", "deepseek_v2_lite"])
def test_mla_presets_match_jax(name):
    cfg, jcfg = get_model_config(name), jax_preset(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for prop in ("qk_head_dim", "rope_cache_dim", "moe_ffn_size",
                 "num_dense_prefix_layers", "kv_cache_spec"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop


def test_latent_pool_sizing():
    """An MLA block holds the latent and the padded rope part per layer
    and slot, not KV x head_dim twice."""
    cfg = get_model_config("deepseek_v2_lite")
    assert cfg.kv_cache_spec == ((1, 512), (1, 128))
    assert kv_block_bytes(cfg, 16, torch.bfloat16) == 27 * 16 * 640 * 2
    tiny = get_model_config("mla_tiny")
    kc, vc = allocate_device_cache(tiny, 5, 4, "cpu", torch.float32)
    assert kc.shape == (3, 20, 1, 32) and vc.shape == (3, 20, 1, 128)
    assert kv_block_bytes(tiny, 4, torch.float32) == (
        kc[:, :4].numel() + vc[:, :4].numel()) * 4
    q, _ = allocate_device_cache(tiny, 5, 4, "cpu", torch.float32, "int8")
    assert q["q"].shape == (3, 20, 1, 32) and q["s"].shape == (3, 20, 1)


def test_mla_refusals():
    """The MLA paths that need the MLA kernels serve on the CPU (the forward
    with S > 1, embeddings, an int8 latent pool); the card's kernel
    geometry is checked when an engine is built."""
    cfg = get_model_config("mla_tiny")
    tp = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    fwd = TM.make_forward_fn(cfg, 4)
    kc, vc = allocate_device_cache(cfg, 4, 4, "cpu", torch.float32)
    toks = torch.tensor([[5, 9]], dtype=torch.int32)
    pos = torch.tensor([[0, 1]], dtype=torch.int32)
    logits, _, _ = fwd(tp, toks, pos, pos + 4, torch.tensor(
        [[1]], dtype=torch.int32), torch.tensor([2], dtype=torch.int32),
        torch.tensor([1], dtype=torch.int32), kc, vc)
    assert logits.shape == (1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    args = EngineArgs(block_size=4, num_blocks=16, max_num_seqs=2,
                      max_num_batched_tokens=16, max_model_len=32)
    eng8 = AsyncTorchEngine(cfg, dataclasses.replace(
        args, kv_cache_dtype="int8"), params=tp, device="cpu")
    assert eng8.k_cache["q"].dtype == torch.int8
    assert eng8.v_cache["s"].shape == (cfg.num_layers, 16 * 4, 1)
    eng = AsyncTorchEngine(cfg, args, params=tp, device="cpu")
    (vec,) = asyncio.run(eng.embed([[1, 2, 3]]))
    assert len(vec) == cfg.hidden_size
    assert abs(float(np.linalg.norm(vec)) - 1.0) < 1e-5
    # the card's kernel geometry: 16-head tiles, 64-wide latent and rope
    with pytest.raises(ValueError, match="multiple of 16"):
        TM.check_kernel_geometry(cfg)
    TM.check_kernel_geometry(get_model_config("deepseek_v2_lite"))
