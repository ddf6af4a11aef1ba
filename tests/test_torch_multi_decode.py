"""The multi-step decode burst of the torch port against the JAX package's.

- ``make_multi_decode_fn`` (K = 3, the packed ragged layout) against JAX
  ``make_multi_decode_fn(ragged=True)`` on the tiny Llama and on
  ``mla_tiny``, a greedy row and a seeded row after a prefill of both
  (the rows of ``tests/test_ragged.py``'s burst test), identical weights
  from the port's ``init_params``: tokens equal, logps within 1e-5.
- ``AsyncTorchEngine(multi_step_decode=4)`` against the K = 1 engine and
  the JAX burst engine: greedy, seeded and top-k streams of 11 tokens
  (so the last burst ends mid-way and drops its overshoot), one output
  frame a burst; a constrained burst on the device FSM against the host
  oracle; penalty rows take the single step.
"""

import asyncio
import re

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
from dynamo_tpu.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols import SamplingOptions as JaxSampling
from dynamo_tpu.protocols import StopConditions as JaxStop
from dynamo_tpu_torch.engine import model as TM
from dynamo_tpu_torch.engine import sampling
from dynamo_tpu_torch.engine.cache import allocate_device_cache
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine, ragged_grid_shape
from dynamo_tpu_torch.engine.weights import params_from_jax
from dynamo_tpu_torch.models import get_model_config
from dynamo_tpu_torch.protocols import (
    PreprocessedRequest, SamplingOptions, StopConditions,
)

BS, W, K = 4, 8, 3
#: two prompts (prefilled), then a burst from a newest token each
PROMPTS = [[5, 9, 17, 23, 42], [7, 11, 13]]
BT = np.stack([np.arange(1 + W * b, 1 + W * (b + 1)) for b in range(2)]
              ).astype(np.int32)


def _configs(name):
    if name == "tiny":
        return ModelConfig.tiny(), JaxModelConfig.tiny()
    return get_model_config(name), jax_preset(name)


def _prefill_operands():
    """Both prompts as one packed ragged step (T 8, R 2) with its chunk
    grid, the engine's packing."""
    T, R = 8, 2
    C, S_C = ragged_grid_shape(T)
    ints5 = np.zeros((5, T), np.int32)
    ints5[3] = C
    rows3 = np.zeros((R, 3), np.int32)
    grid_rows = np.zeros((C,), np.int32)
    t = tile = 0
    for i, row in enumerate(PROMPTS):
        n = len(row)
        ints5[0, t:t + n] = row
        ints5[1, t:t + n] = np.arange(n)
        ints5[2, t:t + n] = [BT[i, p // BS] * BS + p % BS for p in range(n)]
        for off in range(0, n, S_C):
            w = min(S_C, n - off)
            grid_rows[tile] = i
            ints5[3, t + off:t + off + w] = tile
            ints5[4, t + off:t + off + w] = np.arange(w)
            tile += 1
        rows3[i] = (t, n, n)
        t += n
    return ints5, rows3, grid_rows


@pytest.mark.parametrize("name", ["tiny", "mla_tiny"])
def test_multi_decode_fn_matches_jax(name):
    cfg, jcfg = _configs(name)
    tp = TM.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    nb = 2 * W + 2
    tk, tv = allocate_device_cache(cfg, nb, BS, "cpu", torch.float32)
    jk, jv = jax_cache(jcfg, nb, BS, dtype=jnp.float32)
    ops = _prefill_operands()
    TM.make_ragged_step_fn(cfg, BS)(
        tp, *(torch.from_numpy(a) for a in ops), torch.from_numpy(BT),
        tk, tv)
    _, jk, jv = M.make_ragged_step_fn(jcfg, BS)(
        jp, *(jnp.asarray(a) for a in ops), jnp.asarray(BT), jk, jv)

    # the newest token of each row at position n (its KV not yet written):
    # row 0 greedy, row 1 seeded
    ints = np.zeros((2, 4), np.int32)
    floats = np.zeros((2, 2), np.float32)
    rand = np.zeros((2, 2), np.uint32)
    for b, row in enumerate(PROMPTS):
        n = len(row)
        ints[b] = (61 + b, n, n + 1, 0)
        floats[b] = (0.8 if b else 0.0, 1.0)
        rand[b] = (b + 1, 0)
    jt, jl, _, _ = M.make_multi_decode_fn(jcfg, BS, num_steps=K, ragged=True)(
        jp, jnp.asarray(ints), jnp.asarray(floats), jnp.asarray(rand),
        jnp.asarray(BT), jk, jv)

    temp, top_k, top_p = floats[:, 0], ints[:, 3], floats[:, 1]
    rows = sampling.pack_rows(temp, top_k, top_p, rand)
    tt, tl = TM.make_multi_decode_fn(cfg, BS, K)(
        tp, torch.from_numpy(np.ascontiguousarray(ints[:, :3].T)),
        torch.from_numpy(rows), torch.from_numpy(BT), tk, tv,
        (temp, top_k, top_p))
    assert tt.shape == (K, 2) and tl.shape == (K, 2)
    assert tt.tolist() == np.asarray(jt).tolist()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=0)


# ------------------------------------------------------------ engine level

#: tests/test_engine.py's tiny_engine settings
SETTINGS = dict(block_size=4, num_blocks=128, max_num_seqs=8,
                max_num_batched_tokens=64, max_model_len=256)
#: greedy, seeded, and seeded top-k (tests/test_engine.py's burst cases)
CASES = [(list(range(1, 20)), {}),
         (list(range(5, 40)), {"temperature": 0.8, "seed": 7}),
         (list(range(2, 17)), {"temperature": 0.9, "top_k": 20, "seed": 3})]


async def _serve(eng, reqs):
    async def one(r):
        toks, frames, reason = [], 0, None
        async for out in eng.generate(r):
            toks.extend(out.token_ids)
            frames += 1
            reason = out.finish_reason or reason
        return toks, reason, frames

    try:
        return await asyncio.gather(*(one(r) for r in reqs))
    finally:
        await eng.close()


def _reqs(kind, max_tokens=11):
    Req, Samp, Stop = ((JaxRequest, JaxSampling, JaxStop) if kind == "jax"
                       else (PreprocessedRequest, SamplingOptions,
                             StopConditions))
    return [Req(model="tiny", token_ids=p, sampling_options=Samp(**o),
                stop_conditions=Stop(max_tokens=max_tokens,
                                     ignore_eos=True))
            for p, o in CASES]


def test_burst_streams_equal_single_step_and_jax():
    jparams = M.init_params(JaxModelConfig.tiny(), jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")

    def engine(k):
        return AsyncTorchEngine(ModelConfig.tiny(), EngineArgs(
            multi_step_decode=k, **SETTINGS), params=params, device="cpu")

    single = asyncio.run(_serve(engine(1), _reqs("torch")))
    burst_eng = engine(4)
    burst = asyncio.run(_serve(burst_eng, _reqs("torch")))
    jeng = AsyncJaxEngine(JaxModelConfig.tiny(), JaxEngineArgs(
        multi_step_decode=4, prefill_buckets=(8, 16, 32, 64), **SETTINGS),
        params=jparams)
    jax_burst = asyncio.run(_serve(jeng, _reqs("jax")))
    assert [t for t, _, _ in burst] == [t for t, _, _ in single]
    assert [t for t, _, _ in burst] == [t for t, _, _ in jax_burst]
    assert all(len(t) == 11 and r == "length" for t, r, _ in burst)
    # one frame a step on the single-step engine; on the burst engine one
    # a burst (the last one's overshoot dropped), a few more where a row
    # decoded beside another's prefill chunks
    assert [f for _, _, f in single] == [11, 11, 11]
    assert all(f <= 6 for _, _, f in burst), burst
    assert burst_eng.bursts >= 3
    assert {k for k in burst_eng.compiled_signatures
            if k[0].startswith("multi")} == {("multi", 8)}
    assert burst_eng.pipelined_steps == 0


GUIDED_VOCAB = [""] + [chr(32 + i) for i in range(255)]


def test_constrained_burst_on_device_fsm_equals_host_oracle():
    """Constrained rows mask and advance inside the burst (greedy and
    seeded): the streams equal the host oracle's single steps, and the
    burst stayed fused (multi_fsm)."""
    def engine(params=None, **kw):
        return AsyncTorchEngine(ModelConfig.tiny(), EngineArgs(
            block_size=16, num_blocks=64, max_num_seqs=4,
            max_num_batched_tokens=128, max_model_len=128, **kw),
            params=params, device="cpu", guided_vocab=GUIDED_VOCAB)

    def reqs():
        return [PreprocessedRequest(
            model="t", token_ids=[1, 2, 3],
            sampling_options=SamplingOptions(temperature=temp, seed=seed,
                                             guided=g),
            stop_conditions=StopConditions(max_tokens=24),
            eos_token_ids=[2])
            for g in ({"regex": r"[ab]{6}"}, {"choice": ["apple", "banana"]})
            for seed, temp in ((None, 0.0), (11, 0.8))]

    multi = engine(multi_step_decode=4)
    host = engine(params=multi.params, structured_device=False)
    a = asyncio.run(_serve(multi, reqs()))
    b = asyncio.run(_serve(host, reqs()))
    assert [t for t, _, _ in a] == [t for t, _, _ in b]
    assert all(r == "stop" for _, r, _ in a)
    txt = "".join(GUIDED_VOCAB[t] for t in a[0][0] if t != 2)
    assert re.fullmatch(r"[ab]{6}", txt), txt
    assert {k[0] for k in multi.compiled_signatures
            if k[0].startswith("multi")} == {"multi_fsm"}
    assert multi.bursts > 0


def test_penalty_rows_take_the_single_step():
    """A presence penalty needs the host's history every step: the burst
    engine serves it one step at a time, and an overwhelming penalty makes
    every generated token distinct (tests/test_penalties.py)."""
    eng = AsyncTorchEngine(ModelConfig.tiny(), EngineArgs(
        block_size=16, num_blocks=64, max_num_seqs=4,
        max_num_batched_tokens=128, max_model_len=128, multi_step_decode=4),
        device="cpu")

    def req(penalty):
        return PreprocessedRequest(
            model="tiny", token_ids=[1, 2, 3, 4],
            sampling_options=SamplingOptions(temperature=0.0,
                                             presence_penalty=penalty),
            stop_conditions=StopConditions(max_tokens=12, ignore_eos=True))

    async def run():
        try:
            return ((await _serve_one(eng, req(100.0))), eng.bursts,
                    (await _serve_one(eng, req(0.0))))
        finally:
            await eng.close()

    toks, bursts, base = asyncio.run(run())
    assert len(toks) == 12 and len(set(toks)) == len(toks), toks
    assert bursts == 0
    assert len(set(base)) < len(base), "the tiny greedy model repeats"
    assert eng.bursts > 0  # the unpenalised request took the burst


async def _serve_one(eng, r):
    toks = []
    async for out in eng.generate(r):
        toks.extend(out.token_ids)
    return toks
