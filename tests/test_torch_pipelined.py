"""The port's depth-2 pipelined decode loop (``AsyncTorchEngine``), the
greedy cases of ``tests/test_pipelined_engine.py`` run on the port.

The pipelined loop launches step N+1 with step N's tokens fed on the
device before step N's tokens reach the host. It must change the order of
execution only: streams equal the serial loop's and the JAX engine's
(whose loop is pipelined by default), step N+1's dispatch precedes step
N's commit, cancellation and step failures drain the pipeline, and a
memory-starved engine still finishes every request.
"""

import asyncio
import dataclasses

import jax
import numpy as np
import pytest

from dynamo_tpu.engine import model as M
from dynamo_tpu.engine.config import EngineArgs as JaxEngineArgs
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import AsyncJaxEngine
from dynamo_tpu.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols import StopConditions as JaxStop
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.engine.weights import params_from_jax
from dynamo_tpu_torch.engine.scheduler import SeqState
from dynamo_tpu_torch.protocols import (
    FinishReason, OutputOptions, PreprocessedRequest, SamplingOptions,
    StopConditions,
)

pytestmark = pytest.mark.anyio

#: tests/test_pipelined_engine.py tiny_engine settings (the JAX engine also
#: takes prefill_buckets, which its ragged step does not read)
SETTINGS = dict(block_size=4, num_blocks=128, max_num_seqs=8,
                max_num_batched_tokens=64, max_model_len=256,
                decode_batch_buckets=(1, 2, 4, 8))
PROMPTS = [list(range(1, 20)), list(range(30, 45)), list(range(7, 18))]


def tiny_engine(params=None, **kw) -> AsyncTorchEngine:
    return AsyncTorchEngine(ModelConfig.tiny(), EngineArgs(**{**SETTINGS,
                                                              **kw}),
                            params=params, device="cpu")


def req(tokens, max_tokens=8) -> PreprocessedRequest:
    return PreprocessedRequest(
        model="tiny", token_ids=list(tokens),
        stop_conditions=StopConditions(max_tokens=max_tokens,
                                       ignore_eos=True))


async def collect(eng, r, ctx=None):
    toks, reason = [], None
    async for out in eng.generate(r, ctx):
        toks.extend(out.token_ids)
        if out.finish_reason is not None:
            reason = out.finish_reason
    return toks, reason


def _shared_params():
    jparams = M.init_params(JaxModelConfig.tiny(), jax.random.key(0))
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


async def test_pipelined_matches_serial():
    """Execution order only: the pipelined streams equal the serial loop's,
    per sequence, in order."""
    _, params = _shared_params()
    e_on = tiny_engine(params)
    e_off = tiny_engine(params, pipeline_decode=False)
    a = await asyncio.gather(*[collect(e_on, req(p, 12)) for p in PROMPTS])
    b = await asyncio.gather(*[collect(e_off, req(p, 12)) for p in PROMPTS])
    await e_on.close()
    await e_off.close()
    assert a == b
    assert all(len(t) == 12 and r == FinishReason.LENGTH for t, r in a)
    assert e_on.pipelined_steps > 0, "pipelined path never engaged"
    assert e_off.pipelined_steps == 0


async def test_pipelined_matches_jax_engine():
    """The port's pipelined streams equal the JAX engine's (pipelined by
    default) on the same weights."""
    jparams, params = _shared_params()
    eng = tiny_engine(params)
    got = await asyncio.gather(*[collect(eng, req(p, 12)) for p in PROMPTS])
    await eng.close()
    assert eng.pipelined_steps > 0

    jeng = AsyncJaxEngine(JaxModelConfig.tiny(),
                          JaxEngineArgs(prefill_buckets=(8, 16, 32, 64),
                                        **SETTINGS), params=jparams)

    async def jcollect(p):
        toks = []
        async for out in jeng.generate(JaxRequest(
                model="tiny", token_ids=p,
                stop_conditions=JaxStop(max_tokens=12, ignore_eos=True))):
            toks.extend(out.token_ids)
        return toks

    want = await asyncio.gather(*[jcollect(p) for p in PROMPTS])
    await jeng.close()
    assert jeng.pipelined_steps > 0
    assert [t for t, _ in got] == want


async def test_pipeline_dispatch_does_not_wait_on_commit():
    """Step N+1's dispatch happens BEFORE step N's commit, and commits land
    in dispatch order (per-sequence token order preserved)."""
    eng = tiny_engine()
    events = []
    orig_d = eng._dispatch_decode_step
    orig_c = eng._commit_decode_step

    async def d(seqs, feed=None):
        h = await orig_d(seqs, feed=feed)
        if h is not None:
            events.append(("dispatch", id(h)))
        return h

    async def c(h):
        events.append(("commit", id(h)))
        return await orig_c(h)

    eng._dispatch_decode_step = d
    eng._commit_decode_step = c
    toks, reason = await collect(eng, req(range(1, 10), max_tokens=8))
    await eng.close()
    assert len(toks) == 8 and reason == FinishReason.LENGTH
    dispatches = [i for i, (k, _) in enumerate(events) if k == "dispatch"]
    commits = [i for i, (k, _) in enumerate(events) if k == "commit"]
    assert len(dispatches) >= 2 and commits
    assert dispatches[1] < commits[0]
    assert ([h for k, h in events if k == "commit"]
            == [h for k, h in events if k == "dispatch"])


async def test_cancellation_mid_pipeline():
    """Cancelling one sequence mid-flight drains the pipeline, reaps the
    sequence, and leaves the other stream running to completion."""
    eng = tiny_engine()

    class Ctx:
        cancelled = False
        expired = False
        id = "cancel-me"

    ctx = Ctx()

    async def consume_then_cancel():
        n = 0
        async for out in eng.generate(req(range(1, 10), max_tokens=500),
                                      ctx):
            n += len(out.token_ids)
            if n >= 4:
                ctx.cancelled = True
        return n

    n1, (toks2, reason2) = await asyncio.wait_for(
        asyncio.gather(consume_then_cancel(),
                       collect(eng, req(range(30, 40), max_tokens=12))),
        timeout=60)
    await eng.close()
    assert n1 < 500
    assert len(toks2) == 12 and reason2 == FinishReason.LENGTH
    assert eng.pipelined_steps > 0
    assert eng.pool.num_active_blocks == 0


async def test_step_exception_fails_all_inflight_then_recovers():
    """A step failure with a pipelined step in flight fails EVERY in-flight
    sequence (no hung consumer) and leaves the engine serving."""
    eng = tiny_engine()
    calls = {"n": 0}
    real = eng.step_fn

    def boom(*a):
        calls["n"] += 1
        if calls["n"] == 4:  # past prefill + the first pipelined launches
            raise RuntimeError("injected step failure")
        return real(*a)

    eng.step_fn = boom
    results = await asyncio.wait_for(asyncio.gather(
        collect(eng, req(range(1, 12), max_tokens=50)),
        collect(eng, req(range(20, 33), max_tokens=50))), timeout=60)
    assert all(r == FinishReason.ERROR for _, r in results)
    assert eng.pipelined_steps > 0
    toks, reason = await collect(eng, req(range(40, 50), max_tokens=5))
    await eng.close()
    assert len(toks) == 5 and reason == FinishReason.LENGTH


async def test_pipeline_feature_gates():
    """The serial loop runs when the knob is off, while a sequence is still
    in prefill, or while a request waits for admission; streams stay
    correct either way."""
    eng = tiny_engine(pipeline_decode=False)
    toks, reason = await collect(eng, req(range(1, 12), max_tokens=6))
    await eng.close()
    assert len(toks) == 6 and reason == FinishReason.LENGTH
    assert eng.pipelined_steps == 0

    eng = tiny_engine()
    seqs = [SeqState(request_id=f"s{i}", req=req(range(1, 5)), ctx=None,
                     sink=None) for i in range(2)]
    eng.scheduler.running = list(seqs)
    assert eng._can_pipeline(seqs)
    assert not eng._can_pipeline(seqs[:1])  # one is mid-prefill
    # a row that needs the host between its draw and its emission keeps
    # the batch on the serial loop
    for needs_host in (dict(output_options=OutputOptions(logprobs=1)),
                       dict(sampling_options=SamplingOptions(
                           logit_bias={"3": 1.0})),
                       dict(sampling_options=SamplingOptions(
                           presence_penalty=0.5))):
        seqs[1].req = dataclasses.replace(req(range(1, 5)), **needs_host)
        assert not eng._can_pipeline(seqs)
    seqs[1].req = req(range(1, 5))
    eng.scheduler.waiting.append(type("S", (), {"tenant": "t",
                                                "priority": "standard"})())
    assert not eng._can_pipeline(seqs)


async def test_block_free_sets_engine_wake():
    eng = tiny_engine()
    ids = eng.pool.allocate(2)
    eng._wake.clear()
    eng.pool.release(ids)
    assert eng._wake.is_set()
    await eng.close()


async def test_starved_engine_makes_progress():
    """Far fewer blocks than the concurrent demand: every sequence still
    completes (pipelined allocation failure drains into plan(), which
    preempts)."""
    eng = tiny_engine(num_blocks=14, max_num_seqs=4,
                      max_num_batched_tokens=16, max_model_len=64,
                      decode_batch_buckets=(1, 2, 4))

    async def one(seed):
        prompt = [1 + (seed * 11 + i) % 200 for i in range(12)]
        return await collect(eng, req(prompt, max_tokens=6))

    results = await asyncio.wait_for(
        asyncio.gather(*(one(i) for i in range(4))), timeout=120)
    await eng.close()
    assert all(len(t) == 6 for t, _ in results)
