"""AsyncTorchEngine against AsyncJaxEngine on the CPU.

Both engines serve the same tiny model (the JAX package's random init,
carried over with ``params_from_jax``) under the JAX engine tests'
``tiny_engine`` settings, with four concurrent greedy requests of mixed
lengths whose prompts need chunked prefill. Greedy streams must be
identical token for token, and so must the KV stored events' block hashes.
"""

import asyncio

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import model as M
from dynamo_tpu.engine.config import EngineArgs as JaxEngineArgs
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import AsyncJaxEngine
from dynamo_tpu.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols import StopConditions as JaxStop
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.engine.weights import params_from_jax
from dynamo_tpu_torch.protocols import (
    FinishReason, OutputOptions, PreprocessedRequest, SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime.context import Context

pytestmark = pytest.mark.anyio

#: tests/test_engine.py tiny_engine settings (the JAX engine also takes
#: prefill_buckets, which its ragged step does not read)
SETTINGS = dict(block_size=4, num_blocks=128, max_num_seqs=8,
                max_num_batched_tokens=64, max_model_len=256,
                decode_batch_buckets=(1, 2, 4, 8))


def _prompts():
    rng = np.random.default_rng(7)
    return [list(map(int, rng.integers(1, 256, n))) for n in (41, 9, 30, 17)]


async def _serve(eng, reqs):
    async def one(r):
        toks, reason = [], None
        async for out in eng.generate(r):
            toks.extend(out.token_ids)
            reason = out.finish_reason or reason
        return toks, reason

    try:
        return await asyncio.gather(*(one(r) for r in reqs))
    finally:
        await eng.close()


def _stored(events):
    return [[(b.block_hash, b.tokens_hash) for b in e.stored_blocks]
            for e in events if e.stored_blocks]


async def test_streams_and_kv_events_match_jax_engine():
    jparams = M.init_params(JaxModelConfig.tiny(), jax.random.key(0))
    max_toks = (8, 5, 7, 6)

    jev = []
    jeng = AsyncJaxEngine(JaxModelConfig.tiny(),
                          JaxEngineArgs(prefill_buckets=(8, 16, 32, 64),
                                        **SETTINGS),
                          params=jparams, event_cb=jev.append)
    jout = await _serve(jeng, [
        JaxRequest(model="tiny", token_ids=p,
                   stop_conditions=JaxStop(max_tokens=m, ignore_eos=True))
        for p, m in zip(_prompts(), max_toks)])

    tev = []
    teng = AsyncTorchEngine(
        ModelConfig.tiny(), EngineArgs(**SETTINGS),
        params=params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"),
        device="cpu", event_cb=tev.append)
    mixed = []
    plan = teng.scheduler.plan

    def spy():
        p = plan()
        mixed.append(bool(p.prefill and p.decode))
        return p

    teng.scheduler.plan = spy
    tout = await _serve(teng, [
        PreprocessedRequest(model="tiny", token_ids=p,
                            stop_conditions=StopConditions(
                                max_tokens=m, ignore_eos=True))
        for p, m in zip(_prompts(), max_toks)])

    assert [t for t, _ in tout] == [t for t, _ in jout]
    assert [len(t) for t, _ in tout] == list(max_toks)
    assert all(r == FinishReason.LENGTH for _, r in tout)
    assert _stored(tev) and _stored(tev) == _stored(jev)
    # some step packed prefill chunks and decode rows together
    assert any(mixed)


def _guided_vocab():
    """The test tokenizer's words: the guided case's alphabet (ids past it
    are never constraint-eligible)."""
    from dynamo_tpu_torch.llm.tokenizer import wordlevel_test_vocab
    return wordlevel_test_vocab()


@pytest.mark.parametrize("sampling,output", [
    (SamplingOptions(temperature=0.7, seed=5), None),
    (SamplingOptions(top_k=5, temperature=0.9, seed=1), None),
    (SamplingOptions(top_p=0.9, temperature=1.2, seed=2), None),
    (SamplingOptions(seed=3), None),
    (SamplingOptions(presence_penalty=0.5), None),
    (SamplingOptions(logit_bias={"3": 1.0}), None),
    (SamplingOptions(guided={"choice": ["a"]}), None),
    (SamplingOptions(), OutputOptions(logprobs=2)),
])
async def test_non_greedy_request_refused(sampling, output):
    """The name is from when the port refused these requests. They are
    served now, and each stream (tokens, logprobs, top logprobs, finish)
    equals the JAX engine's on the same weights; the guided case on both
    engines' guided alphabet of the test tokenizer."""
    from dynamo_tpu.protocols import OutputOptions as JaxOutput
    from dynamo_tpu.protocols import SamplingOptions as JaxSampling

    jparams = M.init_params(JaxModelConfig.tiny(), jax.random.key(0))
    vocab = _guided_vocab()

    async def one(eng, req):
        toks, lps, tops, reason = [], [], [], None
        async for out in eng.generate(req):
            toks.extend(out.token_ids)
            lps.extend(out.log_probs or [])
            tops.extend(out.top_logprobs or [])
            reason = out.finish_reason or reason
        await eng.close()
        return toks, lps, tops, reason

    jeng = AsyncJaxEngine(JaxModelConfig.tiny(),
                          JaxEngineArgs(prefill_buckets=(8, 16, 32, 64),
                                        **SETTINGS),
                          params=jparams, guided_vocab=vocab)
    want = await one(jeng, JaxRequest(
        model="tiny", token_ids=[1, 2, 3],
        sampling_options=JaxSampling(**vars(sampling)),
        output_options=JaxOutput(**vars(output or OutputOptions())),
        stop_conditions=JaxStop(max_tokens=6, ignore_eos=True)))
    eng = AsyncTorchEngine(
        ModelConfig.tiny(), EngineArgs(**SETTINGS),
        params=params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"),
        device="cpu", guided_vocab=vocab)
    got = await one(eng, PreprocessedRequest(
        model="tiny", token_ids=[1, 2, 3], sampling_options=sampling,
        output_options=output or OutputOptions(),
        stop_conditions=StopConditions(max_tokens=6, ignore_eos=True)))
    assert got[0] == want[0] and got[3] == want[3]
    np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=0)
    assert [[i for i, _ in t] for t in got[2]] == \
        [[i for i, _ in t] for t in want[2]]
    if sampling.guided:
        assert got[0] == [vocab.index("a")] and got[3] == FinishReason.STOP


async def test_multimodal_request_refused():
    """The one refusal left: multimodal input (ROADMAP A9)."""
    eng = AsyncTorchEngine(ModelConfig.tiny(), EngineArgs(**SETTINGS),
                           device="cpu")
    req = PreprocessedRequest(model="tiny", token_ids=[1, 2, 3],
                              mm_embeds=[[0.0] * 64])
    with pytest.raises(ValueError, match="ROADMAP A9"):
        async for _ in eng.generate(req):
            pass
    await eng.close()


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AsyncTorchEngine(ModelConfig.tiny(), EngineArgs(**SETTINGS))


def test_cpu_pool_needs_explicit_size():
    with pytest.raises(ValueError, match="num_blocks"):
        AsyncTorchEngine(ModelConfig.tiny(),
                         EngineArgs(**{**SETTINGS, "num_blocks": None}),
                         device="cpu")


async def test_cancel_mid_stream_frees_blocks_and_reports_metrics():
    """A cancelled Context ends the stream at the next plan and returns the
    sequence's blocks; each step reports load through metrics_cb."""
    metrics = []
    eng = AsyncTorchEngine(ModelConfig.tiny(), EngineArgs(**SETTINGS),
                           device="cpu", metrics_cb=metrics.append)
    ctx = Context()
    req = PreprocessedRequest(model="tiny", token_ids=list(range(1, 30)),
                              stop_conditions=StopConditions(
                                  max_tokens=50, ignore_eos=True))
    got = []
    async for out in eng.generate(req, ctx):
        got.extend(out.token_ids)
        if len(got) == 3:
            ctx.cancel()
    await eng.close()
    assert 3 <= len(got) < 50
    assert eng.pool.num_active_blocks == 0
    assert metrics and metrics[0].worker_stats.request_active_slots == 1
    assert metrics[0].kv_stats.kv_total_blocks == SETTINGS["num_blocks"] - 1
