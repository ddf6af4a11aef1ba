"""Sampled streams of the port's engine against the JAX engine's, on the
same weights (Llama tiny and ``mla_tiny``, bf16/f32 and int8 KV as the
greedy parity tests run them).

Seeded draws are bit for bit ``jax.random``'s, so seeded temperature,
top-k and top-p streams must be equal token for token, on the serial and
the pipelined loop, after a forced preemption too (the key's step is the
absolute position). Top logprobs agree in ids and within 1e-5. The cases
of ``tests/test_penalties.py`` re-run on the port's logit edits.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import model as M
from dynamo_tpu.engine.config import EngineArgs as JaxEngineArgs
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import AsyncJaxEngine
from dynamo_tpu.models import get_model_config as jax_preset
from dynamo_tpu.protocols import OutputOptions as JaxOutput
from dynamo_tpu.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols import SamplingOptions as JaxSampling
from dynamo_tpu.protocols import StopConditions as JaxStop
from dynamo_tpu_torch.engine import model as TM
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine, _has_penalties
from dynamo_tpu_torch.engine.scheduler import SeqState
from dynamo_tpu_torch.engine.weights import params_from_jax
from dynamo_tpu_torch.models import get_model_config
from dynamo_tpu_torch.protocols import (
    OutputOptions, PreprocessedRequest, SamplingOptions, StopConditions,
)

SETTINGS = dict(block_size=4, num_blocks=128, max_num_seqs=8,
                max_num_batched_tokens=32, max_model_len=256,
                decode_batch_buckets=(1, 2, 4, 8))

#: (temperature, top_k, top_p, seed) of the seeded requests, and one
#: greedy request beside them
SAMPLED = [(0.8, 0, 1.0, 11), (1.2, 5, 1.0, 0), (0.7, 0, 0.9, 2**31 - 1),
           (1.0, 64, 0.5, 7), (0.0, 0, 1.0, None)]


def _prompts(n=len(SAMPLED), seed=3):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, 256, int(k))))
            for k in rng.integers(5, 40, n)]


def _llama_params():
    jp = M.init_params(JaxModelConfig.tiny(), jax.random.key(0))
    return (ModelConfig.tiny(), JaxModelConfig.tiny(), jp,
            params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))


def _mla_params():
    cfg = get_model_config("mla_tiny")
    tp = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, jax_preset("mla_tiny"), jax.tree.map(
        lambda t: jnp.asarray(t.numpy()), tp), tp


def _requests(kind, prompts, max_tokens, logprobs=None):
    Req, Samp, Stop, Out = ((JaxRequest, JaxSampling, JaxStop, JaxOutput)
                            if kind == "jax" else
                            (PreprocessedRequest, SamplingOptions,
                             StopConditions, OutputOptions))
    return [Req(model="m", token_ids=p,
                sampling_options=Samp(temperature=t, top_k=k or None,
                                      top_p=tp, seed=seed),
                output_options=Out(logprobs=logprobs),
                stop_conditions=Stop(max_tokens=max_tokens, ignore_eos=True))
            for p, (t, k, tp, seed) in zip(prompts, SAMPLED)]


async def _serve(eng, reqs):
    async def one(r):
        toks, lps, tops = [], [], []
        async for out in eng.generate(r):
            toks.extend(out.token_ids)
            lps.extend(out.log_probs or [])
            tops.extend(out.top_logprobs or [])
        return toks, lps, tops

    try:
        return await asyncio.gather(*(one(r) for r in reqs))
    finally:
        await eng.close()


def _jax_engine(jcfg, jp, **kw):
    return AsyncJaxEngine(jcfg, JaxEngineArgs(
        prefill_buckets=(8, 16, 32), **{**SETTINGS, **kw}), params=jp)


def _torch_engine(cfg, tp, **kw):
    return AsyncTorchEngine(cfg, EngineArgs(**{**SETTINGS, **kw}),
                            params=tp, device="cpu")


@pytest.mark.parametrize("family,kv", [("llama", None), ("llama", "int8"),
                                       ("mla", None)])
def test_seeded_streams_match_jax_engine(family, kv):
    cfg, jcfg, jp, tp = _llama_params() if family == "llama" \
        else _mla_params()
    prompts = _prompts()
    jout = asyncio.run(_serve(_jax_engine(jcfg, jp, kv_cache_dtype=kv),
                              _requests("jax", prompts, 10)))
    tout = asyncio.run(_serve(_torch_engine(cfg, tp, kv_cache_dtype=kv),
                              _requests("torch", prompts, 10)))
    assert [t for t, _, _ in tout] == [t for t, _, _ in jout]
    # int8 pages: a K/V value on a rounding boundary may quantize one step
    # apart when the two packages' f32 inputs differ in the last bit, which
    # moves a logprob by ~1e-4 (the tokens above are still equal)
    atol = 1e-3 if kv == "int8" else 1e-5
    for (_, tl, _), (_, jl, _) in zip(tout, jout):
        np.testing.assert_allclose(tl, jl, atol=atol, rtol=0)


def test_top_logprobs_match_jax_engine():
    """Logprob rows (serial loop) beside seeded draws: top ids equal,
    values within 1e-5, and the selected logprob from the same
    log_softmax."""
    cfg, jcfg, jp, tp = _llama_params()
    prompts = _prompts(seed=4)
    jout = asyncio.run(_serve(_jax_engine(jcfg, jp),
                              _requests("jax", prompts, 6, logprobs=3)))
    tout = asyncio.run(_serve(_torch_engine(cfg, tp),
                              _requests("torch", prompts, 6, logprobs=3)))
    for (tt, tl, ttop), (jt, jl, jtop) in zip(tout, jout):
        assert tt == jt
        np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
        assert len(ttop) == len(tt) and all(len(x) == 3 for x in ttop)
        assert [[i for i, _ in x] for x in ttop] == \
            [[i for i, _ in x] for x in jtop]
        np.testing.assert_allclose([[v for _, v in x] for x in ttop],
                                   [[v for _, v in x] for x in jtop],
                                   atol=1e-5, rtol=0)


def test_seeded_streams_pipelined_serial_and_preempted_equal():
    """One engine's seeded streams equal on the pipelined loop, on the
    serial loop, and on an engine so short of blocks that it preempts
    (recompute: the keys' steps are absolute positions)."""
    cfg, _, _, tp = _llama_params()
    prompts = _prompts(seed=5)
    on = _torch_engine(cfg, tp)
    a = asyncio.run(_serve(on, _requests("torch", prompts, 16)))
    assert on.pipelined_steps > 0
    b = asyncio.run(_serve(_torch_engine(cfg, tp, pipeline_decode=False),
                           _requests("torch", prompts, 16)))
    tight = _torch_engine(cfg, tp, num_blocks=24)
    preempted = []
    orig = tight.scheduler._preempt

    def spy(seq):
        preempted.append(seq.request_id)
        orig(seq)

    tight.scheduler._preempt = spy
    c = asyncio.run(_serve(tight, _requests("torch", prompts, 16)))
    assert preempted, "the small pool never preempted"
    toks = [[t for t, _, _ in x] for x in (a, b, c)]
    assert toks[0] == toks[1] == toks[2]
    assert all(len(t) == 16 for t in toks[0])


def test_unseeded_requests_draw_their_own_keys():
    """An unseeded request's key seed is drawn once at admission (the JAX
    engine hashes its per-engine request id with the process's salted
    ``hash``, ROADMAP C3): two identical unseeded requests draw apart."""
    cfg, _, _, tp = _llama_params()
    p = _prompts(1, seed=6)[0]
    reqs = [PreprocessedRequest(
        model="m", token_ids=p,
        sampling_options=SamplingOptions(temperature=1.5),
        stop_conditions=StopConditions(max_tokens=16, ignore_eos=True))
        for _ in range(2)]
    (a, _, _), (b, _, _) = asyncio.run(_serve(_torch_engine(cfg, tp), reqs))
    assert len(a) == len(b) == 16 and a != b


# ----------------------------------------- tests/test_penalties.py on the port


@pytest.fixture(scope="module")
def engine():
    eng = AsyncTorchEngine(ModelConfig.tiny(), EngineArgs(
        block_size=16, num_blocks=64, max_num_seqs=4,
        max_num_batched_tokens=128, max_model_len=128), device="cpu")
    yield eng
    asyncio.run(eng.close())


def _req(tokens, **sampling):
    return PreprocessedRequest(
        model="tiny", token_ids=list(tokens),
        sampling_options=SamplingOptions(temperature=0.0, **sampling))


def _seq(req, tokens, prompt_len):
    s = SeqState(request_id="r0", req=req, ctx=None, sink=None)
    s.tokens = list(tokens)
    s.prompt_len = prompt_len
    return s


def _sample_one(engine, seq, logits_row):
    logits = torch.tensor([logits_row], dtype=torch.float32)
    toks, _, _ = engine._sample(logits, engine._sampling_plan([seq]))
    return int(toks[0])


def test_no_penalty_is_plain_argmax(engine):
    seq = _seq(_req([1, 2]), [1, 2, 3], prompt_len=2)
    assert _sample_one(engine, seq, [0.0, 1.0, 2.0, 5.0, 0.0]) == 3
    assert not _has_penalties(seq)


def test_presence_penalty_demotes_generated_tokens(engine):
    seq = _seq(_req([1, 2], presence_penalty=4.0), [1, 2, 3], prompt_len=2)
    assert _has_penalties(seq)
    assert _sample_one(engine, seq, [0.0, 1.0, 2.0, 5.0, 0.0]) == 2


def test_presence_ignores_prompt_tokens(engine):
    seq = _seq(_req([1, 2, 3], presence_penalty=4.0), [1, 2, 3], prompt_len=3)
    assert _sample_one(engine, seq, [0.0, 1.0, 2.0, 5.0, 0.0]) == 3


def test_frequency_penalty_scales_with_count(engine):
    seq = _seq(_req([1], frequency_penalty=2.0), [1, 3, 3], prompt_len=1)
    assert _sample_one(engine, seq, [0.0, 1.0, 2.0, 5.0, 0.0]) == 2
    seq = _seq(_req([1], frequency_penalty=2.0), [1, 3], prompt_len=1)
    assert _sample_one(engine, seq, [0.0, 1.0, 2.0, 5.0, 0.0]) == 3


def test_repetition_penalty_hf_semantics(engine):
    seq = _seq(_req([1, 3], repetition_penalty=3.0), [1, 3], prompt_len=2)
    assert _has_penalties(seq)
    assert _sample_one(engine, seq, [-1.0, 4.0, 2.5, 6.0, 0.0]) == 2
    seq = _seq(_req([0], repetition_penalty=3.0), [0], prompt_len=1)
    assert _sample_one(engine, seq, [-1.0, -2.5, -9.0, -9.0, -9.0]) == 1


def test_repetition_one_is_neutral(engine):
    seq = _seq(_req([3], repetition_penalty=1.0), [3], prompt_len=1)
    assert not _has_penalties(seq)
    assert _sample_one(engine, seq, [0.0, 1.0, 2.0, 5.0, 0.0]) == 3


def test_penalties_compose_with_logit_bias(engine):
    seq = _seq(_req([1], presence_penalty=4.0, logit_bias={0: 10.0}),
               [1, 3], prompt_len=1)
    assert _sample_one(engine, seq, [0.0, 1.0, 2.0, 5.0, 0.0]) == 0


def test_penalties_and_bias_match_jax_sample(engine):
    """Penalties and a logit_bias on one token (two additive terms on one
    logit, added in the JAX engine's order), under seeded draws: the port's
    edits and draw give the JAX engine's ``_sample`` tokens and logprobs
    on the same logits and histories."""
    from dynamo_tpu.engine.engine import AsyncJaxEngine as JaxEngine
    from dynamo_tpu.engine.scheduler import SeqState as JaxSeq

    rng = np.random.default_rng(8)
    V = 64
    logits = rng.standard_normal((3, V)).astype(np.float32) * 2
    hist = [list(map(int, rng.integers(0, V, 12))) for _ in range(3)]
    opts = [dict(frequency_penalty=0.5, logit_bias={"17": 0.7}, seed=2,
                 temperature=1.1, repetition_penalty=1.3),
            dict(presence_penalty=0.3, frequency_penalty=0.2, seed=5,
                 temperature=0.8, repetition_penalty=1.1,
                 logit_bias={str(hist[1][-1]): 0.4, "9": -2.0}),
            dict(presence_penalty=2.0, logit_bias={str(hist[2][-1]): 1.5})]

    def seqs(Req, Samp, Seq):
        out = []
        for i, (h, o) in enumerate(zip(hist, opts)):
            s = Seq(request_id=f"r{i}", ctx=None, sink=None,
                    req=Req(model="m", token_ids=h[:8],
                            sampling_options=Samp(**o)))
            s.tokens, s.prompt_len, s.step_idx = list(h), 8, len(h)
            out.append(s)
        return out

    jeng = JaxEngine(JaxModelConfig.tiny(), JaxEngineArgs(
        block_size=16, num_blocks=16, max_num_seqs=4,
        max_num_batched_tokens=64, max_model_len=128))
    try:
        jt, jl, _ = asyncio.run(jeng._sample(
            seqs(JaxRequest, JaxSampling, JaxSeq), jnp.asarray(logits)))
    finally:
        asyncio.run(jeng.close())
    tt, _, host = engine._sample(
        torch.from_numpy(logits),
        engine._sampling_plan(seqs(PreprocessedRequest, SamplingOptions,
                                   SeqState)))
    assert tt.tolist() == np.asarray(jt).tolist()
    np.testing.assert_allclose(host[1].numpy(), np.asarray(jl), atol=1e-6,
                               rtol=0)


def test_e2e_presence_penalty_forbids_repeats():
    """Greedy decode on random weights repeats tokens; an overwhelming
    presence penalty makes every generated token distinct."""
    cfg, _, _, tp = _llama_params()

    def run(penalty):
        req = PreprocessedRequest(
            model="m", token_ids=[1, 2, 3, 4],
            sampling_options=SamplingOptions(presence_penalty=penalty),
            stop_conditions=StopConditions(max_tokens=24, ignore_eos=True))
        return asyncio.run(_serve(_torch_engine(cfg, tp), [req]))[0][0]

    plain = run(0.0)
    assert len(set(plain)) < len(plain)  # random weights repeat
    penalised = run(1e4)
    assert len(penalised) == 24 and len(set(penalised)) == 24


def test_logit_bias_forces_token():
    cfg, _, _, tp = _llama_params()
    req = PreprocessedRequest(
        model="m", token_ids=[5, 6, 7],
        sampling_options=SamplingOptions(logit_bias={"42": 100.0}),
        stop_conditions=StopConditions(max_tokens=5, ignore_eos=True))
    toks = asyncio.run(_serve(_torch_engine(cfg, tp), [req]))[0][0]
    assert toks == [42] * 5
