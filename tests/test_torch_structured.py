"""Structured decoding in the port: the FSM compiler and arena
(``dynamo_tpu_torch/structured``) against the JAX package's, the guided
alphabet read from ``tokenizer.json``, and the engine's device-FSM
streams against its host-oracle streams.

The device path (tables gathered inside the sampling step, the pipelined
loop feeding FSM states device to device) must give the host oracle's
streams token for token, greedy and seeded, and the JAX engine's.
"""

import asyncio
import os
import re

import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineArgs as JaxEngineArgs
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import AsyncJaxEngine
from dynamo_tpu.llm.guided import CharDfa as JaxCharDfa
from dynamo_tpu.llm.guided import TokenMachine as JaxTokenMachine
from dynamo_tpu.llm.tokenizer import TokenizerWrapper, make_test_tokenizer
from dynamo_tpu.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols import SamplingOptions as JaxSampling
from dynamo_tpu.protocols import StopConditions as JaxStop
from dynamo_tpu.structured import compile_fsm as jax_compile_fsm
from dynamo_tpu_torch.engine import sampling
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.engine.weights import params_from_jax
from dynamo_tpu_torch.llm.guided import (
    CharDfa, GuidedState, TokenMachine,
)
from dynamo_tpu_torch.llm.tokenizer import (
    guided_vocab_from_dir, wordlevel_test_vocab,
)
from dynamo_tpu_torch.protocols import (
    PreprocessedRequest, SamplingOptions, StopConditions,
)
from dynamo_tpu_torch.runtime.context import InvalidRequestError
from dynamo_tpu_torch.structured import (
    COMPILE_STATS, FsmCursor, StructuredRuntime, build_guided_state,
    compile_fsm,
)
from tests.hf_fixture import train_bpe_tokenizer

CFG = ModelConfig.tiny()
VOCAB = [""] + [chr(32 + i) for i in range(CFG.vocab_size - 1)]
CHAR_VOCAB = [""] + [chr(32 + i) for i in range(95)]


# ------------------------------------------------------------ compiler unit

@pytest.mark.parametrize("pattern", [
    r"[ab]{3}", r"yes|no|maybe", r"a(xy|b)", r"\d+",
    r'"([^"\\]|\\["\\nrt])*"',
])
def test_compiled_tables_equal_jax(pattern):
    """The port's tables (mask words, next states, exhausted flags) equal
    the JAX compiler's, and every reachable state's mask and transition
    equal the host oracle's, walked from both ends of the allowed set."""
    V, eos = len(CHAR_VOCAB), [2]
    tm = TokenMachine(CharDfa(pattern), CHAR_VOCAB)
    fsm = compile_fsm(tm, eos, V, 2000)
    want = jax_compile_fsm(JaxTokenMachine(JaxCharDfa(pattern), CHAR_VOCAB),
                           eos, V, 2000)
    np.testing.assert_array_equal(fsm.mask, want.mask)
    np.testing.assert_array_equal(fsm.next, want.next)
    np.testing.assert_array_equal(fsm.exhausted, want.exhausted)
    for pick_last in (False, True):
        gs = GuidedState(tm, eos)
        rt = StructuredRuntime(V, 512)
        cur = FsmCursor(rt.acquire(("t", pattern, pick_last), fsm), rt)
        for _ in range(48):
            a = sorted(gs.allowed_token_ids(V))
            assert a == sorted(cur.allowed_token_ids(V))
            assert (gs.done, gs.exhausted) == (cur.done, cur.exhausted)
            if not a or gs.done or gs.exhausted:
                break
            t = a[-1] if pick_last else a[0]
            gs.advance(t)
            cur.advance(t)


def test_arena_segments_share_and_evict():
    rt = StructuredRuntime(2, 64)
    fsm = compile_fsm(TokenMachine(CharDfa("ab"), ["a", "b"]), [], 2, 32)
    s1 = rt.acquire("k1", fsm)
    s2 = rt.acquire("k1", fsm)
    assert s1 is s2 and s1.refs == 2  # one constraint shares a segment
    rt.release(s1)
    rt.release(s1)
    big = compile_fsm(TokenMachine(CharDfa("a{40}"), ["a", "b"]), [], 2, 63)
    assert rt.acquire("k2", big) is not None
    assert rt.evictions >= 1 or rt.stats()["segments"] == 2


def test_budget_fallback_to_host_oracle():
    rt = StructuredRuntime(len(CHAR_VOCAB), 33)  # min arena, 32 usable
    gs = build_guided_state({"regex": "a{64}"}, CHAR_VOCAB, [2], rt)
    assert not getattr(gs, "device", False)
    assert rt.rows_host == 1


def test_compile_cache_counts_hits_and_misses():
    vocab = ["x", "y", "z"]
    rt = StructuredRuntime(len(vocab), 64)
    before = dict(COMPILE_STATS)
    build_guided_state({"regex": "xy+z"}, vocab, [], rt)
    assert COMPILE_STATS["miss"] == before["miss"] + 1
    build_guided_state({"regex": "xy+z"}, vocab, [], rt)
    assert COMPILE_STATS["hit"] == before["hit"] + 1


def test_free_state_is_identity():
    """Arena row 0 (FREE) allows every token and loops on itself."""
    rt = StructuredRuntime(37, 64)
    mask_t, next_t = rt.device_tables()
    logits = torch.linspace(-3, 3, 2 * 37).reshape(2, 37)
    out = sampling.apply_fsm_mask(logits, torch.zeros(2, dtype=torch.int32),
                                  mask_t)
    assert torch.equal(out, logits)
    assert int(next_t[0, 5]) == 0


def test_tables_upload_again_only_when_dirty():
    """The arenas are allocated once: a new segment's rows are copied into
    the same tensors (a captured sampler keeps reading them), and they
    then equal the host tables."""
    rt = StructuredRuntime(len(CHAR_VOCAB), 64)
    a = rt.device_tables()
    assert rt.device_tables()[0] is a[0]
    assert not a[0][1:].any()  # only the FREE row so far
    cur = build_guided_state({"regex": "ab"}, CHAR_VOCAB, [], rt)
    b = rt.device_tables()
    assert b[0] is a[0] and b[1] is a[1] and b[0].dtype == torch.int32
    off, n = cur.seg.offset, cur.seg.size
    assert b[0][off:off + n].any()
    np.testing.assert_array_equal(b[0].numpy(),
                                  rt._mask_np.view(np.int32))
    np.testing.assert_array_equal(b[1].numpy(), rt._next_np)


def test_unsatisfiable_constraint_is_invalid_request():
    """The vocabulary cannot spell "zzz": a typed, terminal 400."""
    with pytest.raises(InvalidRequestError, match="cannot be satisfied"):
        build_guided_state({"regex": "zzz"}, ["a", "b"], [],
                           StructuredRuntime(2, 64))


# ----------------------------------------------------------- guided alphabet

@pytest.mark.parametrize("which", ["byte_level_bpe", "test_wordlevel"])
def test_guided_vocab_from_dir_equals_tokenizers(which, tmp_path):
    """The alphabet read with json alone equals TokenizerWrapper's, on the
    hf_fixture's byte-level BPE (special added tokens → "") and on the
    WordLevel test tokenizer."""
    if which == "byte_level_bpe":
        train_bpe_tokenizer().save(os.path.join(tmp_path, "tokenizer.json"))
        want = TokenizerWrapper.from_dir(str(tmp_path)).guided_vocab()
        assert "" in want and any(" " in t for t in want)
    else:
        tk = make_test_tokenizer()
        tk._tk.save(os.path.join(tmp_path, "tokenizer.json"))
        want = tk.guided_vocab()
        assert want == wordlevel_test_vocab()
    assert guided_vocab_from_dir(str(tmp_path)) == want


def test_guided_vocab_unknown_decoder_is_none(tmp_path):
    (tmp_path / "tokenizer.json").write_text(
        '{"model": {"type": "BPE", "vocab": {"a": 0, "b": 1}}, '
        '"decoder": {"type": "WordPiece"}, "added_tokens": []}')
    assert guided_vocab_from_dir(str(tmp_path)) is None


# ---------------------------------------------------- engine path identity

def _req(kind, guided, seed=None, temp=0.0, mt=24, eos=(2,),
         min_tokens=None):
    Req, Samp, Stop = ((JaxRequest, JaxSampling, JaxStop) if kind == "jax"
                       else (PreprocessedRequest, SamplingOptions,
                             StopConditions))
    return Req(model="t", token_ids=[1, 2, 3],
               sampling_options=Samp(temperature=temp, seed=seed,
                                     guided=guided),
               stop_conditions=Stop(max_tokens=mt, min_tokens=min_tokens),
               eos_token_ids=list(eos))


async def _collect(eng, r):
    toks = []
    async for out in eng.generate(r):
        toks.extend(out.token_ids)
        if out.finish_reason is not None:
            return toks, out.finish_reason
    return toks, None


def _engine(params=None, **kw):
    base = dict(block_size=16, num_blocks=64, max_num_seqs=4,
                max_num_batched_tokens=128, max_model_len=128)
    return AsyncTorchEngine(CFG, EngineArgs(**{**base, **kw}),
                            params=params, device="cpu", guided_vocab=VOCAB)


GUIDEDS = [
    {"regex": r"[ab]{6}"},
    {"choice": ["apple", "banana"]},
    {"json": {"type": "object", "properties": {"ok": {"type": "boolean"},
                                               "k": {"enum": ["x", "yz"]}}}},
]


def test_device_fsm_equal_to_host_oracle_and_jax():
    """Device-FSM streams equal the host oracle's token for token, greedy
    and seeded, while riding the pipelined loop; and equal the JAX
    engine's device-FSM streams on the same weights."""
    import jax

    from dynamo_tpu.engine import model as M

    jparams = M.init_params(JaxModelConfig.tiny(), jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    cases = [(g, seed, temp) for g in GUIDEDS
             for seed, temp in [(None, 0.0), (7, 0.9)]]

    async def run(eng, kind):
        try:
            return [await _collect(eng, _req(kind, g, seed, temp, 32))
                    for g, seed, temp in cases]
        finally:
            await eng.close()

    dev = _engine(params)
    host = _engine(params, structured_device=False)
    assert dev.structured is not None and host.structured is None
    a = asyncio.run(run(dev, "torch"))
    b = asyncio.run(run(host, "torch"))
    assert a == b
    assert dev.structured.stats()["rows_device"] == len(cases)
    assert dev.pipelined_steps > 0 and host.pipelined_steps == 0
    jeng = AsyncJaxEngine(JaxModelConfig.tiny(), JaxEngineArgs(
        block_size=16, num_blocks=64, max_num_seqs=4,
        max_num_batched_tokens=128, max_model_len=128), params=jparams,
        guided_vocab=VOCAB)
    assert asyncio.run(run(jeng, "jax")) == a
    for (g, _, _), (toks, reason) in zip(cases, a):
        txt = "".join(VOCAB[t] for t in toks if t != 2)
        if "regex" in g:
            assert re.fullmatch(g["regex"], txt), txt
        assert reason == "stop"


def test_constrained_row_in_mixed_ragged_step():
    """A device-FSM row decoding beside a free prompt's prefill chunks in
    ONE packed step (serial loop): the constrained text is valid and
    equals the host oracle's."""
    async def run(eng):
        plans = []
        plan = eng.scheduler.plan

        def spy():
            p = plan()
            plans.append(bool(p.prefill) and bool(p.decode))
            return p

        eng.scheduler.plan = spy
        try:
            guided = asyncio.create_task(_collect(
                eng, _req("torch", {"regex": r"[ab]{12}"}, mt=24)))
            while not any(s.generated for s in eng.scheduler.running):
                await asyncio.sleep(0.001)
            await _collect(eng, PreprocessedRequest(
                model="t", token_ids=list(range(3, 75)),
                stop_conditions=StopConditions(max_tokens=4,
                                               ignore_eos=True),
                eos_token_ids=[2]))
            return await guided, any(plans)
        finally:
            await eng.close()

    dev = _engine(max_num_batched_tokens=16)
    a, mixed = asyncio.run(run(dev))
    b, _ = asyncio.run(run(_engine(params=dev.params,
                                   max_num_batched_tokens=16,
                                   structured_device=False)))
    assert mixed and a == b
    txt = "".join(VOCAB[t] for t in a[0] if t != 2)
    assert re.fullmatch(r"[ab]{12}", txt), txt


def test_min_tokens_falls_back_to_host_oracle():
    """min_tokens EOS gating is per step: those rows use the oracle and
    still defer EOS."""
    dev = _engine()

    async def run():
        try:
            return await _collect(dev, _req(
                "torch", {"choice": ["hi", "hiyo"]}, mt=16, eos=(5,),
                min_tokens=4))
        finally:
            await dev.close()

    toks, _ = asyncio.run(run())
    assert "".join(VOCAB[t] for t in toks if t != 5).startswith("hiyo")
    assert dev.structured.stats()["rows_host"] >= 1


def test_arena_released_on_finish():
    dev = _engine()

    async def run():
        try:
            await _collect(dev, _req("torch", {"regex": r"[ab]{4}"}))
            await _collect(dev, _req("torch", {"regex": r"[ab]{4}"}))
        finally:
            await dev.close()

    asyncio.run(run())
    segs = list(dev.structured._segments.values())
    assert len(segs) == 1 and segs[0].refs == 0


def test_budget_too_small_serves_on_host_oracle():
    dev = _engine(structured_table_mb=0.0001)
    assert dev.structured is None

    async def run():
        try:
            return await _collect(dev, _req("torch", {"regex": r"[ab]{4}"}))
        finally:
            await dev.close()

    toks, _ = asyncio.run(run())
    txt = "".join(VOCAB[t] for t in toks if t != 2)
    assert re.fullmatch(r"[ab]{4}", txt), txt
