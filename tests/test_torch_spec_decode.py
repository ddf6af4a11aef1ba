"""Speculative decoding in the torch port against the JAX package's.

The contract is the reference's (``tests/test_spec_decode.py``): greedy
outputs are identical with speculation on or off. On the CPU in f32 the
port's spec streams must equal its plain streams and the JAX spec engine's,
with the same KV-event hashes and ``SpecDecodeStats``.

- ``_draft_tokens`` (prompt lookup) against ``AsyncJaxEngine._draft_tokens``
  on the reference's cases and on random sequences grown token by token.
- ``make_ragged_verify_fn`` against the JAX one, plain and FSM-masked, on
  the tiny Llama, ``mla_tiny`` and int8 pages: the ids, the logprobs and
  the written cache slots.
- ``make_draft_fn`` against the JAX one, and its refusals.
- Engines: prompt lookup (K = 3 and 4, repetitive and random prompts,
  concurrent rows, a configuration whose rows verify in two groups), the
  layer-skip draft (D = 1, and D = num_layers with full acceptance), int8
  pools and ``mla_tiny``: one JAX run per configuration, shared by the
  stream and the event tests through a module fixture.
- Constrained rows verify under mask words and equal the host oracle;
  sampled and logprob requests skip speculation; the governor suspends,
  re-probes and, suspended, serves plain steps; a live engine switches
  speculation off and on on the buffers it was made with; ``warmup()``
  covers every verify and draft signature (no capture while serving,
  under the replaying stand-in of ``tests/test_torch_graphs.py``).
"""

import asyncio
import dataclasses
import re
from types import SimpleNamespace

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
from dynamo_tpu_torch.engine.cache import allocate_device_cache
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import (
    AsyncTorchEngine, ragged_grid_shape, verify_buckets, verify_groups,
)
from dynamo_tpu_torch.models import get_model_config
from dynamo_tpu_torch.protocols import (
    OutputOptions, PreprocessedRequest, SamplingOptions, StopConditions,
)
from tests.test_torch_graphs import RerunGraphs

# ------------------------------------------------------------- prompt lookup


def _state(tokens):
    return SimpleNamespace(tokens=list(tokens), ngram_pos={}, ngram_indexed=0)


@pytest.mark.parametrize("tokens,k", [
    ([1, 5, 6, 7, 8, 9, 2, 5, 6], 3), ([5, 6, 1, 5, 6, 2, 9, 5, 6], 2),
    ([1, 2, 3, 4, 5], 3), ([7], 3), ([4, 4, 4, 4], 2),
    ([1, 2, 3, 1, 2, 3, 1, 2], 4)])
def test_draft_tokens_equal_jax(tokens, k):
    want = AsyncJaxEngine._draft_tokens(_state(tokens), k)
    assert AsyncTorchEngine._draft_tokens(_state(tokens), k) == want


def test_draft_tokens_incremental_equal_jax():
    """The reference's incremental case, then random sequences over a small
    alphabet grown a few tokens at a time, one index each: every lookup
    equals the JAX engine's, and never matches its own trailing gram."""
    s = _state([1, 5, 6, 7])
    assert AsyncTorchEngine._draft_tokens(s, 2) == []
    s.tokens += [2, 5, 6]
    assert AsyncTorchEngine._draft_tokens(s, 2) == [7, 2]
    rng = np.random.default_rng(3)
    for trial in range(20):
        mine, ref = _state([]), _state([])
        for _ in range(60):
            new = list(map(int, rng.integers(0, 4 + trial % 5,
                                             int(rng.integers(1, 4)))))
            mine.tokens += new
            ref.tokens += new
            k = int(rng.integers(1, 6))
            assert (AsyncTorchEngine._draft_tokens(mine, k)
                    == AsyncJaxEngine._draft_tokens(ref, k))
        assert mine.ngram_pos == ref.ngram_pos


# ------------------------------------------------------------------ verify

BS, W = 4, 8
#: two prefilled prompts; then a verify row each: [newest, draft...]
PROMPTS = [[5, 9, 17, 23, 42], [7, 11, 13]]
BT = np.stack([np.arange(1 + W * b, 1 + W * (b + 1)) for b in range(2)]
              ).astype(np.int32)
DRAFTS = [[61, 3, 77], [99]]  # the second row's draft is padded with 0
K = 3


def _configs(name):
    if name == "mla_tiny":
        return get_model_config(name), jax_preset(name)
    return ModelConfig.tiny(), JaxModelConfig.tiny()


def _pack(rows, T):
    """(tokens, positions) per row as one packed ragged step of T tokens
    and len(rows) rows, the engine's chunk grid and each row's kv_len
    (its last position + 1 + ``pad``)."""
    C, S_C = ragged_grid_shape(T)
    ints5 = np.zeros((5, T), np.int32)
    ints5[3] = C
    rows3 = np.zeros((len(rows), 3), np.int32)
    grid_rows = np.zeros((C,), np.int32)
    t = tile = 0
    for i, (toks, pos, kv) in enumerate(rows):
        n = len(toks)
        ints5[0, t:t + n] = toks
        ints5[1, t:t + n] = pos
        ints5[2, t:t + n] = [BT[i, p // BS] * BS + p % BS for p in pos]
        for off in range(0, n, S_C):
            w = min(S_C, n - off)
            grid_rows[tile] = i
            ints5[3, t + off:t + off + w] = tile
            ints5[4, t + off:t + off + w] = np.arange(w)
            tile += 1
        rows3[i] = (t, n, kv)
        t += n
    return ints5, rows3, grid_rows


def _verify_rows():
    rows = []
    for p, d in zip(PROMPTS, DRAFTS):
        n = len(p)
        toks = [60 + n] + d + [0] * (K - len(d))
        rows.append((toks, list(range(n, n + K + 1)), n + K + 1))
    return rows


def _leaves(cache):
    if isinstance(cache, dict):
        return [np.asarray(cache[k]) for k in ("q", "s")]
    return [np.asarray(cache)]


def _dequant(leaves):
    if len(leaves) == 1:
        return leaves[0].astype(np.float32)
    q, s = leaves
    return q.astype(np.float32) * s[..., None]


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("name", ["tiny", "mla_tiny", "int8"])
def test_ragged_verify_fn_matches_jax(name, masked):
    """Prefill both prompts through the ragged step, then one verify step
    of two rows (the second row's draft padded with token 0): the greedy
    ids equal, the logprobs within 1e-5, and every cache slot the verify
    wrote equal within f32 rounding (int8: one quantisation step)."""
    cfg, jcfg = _configs("tiny" if name == "int8" else name)
    quant = name == "int8"
    tp = TM.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    nb = 2 * W + 2
    tk, tv = allocate_device_cache(cfg, nb, BS, "cpu", torch.float32,
                                   "int8" if quant else None)
    jk, jv = jax_cache(jcfg, nb, BS, dtype="int8" if quant else jnp.float32)
    ops = _pack([(p, list(range(len(p))), len(p)) for p in PROMPTS], 8)
    TM.make_ragged_step_fn(cfg, BS)(
        tp, *(torch.from_numpy(a) for a in ops), torch.from_numpy(BT),
        tk, tv)
    _, jk, jv = M.make_ragged_step_fn(jcfg, BS, kv_quant=quant)(
        jp, *(jnp.asarray(a) for a in ops), jnp.asarray(BT), jk, jv)

    T = 8
    ints5, rows3, grid_rows = _pack(_verify_rows(), T)
    extra_t, extra_j = (), ()
    if masked:
        W32 = -(-cfg.vocab_size // 32)
        rng = np.random.default_rng(9)
        mw = rng.integers(0, 2**32, (T, W32), dtype=np.uint64).astype(
            np.uint32)
        mw[:, 0] |= np.uint32(1 << 3)  # every position allows token 3
        extra_t = (torch.from_numpy(mw.view(np.int32)),)
        extra_j = (jnp.asarray(mw),)
    ids, lps, _, _ = TM.make_ragged_verify_fn(cfg, BS, masked=masked)(
        tp, *(torch.from_numpy(a) for a in (ints5, rows3, grid_rows)),
        torch.from_numpy(BT), *extra_t, tk, tv)
    jids, jlps, jk, jv = M.make_ragged_verify_fn(
        jcfg, BS, kv_quant=quant, masked=masked)(
        jp, *(jnp.asarray(a) for a in (ints5, rows3, grid_rows, BT)),
        *extra_j, jk, jv)
    assert ids.dtype == torch.int32 and ids.shape == (T,)
    assert ids.tolist() == np.asarray(jids).tolist()
    np.testing.assert_allclose(lps.numpy(), np.asarray(jlps), atol=1e-5,
                               rtol=0)
    if masked:
        bits = (mw[np.arange(T), ids.numpy() // 32]
                >> (ids.numpy() % 32).astype(np.uint32)) & 1
        assert bits.all()
    slots = torch.from_numpy(ints5[2].astype(np.int64))
    for mine, ref in ((tk, jk), (tv, jv)):
        got = _dequant([a[:, slots.numpy()] for a in _leaves(
            {k: v.numpy() for k, v in mine.items()} if quant
            else mine.numpy())])
        want = _dequant([a[:, slots.numpy()] for a in _leaves(ref)])
        tol = 1.01 * float(np.asarray(ref["s"]).max()) if quant else 1e-5
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_ragged_verify_fn_writes_into_logits_out():
    """A verify of T tokens takes its logits in the first T rows of a
    larger scratch buffer, with the same ids and logprobs as without."""
    cfg = ModelConfig.tiny()
    tp = TM.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    ints5, rows3, grid_rows = _pack(_verify_rows(), 8)
    fn = TM.make_ragged_verify_fn(cfg, BS)
    outs = []
    for buf in (None, torch.full((16, cfg.vocab_size), float("nan"))):
        tk, tv = allocate_device_cache(cfg, 2 * W + 2, BS, "cpu",
                                       torch.float32)
        ids, lps, _, _ = fn(tp, *(torch.from_numpy(a) for a in (
            ints5, rows3, grid_rows, BT)), tk, tv, logits_out=buf)
        outs.append((ids.tolist(), lps.tolist()))
    assert outs[0] == outs[1]
    assert bool(torch.isnan(buf[8:]).all()) and not bool(
        torch.isnan(buf[:8]).any())


# ------------------------------------------------------------------- draft


@pytest.mark.parametrize("D", [1, 2])
def test_draft_fn_matches_jax(D):
    """K greedy tokens through the first D layers, from the newest token
    of each prefilled row (a padding row beside them): the tokens equal,
    and the draft wrote only the first D layers' slots, equal to JAX's."""
    cfg, jcfg = _configs("tiny")
    tp = TM.init_params(cfg, torch.Generator().manual_seed(6), "cpu")
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    nb = 2 * W + 2
    tk, tv = allocate_device_cache(cfg, nb, BS, "cpu", torch.float32)
    jk, jv = jax_cache(jcfg, nb, BS, dtype=jnp.float32)
    ops = _pack([(p, list(range(len(p))), len(p)) for p in PROMPTS], 8)
    TM.make_ragged_step_fn(cfg, BS)(
        tp, *(torch.from_numpy(a) for a in ops), torch.from_numpy(BT),
        tk, tv)
    _, jk, jv = M.make_ragged_step_fn(jcfg, BS)(
        jp, *(jnp.asarray(a) for a in ops), jnp.asarray(BT), jk, jv)
    R = 4
    ints = np.zeros((R, 3), np.int32)
    bt = np.zeros((R, W), np.int32)
    for i, p in enumerate(PROMPTS):
        ints[i] = (60 + i, len(p), len(p) + 1)
        bt[i] = BT[i]
    before = tk.clone()
    toks = TM.make_draft_fn(cfg, BS, D, K)(
        tp, torch.from_numpy(np.ascontiguousarray(ints.T)),
        torch.from_numpy(bt), tk, tv)
    jtoks, jk, _ = M.make_draft_fn(jcfg, BS, D, K)(
        jp, jnp.asarray(ints), jnp.asarray(bt), jk, jv)
    assert toks.shape == (K, R)
    # padding rows read the null block: their tokens are unspecified
    assert toks[:, :2].tolist() == np.asarray(jtoks)[:, :2].tolist()
    assert torch.equal(tk[D:], before[D:])  # deeper layers untouched
    # the real rows' slots (padding rows write the null block)
    slots = [int(BT[i, p // BS]) * BS + p % BS
             for i, row in enumerate(PROMPTS)
             for p in range(len(row), len(row) + K)]
    np.testing.assert_allclose(tk[:D, slots].numpy(),
                               np.asarray(jk)[:D, slots], atol=1e-5, rtol=0)
    assert bool(tk[:D, slots].any())


@pytest.mark.parametrize("name,D", [("tiny", 3), ("tiny", 0),
                                    ("mla_tiny", 1)])
def test_draft_fn_refusals_equal_jax(name, D):
    """A depth outside (0, num_layers], and a model with a dense prefix
    (no uniform stack to cut), are refused with the JAX package's
    message."""
    cfg, jcfg = _configs(name)
    with pytest.raises(ValueError) as jerr:
        M.make_draft_fn(jcfg, BS, D, K)
    with pytest.raises(ValueError) as err:
        TM.make_draft_fn(cfg, BS, D, K)
    assert str(err.value) == str(jerr.value)


# ------------------------------------------------------------------- knobs


@pytest.mark.parametrize("kw", [
    dict(speculative_tokens=4, speculative_method="draft_layers"),
    dict(speculative_method="magic"),
])
def test_invalid_knobs_raise_jax_messages(kw):
    with pytest.raises(ValueError) as jerr:
        JaxEngineArgs(block_size=4, **kw)
    with pytest.raises(ValueError) as err:
        EngineArgs(block_size=4, **kw)
    assert str(err.value) == str(jerr.value)


def test_knobs_accepted_with_jax_defaults():
    for method in ("prompt_lookup", "draft_layers"):
        a = EngineArgs(speculative_tokens=4, speculative_method=method,
                       speculative_draft_layers=1)
        assert (a.speculative_tokens, a.speculative_method) == (4, method)
    a, j = EngineArgs(), JaxEngineArgs()
    for name in ("speculative_tokens", "speculative_method",
                 "speculative_draft_layers", "spec_gain_window",
                 "spec_reprobe_steps"):
        assert getattr(a, name) == getattr(j, name), name
    with pytest.raises(ValueError, match="draft_layers"):
        AsyncTorchEngine(ModelConfig.tiny(), EngineArgs(
            block_size=4, num_blocks=64, speculative_tokens=4,
            speculative_method="draft_layers", speculative_draft_layers=5),
            device="cpu")


def test_verify_groups_split_as_jax():
    """Rows that no bucket holds at once verify in groups of what the
    largest bucket's tokens and tiles take; the buckets warmup() runs are
    every one the row counts can pick."""
    args = EngineArgs(max_num_seqs=6, max_num_batched_tokens=16)
    assert args.ragged_token_buckets == (8, 16)
    assert verify_groups(args, 3, 4) == [(range(3), 16)]
    assert verify_groups(args, 5, 4) == [(range(0, 4), 16),
                                         (range(4, 5), 8)]
    assert verify_groups(args, 6, 4) == [(range(0, 4), 16),
                                         (range(4, 6), 8)]
    assert verify_buckets(dataclasses.replace(args, speculative_tokens=3)
                          ) == [8, 16]


# ----------------------------------------------------------------- engines

#: tests/test_spec_decode.py's engine
SETTINGS = dict(block_size=4, num_blocks=128, max_num_seqs=4,
                max_num_batched_tokens=64, max_model_len=256)
REPETITIVE = [[11, 12, 13, 14, 15, 16] * 4, [21, 22, 23, 24] * 5,
              [31, 32, 33] * 6]
RANDOM = [[7, 91, 23, 151, 3, 88, 42, 199, 64, 5, 130, 77],
          [2, 71, 5, 93, 11, 44, 8, 120], list(range(1, 30))]

#: name -> (model, engine knobs, prompts, max_tokens)
CONFIGS = {
    "lookup_k4": ("tiny", dict(speculative_tokens=4),
                  REPETITIVE[:2] + RANDOM[:1], 20),
    "lookup_k3": ("tiny", dict(speculative_tokens=3),
                  [REPETITIVE[2], RANDOM[1], RANDOM[2]], 16),
    # six rows of 4 tokens in buckets of at most 16: two verify groups
    "lookup_groups": ("tiny", dict(speculative_tokens=3, max_num_seqs=6,
                                   max_num_batched_tokens=16),
                      REPETITIVE + RANDOM, 12),
    "draft_d1": ("tiny", dict(speculative_tokens=3,
                              speculative_method="draft_layers",
                              speculative_draft_layers=1),
                 [RANDOM[2], list(range(7, 45)), [3, 9, 4, 9, 4, 9, 4]], 16),
    "draft_full": ("tiny", dict(speculative_tokens=4,
                                speculative_method="draft_layers",
                                speculative_draft_layers=2),
                   [RANDOM[2][:19]], 24),
    "int8_lookup": ("tiny", dict(speculative_tokens=3,
                                 kv_cache_dtype="int8"),
                    [[1, 2, 3, 4] * 3, RANDOM[0]], 16),
    "int8_draft": ("tiny", dict(speculative_tokens=3, kv_cache_dtype="int8",
                                speculative_method="draft_layers",
                                speculative_draft_layers=1),
                   [[1, 2, 3, 4] * 3, RANDOM[0]], 12),
    "mla_lookup": ("mla_tiny", dict(speculative_tokens=4),
                   REPETITIVE[:2] + RANDOM[1:2], 16),
}


def _events(events):
    return [(e.stored_parent_hash,
             [(b.block_hash, b.tokens_hash) for b in e.stored_blocks],
             list(e.removed_hashes), e.cleared) for e in events]


async def _serve(eng, reqs):
    async def one(r):
        toks, frames = [], 0
        async for out in eng.generate(r):
            toks.extend(out.token_ids)
            frames += 1
        return toks, frames

    try:
        return await asyncio.gather(*(one(r) for r in reqs))
    finally:
        await eng.close()


def _reqs(kind, prompts, n, **sampling):
    Req, Samp, Stop = ((JaxRequest, JaxSampling, JaxStop) if kind == "jax"
                       else (PreprocessedRequest, SamplingOptions,
                             StopConditions))
    return [Req(model="t", token_ids=list(p),
                sampling_options=Samp(temperature=0.0, **sampling),
                stop_conditions=Stop(max_tokens=n, ignore_eos=True))
            for p in prompts]


_RUNS: dict = {}


@pytest.fixture(scope="module")
def runs():
    """name -> the port's plain run, its spec run and the JAX spec run of
    CONFIGS[name] (streams, frames, events, spec stats, engines), each
    made once."""
    def get(name):
        if name in _RUNS:
            return _RUNS[name]
        model, knobs, prompts, n = CONFIGS[name]
        cfg, jcfg = _configs(model)
        params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
        spec_kw = {**SETTINGS, **knobs}
        plain_kw = {k: v for k, v in spec_kw.items()
                    if not k.startswith("spec")}
        out = {}
        for label, kw in (("plain", plain_kw), ("spec", spec_kw)):
            ev = []
            eng = AsyncTorchEngine(cfg, EngineArgs(**kw), params=params,
                                   device="cpu", event_cb=ev.append)
            res = asyncio.run(_serve(eng, _reqs("torch", prompts, n)))
            out[label] = {"streams": [t for t, _ in res],
                          "frames": [f for _, f in res], "events": ev,
                          "engine": eng}
        jev = []
        jeng = AsyncJaxEngine(jcfg, JaxEngineArgs(
            prefill_buckets=(8, 16, 32, 64), **spec_kw),
            params=jparams, event_cb=jev.append)
        res = asyncio.run(_serve(jeng, _reqs("jax", prompts, n)))
        out["jax"] = {"streams": [t for t, _ in res], "events": jev,
                      "engine": jeng}
        _RUNS[name] = out
        return out

    return get


@pytest.mark.parametrize("name", list(CONFIGS))
def test_spec_streams_equal_plain_and_jax(runs, name):
    r = runs(name)
    n = CONFIGS[name][3]
    spec = r["spec"]["streams"]
    assert all(len(t) == n for t in spec)
    assert spec == r["plain"]["streams"]
    assert spec == r["jax"]["streams"]
    eng = r["spec"]["engine"]
    st = eng.spec_stats
    assert st.num_drafts > 0 and eng.verify_steps > 0
    # a round delivers one output a row: fewer frames than tokens wherever
    # a draft was accepted
    if st.num_accepted_tokens:
        assert sum(r["spec"]["frames"]) < sum(len(t) for t in spec)
    if "draft_layers" in str(CONFIGS[name][1]):
        assert eng.draft_steps > 0
    assert eng.pipelined_steps == 0  # speculation keeps the serial loop


@pytest.mark.parametrize("name", list(CONFIGS))
def test_spec_events_and_stats_equal_jax(runs, name):
    r = runs(name)
    eng, jeng = r["spec"]["engine"], r["jax"]["engine"]
    assert _events(r["spec"]["events"]) == _events(r["jax"]["events"])
    assert any(e.stored_blocks for e in r["spec"]["events"])
    assert vars(eng.spec_stats) == vars(jeng.spec_stats)
    st = eng.spec_stats
    assert 0 <= st.num_accepted_tokens <= st.num_draft_tokens
    assert st.num_spec_tokens >= st.num_drafts
    assert ({k for k in eng.compiled_signatures if k[0] in ("verify",
                                                             "draft")}
            == {k for k in jeng.compiled_signatures
                if k[0] in ("verify", "draft")})
    metrics = eng._metrics()
    assert metrics.spec_decode_stats is eng.spec_stats
    assert metrics.to_wire()["spec_decode_stats"]["num_drafts"] > 0


def test_verify_groups_and_full_acceptance(runs):
    """The grouped configuration verified some round in two steps; the
    full-depth draft is the model, so every draft is accepted."""
    grouped = runs("lookup_groups")["spec"]["engine"]
    assert {T for k, T in grouped.compiled_signatures if k == "verify"} \
        == {8, 16}
    assert grouped.verify_steps > grouped.spec_rounds > 0
    st = runs("draft_full")["spec"]["engine"].spec_stats
    assert st.num_accepted_tokens / max(1, st.num_draft_tokens) > 0.9, vars(st)
    assert runs("int8_lookup")["spec"]["engine"].k_cache["q"].dtype == \
        torch.int8


def test_plain_engine_counts_no_drafts(runs):
    plain = runs("lookup_k4")["plain"]["engine"]
    assert plain.spec_stats.num_drafts == 0 and plain.verify_steps == 0
    assert plain._metrics().spec_decode_stats is None


def test_speculation_switched_off_and_on_in_a_live_engine(runs):
    """An engine made with speculative_tokens=4 serves with speculation
    switched off (no draft, the pipelined loop allowed) and on again, on
    the staging buffer and verify scratch it was made with: both runs
    stream the JAX spec engine's tokens."""
    model, knobs, prompts, n = CONFIGS["lookup_k4"]
    ref = runs("lookup_k4")
    eng = AsyncTorchEngine(ModelConfig.tiny(), EngineArgs(**SETTINGS,
                                                          **knobs),
                           params=ref["spec"]["engine"].params, device="cpu")
    scratch, staging = eng._verify_logits, eng._staging.dev

    async def run():
        async def serve():
            res = await asyncio.gather(*(
                _one(eng, r) for r in _reqs("torch", prompts, n)))
            return [t for t, _ in res]

        eng.args.speculative_tokens = 0
        off = await serve()
        drafts = eng.spec_stats.num_drafts
        eng.pool.clear()
        eng.args.speculative_tokens = 4
        on = await serve()
        await eng.close()
        return off, drafts, on

    off, drafts, on = asyncio.run(run())
    assert drafts == 0 and eng.spec_stats.num_drafts > 0
    assert off == on == ref["jax"]["streams"]
    assert eng._verify_logits is scratch and eng._staging.dev is staging


# ------------------------------------------------ constrained, skipped rows

VOCAB = [""] + [chr(32 + i) for i in range(255)]
GUIDEDS = [
    {"regex": r"[ab]{6}"},
    {"choice": ["apple", "banana"]},
    {"json": {"type": "object", "properties": {"ok": {"type": "boolean"},
                                               "k": {"enum": ["x", "yz"]}}}},
]


def test_constrained_spec_rows_equal_host_oracle():
    """Device-FSM rows verify under the mask words walked along their
    drafts (``verify_fsm``) and stream what the host oracle's single steps
    stream (``tests/test_structured.py``'s spec case)."""
    def engine(params=None, **kw):
        return AsyncTorchEngine(ModelConfig.tiny(), EngineArgs(
            block_size=16, num_blocks=64, max_num_seqs=4,
            max_num_batched_tokens=128, max_model_len=128, **kw),
            params=params, device="cpu", guided_vocab=VOCAB)

    def reqs():
        return [PreprocessedRequest(
            model="t", token_ids=[1, 2, 3],
            sampling_options=SamplingOptions(temperature=0.0, guided=g),
            stop_conditions=StopConditions(max_tokens=24),
            eos_token_ids=[2]) for g in GUIDEDS]

    async def run(eng):
        try:
            out = []
            for r in reqs():
                toks = []
                async for o in eng.generate(r):
                    toks.extend(o.token_ids)
                out.append(toks)
            return out
        finally:
            await eng.close()

    spec = engine(speculative_tokens=3)
    host = engine(params=spec.params, structured_device=False)
    a = asyncio.run(run(spec))
    assert a == asyncio.run(run(host))
    assert any(k[0] == "verify_fsm" for k in spec.compiled_signatures)
    assert spec.spec_stats.num_drafts > 0
    txt = "".join(VOCAB[t] for t in a[0] if t != 2)
    assert re.fullmatch(r"[ab]{6}", txt), txt


def test_sampled_and_logprob_requests_skip_speculation():
    """Sampled and logprobs requests bypass the spec path (greedy only, no
    top-k capture); a greedy request right after engages it."""
    eng = AsyncTorchEngine(ModelConfig.tiny(), EngineArgs(
        speculative_tokens=4, **SETTINGS), device="cpu")
    prompt = [11, 12, 13, 14] * 4

    async def one(**kw):
        out = kw.pop("output", None)
        r = _reqs("torch", [prompt], 8)[0]
        r.sampling_options = SamplingOptions(**kw)
        if out is not None:
            r.output_options = out
        toks = []
        async for o in eng.generate(r):
            toks.extend(o.token_ids)
        return toks

    async def run():
        try:
            await one(temperature=0.8, seed=3)
            sampled = eng.spec_stats.num_drafts
            await one(temperature=0.0, output=OutputOptions(logprobs=2))
            logprobs = eng.spec_stats.num_drafts
            await one(temperature=0.0)
            return sampled, logprobs, eng.spec_stats.num_drafts
        finally:
            await eng.close()

    assert asyncio.run(run())[:2] == (0, 0)
    assert eng.spec_stats.num_drafts > 0


# ----------------------------------------------------------------- governor


def test_governor_suspends_and_reprobes_as_jax():
    """A losing window (one token a row a round) suspends speculation,
    counted, until spec_reprobe_steps steps have passed; a winning window
    never trips it. The JAX engine's governor on the same inputs agrees
    at every point."""
    kw = dict(speculative_tokens=4, spec_gain_window=8,
              spec_reprobe_steps=100)
    eng = AsyncTorchEngine(ModelConfig.tiny(), EngineArgs(**SETTINGS, **kw),
                           device="cpu")
    jeng = AsyncJaxEngine(JaxModelConfig.tiny(), JaxEngineArgs(
        prefill_buckets=(8, 16, 32, 64), **SETTINGS, **kw))

    def state(e):
        return (e._spec_active(), e.spec_disabled_total,
                e.spec_measured_gain)

    assert state(eng) == state(jeng) == (True, 0, None)
    for e in (eng, jeng):
        for _ in range(8):
            e._note_spec_result(emitted=2, n_seqs=2)
    assert state(eng) == state(jeng)
    assert not eng._spec_active() and eng.spec_disabled_total == 1
    assert eng.spec_measured_gain < 1.0
    for e in (eng, jeng):
        e.steps += 100
        for _ in range(8):
            e._note_spec_result(emitted=6, n_seqs=2)  # 3 tokens a row
    assert state(eng) == state(jeng)
    assert eng._spec_active() and eng.spec_disabled_total == 1
    # measured walls re-baseline the cost: capped by the static estimate,
    # floored at 1.01
    for e in (eng, jeng):
        e._spec_round_ms, e._decode_step_ms = 30.0, 10.0
    assert eng._spec_dispatch_cost() == jeng._spec_dispatch_cost() == 1.05
    for e in (eng, jeng):
        e._spec_round_ms = 5.0
    assert eng._spec_dispatch_cost() == jeng._spec_dispatch_cost() == 1.01
    asyncio.run(jeng.close())


def test_suspended_spec_takes_the_plain_step():
    """While suspended, decode dispatches no draft and no verify, and the
    stream is plain greedy decode's; the plain decode-only steps feed the
    governor's step wall."""
    eng = AsyncTorchEngine(ModelConfig.tiny(), EngineArgs(
        speculative_tokens=4, **SETTINGS), device="cpu")
    plain = AsyncTorchEngine(ModelConfig.tiny(), EngineArgs(**SETTINGS),
                             params=eng.params, device="cpu")
    eng._spec_resume_step = 10_000_000  # the governor tripped
    prompt = [11, 12, 13, 14] * 4
    got = asyncio.run(_serve(eng, _reqs("torch", [prompt], 8)))
    want = asyncio.run(_serve(plain, _reqs("torch", [prompt], 8)))
    assert got[0][0] == want[0][0] and len(got[0][0]) == 8
    assert eng.spec_stats.num_drafts == 0 and eng.verify_steps == 0
    assert eng._decode_step_ms is not None


# ------------------------------------------------------------------- warmup


@pytest.mark.parametrize("method", ["prompt_lookup", "draft_layers"])
def test_warmup_covers_every_spec_signature(method):
    """warmup() runs every verify bucket 1 .. max_num_seqs rows can pick
    (masked too: the engine has an FSM arena) and the draft burst of every
    row count; serving greedy, constrained and grouped traffic after it
    captures nothing, and its streams equal an eager engine's."""
    def engine(params=None):
        return AsyncTorchEngine(ModelConfig.tiny(), EngineArgs(
            block_size=4, num_blocks=256, max_num_seqs=6,
            max_num_batched_tokens=16, max_model_len=256,
            speculative_tokens=3, speculative_method=method,
            speculative_draft_layers=1), params=params, device="cpu",
            guided_vocab=VOCAB)

    guided = PreprocessedRequest(
        model="t", token_ids=[1, 2, 3],
        sampling_options=SamplingOptions(temperature=0.0,
                                         guided=GUIDEDS[0]),
        stop_conditions=StopConditions(max_tokens=12), eos_token_ids=[2])

    async def serve(eng, warm):
        try:
            rep = await eng.warmup() if warm else None
            caps = dict(eng.compile_events)
            out = [t for t, _ in await asyncio.gather(
                *(_one(eng, r) for r in _reqs("torch", REPETITIVE + RANDOM,
                                              10) + [guided]))]
            return rep, caps, out
        finally:
            await eng.close()

    eager = engine()
    _, _, want = asyncio.run(serve(eager, False))
    warm = engine(params=eager.params)
    warm.graphs = fake = RerunGraphs()
    warm.use_graphs = True
    rep, caps, got = asyncio.run(serve(warm, True))
    assert got == want
    # nothing captured while serving but the constrained prefill's FSM
    # sampler (keyed by the arena's address, which warmup does not know)
    assert {k: v for k, v in warm.compile_events.items() if k != "sample"} \
        == {k: v for k, v in caps.items() if k != "sample"}
    assert warm.spec_stats.num_drafts > 0 and fake.replays > 0
    Ts = verify_buckets(warm.args)
    assert Ts == [8, 16]
    assert sorted(rep["verify"]) == sorted(
        (k, T) for T in Ts for k in ("verify", "verify_fsm"))
    assert {k for k in fake.graphs if k[0].startswith("verify")} == set(
        rep["verify"])
    if method == "draft_layers":
        assert rep["draft"] == [6]
        assert {k for k in fake.graphs if k[0] == "draft"} == {
            ("draft", 6, 3, 1)}
    else:
        assert rep["draft"] == []
    served = {k for k in warm.compiled_signatures
              if k[0] in ("verify", "verify_fsm")}
    assert served <= set(rep["verify"])


async def _one(eng, r):
    toks = []
    async for o in eng.generate(r):
        toks.extend(o.token_ids)
    return toks, None


def test_top_logprobs_bypass_burst_and_speculation():
    """The twin of ``tests/test_perf_logprobs.py::
    test_engine_emits_top_logprobs`` with ``multi_step_decode=4`` and with
    ``speculative_tokens=4``: a greedy logprobs request takes neither fast
    path, and each token comes with its sorted top logprobs, the chosen
    one first."""
    for kw in (dict(multi_step_decode=4), dict(speculative_tokens=4)):
        eng = AsyncTorchEngine(ModelConfig.tiny(), EngineArgs(
            block_size=4, num_blocks=64, max_num_seqs=4,
            max_num_batched_tokens=32, max_model_len=128, **kw),
            device="cpu")
        req = PreprocessedRequest(
            model="t", token_ids=list(range(1, 9)),
            stop_conditions=StopConditions(max_tokens=5, ignore_eos=True),
            sampling_options=SamplingOptions(temperature=0.0),
            output_options=OutputOptions(logprobs=3))

        async def run():
            outs = []
            try:
                async for out in eng.generate(req):
                    outs.append(out)
            finally:
                await eng.close()
            return outs

        outs = asyncio.run(run())
        toks = [t for o in outs for t in o.token_ids]
        tops = [tp for o in outs for tp in (o.top_logprobs or [])]
        assert len(tops) == len(toks) == 5
        for tok, alts in zip(toks, tops):
            assert 1 <= len(alts) <= 3
            lps = [p for _, p in alts]
            assert lps == sorted(lps, reverse=True)
            assert alts[0][0] == tok
            assert all(p <= 0.0 for p in lps)
        assert eng.bursts == 0 and eng.spec_stats.num_drafts == 0
