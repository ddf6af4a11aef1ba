"""Step signatures, warmup and the graph discipline of the torch port, on
the CPU.

- ``AsyncTorchEngine.warmup()`` runs each (kind, T) of every token bucket
  exactly once and leaves the JAX engine's ``compiled_signatures`` after
  the same warmup; a request inside the warmed envelope adds none (the
  port of ``tests/test_pipelined_engine.py``'s warmup test).
- The knobs this slice lifts: ``EngineArgs(warmup_buckets=True,
  multi_step_decode=4)`` and the worker's ``--warmup-buckets``,
  ``--warmup-seq-lens`` and ``--multi-step-decode``.
- ``GraphCache``'s bookkeeping with torch.cuda's graph calls replaced by
  stand-ins: one eager run and one capture per key, launch counts taken
  back after the capture and added at each replay.
- The engine's steps through a stand-in cache that replays a signature by
  running the callable of its first use again into that use's outputs:
  what a replay does (the same launches on the same tensors, the outputs
  overwritten in place). Greedy, seeded, device-FSM (a second constraint
  placed after the sampler's capture) and burst streams, on both decode
  loops, must equal the eager engine's. A tensor a step allocates anew, a
  feed copied after the replay, or an output read after the next replay
  would break them.
"""

import asyncio

import pytest
import torch

from dynamo_tpu.engine.config import EngineArgs as JaxEngineArgs
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import AsyncJaxEngine
from dynamo_tpu_torch.engine import graphs as G
from dynamo_tpu_torch.engine import main
from dynamo_tpu_torch.engine.config import (
    UNPORTED_KNOBS, EngineArgs, ModelConfig,
)
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.ops.ragged_attention import ragged_paged_attention
from dynamo_tpu_torch.protocols import (
    PreprocessedRequest, SamplingOptions, StopConditions,
)

#: tests/test_pipelined_engine.py's engine, at two token buckets
SETTINGS = dict(block_size=4, num_blocks=128, max_num_seqs=8,
                max_num_batched_tokens=16, max_model_len=256)


def _req(tokens, n, **sampling):
    return PreprocessedRequest(
        model="tiny", token_ids=list(tokens),
        sampling_options=SamplingOptions(**sampling),
        stop_conditions=StopConditions(max_tokens=n, ignore_eos=True))


async def _collect(eng, r):
    toks = []
    async for out in eng.generate(r):
        toks.extend(out.token_ids)
    return toks


def test_warmup_runs_each_signature_once_as_jax():
    eng = AsyncTorchEngine(ModelConfig.tiny(), EngineArgs(**SETTINGS),
                           device="cpu")
    seen = []
    real = eng.step_fn

    def counting(params, ints5, rows3, gr, bt, k, v):
        seen.append(("ragged" if gr is not None else "ragged_dec",
                     ints5.shape[1]))
        return real(params, ints5, rows3, gr, bt, k, v)

    eng.step_fn = counting

    async def run():
        try:
            rep = await eng.warmup(seq_lens=[14])
            calls = list(seen)
            warm = set(eng.compiled_signatures)
            toks = await _collect(eng, _req(range(1, 11), 4))
            return rep, calls, warm, toks
        finally:
            await eng.close()

    rep, calls, warm, toks = asyncio.run(run())
    buckets = list(eng.args.ragged_token_buckets)
    assert buckets == [8, 16]
    for kind in ("ragged", "ragged_dec"):
        assert sorted(t for k, t, *_ in rep["ragged"] if k == kind) == buckets
    assert len(calls) == len(set(calls)) == 2 * len(buckets)
    assert rep["sample"] == [8] and rep["seconds"] >= 0
    assert eng.warmed_up
    # a request inside the warmed envelope: no new signature
    assert len(toks) == 4
    assert eng.compiled_signatures == warm
    with pytest.raises(RuntimeError, match="before serving"):
        _warmup_with_work(eng)

    jeng = AsyncJaxEngine(JaxModelConfig.tiny(), JaxEngineArgs(
        prefill_buckets=(8, 16), **SETTINGS))
    try:
        jrep = asyncio.run(jeng.warmup(seq_lens=[14]))
    finally:
        asyncio.run(jeng.close())
    assert jeng.compiled_signatures == warm
    assert rep["ragged"] == [tuple(r) for r in jrep["ragged"]]
    assert rep["sample"] == jrep["sample"]


def _warmup_with_work(eng):
    """warmup() once a sequence is scheduled."""
    eng.scheduler.running.append(None)
    try:
        asyncio.run(eng.warmup())
    finally:
        eng.scheduler.running.clear()


def test_lifted_knobs_are_accepted():
    for name in ("multi_step_decode", "warmup_buckets"):
        assert name not in UNPORTED_KNOBS
    assert "warmup_seq_lens" not in main.REFUSED_FLAGS
    args = EngineArgs(warmup_buckets=True, multi_step_decode=4)
    assert args.warmup_buckets and args.multi_step_decode == 4
    cli = main.build_parser().parse_args([
        "--allow-test-metadata", "--device", "cpu", "--warmup-buckets",
        "--warmup-seq-lens", "14,200", "--multi-step-decode", "4"])
    _cfg, args, _eos, _tok = main.configure(cli)
    assert args.warmup_buckets and args.multi_step_decode == 4
    assert main.warmup_seq_lens(cli) == [14, 200]
    cli.warmup_seq_lens = "14,x"
    with pytest.raises(SystemExit, match="comma-separated"):
        main.configure(cli)


# ------------------------------------------------------ GraphCache on fakes


class _FakeGraph:
    def replay(self):
        pass


class _FakeGraphCtx:
    """torch.cuda.graph: runs the body (as a capture records it)."""

    def __init__(self, graph, **kw):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_graph_cache_counts_replays(monkeypatch):
    for name, fake in (("graph_pool_handle", lambda: (0, 1)),
                       ("Stream", lambda device=None: None),
                       ("synchronize", lambda device=None: None),
                       ("empty_cache", lambda: None),
                       ("memory_reserved", lambda device=None: 0),
                       ("CUDAGraph", _FakeGraph),
                       ("graph", _FakeGraphCtx)):
        monkeypatch.setattr(torch.cuda, name, fake)
    monkeypatch.setattr(ragged_paged_attention, "launches", 0)
    cache = G.GraphCache(torch.device("cpu"))
    calls = []

    def step():
        calls.append(1)
        ragged_paged_attention.launches += 3  # three launches a run
        return len(calls)

    out, secs = cache.run(("ragged", 8), step)
    # the eager run counts, the capture's launches are taken back
    assert out == 1 and secs is not None and len(calls) == 2
    assert ragged_paged_attention.launches == 3
    assert ("ragged", 8) in cache and len(cache) == 1
    for i in range(4):
        out, secs = cache.run(("ragged", 8), step)
        assert out == 2 and secs is None  # the capture's static output
    assert len(calls) == 2  # a replay calls nothing in Python
    assert ragged_paged_attention.launches == 3 + 4 * 3
    cache.clear()
    assert len(cache) == 0


# ------------------------------------------------- the engine under replays


def _copy_into(static, new):
    if isinstance(static, torch.Tensor):
        static.copy_(new)
    elif isinstance(static, (tuple, list)):
        for s, n in zip(static, new):
            _copy_into(s, n)


class RerunGraphs:
    """A stand-in for ``GraphCache``: a new key runs eagerly, then once
    more into outputs of its own (the capture's static outputs); a replay
    runs the first use's callable again and copies what it returns into
    those outputs."""

    def __init__(self):
        self.graphs = {}
        self.replays = 0

    def clear(self):
        self.graphs.clear()

    def __len__(self):
        return len(self.graphs)

    def __contains__(self, key):
        return key in self.graphs

    def run(self, key, fn):
        g = self.graphs.get(key)
        if g is not None:
            _copy_into(g[1], g[0]())
            self.replays += 1
            return g[1], None
        out = fn()
        self.graphs[key] = (fn, fn())
        return out, 0.0


VOCAB = [""] + [chr(32 + i) for i in range(255)]


def test_replayed_steps_give_eager_streams():
    cfg = ModelConfig.tiny()

    def engine(params=None, **kw):
        return AsyncTorchEngine(cfg, EngineArgs(
            block_size=4, num_blocks=256, max_num_seqs=8,
            max_num_batched_tokens=32, max_model_len=256, **kw),
            params=params, device="cpu", guided_vocab=VOCAB)

    def reqs():
        free = [_req(range(1 + i, 14 + 3 * i), 9, **o) for i, o in enumerate(
            [{}, {"temperature": 0.8, "seed": 5},
             {"temperature": 0.9, "top_k": 7, "top_p": 0.9, "seed": 6}])]
        guided = [PreprocessedRequest(
            model="t", token_ids=[1, 2, 3],
            sampling_options=SamplingOptions(temperature=t, seed=4,
                                             guided=g),
            stop_conditions=StopConditions(max_tokens=16),
            eos_token_ids=[2])
            for g, t in (({"regex": r"[ab]{5}"}, 0.0),
                         ({"choice": ["yes", "no"]}, 0.7))]
        return free, guided

    async def serve(eng):
        out = []
        try:
            for pipeline in (True, False):
                eng.args.pipeline_decode = pipeline
                eng.pool.clear()
                free, guided = reqs()
                out.append(await asyncio.gather(
                    *(_collect(eng, r) for r in free)))
                # one constraint after the other: the second's arena rows
                # are placed after the FSM sampler was first used
                out.append([await _collect(eng, r) for r in guided])
            eng.args.multi_step_decode = 4
            free, guided = reqs()
            out.append(await asyncio.gather(
                *(_collect(eng, r) for r in free + guided)))
        finally:
            await eng.close()
        return out

    eager = engine()
    want = asyncio.run(serve(eager))
    replayed = engine(params=eager.params)
    replayed.graphs = fake = RerunGraphs()
    replayed.use_graphs = True
    got = asyncio.run(serve(replayed))
    assert got == want
    kinds = {k[0] for k in fake.graphs}
    assert {"ragged", "ragged_dec", "sample", "multi"} <= kinds, kinds
    assert fake.replays > 20
    assert replayed.pipelined_steps > 0 and replayed.bursts > 0
    assert sum(replayed.compile_events.values()) == len(fake.graphs)
