"""Disaggregated prefill/decode in the torch port, held against the JAX
package (``dynamo_tpu/disagg``, ``tests/test_disagg.py``).

- The wire: every protocol dict (bundles f32, bf16 and packed int8, layer
  slices, chunk and layer frames, the prefill response, the kv_pull block
  frame) is the JAX one key for key and byte for byte, and each package
  reads the other's.
- The flows, on the tiny model with the JAX package's random weights: a
  torch prefill engine and a torch decode engine behind the port's
  handlers give the JAX aggregated engine's stream (greedy, seeded with
  logprobs, penalties, a device-FSM guided constraint), whole-bundle and
  pipelined (chunk frames, then the layer-group tail), with the KV stored
  events of a local prefill; every failure case returns its blocks; the
  prefill queue claims, times out to round robin, and the threshold is
  live from the control plane.

Every wait on a stream is bounded (``asyncio.wait_for``), so a fault fails
the test instead of hanging it.
"""

import asyncio

import jax
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

from dynamo_tpu.disagg import protocols as JP
from dynamo_tpu.engine import model as M
from dynamo_tpu.engine.config import EngineArgs as JaxEngineArgs
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import AsyncJaxEngine
from dynamo_tpu.kvbm import distributed as JD
from dynamo_tpu.protocols import OutputOptions as JaxOutput
from dynamo_tpu.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols import SamplingOptions as JaxSampling
from dynamo_tpu.protocols import StopConditions as JaxStop
from dynamo_tpu_torch.disagg import protocols as TP
from dynamo_tpu_torch.disagg.handlers import (
    DecodeWorkerHandler, DisaggConfigWatcher, PrefillWorkerHandler,
)
from dynamo_tpu_torch.disagg.protocols import (
    DisaggConfig, KvChunkFrame, KvLayerFrame, PrefillResponse,
)
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.engine.weights import params_from_jax
from dynamo_tpu_torch.kvbm import distributed as TD
from dynamo_tpu_torch.protocols import (
    FinishReason, OutputOptions, PreprocessedRequest, SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime.codec import packb, unpackb
from dynamo_tpu_torch.runtime.control_plane import LocalControlPlane
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

pytestmark = pytest.mark.anyio

SETTINGS = dict(block_size=4, num_blocks=128, max_num_seqs=8,
                max_num_batched_tokens=64, max_model_len=256)
VOCAB = [""] + [chr(32 + i) for i in range(ModelConfig.tiny().vocab_size - 1)]
#: 150 tokens: three chunks of at most 64, ending mid-block
PROMPT = [int(t) for t in np.random.default_rng(11).integers(3, 250, 150)]
#: every wait on a stream or a pull
WAIT_S = 60

_PARAMS: dict = {}


def _jparams():
    if "jax" not in _PARAMS:
        _PARAMS["jax"] = M.init_params(JaxModelConfig.tiny(),
                                       jax.random.key(0))
    return _PARAMS["jax"]


def make_engine(**kw) -> AsyncTorchEngine:
    """A tiny CPU engine on the JAX package's random weights. These tests
    hold the host-staged transfer, so the direct one is off (two engines
    of one process would negotiate it: test_torch_direct_transfer.py)."""
    if "torch" not in _PARAMS:
        _PARAMS["torch"] = params_from_jax(
            jax.tree.map(np.asarray, _jparams()), "cpu")
    event_cb = kw.pop("event_cb", None)
    return AsyncTorchEngine(ModelConfig.tiny(),
                            EngineArgs(**{**SETTINGS,
                                          "kv_transfer_direct": False, **kw}),
                            params=_PARAMS["torch"], device="cpu",
                            guided_vocab=VOCAB, event_cb=event_cb)


def req(tokens=PROMPT, max_tokens=8, sampling=None, output=None):
    return PreprocessedRequest(
        model="tiny", token_ids=list(tokens),
        stop_conditions=StopConditions(max_tokens=max_tokens,
                                       ignore_eos=True),
        sampling_options=sampling or SamplingOptions(),
        output_options=output or OutputOptions())


async def through_handler(dh, r, ctx=None):
    """Tokens, logprobs and finish reasons of a decode handler's stream."""
    async def run():
        toks, lps, reasons = [], [], []
        async for frame in dh.generate(r.to_wire(), ctx):
            toks.extend(frame.get("token_ids") or [])
            lps.extend(frame.get("log_probs") or [])
            if frame.get("finish_reason"):
                reasons.append(frame["finish_reason"])
        return toks, lps, reasons
    return await asyncio.wait_for(run(), WAIT_S)


async def collect(eng, r):
    async def run():
        toks, lps = [], []
        async for out in eng.generate(r):
            toks.extend(out.token_ids)
            lps.extend(out.log_probs or [])
        return toks, lps
    return await asyncio.wait_for(run(), WAIT_S)


async def jax_reference(sampling=None, logprobs=None, guided=False,
                        kv_cache_dtype=None, tokens=PROMPT, max_tokens=8):
    """The JAX aggregated engine's (tokens, logprobs) on the same weights."""
    eng = AsyncJaxEngine(
        JaxModelConfig.tiny(), JaxEngineArgs(
            prefill_buckets=(8, 16, 32, 64), kv_cache_dtype=kv_cache_dtype,
            decode_batch_buckets=(1, 2, 4, 8), **SETTINGS),
        params=_jparams(), guided_vocab=VOCAB if guided else None)
    toks, lps = [], []
    try:
        async for out in eng.generate(JaxRequest(
                model="tiny", token_ids=list(tokens),
                sampling_options=JaxSampling(**vars(sampling or
                                                    SamplingOptions())),
                output_options=JaxOutput(logprobs=logprobs),
                stop_conditions=JaxStop(max_tokens=max_tokens,
                                        ignore_eos=True))):
            toks.extend(out.token_ids)
            lps.extend(out.log_probs or [])
    finally:
        await eng.close()
    return toks, lps


async def jax_alone(prompts, max_tokens=8):
    """The JAX aggregated engine's greedy stream of each prompt alone."""
    eng = AsyncJaxEngine(
        JaxModelConfig.tiny(), JaxEngineArgs(
            prefill_buckets=(8, 16, 32, 64),
            decode_batch_buckets=(1, 2, 4, 8), **SETTINGS),
        params=_jparams())
    out = []
    try:
        for p in prompts:
            toks = []
            async for o in eng.generate(JaxRequest(
                    model="tiny", token_ids=list(p),
                    stop_conditions=JaxStop(max_tokens=max_tokens,
                                            ignore_eos=True))):
                toks.extend(o.token_ids)
            out.append(toks)
    finally:
        await eng.close()
    return out


class LocalPrefillClient:
    """Routes the decode handler's prefill calls to an in-process
    PrefillWorkerHandler, recording how each was dispatched."""

    def __init__(self, ph, ids=(1,), die_after_chunk=False):
        self.ph = ph
        self.ids = list(ids)
        self.calls = []
        self.frames = []
        self.die_after_chunk = die_after_chunk

    def available_ids(self):
        return self.ids

    async def generate(self, request, ctx=None, mode="round_robin",
                       instance_id=None):
        self.calls.append((mode, instance_id))

        async def stream():
            async for frame in self.ph.generate(request, ctx):
                self.frames.append(
                    "chunk" if KvChunkFrame.is_wire(frame) else
                    "layer" if KvLayerFrame.is_wire(frame) else "final")
                yield frame
                if self.die_after_chunk and KvChunkFrame.is_wire(frame):
                    raise ConnectionError("prefill worker died")
        return stream()


async def _settled(eng, free0):
    for _ in range(100):
        if eng.pool.num_free_blocks == free0 and not eng.scheduler.has_work:
            return True
        await asyncio.sleep(0.02)
    return False


# ------------------------------------------------------------------ wire

def _pair(kind):
    """(torch tensor, numpy array) of the same bytes."""
    x = np.random.default_rng(5).standard_normal((2, 3, 4, 2, 8)).astype(
        np.float32)
    if kind == "float32":
        return torch.from_numpy(x.copy()), x
    if kind == "bfloat16":
        return (torch.from_numpy(x).to(torch.bfloat16),
                x.astype(ml_dtypes.bfloat16))
    u = np.random.default_rng(6).integers(0, 256, (2, 3, 4 * 2 * 12),
                                          dtype=np.uint8)
    return torch.from_numpy(u.copy()), u


def _objects(case):
    kind = {"bf16": "bfloat16", "packed": "uint8"}.get(case, "float32")
    tk, jk = _pair(kind)
    tv, jv = tk + 1 if kind != "uint8" else tk.flip(0), (
        (jk + 1).astype(jk.dtype) if kind != "uint8" else jk[::-1].copy())
    layer = dict(start_layer=1, total_layers=4) if case == "layer" else {}
    tb = TP.KvBundle(k=tk, v=tv, num_tokens=11, block_size=4,
                     start_block=2, **layer)
    jb = JP.KvBundle(k=jk, v=jv, num_tokens=11, block_size=4,
                     start_block=2, **layer)
    if case == "chunk":
        return TP.KvChunkFrame(tb), JP.KvChunkFrame(jb), "KvChunkFrame"
    if case == "layer_frame":
        return TP.KvLayerFrame(tb), JP.KvLayerFrame(jb), "KvLayerFrame"
    if case == "response":
        return (TP.PrefillResponse(7, -0.5, tb),
                JP.PrefillResponse(7, -0.5, jb), "PrefillResponse")
    if case == "response_empty":
        return (TP.PrefillResponse(-1, None, None),
                JP.PrefillResponse(-1, None, None), "PrefillResponse")
    return tb, jb, "KvBundle"


@pytest.mark.parametrize("case", ["f32", "bf16", "packed", "layer", "chunk",
                                  "layer_frame", "response",
                                  "response_empty"])
def test_wire_dicts_equal_jax_both_ways(case):
    t_obj, j_obj, name = _objects(case)
    tw, jw = t_obj.to_wire(), j_obj.to_wire()
    assert msgpack.packb(tw) == msgpack.packb(jw)
    assert packb(tw) == msgpack.packb(jw)
    # each package reads the other's, after the wire
    back_t = getattr(TP, name).from_wire(unpackb(msgpack.packb(jw)))
    back_j = getattr(JP, name).from_wire(msgpack.unpackb(packb(tw),
                                                         raw=False))
    assert packb(back_t.to_wire()) == packb(tw)
    assert msgpack.packb(back_j.to_wire()) == msgpack.packb(jw)
    assert TP.DisaggConfig.KEY == JP.DisaggConfig.KEY
    assert (TP.DisaggConfig().max_local_prefill_length
            == JP.DisaggConfig().max_local_prefill_length)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "uint8"])
def test_kv_pull_block_frame_equals_jax(kind):
    tk, jk = _pair(kind)
    tk, jk = tk[:, 0], jk[:, 0]
    tw, jw = TD._pack_block(99, tk, tk), JD._pack_block(99, jk, jk)
    assert msgpack.packb(tw) == msgpack.packb(jw)
    h, k, v = TD._unpack_block(unpackb(msgpack.packb(jw)))
    assert h == 99 and TP.tensor_bytes(k) == jk.tobytes()
    h, k, _v = JD._unpack_block(msgpack.unpackb(packb(tw), raw=False))
    assert h == 99 and k.tobytes() == jk.tobytes()


# ----------------------------------------------------------------- flows

CASES = {
    "greedy": (None, None, False),
    "seeded_logprobs": (SamplingOptions(temperature=0.8, top_p=0.9,
                                        seed=1234), 2, False),
    "penalties": (SamplingOptions(repetition_penalty=1.3,
                                  frequency_penalty=0.4), None, False),
    "guided_fsm": (SamplingOptions(guided={"regex": "[ab]{6}"}), None,
                   True),
}


@pytest.mark.parametrize("path", ["bundle", "pipelined"])
@pytest.mark.parametrize("case", list(CASES))
async def test_disagg_matches_jax_aggregated(case, path):
    """Prefill on one torch engine, decode on another: the JAX aggregated
    stream, token for token (logprobs within 1e-5), and the decode
    engine's KV stored events those of a local prefill. The penalty case
    is held against the torch aggregated engine (the JAX engine recompiles
    its logit edits per shape, 12 s here; test_torch_engine.py holds the
    port's penalties against it)."""
    sampling, logprobs, guided = CASES[case]
    r = req(sampling=sampling, output=OutputOptions(logprobs=logprobs))
    local_events, events = [], []
    loc = make_engine(event_cb=local_events.append)
    local = await collect(loc, r)
    await loc.close()
    want = (local if case == "penalties"
            else await jax_reference(sampling, logprobs, guided))

    pre, dec = make_engine(), make_engine(event_cb=events.append)
    free0 = dec.pool.num_free_blocks
    try:
        if path == "bundle":
            presp = await asyncio.wait_for(pre.prefill_extract(r), WAIT_S)
            assert presp.bundle.num_tokens == len(PROMPT)
            presp = PrefillResponse.from_wire(unpackb(packb(
                presp.to_wire())))
            toks, lps = [], []

            async def run():
                async for out in dec.generate_injected(r, presp):
                    toks.extend(out.token_ids)
                    lps.extend(out.log_probs or [])
            await asyncio.wait_for(run(), WAIT_S)
            got = (toks, lps)
        else:
            client = LocalPrefillClient(PrefillWorkerHandler(pre))
            dh = DecodeWorkerHandler(
                dec, client, DisaggConfig(max_local_prefill_length=8))
            toks, lps, reasons = await through_handler(dh, r)
            got = (toks, lps)
            assert client.frames.count("chunk") >= 2
            assert client.frames.count("layer") == 2  # the tiny model's L
            assert client.frames[-1] == "final"
            assert "fallbacks" not in dh.report()
            assert dh.report()["remote_prefills"] == {"placed": 1}
            if not guided:
                assert reasons == [FinishReason.LENGTH]
        assert got[0] == want[0]
        assert got[1] == pytest.approx(want[1], abs=1e-5)
        assert await _settled(dec, free0)
        assert ([[b.block_hash for b in e.stored_blocks] for e in events]
                == [[b.block_hash for b in e.stored_blocks]
                    for e in local_events])
    finally:
        await pre.close()
        await dec.close()


@pytest.mark.parametrize("loop", [dict(pipeline_decode=False),
                                  dict(multi_step_decode=4)])
async def test_disagg_on_the_serial_loop_and_the_burst(loop):
    """Both engines on the serial loop, or decoding in bursts of four: the
    chunk frames still ship from the progress callback, and the stream is
    the JAX aggregated one (two requests share the decode engine)."""
    want = await jax_alone([PROMPT, PROMPT[:-1]])
    pre, dec = make_engine(**loop), make_engine(**loop)
    client = LocalPrefillClient(PrefillWorkerHandler(pre))
    dh = DecodeWorkerHandler(dec, client,
                             DisaggConfig(max_local_prefill_length=8))
    try:
        gots = await asyncio.gather(through_handler(dh, req()),
                                    through_handler(dh, req(PROMPT[:-1])))
        assert [g[0] for g in gots] == want
        assert client.frames.count("chunk") >= 2
        assert dh.report()["remote_prefills"] == {"placed": 2}
        if loop.get("multi_step_decode"):
            assert dec.bursts > 0
    finally:
        await pre.close()
        await dec.close()


async def test_concurrent_requests_each_equal_jax_aggregated():
    """Five prompts of other lengths and tokens at once through one float32
    pair: their chunk frames, layer assemblies and injected blocks overlap
    on both engines, and each stream is the JAX aggregated engine's stream
    of that prompt alone. Each request's blocks on the decode engine hold
    the prefill engine's bytes (the digests of both sides, by request
    id)."""
    from dynamo_tpu_torch.runtime.context import Context

    rng = np.random.default_rng(29)
    prompts = [[int(t) for t in rng.integers(3, 250, n)]
               for n in (150, 97, 131, 66, 120)]
    want = await jax_alone(prompts)
    pre = make_engine()
    dec = make_engine(kv_transfer_layer_groups=2)
    client = LocalPrefillClient(PrefillWorkerHandler(pre))
    dh = DecodeWorkerHandler(dec, client,
                             DisaggConfig(max_local_prefill_length=8))
    free0 = dec.pool.num_free_blocks
    try:
        gots = await asyncio.gather(*(
            through_handler(dh, req(p), Context(id=f"r{i}"))
            for i, p in enumerate(prompts)))
        assert [g[0] for g in gots] == want
        rep = dh.report()
        assert rep["remote_prefills"] == {"placed": len(prompts)}
        assert "fallbacks" not in rep
        sent = {r["id"]: r["digest"] for r in pre.extract_records()}
        got = {r["id"]: r["digest"] for r in rep["transfers"]}
        assert got == sent and len(got) == len(prompts)
        assert len(set(got.values())) == len(prompts)
        assert client.frames.count("layer") == 2 * len(prompts)
        assert await _settled(dec, free0)
    finally:
        await pre.close()
        await dec.close()


@pytest.mark.parametrize("layer_groups", [2, 1])
@pytest.mark.parametrize("decode", ["torch", "jax"])
async def test_frames_split_under_the_frame_cap(monkeypatch, layer_groups,
                                                decode):
    """With the frame cap at three blocks' pages, every chunk ships as
    frames of at most three blocks, and the tail as layer assemblies of
    three blocks (or chunk frames and a three-block final bundle); a torch
    and a JAX decode handler both place them and give the JAX aggregated
    stream."""
    from dynamo_tpu.disagg.handlers import DecodeWorkerHandler as JaxDecode
    from dynamo_tpu.disagg.protocols import DisaggConfig as JaxDisaggConfig
    from dynamo_tpu_torch.engine import engine as E
    from dynamo_tpu_torch.engine.cache import kv_block_bytes

    cfg = ModelConfig.tiny()
    monkeypatch.setattr(E, "FRAME_BYTES", 3 * kv_block_bytes(
        cfg, 4, torch.float32))
    want = await jax_reference()
    pre = make_engine()
    client = CodecPrefillClient(PrefillWorkerHandler(pre))
    if decode == "torch":
        dec = make_engine(kv_transfer_layer_groups=layer_groups)
        dh = DecodeWorkerHandler(dec, client,
                                 DisaggConfig(max_local_prefill_length=8))
    else:
        dec = AsyncJaxEngine(
            JaxModelConfig.tiny(), JaxEngineArgs(
                prefill_buckets=(8, 16, 32, 64),
                kv_transfer_layer_groups=layer_groups,
                decode_batch_buckets=(1, 2, 4, 8), **SETTINGS),
            params=_jparams())
        dh = JaxDecode(dec, client,
                       JaxDisaggConfig(max_local_prefill_length=8))
    try:
        got = await through_handler(dh, req())
        assert got[0] == want[0]
        (rec,) = pre.extract_log
        assert all(n <= 3 * kv_block_bytes(cfg, 4, torch.float32)
                   for _k, n, _t0, _t1 in rec["frames"])
        kinds = [f[0] for f in rec["frames"]]
        block = kv_block_bytes(cfg, 4, torch.float32)
        # every block ships once: chunk frames first (as many as the
        # backpressure let through), then the rest as layer assemblies of
        # two frames, or as the final bundle
        assert sum(n for _k, n, _t0, _t1 in rec["frames"]) == \
            (len(PROMPT) + 3) // 4 * block
        n_chunk = kinds.count("chunk")
        assert kinds[:n_chunk] == ["chunk"] * n_chunk and n_chunk >= 2
        rest = kinds[n_chunk:]
        if layer_groups > 1:
            assert rest == ["layer"] * len(rest) and len(rest) % 2 == 0
        else:
            assert rest == ["tail"]
        if decode == "torch":
            assert dh.report()["remote_prefills"] == {"placed": 1}
    finally:
        await pre.close()
        await dec.close()


async def test_prefill_blocks_released_after_extract():
    eng = make_engine()
    free0 = eng.pool.num_free_blocks
    presp = await asyncio.wait_for(eng.prefill_extract(req(PROMPT[:22])),
                                   WAIT_S)
    assert presp.bundle is not None and presp.bundle.num_blocks == 6
    assert eng.pool.num_free_blocks == free0
    assert eng.pool.num_active_blocks == 0
    await eng.close()


async def test_short_prompt_stays_local_long_goes_remote():
    pre, dec = make_engine(), make_engine()
    client = LocalPrefillClient(PrefillWorkerHandler(pre))
    dh = DecodeWorkerHandler(dec, client,
                             DisaggConfig(max_local_prefill_length=8))
    try:
        want = await jax_reference(tokens=PROMPT[:6])
        got = await through_handler(dh, req(PROMPT[:6]))
        assert got[0] == want[0] and client.calls == []
        # no prefill worker up: served locally too
        client.ids = []
        got = await through_handler(dh, req(PROMPT[:40]))
        assert client.calls == [] and len(got[0]) == 8
    finally:
        await pre.close()
        await dec.close()


async def test_stream_chunks_then_final_frame():
    """Without ``kv_layers`` the stream is chunk frames, contiguous, then
    the final response with the tail; with it the tail rides layer frames
    covering every layer."""
    pre = make_engine()
    try:
        for annotations, tail_kind in ((["kv_chunks"], "bundle"),
                                       (["kv_chunks", "kv_layers"], "layers")):
            pre.pool.clear()  # no prefix hit: every chunk computes
            r = req()
            r.annotations = annotations
            frames = []

            async def run():
                async for w in pre.prefill_extract_stream(r):
                    frames.append(unpackb(packb(w)))
            await asyncio.wait_for(run(), WAIT_S)
            chunks = [KvChunkFrame.from_wire(f).bundle for f in frames
                      if KvChunkFrame.is_wire(f)]
            layers = [KvLayerFrame.from_wire(f).bundle for f in frames
                      if KvLayerFrame.is_wire(f)]
            final = PrefillResponse.from_wire(frames[-1])
            assert len(chunks) >= 2 and final.token_id >= 0
            nxt = 0
            for b in chunks:
                assert b.start_block == nxt
                nxt += b.num_blocks
            total = (len(PROMPT) + 3) // 4
            if tail_kind == "bundle":
                assert not layers and final.bundle.start_block == nxt
                assert nxt + final.bundle.num_blocks == total
            else:
                assert final.bundle is None
                assert [(b.start_layer, b.total_layers) for b in layers] == \
                    [(0, 2), (1, 2)]
                assert all(b.start_block == nxt
                           and nxt + b.num_blocks == total for b in layers)
        assert pre.pool.num_active_blocks == 0
    finally:
        await pre.close()


async def test_mismatch_falls_back_local_without_leak():
    """A decode engine whose block size differs cannot place the frames:
    it drains the stream, recomputes locally (counted), leaks nothing."""
    want = await jax_reference()
    pre, dec = make_engine(), make_engine(block_size=8)
    free0 = dec.pool.num_free_blocks
    dh = DecodeWorkerHandler(dec, LocalPrefillClient(PrefillWorkerHandler(pre)),
                             DisaggConfig(max_local_prefill_length=8))
    try:
        got = await through_handler(dh, req())
        assert got[0] == want[0]
        assert dh.report()["fallbacks"] == {"recompute_bundle_dims": 1}
        assert await _settled(dec, free0)
        assert await _settled(pre, pre.pool.num_free_blocks)
        assert pre.pool.num_active_blocks == 0
    finally:
        await pre.close()
        await dec.close()


async def test_stream_failure_releases_injected_blocks():
    pre, dec = make_engine(), make_engine()
    free0 = dec.pool.num_free_blocks
    client = LocalPrefillClient(PrefillWorkerHandler(pre),
                                die_after_chunk=True)
    dh = DecodeWorkerHandler(dec, client,
                             DisaggConfig(max_local_prefill_length=8))
    try:
        got = await through_handler(dh, req())
        assert len(got[0]) == 8  # recomputed locally
        assert dh.report()["fallbacks"] == {"stream_error": 1}
        assert await _settled(dec, free0)
        for _ in range(100):  # the abandoned extraction returns its blocks
            if pre.pool.num_active_blocks == 0:
                break
            await asyncio.sleep(0.02)
        assert pre.pool.num_active_blocks == 0
    finally:
        await pre.close()
        await dec.close()


async def test_failed_scatter_releases_and_recomputes():
    pre, dec = make_engine(), make_engine()
    free0 = dec.pool.num_free_blocks

    def boom(*a, **k):
        raise RuntimeError("synthetic scatter failure")

    dec.scatter_chunk = boom
    dh = DecodeWorkerHandler(dec, LocalPrefillClient(PrefillWorkerHandler(pre)),
                             DisaggConfig(max_local_prefill_length=8))
    try:
        want = await jax_reference()
        got = await through_handler(dh, req())
        assert got[0] == want[0]
        assert dh.report()["fallbacks"] == {"recompute_scatter": 1}
        assert await _settled(dec, free0)
    finally:
        await pre.close()
        await dec.close()


async def test_prefill_extract_cancelled_releases_blocks():
    eng = make_engine()
    free0 = eng.pool.num_free_blocks
    task = asyncio.get_running_loop().create_task(
        eng.prefill_extract(req(PROMPT[:59])))
    await asyncio.sleep(0)
    task.cancel()
    with pytest.raises(asyncio.CancelledError):
        await task
    assert await _settled(eng, free0)
    assert eng.pool.num_active_blocks == 0
    await eng.close()


async def test_extract_cancelled_mid_step_leaves_later_requests_alone(
        monkeypatch):
    """A prefill_extract cancelled while its one-token step runs: the step
    commits and finishes the sequence normally, and nothing of the abort
    outlives it. The requests served after it on that engine (extracts
    and a stream) come out whole, and every block returns."""
    import threading

    eng = make_engine()
    free0 = eng.pool.num_free_blocks
    in_step, go = threading.Event(), threading.Event()
    step = eng._step

    def held_step(*a, **kw):
        in_step.set()
        go.wait(WAIT_S)
        return step(*a, **kw)

    monkeypatch.setattr(eng, "_step", held_step)
    try:
        task = asyncio.get_running_loop().create_task(
            eng.prefill_extract(req(PROMPT[:22])))
        assert await asyncio.to_thread(in_step.wait, WAIT_S)
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        go.set()
        assert await _settled(eng, free0)
        for n in (22, 23, 22):
            presp = await asyncio.wait_for(
                eng.prefill_extract(req(PROMPT[:n])), WAIT_S)
            assert presp.token_id >= 0
            assert presp.bundle.num_blocks == (n + 3) // 4
        toks, _ = await collect(eng, req(PROMPT[:22]))
        assert len(toks) == 8
        assert await _settled(eng, free0)
    finally:
        go.set()
        await eng.close()


async def test_prefill_queue_dispatch_end_to_end():
    """The decode side enqueues a ticket, the prefill worker's queue loop
    claims it, the stream goes direct to the claimant; the queue drains."""
    from dynamo_tpu_torch.disagg.queue import (
        PREFILL_QUEUE, PrefillQueueClient, PrefillQueueWorker,
        engine_capacity_gate, prefill_queue_depth,
    )

    plane = LocalControlPlane()
    pre, dec = make_engine(), make_engine()
    client = LocalPrefillClient(PrefillWorkerHandler(pre), ids=[7001])
    qw = await PrefillQueueWorker(plane, instance_id=7001,
                                  capacity_gate=engine_capacity_gate(pre)
                                  ).start()
    dh = DecodeWorkerHandler(dec, client,
                             DisaggConfig(max_local_prefill_length=8),
                             prefill_queue=PrefillQueueClient(plane))
    try:
        want = await jax_reference()
        got = await through_handler(dh, req())
        assert got[0] == want[0]
        assert client.calls == [("direct", 7001)] and qw.claims == 1
        assert await plane.queue_depth(PREFILL_QUEUE) == 0
        assert await prefill_queue_depth(plane) == 0
    finally:
        await qw.stop()
        await pre.close()
        await dec.close()
        await plane.close()


async def test_claim_timeout_falls_back_round_robin():
    from dynamo_tpu_torch.disagg.queue import PrefillQueueClient

    plane = LocalControlPlane()
    pre, dec = make_engine(), make_engine()
    client = LocalPrefillClient(PrefillWorkerHandler(pre))
    queue = PrefillQueueClient(plane, claim_timeout=0.1)
    metrics = MetricsRegistry()
    dh = DecodeWorkerHandler(dec, client,
                             DisaggConfig(max_local_prefill_length=8),
                             prefill_queue=queue, metrics=metrics)
    try:
        want = await jax_reference()
        got = await through_handler(dh, req())
        assert got[0] == want[0]
        assert client.calls == [("round_robin", None)]
        assert queue.claim_timeouts == 1
        report = dh.report()
        assert report["fallbacks"] == {"timeout": 1}
        # the Prometheus side reads the same counts
        text = metrics.render()
        assert ('dynamo_prefill_claim_fallback_total{reason="timeout"} 1'
                in text)
        nbytes = report["transfer_bytes"]["host"]
        assert nbytes == sum(f[1] for f in report["transfers"][0]["frames"])
        assert f'dynamo_kv_transfer_bytes_total{{path="host"}} {nbytes}' \
            in text
        assert 'dynamo_kv_transfer_seconds_count{path="host"} 1' in text
        # host-staged only: no direct link path, no direct pull
        assert 'path="proc"' not in text and 'path="ipc"' not in text
        assert not [line for line in text.splitlines() if line.startswith(
            "dynamo_kv_direct_pull_failures_total")]
    finally:
        await pre.close()
        await dec.close()
        await plane.close()


async def test_claim_timeout_prefers_the_near_prefill_instance(monkeypatch):
    """Two prefill workers behind the hub, one labelled on this decode
    worker's host (published from ``DYN_TOPO_HOST``) and one elsewhere
    (labels given as metadata): after a claim timeout the decode worker
    goes direct to the near one, every time, and the stream is the JAX
    aggregated one."""
    from dynamo_tpu_torch.disagg.queue import PrefillQueueClient
    from dynamo_tpu_torch.router.topology import TopologyLabels
    from dynamo_tpu_torch.runtime import DistributedRuntime
    from dynamo_tpu_torch.runtime.control_plane import ControlPlaneServer

    hub = ControlPlaneServer()
    addr = await hub.start()
    far_rt = await DistributedRuntime.create(address=addr)
    near_rt = await DistributedRuntime.create(address=addr)
    caller = await DistributedRuntime.create(address=addr)
    pre, dec = make_engine(), make_engine()
    served = []

    def handler(name):
        ph = PrefillWorkerHandler(pre)

        async def gen(request, ctx):
            served.append(name)
            async for frame in ph.generate(request, ctx):
                yield frame
        return gen

    try:
        await far_rt.namespace("ns").component("prefill").endpoint(
            "generate").serve_endpoint(
                handler("far"), metadata={"topo": {"host": "far-host"}})
        monkeypatch.setenv("DYN_TOPO_HOST", "near-host")
        near = await near_rt.namespace("ns").component("prefill").endpoint(
            "generate").serve_endpoint(handler("near"))
        monkeypatch.delenv("DYN_TOPO_HOST")
        client = await caller.namespace("ns").component("prefill").endpoint(
            "generate").client().start()
        async def both_seen():
            while len(client.available_ids()) < 2:
                await asyncio.sleep(0.02)
        await asyncio.wait_for(both_seen(), WAIT_S)
        assert (client.instance(near.lease_id).metadata["topo"]
                == {"host": "near-host"})
        dh = DecodeWorkerHandler(
            dec, client, DisaggConfig(max_local_prefill_length=8),
            prefill_queue=PrefillQueueClient(caller.plane, claim_timeout=0.1),
            topo_labels=TopologyLabels(host="near-host"))
        want = await jax_reference()
        for _ in range(3):
            got = await through_handler(dh, req())
            assert got[0] == want[0]
        assert served == ["near"] * 3
        assert dh.report()["fallbacks"] == {"timeout": 3}
        await client.stop()
    finally:
        await pre.close()
        await dec.close()
        for rt in (caller, near_rt, far_rt):
            await rt.shutdown()
        await hub.stop()


async def test_threshold_watched_from_control_plane():
    plane = LocalControlPlane()
    cfg = DisaggConfig(max_local_prefill_length=512)
    w = await DisaggConfigWatcher(plane, cfg).start()
    await plane.kv_put(DisaggConfig.KEY, b"128")
    for _ in range(100):
        if cfg.max_local_prefill_length == 128:
            break
        await asyncio.sleep(0.01)
    assert cfg.max_local_prefill_length == 128
    await plane.kv_put(DisaggConfig.KEY, b"not-a-number")  # ignored
    await asyncio.sleep(0.05)
    assert cfg.max_local_prefill_length == 128
    await w.stop()
    await plane.close()

    plane2 = LocalControlPlane()  # a value present at start applies
    await plane2.kv_put(DisaggConfig.KEY, b"64")
    cfg2 = DisaggConfig()
    w2 = await DisaggConfigWatcher(plane2, cfg2).start()
    assert cfg2.max_local_prefill_length == 64
    await w2.stop()
    await plane2.close()


def test_bundle_dims_checks():
    """check_bundle_dims refuses another block size, another geometry, a
    layer slice outside the cache, and a packed bundle of another width."""
    eng = make_engine()
    ok = TP.KvBundle(k=torch.zeros(2, 3, 4, 2, 16), v=torch.zeros(2, 3, 4, 2,
                                                                     16),
                     num_tokens=12, block_size=4)
    assert eng.check_bundle_dims(ok)
    bad = [
        TP.KvBundle(k=ok.k, v=ok.v, num_tokens=12, block_size=8),
        TP.KvBundle(k=torch.zeros(2, 3, 4, 2, 8), v=ok.v, num_tokens=12,
                    block_size=4),
        TP.KvBundle(k=torch.zeros(1, 3, 4, 2, 16), v=ok.v, num_tokens=12,
                    block_size=4),
        TP.KvBundle(k=ok.k, v=ok.v, num_tokens=12, block_size=4,
                    start_layer=1, total_layers=2),
        TP.KvBundle(k=torch.zeros(2, 3, 99, dtype=torch.uint8), v=ok.v,
                    num_tokens=12, block_size=4),
    ]
    assert not any(eng.check_bundle_dims(b) for b in bad)
    assert eng.check_bundle_dims(TP.KvBundle(
        k=ok.k[1:], v=ok.v[1:], num_tokens=12, block_size=4, start_layer=1,
        total_layers=2))


# ------------------------------------------------------------ mixed fleet

class CodecPrefillClient(LocalPrefillClient):
    """A prefill client whose frames cross the wire codec, for a decode
    handler of either package."""

    def __init__(self, ph, ids=(1,)):
        super().__init__(ph, ids)

    async def generate(self, request, ctx=None, mode="round_robin",
                       instance_id=None):
        self.calls.append((mode, instance_id))
        request = unpackb(packb(request))

        async def stream():
            async for frame in self.ph.generate(request, ctx):
                self.frames.append(
                    "chunk" if KvChunkFrame.is_wire(frame) else
                    "layer" if KvLayerFrame.is_wire(frame) else "final")
                yield msgpack.unpackb(packb(frame), raw=False)
        return stream()


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
async def test_mixed_prefill_decode_pairs_equal_jax_aggregated(direction, kv):
    """A JAX prefill engine feeds a torch decode handler, and a torch
    prefill engine feeds a JAX decode handler, frames over the wire codec
    (int8 KV: packed bundles): greedy and seeded streams equal the JAX
    aggregated engine's, and the decode engine stores the blocks the JAX
    engine stores, under the same hashes. The frontend-level fleet is
    ``tests/test_torch_disagg_fleet.py``."""
    from dynamo_tpu.disagg.handlers import DecodeWorkerHandler as JaxDecode
    from dynamo_tpu.disagg.handlers import PrefillWorkerHandler as JaxPrefill
    from dynamo_tpu.disagg.protocols import DisaggConfig as JaxDisaggConfig

    samplings = (None, SamplingOptions(temperature=0.8, seed=77))
    jax_events = []
    jeng = AsyncJaxEngine(
        JaxModelConfig.tiny(), JaxEngineArgs(
            prefill_buckets=(8, 16, 32, 64), kv_cache_dtype=kv,
            decode_batch_buckets=(1, 2, 4, 8), **SETTINGS),
        params=_jparams(), event_cb=jax_events.append)
    # the JAX engine's own aggregated streams and stored blocks first
    refs = []
    for sampling in samplings:
        toks = []
        async for out in jeng.generate(JaxRequest(
                model="tiny", token_ids=PROMPT,
                sampling_options=JaxSampling(**vars(sampling or
                                                    SamplingOptions())),
                stop_conditions=JaxStop(max_tokens=8, ignore_eos=True))):
            toks.extend(out.token_ids)
        refs.append((toks, [b.block_hash for e in jax_events
                            for b in e.stored_blocks]))
        jeng.pool.clear()
        del jax_events[:]
    events = []
    if direction == "jax_to_torch":
        pre, dec = jeng, make_engine(kv_cache_dtype=kv,
                                     event_cb=events.append)
        client = CodecPrefillClient(JaxPrefill(pre))
        dh = DecodeWorkerHandler(dec, client,
                                 DisaggConfig(max_local_prefill_length=8))
    else:
        pre, dec = make_engine(kv_cache_dtype=kv), jeng
        events = jax_events
        client = CodecPrefillClient(PrefillWorkerHandler(pre))
        dh = JaxDecode(dec, client,
                       JaxDisaggConfig(max_local_prefill_length=8))
    try:
        for sampling, (want, hashes) in zip(samplings, refs):
            pre.pool.clear()  # every chunk computes and ships
            dec.pool.clear()
            del events[:]
            got = await through_handler(dh, req(sampling=sampling))
            assert got[0] == want
            assert [b.block_hash for e in events
                    for b in e.stored_blocks] == hashes
        assert client.frames.count("chunk") >= 4  # two pipelined streams
        if direction == "jax_to_torch":
            assert "fallbacks" not in dh.report()
            assert dh.report()["remote_prefills"] == {"placed": 2}
            assert client.frames.count("layer") == 4
        assert await _settled(dec, dec.pool.num_free_blocks)
    finally:
        await pre.close()
        await dec.close()


def test_roles_flags_and_refusals():
    """Both roles configure, ``--kv-layer-groups`` reaches EngineArgs, the
    swap and local KVBM flags and knobs (A8e parts 1 and 2a) are accepted
    and reach EngineArgs, and what stays unported is refused under its id:
    the G4 tier and the distributed block manager (A8e). The direct
    transfer (A8d) is on unless ``--no-kv-transfer-direct`` turns it
    off."""
    from dynamo_tpu_torch.engine import main as worker_main

    def configure(*argv):
        return worker_main.configure(worker_main.build_parser().parse_args(
            ["--arch", "tiny", "--device", "cpu", "--allow-test-metadata",
             *argv]))

    for role in ("prefill", "decode"):
        _cfg, args, _eos, _tk = configure("--role", role,
                                          "--kv-layer-groups", "2")
        assert args.kv_transfer_layer_groups == 2
    assert configure()[1].kv_transfer_layer_groups == 4
    args = configure()[1]
    assert args.preempt_swap and args.swap_host_bytes is None
    assert args.kvbm_host_bytes == 0 and args.kvbm_disk_dir is None
    args = configure("--no-preempt-swap", "--swap-host-gb", "0.5",
                     "--kvbm-host-gb", "1", "--kvbm-disk-dir", "/kv",
                     "--kvbm-disk-gb", "2")[1]
    assert not args.preempt_swap and args.swap_host_bytes == 1 << 29
    assert args.kvbm_host_bytes == 1 << 30
    assert (args.kvbm_disk_dir, args.kvbm_disk_bytes) == ("/kv", 2 << 30)
    for argv, item in ((["--kvbm-g4-gb", "1"], "A8e"),
                       (["--kvbm-distributed"], "A8e"),
                       (["--kvbm-leader-workers", "2"], "A8e")):
        with pytest.raises(SystemExit, match=f"ROADMAP {item}"):
            configure(*argv)
    assert EngineArgs().preempt_swap  # the JAX package's default
    EngineArgs(preempt_swap=True, kvbm_host_bytes=1 << 20,
               kvbm_disk_dir="/kv", kvbm_disk_bytes=1 << 20,
               swap_host_bytes=1 << 20)
    with pytest.raises(ValueError, match="ROADMAP A11"):
        EngineArgs(tp_size=2)
    # the direct transfer is ported: on by default, off by its flag
    assert EngineArgs().kv_transfer_direct
    assert not configure("--role", "decode",
                         "--no-kv-transfer-direct")[1].kv_transfer_direct
