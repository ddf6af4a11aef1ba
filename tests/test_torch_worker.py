"""The torch worker behind the JAX package's frontend: the half of the
port's serving path that the card cannot run (the frontend stays the JAX
package's).

A JAX ``ControlPlaneServer`` (``dynctl``), a JAX ``HttpService`` with a
``ModelWatcher`` in KV-router mode, and the port's worker
(``dynamo_tpu_torch.engine.main``, on the CPU) joined to the hub through
the port's ``RemoteControlPlane``, serving the ``tests/hf_fixture.py``
checkpoint:

- a chat request returns the text transformers predicts (the twin of
  ``tests/test_real_checkpoint.py:82``);
- the JAX KV router's indexer holds the torch worker's blocks under the
  hashes the JAX engine computes for the same request;
- ``/v1/embeddings`` answers through the torch worker;
- once the worker shuts down, the model leaves the frontend's list;
- a seeded sampled chat request with logprobs returns the text and the
  logprobs the JAX engine gives on the same weights, and a
  ``response_format`` json_schema request returns JSON that parses and
  fits the schema (the worker reads its guided alphabet from the
  checkpoint's ``tokenizer.json``);
- a ``--role prefill`` and a ``--role decode`` torch worker answer a chat
  request with the text transformers predicts, its KV moved between them
  over TCP, and only the decode worker registers the model.
"""

import asyncio
import contextlib
import json

import jax.numpy as jnp
import pytest
import torch

transformers = pytest.importorskip("transformers")
aiohttp = pytest.importorskip("aiohttp")
jinja2 = pytest.importorskip("jinja2")

from dynamo_tpu.engine.config import EngineArgs as JaxEngineArgs
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import AsyncJaxEngine
from dynamo_tpu.engine.loader import load_hf_params as jax_load_hf_params
from dynamo_tpu.frontend.http import HttpService
from dynamo_tpu.llm.discovery import ModelManager, ModelWatcher
from dynamo_tpu.llm.tokenizer import TokenizerWrapper
from dynamo_tpu.protocols import OutputOptions as JaxOutput
from dynamo_tpu.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols import SamplingOptions as JaxSampling
from dynamo_tpu.protocols import StopConditions as JaxStop
from dynamo_tpu.runtime import ControlPlaneServer, DistributedRuntime
from dynamo_tpu_torch.engine import main as worker_main
from tests.hf_fixture import CHAT_TEMPLATE, make_tiny_llama_checkpoint

pytestmark = pytest.mark.anyio

PROMPT = "the quick brown fox"
N_NEW = 12
MODEL = "tiny-real"
ENGINE = ["--block-size", "4", "--num-blocks", "128", "--max-num-seqs", "4",
          "--max-num-batched-tokens", "64", "--max-model-len", "256"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return make_tiny_llama_checkpoint(str(tmp_path_factory.mktemp("ckpt")))


def _prompt_ids(ckpt: str) -> list[int]:
    rendered = jinja2.Environment(keep_trailing_newline=True).from_string(
        CHAT_TEMPLATE).render(messages=[{"role": "user", "content": PROMPT}],
                              add_generation_prompt=True)
    return TokenizerWrapper.from_dir(ckpt).encode(rendered)


def _hf_greedy(ckpt: str, ids: list[int]) -> list[int]:
    m = transformers.AutoModelForCausalLM.from_pretrained(
        ckpt, attn_implementation="eager").eval()
    with torch.no_grad():
        out = m.generate(torch.tensor([ids]), max_new_tokens=N_NEW,
                         do_sample=False, eos_token_id=None, pad_token_id=0)
    return out[0, len(ids):].tolist()


async def _jax_block_hashes(ckpt: str, ids: list[int]) -> set[int]:
    """The block hashes the JAX engine's KV stored events carry for the
    same request on the same checkpoint."""
    cfg = JaxModelConfig.from_pretrained(ckpt)
    cfg.dtype = "float32"
    events = []
    eng = AsyncJaxEngine(cfg, JaxEngineArgs(
        block_size=4, num_blocks=128, max_num_seqs=4,
        max_num_batched_tokens=64, max_model_len=256),
        params=jax_load_hf_params(cfg, ckpt, dtype=jnp.float32),
        event_cb=events.append)
    async for _ in eng.generate(JaxRequest(
            model=MODEL, token_ids=ids,
            stop_conditions=JaxStop(max_tokens=N_NEW, ignore_eos=True))):
        pass
    await eng.close()
    return {b.block_hash for e in events for b in e.stored_blocks}


async def _until(pred, what: str, timeout: float = 20.0):
    deadline = asyncio.get_running_loop().time() + timeout
    while not pred():
        if asyncio.get_running_loop().time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.05)


async def test_handler_recomputes_plans_and_refuses_unported():
    """A migrated (``restore``) or onboarded request is served by local
    recompute, with the stream a plain request gets; a request the engine
    cannot serve is a terminal invalid-request error."""
    from dynamo_tpu_torch.disagg.handlers import DecodeWorkerHandler
    from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
    from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
    from dynamo_tpu_torch.protocols import (
        PreprocessedRequest, SamplingOptions, StopConditions,
    )
    from dynamo_tpu_torch.runtime.context import InvalidRequestError

    eng = AsyncTorchEngine(ModelConfig.tiny(), EngineArgs(
        block_size=4, num_blocks=64, max_num_seqs=4,
        max_num_batched_tokens=64, max_model_len=128), device="cpu")
    handler = DecodeWorkerHandler(eng)

    async def tokens(**kw):
        req = PreprocessedRequest(
            model="tiny", token_ids=list(range(3, 20)),
            stop_conditions=StopConditions(max_tokens=5, ignore_eos=True),
            **kw)
        out = []
        async for frame in handler.generate(req.to_wire(), None):
            out.extend(frame["token_ids"])
        return out

    try:
        plain = await tokens()
        assert len(plain) == 5
        assert await tokens(restore={"sources": [[7, 4, 1.0]]}) == plain
        assert await tokens(onboard={"sources": [[7, 4, 1.0]]}) == plain
        # a seeded draw is served now; multimodal input is still refused
        sampled = await tokens(sampling_options=SamplingOptions(
            temperature=0.5, seed=3))
        assert len(sampled) == 5
        with pytest.raises(InvalidRequestError, match="ROADMAP A9"):
            await tokens(mm_refs=[{"url": "x"}])
    finally:
        await eng.close()


async def test_torch_worker_behind_jax_frontend(ckpt, monkeypatch):
    ids = _prompt_ids(ckpt)
    tk = TokenizerWrapper.from_dir(ckpt)
    expected_text = tk.decode(_hf_greedy(ckpt, ids))
    jax_hashes = await _jax_block_hashes(ckpt, ids)
    assert jax_hashes

    hub = ControlPlaneServer()
    addr = await hub.start()
    # the torch worker joins the JAX hub through its own runtime
    monkeypatch.setenv("DYN_CONTROL_PLANE", addr)
    cli = worker_main.build_parser().parse_args(
        ["--model", MODEL, "--model-path", ckpt, "--device", "cpu", *ENGINE])
    cfg, args, eos, tokenizer_ref = worker_main.configure(cli)
    cfg.dtype = "float32"  # CPU parity run, as for the JAX engine above
    assert eos and tokenizer_ref == ckpt  # from generation_config.json
    engine = worker_main.build_engine(cli, cfg, args)
    stop = asyncio.Event()
    worker = asyncio.get_running_loop().create_task(worker_main.serve(
        cli, engine, args, eos, tokenizer_ref, stop))

    rt = await DistributedRuntime.create(address=addr)
    manager = ModelManager()
    watcher = await ModelWatcher(rt, manager, router_mode="kv").start()
    service = HttpService(manager, port=0)
    await service.start()
    base = f"http://127.0.0.1:{service.port}"
    try:
        await _until(lambda: MODEL in manager.list_models(), "registration")
        async with aiohttp.ClientSession() as http:
            resp = await http.post(f"{base}/v1/chat/completions", json={
                "model": MODEL, "stream": False, "temperature": 0.0,
                "max_tokens": N_NEW, "ignore_eos": True,
                "messages": [{"role": "user", "content": PROMPT}]})
            assert resp.status == 200, await resp.text()
            body = await resp.json()
            assert body["choices"][0]["message"]["content"] == expected_text
            assert body["usage"]["completion_tokens"] == N_NEW

            resp = await http.post(f"{base}/v1/embeddings", json={
                "model": MODEL, "input": ["hello world", PROMPT]})
            assert resp.status == 200, await resp.text()
            data = (await resp.json())["data"]
            assert len(data) == 2
            assert len(data[0]["embedding"]) == cfg.hidden_size
            norm = sum(x * x for x in data[1]["embedding"]) ** 0.5
            assert abs(norm - 1.0) < 1e-4

        served = manager.get(MODEL)
        (lease,) = served.client.instance_ids()
        tree = served.router.indexer.tree
        await _until(lambda: tree.worker_hashes(lease) == jax_hashes,
                     "the torch worker's blocks in the JAX router")
        scores = served.router.indexer.find_matches_for_tokens(ids).scores
        assert scores.get(lease, 0) == len(ids) // args.block_size
    finally:
        stop.set()
        report = await asyncio.wait_for(worker, 30)
        try:
            await _until(lambda: MODEL not in manager.list_models(),
                         "the model to leave the frontend")
        finally:
            await service.stop()
            await watcher.stop()
            await rt.shutdown()
            await hub.stop()
    assert report["steps"] > 0 and report["pipelined_steps"] > 0


@contextlib.asynccontextmanager
async def _fleet(ckpt, monkeypatch):
    """A JAX hub and frontend (KV router) with the torch worker serving
    the checkpoint in f32 on the CPU; yields the frontend's base URL."""
    hub = ControlPlaneServer()
    addr = await hub.start()
    monkeypatch.setenv("DYN_CONTROL_PLANE", addr)
    cli = worker_main.build_parser().parse_args(
        ["--model", MODEL, "--model-path", ckpt, "--device", "cpu", *ENGINE])
    cfg, args, eos, tokenizer_ref = worker_main.configure(cli)
    cfg.dtype = "float32"
    engine = worker_main.build_engine(cli, cfg, args)
    assert engine.guided_vocab is not None and engine.structured is not None
    stop = asyncio.Event()
    worker = asyncio.get_running_loop().create_task(worker_main.serve(
        cli, engine, args, eos, tokenizer_ref, stop))
    rt = await DistributedRuntime.create(address=addr)
    manager = ModelManager()
    watcher = await ModelWatcher(rt, manager, router_mode="kv").start()
    service = HttpService(manager, port=0)
    await service.start()
    try:
        await _until(lambda: MODEL in manager.list_models(), "registration")
        yield f"http://127.0.0.1:{service.port}"
    finally:
        stop.set()
        await asyncio.wait_for(worker, 30)
        await service.stop()
        await watcher.stop()
        await rt.shutdown()
        await hub.stop()


async def _jax_sampled(ckpt, ids, sampling, logprobs, n):
    """The JAX engine's tokens and logprobs for ``ids`` on the checkpoint."""
    cfg = JaxModelConfig.from_pretrained(ckpt)
    cfg.dtype = "float32"
    eng = AsyncJaxEngine(cfg, JaxEngineArgs(
        block_size=4, num_blocks=128, max_num_seqs=4,
        max_num_batched_tokens=64, max_model_len=256),
        params=jax_load_hf_params(cfg, ckpt, dtype=jnp.float32))
    toks, lps, tops = [], [], []
    async for out in eng.generate(JaxRequest(
            model=MODEL, token_ids=ids,
            sampling_options=JaxSampling(**sampling),
            output_options=JaxOutput(logprobs=logprobs),
            stop_conditions=JaxStop(max_tokens=n, ignore_eos=True))):
        toks.extend(out.token_ids)
        lps.extend(out.log_probs)
        tops.extend(out.top_logprobs or [])
    await eng.close()
    return toks, lps, tops


SCHEMA = {"type": "object", "properties": {
    "ok": {"type": "boolean"}, "n": {"enum": [1, 2, 3]},
    "tags": {"type": "array", "items": {"enum": ["a", "b"]},
             "maxItems": 2}}}


@pytest.mark.parametrize("case", ["seeded_logprobs", "json_schema"])
async def test_sampled_and_guided_requests_behind_jax_frontend(
        ckpt, monkeypatch, case):
    ids = _prompt_ids(ckpt)
    tk = TokenizerWrapper.from_dir(ckpt)
    body = {"model": MODEL, "stream": False, "max_tokens": N_NEW,
            "messages": [{"role": "user", "content": PROMPT}]}
    if case == "seeded_logprobs":
        body.update(temperature=0.8, top_p=0.9, seed=1234, logprobs=True,
                    top_logprobs=3, ignore_eos=True)
        want_toks, want_lps, want_tops = await _jax_sampled(
            ckpt, ids, dict(temperature=0.8, top_p=0.9, seed=1234), 3, N_NEW)
    else:
        body.update(max_tokens=48, response_format={
            "type": "json_schema",
            "json_schema": {"name": "probe", "schema": SCHEMA}})
    async with _fleet(ckpt, monkeypatch) as base:
        async with aiohttp.ClientSession() as http:
            resp = await http.post(f"{base}/v1/chat/completions", json=body)
            assert resp.status == 200, await resp.text()
            choice = (await resp.json())["choices"][0]
    text = choice["message"]["content"]
    if case == "seeded_logprobs":
        assert text == tk.decode(want_toks)
        content = choice["logprobs"]["content"]
        assert len(content) == N_NEW
        for entry, lp, tops in zip(content, want_lps, want_tops):
            assert entry["logprob"] == pytest.approx(lp, abs=1e-5)
            assert [t["logprob"] for t in entry["top_logprobs"]] == \
                pytest.approx([v for _, v in tops[:3]], abs=1e-5)
            assert [t["token"] for t in entry["top_logprobs"]] == \
                [tk.decode([i]) for i, _ in tops[:3]]
    else:
        doc = json.loads(text)
        assert choice["finish_reason"] == "stop"
        assert set(doc) == {"ok", "n", "tags"}
        assert isinstance(doc["ok"], bool) and doc["n"] in (1, 2, 3)
        assert len(doc["tags"]) <= 2 and set(doc["tags"]) <= {"a", "b"}


LONG = ("the quick brown fox jumps over the lazy dog and paris is the "
        "capital of france")


async def test_prefill_and_decode_torch_workers_behind_jax_frontend(
        ckpt, monkeypatch):
    """``--role prefill`` and ``--role decode`` torch workers behind the
    JAX hub, frontend and KV router: a chat request whose prompt is past
    the decode worker's threshold is prefilled by the prefill worker (its
    KV in chunk frames and layer frames over TCP, through the prefill
    queue) and answered with the text transformers predicts; only the
    decode worker registers the model."""
    rendered = jinja2.Environment(keep_trailing_newline=True).from_string(
        CHAT_TEMPLATE).render(messages=[{"role": "user", "content": LONG}],
                              add_generation_prompt=True)
    ids = TokenizerWrapper.from_dir(ckpt).encode(rendered)
    # the frontend's streaming detokenizer holds back the incomplete UTF-8
    # bytes of a last byte-level token, which decode() shows as U+FFFD
    expected = TokenizerWrapper.from_dir(ckpt).decode(
        _hf_greedy(ckpt, ids)).rstrip("\ufffd")
    hub = ControlPlaneServer()
    addr = await hub.start()
    monkeypatch.setenv("DYN_CONTROL_PLANE", addr)
    workers = {}
    engines = {}
    for role, extra in (("prefill", ["--max-num-batched-tokens", "8"]),
                        ("decode", ["--max-local-prefill-length", "4"])):
        cli = worker_main.build_parser().parse_args(
            ["--model", MODEL, "--model-path", ckpt, "--device", "cpu",
             "--role", role, *ENGINE, *extra])
        cfg, args, eos, tokenizer_ref = worker_main.configure(cli)
        cfg.dtype = "float32"
        engines[role] = worker_main.build_engine(cli, cfg, args)
        stop = asyncio.Event()
        workers[role] = (stop, asyncio.get_running_loop().create_task(
            worker_main.serve(cli, engines[role], args, eos, tokenizer_ref,
                              stop)))
    rt = await DistributedRuntime.create(address=addr)
    manager = ModelManager()
    watcher = await ModelWatcher(rt, manager, router_mode="kv").start()
    service = HttpService(manager, port=0)
    await service.start()
    reports = {}
    try:
        await _until(lambda: MODEL in manager.list_models(), "registration")
        pre_gen = await rt.namespace("dynamo").component("prefill").endpoint(
            "generate").client().start()
        await pre_gen.wait_for_instances()
        async with aiohttp.ClientSession() as http:
            resp = await http.post(
                f"http://127.0.0.1:{service.port}/v1/chat/completions",
                json={"model": MODEL, "stream": False, "temperature": 0.0,
                      "max_tokens": N_NEW, "ignore_eos": True,
                      "messages": [{"role": "user", "content": LONG}]})
            assert resp.status == 200, await resp.text()
            body = await resp.json()
        assert body["choices"][0]["message"]["content"] == expected
        assert body["usage"]["completion_tokens"] == N_NEW
        cards = await rt.plane.kv_get_prefix(f"models/{MODEL}/")
        (decode_lease,) = manager.get(MODEL).client.instance_ids()
        (prefill_lease,) = pre_gen.instance_ids()
        assert prefill_lease != decode_lease
        assert cards and all(f"/{decode_lease:x}/" in k for k in cards)
        await pre_gen.stop()
    finally:
        for role, (stop, task) in workers.items():
            stop.set()
            reports[role] = await asyncio.wait_for(task, 30)
        await service.stop()
        await watcher.stop()
        await rt.shutdown()
        await hub.stop()
    dis = reports["decode"]["disagg"]
    assert dis["remote_prefills"] == {"placed": 1} and "fallbacks" not in dis
    (xfer,) = dis["transfers"]
    kinds = [f[0] for f in xfer["frames"]]
    assert kinds.count("chunk") >= 1 and kinds.count("layer") == 2
    (extract,) = reports["prefill"]["extract"]
    assert [f[0] for f in extract["frames"]] == kinds
    assert reports["decode"]["active_blocks"] == 0
    assert reports["prefill"]["active_blocks"] == 0
    assert "disagg" not in reports["prefill"]


async def test_spec_worker_streams_plain_tokens_behind_port_hub(monkeypatch):
    """A torch worker started with ``--speculative-tokens 4`` behind the
    port's own hub streams what a plain worker streams for the same
    repetitive prompt, its load metrics on the plane carry
    ``spec_decode_stats``, its ``spec_disabled_total`` counter is
    registered, and its exit report counts the verify forwards."""
    from dynamo_tpu_torch.protocols import (
        LLMEngineOutput, PreprocessedRequest, StopConditions,
    )
    from dynamo_tpu_torch.router.protocols import KV_METRICS_SUBJECT
    from dynamo_tpu_torch.router.publisher import parse_load_event
    from dynamo_tpu_torch.runtime import (
        ControlPlaneServer as PortHub, DistributedRuntime as PortRuntime,
    )

    hub = PortHub()
    addr = await hub.start()
    monkeypatch.setenv("DYN_CONTROL_PLANE", addr)
    runtimes = []
    create = worker_main.DistributedRuntime.create

    async def recording(*a, **kw):
        runtimes.append(await create(*a, **kw))
        return runtimes[-1]

    monkeypatch.setattr(worker_main.DistributedRuntime, "create", recording)
    prompt = [11, 12, 13, 14, 15, 16] * 4
    out = {}
    client_rt = await PortRuntime.create(address=addr)
    try:
        for label, extra in (("plain", []),
                             ("spec", ["--speculative-tokens", "4"])):
            cli = worker_main.build_parser().parse_args(
                ["--arch", "tiny", "--allow-test-metadata", "--device",
                 "cpu", "--model", f"tiny-{label}", "--component", label,
                 *ENGINE, *extra])
            cfg, args, eos, tokenizer_ref = worker_main.configure(cli)
            assert args.speculative_tokens == (4 if extra else 0)
            engine = worker_main.build_engine(cli, cfg, args)
            stop = asyncio.Event()
            task = asyncio.get_running_loop().create_task(worker_main.serve(
                cli, engine, args, eos, tokenizer_ref, stop))
            try:
                gen = await client_rt.namespace("dynamo").component(
                    label).endpoint("generate").client().start()
                await asyncio.wait_for(gen.wait_for_instances(), 20)
                loads = await client_rt.plane.subscribe(KV_METRICS_SUBJECT)
                toks = []
                async for frame in await gen.generate(PreprocessedRequest(
                        model=f"tiny-{label}", token_ids=prompt,
                        stop_conditions=StopConditions(
                            max_tokens=20, ignore_eos=True)).to_wire()):
                    toks.extend(LLMEngineOutput.from_wire(frame).token_ids)
                metrics = []

                async def drain():
                    async for _subject, payload in loads:
                        metrics.append(parse_load_event(payload)[1])

                drainer = asyncio.get_running_loop().create_task(drain())
                await _until(lambda: metrics, "load metrics")
                await asyncio.sleep(0.2)
                drainer.cancel()
                await loads.cancel()
                await gen.stop()
                rendered = runtimes[-1].metrics.render()
            finally:
                stop.set()
                report = await asyncio.wait_for(task, 30)
            out[label] = (toks, metrics, rendered, report)
    finally:
        await client_rt.shutdown()
        await hub.stop()
    (plain, _, _, plain_rep), (spec, metrics, rendered, rep) = (
        out["plain"], out["spec"])
    assert len(spec) == 20 and spec == plain
    assert "dynamo_spec_disabled_total" in rendered
    stats = [m.spec_decode_stats for m in metrics if m.spec_decode_stats]
    assert stats and stats[-1].num_drafts > 0
    assert rep["spec"]["num_drafts"] >= stats[-1].num_drafts
    assert rep["verify_steps"] > 0 and rep["spec_disabled"] == 0
    assert plain_rep["verify_steps"] == 0
    assert plain_rep["spec"]["num_drafts"] == 0
