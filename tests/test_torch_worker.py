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
- once the worker shuts down, the model leaves the frontend's list.
"""

import asyncio

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
from dynamo_tpu.protocols import PreprocessedRequest as JaxRequest
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
        for bad in (dict(sampling_options=SamplingOptions(temperature=0.5)),
                    dict(mm_refs=[{"url": "x"}])):
            with pytest.raises(InvalidRequestError, match="ROADMAP"):
                await tokens(**bad)
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
