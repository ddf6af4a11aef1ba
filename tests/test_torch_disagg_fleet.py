"""A mixed disaggregated fleet behind the JAX frontend and KV router: a
JAX prefill worker feeding a torch decode worker, and a torch prefill
worker feeding a JAX decode worker, on the ``tests/hf_fixture.py``
checkpoint in f32, with f32 and int8 (packed bundles) KV. Each greedy and
seeded chat request returns the text of the JAX aggregated engine on the
same checkpoint, and the router indexes the decode worker's blocks under
the hashes that engine stores.

The workers join the JAX hub over TCP: the torch one through
``dynamo_tpu_torch.engine.main.serve``, the JAX one assembled here from
the JAX package's handlers (its worker entry point has no in-process
stop). A fleet takes 20-30 s on the CPU, so this file is the slow tier;
its fast sibling is ``test_torch_disagg.py::
test_mixed_prefill_decode_pairs_equal_jax_aggregated`` (the same pairs,
handler to handler, on the same wire codec).
"""

import asyncio
import contextlib

import jax.numpy as jnp
import pytest

transformers = pytest.importorskip("transformers")
aiohttp = pytest.importorskip("aiohttp")
jinja2 = pytest.importorskip("jinja2")

from dynamo_tpu.disagg.handlers import DecodeWorkerHandler as JaxDecode
from dynamo_tpu.disagg.handlers import PrefillWorkerHandler as JaxPrefill
from dynamo_tpu.disagg.protocols import DisaggConfig as JaxDisaggConfig
from dynamo_tpu.disagg.queue import PrefillQueueWorker as JaxQueueWorker
from dynamo_tpu.disagg.queue import engine_capacity_gate as jax_gate
from dynamo_tpu.engine.config import EngineArgs as JaxEngineArgs
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import AsyncJaxEngine
from dynamo_tpu.engine.loader import load_hf_params as jax_load_hf_params
from dynamo_tpu.frontend.http import HttpService
from dynamo_tpu.llm.discovery import ModelManager, ModelWatcher
from dynamo_tpu.llm.model_card import ModelDeploymentCard as JaxCard
from dynamo_tpu.llm.model_card import register_llm as jax_register_llm
from dynamo_tpu.llm.model_card import resolve_eos_token_ids
from dynamo_tpu.llm.tokenizer import TokenizerWrapper
from dynamo_tpu.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols import SamplingOptions as JaxSampling
from dynamo_tpu.protocols import StopConditions as JaxStop
from dynamo_tpu.router.publisher import KvEventPublisher as JaxPublisher
from dynamo_tpu.runtime import ControlPlaneServer, DistributedRuntime
from dynamo_tpu_torch.engine import main as worker_main
from tests.hf_fixture import CHAT_TEMPLATE, make_tiny_llama_checkpoint

pytestmark = [pytest.mark.anyio, pytest.mark.slow]

MODEL = "tiny-real"
N_NEW = 10
CONTENT = ("the quick brown fox jumps over the lazy dog and paris is the "
           "capital of france")
SEEDED = dict(temperature=0.8, top_p=0.9, seed=1234)
SETTINGS = dict(block_size=4, num_blocks=128, max_num_seqs=4,
                max_num_batched_tokens=8, max_model_len=256)
ENGINE = ["--block-size", "4", "--num-blocks", "128", "--max-num-seqs", "4",
          "--max-num-batched-tokens", "8", "--max-model-len", "256",
          "--max-local-prefill-length", "4"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return make_tiny_llama_checkpoint(str(tmp_path_factory.mktemp("ckpt")))


def _ids(ckpt):
    rendered = jinja2.Environment(keep_trailing_newline=True).from_string(
        CHAT_TEMPLATE).render(messages=[{"role": "user",
                                         "content": CONTENT}],
                              add_generation_prompt=True)
    return TokenizerWrapper.from_dir(ckpt).encode(rendered)


def _jax_engine(ckpt, kv, events=None):
    cfg = JaxModelConfig.from_pretrained(ckpt)
    cfg.dtype = "float32"
    return AsyncJaxEngine(cfg, JaxEngineArgs(**SETTINGS, kv_cache_dtype=kv),
                          params=jax_load_hf_params(cfg, ckpt,
                                                    dtype=jnp.float32),
                          event_cb=events.append if events is not None
                          else None)


async def _jax_aggregated(ckpt, kv):
    """Greedy and seeded texts of the JAX aggregated engine, and the block
    hashes of its greedy run."""
    tk = TokenizerWrapper.from_dir(ckpt)
    ids = _ids(ckpt)
    texts, hashes = [], None
    for sampling in ({}, SEEDED):
        events = []
        eng = _jax_engine(ckpt, kv, events)
        toks = []
        async for out in eng.generate(JaxRequest(
                model=MODEL, token_ids=ids,
                sampling_options=JaxSampling(**sampling),
                stop_conditions=JaxStop(max_tokens=N_NEW, ignore_eos=True))):
            toks.extend(out.token_ids)
        await eng.close()
        texts.append(tk.decode(toks).rstrip("�"))
        if hashes is None:
            hashes = {b.block_hash for e in events for b in e.stored_blocks}
    return texts, hashes


@contextlib.asynccontextmanager
async def _jax_worker(addr, ckpt, role, kv):
    """A JAX worker of ``role`` joined to the hub: the JAX package's
    handlers, KV event publisher and (prefill) queue worker."""
    eng = _jax_engine(ckpt, kv)
    rt = await DistributedRuntime.create(address=addr)
    lease = await rt.primary_lease()
    pub = JaxPublisher(rt.plane, worker_id=lease, kv_block_size=4)
    await pub.start_resync_responder()
    eng.event_cb = pub.publish_sync
    ns = rt.namespace("dynamo")
    stops = []
    try:
        if role == "prefill":
            handle = await ns.component("prefill").endpoint(
                "generate").serve_endpoint(JaxPrefill(eng).generate,
                                           lease_id=lease)
            qw = await JaxQueueWorker(rt.plane, instance_id=lease,
                                      capacity_gate=jax_gate(eng)).start()
            stops.append(qw.stop)
        else:
            pc = await ns.component("prefill").endpoint(
                "generate").client().start()
            stops.append(pc.stop)
            ep = ns.component("backend").endpoint("generate")
            handle = await ep.serve_endpoint(
                JaxDecode(eng, pc, JaxDisaggConfig(
                    max_local_prefill_length=4)).generate, lease_id=lease)
            await jax_register_llm(rt, ep, JaxCard(
                display_name=MODEL, kv_cache_block_size=4,
                eos_token_ids=resolve_eos_token_ids(ckpt),
                tokenizer_ref=ckpt), lease_id=lease)
        yield lease
    finally:
        for fn in stops:
            await fn()
        await handle.stop(graceful=False)
        await pub.stop()
        await eng.close()
        await rt.shutdown()


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("torch_role", ["decode", "prefill"])
async def test_mixed_fleet_behind_jax_frontend(ckpt, monkeypatch, torch_role,
                                               kv):
    texts, jax_hashes = await _jax_aggregated(ckpt, kv)
    hub = ControlPlaneServer()
    addr = await hub.start()
    monkeypatch.setenv("DYN_CONTROL_PLANE", addr)
    cli = worker_main.build_parser().parse_args(
        ["--model", MODEL, "--model-path", ckpt, "--device", "cpu",
         "--role", torch_role, *ENGINE,
         *(["--kv-cache-dtype", "int8"] if kv else [])])
    cfg, args, eos, tokenizer_ref = worker_main.configure(cli)
    cfg.dtype = "float32"
    engine = worker_main.build_engine(cli, cfg, args)
    stop = asyncio.Event()
    worker = asyncio.get_running_loop().create_task(worker_main.serve(
        cli, engine, args, eos, tokenizer_ref, stop))
    jax_role = "prefill" if torch_role == "decode" else "decode"
    rt = await DistributedRuntime.create(address=addr)
    manager = ModelManager()
    watcher = await ModelWatcher(rt, manager, router_mode="kv").start()
    service = HttpService(manager, port=0)
    await service.start()
    report = None
    try:
        async with _jax_worker(addr, ckpt, jax_role, kv) as jax_lease:
            deadline = asyncio.get_running_loop().time() + 30
            while MODEL not in manager.list_models():
                assert asyncio.get_running_loop().time() < deadline
                await asyncio.sleep(0.05)
            pre = await rt.namespace("dynamo").component("prefill").endpoint(
                "generate").client().start()
            await pre.wait_for_instances()
            async with aiohttp.ClientSession() as http:
                for want, sampling in zip(texts, ({"temperature": 0.0},
                                                  SEEDED)):
                    resp = await http.post(
                        f"http://127.0.0.1:{service.port}/v1/chat/"
                        "completions", json={
                            "model": MODEL, "stream": False,
                            "max_tokens": N_NEW, "ignore_eos": True,
                            "messages": [{"role": "user",
                                          "content": CONTENT}],
                            **sampling})
                    assert resp.status == 200, await resp.text()
                    body = await resp.json()
                    assert body["choices"][0]["message"]["content"] == want
                    assert body["usage"]["completion_tokens"] == N_NEW
                    if sampling is SEEDED:
                        continue
                    served = manager.get(MODEL)
                    (decode_lease,) = served.client.instance_ids()
                    assert decode_lease == (jax_lease if jax_role == "decode"
                                            else await _torch_lease(rt))
                    tree = served.router.indexer.tree
                    deadline = asyncio.get_running_loop().time() + 20
                    while tree.worker_hashes(decode_lease) != jax_hashes:
                        assert asyncio.get_running_loop().time() < deadline, \
                            "the decode worker's blocks in the router"
                        await asyncio.sleep(0.05)
            await pre.stop()
    finally:
        stop.set()
        report = await asyncio.wait_for(worker, 30)
        await service.stop()
        await watcher.stop()
        await rt.shutdown()
        await hub.stop()
    assert report["active_blocks"] == 0
    if torch_role == "decode":
        dis = report["disagg"]
        assert dis["remote_prefills"] == {"placed": 2}
        assert "fallbacks" not in dis
    else:
        assert len(report["extract"]) == 2


async def _torch_lease(rt) -> int:
    client = await rt.namespace("dynamo").component("backend").endpoint(
        "kv_pull").client().start()
    (lease,) = await client.wait_for_instances()
    await client.stop()
    return lease
