"""The port's engine on quantized weights against the JAX package's engine
(``EngineArgs.quantization``, ROADMAP A5), on the CPU in f32, both engines
handed the same unquantized weights and quantizing them at construction:

- greedy streams and KV stored-event hashes equal ``AsyncJaxEngine``'s for
  int8, int8-g16 and int4-g32 on the tiny Llama, int8 weights with int8 KV,
  and int8 on ``mla_tiny`` and ``moe_tiny``;
- the twin of ``tests/test_quant_serving.py``'s mode test: int8 greedy and
  seeded streams equal across the base engine, ``speculative_tokens=3``,
  ``multi_step_decode=4`` and the serial loop;
- an engine built with ``quantization`` draws its weights quantized (no
  full-width stack of a quantized leaf) and keeps them so;
- the worker: ``--quantization int8`` serves a request behind the port's
  hub with the stream a direct engine gives, and ``--quantization int4``
  is refused with the field-named message.
"""

import asyncio

import jax
import jax.numpy as jnp
import pytest
import torch

from dynamo_tpu.engine.config import EngineArgs as JaxEngineArgs
from dynamo_tpu.engine.engine import AsyncJaxEngine
from dynamo_tpu.models import get_model_config as jax_preset
from dynamo_tpu.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols import SamplingOptions as JaxSampling
from dynamo_tpu.protocols import StopConditions as JaxStop
from dynamo_tpu_torch.engine import model as TM
from dynamo_tpu_torch.engine.config import EngineArgs
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.engine.quant import is_qtensor
from dynamo_tpu_torch.models import get_model_config
from dynamo_tpu_torch.protocols import (
    PreprocessedRequest, SamplingOptions, StopConditions,
)

SETTINGS = dict(block_size=4, num_blocks=128, max_num_seqs=8,
                max_num_batched_tokens=64, max_model_len=256,
                decode_batch_buckets=(1, 2, 4, 8))
PROMPTS = [list(range(1, 20)), list(range(30, 45)), [7, 9, 11],
           [3, 5, 8, 13, 21, 34, 55, 89, 144, 233] * 4]
MAX_TOKENS = (8, 6, 7, 5)


def _reqs(kind, prompts, n, seed0=None):
    Req, Samp, Stop = ((JaxRequest, JaxSampling, JaxStop) if kind == "jax"
                       else (PreprocessedRequest, SamplingOptions,
                             StopConditions))
    out = []
    for i, (p, m) in enumerate(zip(prompts, n)):
        samp = (Samp(temperature=0.0) if seed0 is None else
                Samp(temperature=0.8, top_p=0.9, seed=seed0 + i))
        out.append(Req(model="m", token_ids=list(p), sampling_options=samp,
                       stop_conditions=Stop(max_tokens=m, ignore_eos=True)))
    return out


async def _serve(eng, reqs, close=True):
    async def one(r):
        toks = []
        async for out in eng.generate(r):
            toks.extend(out.token_ids)
        return toks

    try:
        return await asyncio.gather(*(one(r) for r in reqs))
    finally:
        if close:
            await eng.close()


def _stored(events):
    return [[(b.block_hash, b.tokens_hash) for b in e.stored_blocks]
            for e in events if e.stored_blocks]


#: name -> (model, engine knobs)
CONFIGS = {
    "int8": ("tiny", dict(quantization="int8")),
    "int8_g16": ("tiny", dict(quantization="int8-g16")),
    "int4_g32": ("tiny", dict(quantization="int4-g32")),
    "int8_kv8": ("tiny", dict(quantization="int8", kv_cache_dtype="int8")),
    "mla_int8": ("mla_tiny", dict(quantization="int8")),
    "moe_int8": ("moe_tiny", dict(quantization="int8")),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_quantized_engine_matches_jax_engine(name):
    model, knobs = CONFIGS[name]
    cfg = get_model_config(model)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    kw = {**SETTINGS, **knobs}
    jev, tev = [], []
    jeng = AsyncJaxEngine(jax_preset(model), JaxEngineArgs(
        prefill_buckets=(8, 16, 32, 64), **kw), params=jparams,
        event_cb=jev.append)
    jout = asyncio.run(_serve(jeng, _reqs("jax", PROMPTS, MAX_TOKENS)))
    teng = AsyncTorchEngine(cfg, EngineArgs(**kw), params=params,
                            device="cpu", event_cb=tev.append)
    # the engine quantized what the JAX engine quantizes
    assert is_qtensor(teng.params["layers"]["w_down"])
    assert not is_qtensor(params["layers"]["w_down"])  # caller's untouched
    tout = asyncio.run(_serve(teng, _reqs("torch", PROMPTS, MAX_TOKENS)))
    assert tout == jout
    assert [len(t) for t in tout] == list(MAX_TOKENS)
    assert _stored(tev) and _stored(tev) == _stored(jev)


def test_int8_streams_equal_across_ragged_modes():
    """tests/test_quant_serving.py's mode test in the port: int8 weights on
    the base engine, prompt-lookup speculation (K 3), the K = 4 decode
    burst and the serial loop give the same greedy and seeded streams."""
    cfg = get_model_config("tiny")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    modes = [{}, dict(speculative_tokens=3), dict(multi_step_decode=4),
             dict(pipeline_decode=False)]
    prompts = PROMPTS[:2] + [[11, 12, 13, 14, 15, 16] * 4]
    greedy, seeded = [], []
    for m in modes:
        eng = AsyncTorchEngine(cfg, EngineArgs(**SETTINGS, quantization="int8",
                                               **m),
                               params=params, device="cpu")

        async def both():
            # 24 greedy tokens: the model's own repeats give lookup drafts
            g = await _serve(eng, _reqs("torch", prompts, (24,) * 3),
                             close=False)
            s = await _serve(eng, _reqs("torch", prompts, (8,) * 3,
                                        seed0=7))
            return g, s
        g, s = asyncio.run(both())
        greedy.append(g)
        seeded.append(s)
        if m.get("speculative_tokens"):
            assert eng.verify_steps > 0
        if m.get("multi_step_decode"):
            assert eng.bursts > 0
    assert all(g == greedy[0] for g in greedy[1:]), "greedy diverged"
    assert all(s == seeded[0] for s in seeded[1:]), "seeded diverged"
    assert [len(t) for t in greedy[0] + seeded[0]] == [24] * 3 + [8] * 3


def test_engine_draws_quantized_weights():
    """Without params the engine draws quantized (``init_params(...,
    quantization)``): the same weights ``quantize_params`` gives of the
    unquantized draw from the seed, every matmul weight quantized."""
    from dynamo_tpu_torch.engine.quant import QUANT_KEYS, quantize_params

    cfg = get_model_config("tiny")
    eng = AsyncTorchEngine(cfg, EngineArgs(**SETTINGS, seed=3,
                                           quantization="int4-g32"),
                           device="cpu")
    want = quantize_params(TM.init_params(
        cfg, torch.Generator().manual_seed(3), "cpu"), "int4-g32")
    for k, v in want["layers"].items():
        got = eng.params["layers"][k]
        assert is_qtensor(got) == (k in QUANT_KEYS)
        if is_qtensor(v):
            assert got["q"].dtype == torch.uint8
            assert torch.equal(got["q"], v["q"])
            assert torch.equal(got["s"], v["s"])
    assert is_qtensor(eng.params["lm_head"])


def test_quantization_knob_validated_like_jax():
    for spec in ("int4", "int3", "int8-g0"):
        try:
            JaxEngineArgs(quantization=spec)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                EngineArgs(quantization=spec)
            assert str(got.value) == str(e)
            assert str(got.value).startswith(f"quantization={spec!r} invalid")
        else:
            raise AssertionError(f"JAX accepted {spec!r}")
    assert EngineArgs(quantization="int4-g32").quantization == "int4-g32"


def test_worker_serves_quantized_and_refuses_bad_spec(monkeypatch):
    """``--quantization int8`` serves behind the port's hub with the stream
    a direct engine on the same (seeded) weights gives; ``--quantization
    int4`` stops at configure with the field-named message."""
    from dynamo_tpu_torch.engine import main as worker_main
    from dynamo_tpu_torch.protocols import LLMEngineOutput
    from dynamo_tpu_torch.runtime import (
        ControlPlaneServer as PortHub, DistributedRuntime as PortRuntime,
    )

    engine_flags = ["--block-size", "4", "--num-blocks", "128",
                    "--max-num-seqs", "4", "--max-num-batched-tokens", "64",
                    "--max-model-len", "256"]

    def parse(*extra):
        return worker_main.build_parser().parse_args(
            ["--arch", "tiny", "--allow-test-metadata", "--device", "cpu",
             "--model", "tiny-q", *engine_flags, *extra])

    with pytest.raises(SystemExit) as exc:
        worker_main.configure(parse("--quantization", "int4"))
    assert "quantization='int4' invalid" in str(exc.value)

    prompt = [11, 12, 13, 14, 15, 16] * 3

    async def run():
        hub = PortHub()
        addr = await hub.start()
        monkeypatch.setenv("DYN_CONTROL_PLANE", addr)
        cli = parse("--quantization", "int8")
        cfg, args, eos, tokenizer_ref = worker_main.configure(cli)
        assert args.quantization == "int8"
        engine = worker_main.build_engine(cli, cfg, args)
        assert is_qtensor(engine.params["layers"]["wq"])
        direct = AsyncTorchEngine(cfg, EngineArgs(
            block_size=4, num_blocks=128, max_num_seqs=4,
            max_num_batched_tokens=64, max_model_len=256,
            quantization="int8"), device="cpu")
        want = (await _serve(direct, _reqs("torch", [prompt], (10,))))[0]
        stop = asyncio.Event()
        task = asyncio.get_running_loop().create_task(worker_main.serve(
            cli, engine, args, eos, tokenizer_ref, stop))
        client_rt = await PortRuntime.create(address=addr)
        try:
            gen = await client_rt.namespace("dynamo").component(
                "backend").endpoint("generate").client().start()
            await asyncio.wait_for(gen.wait_for_instances(), 20)
            toks = []
            async for frame in await gen.generate(PreprocessedRequest(
                    model="tiny-q", token_ids=prompt,
                    stop_conditions=StopConditions(
                        max_tokens=10, ignore_eos=True)).to_wire()):
                toks.extend(LLMEngineOutput.from_wire(frame).token_ids)
            await gen.stop()
        finally:
            stop.set()
            await asyncio.wait_for(task, 30)
            await client_rt.shutdown()
            await hub.stop()
        return toks, want

    got, want = asyncio.run(run())
    assert len(got) == 10 and got == want
