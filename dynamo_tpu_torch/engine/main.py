"""``python -m dynamo_tpu_torch.engine.main`` — run a torch engine worker.

The port of ``dynamo_tpu/engine/main.py``: it builds the engine (from a
checkpoint directory, or a preset with random weights), joins the control
plane, serves its role's endpoints, publishes KV events and load metrics,
and on SIGTERM or SIGINT drains, revokes its lease and leaves discovery.
The JAX package's frontend and router find it as they find a JAX worker.

Roles (``--role``):

- ``aggregated`` (default): ``generate`` prefills and decodes every
  request; the model card is registered.
- ``decode``: as aggregated, but a prompt longer than
  ``--max-local-prefill-length`` (live: ``DisaggConfig.KEY`` on the
  control plane) is prefilled by the ``--prefill-component`` fleet, through
  the prefill queue unless ``--no-prefill-queue``, and its KV scattered
  here.
- ``prefill``: ``generate`` of the prefill component runs prefills and
  streams their KV (chunk frames, then ``--kv-layer-groups`` layer frames
  of the last chunk); it pops the prefill queue and registers no model and
  no ``embed``.

Every role serves ``kv_pull`` (peers' restore and onboard pulls from the
device prefix cache and the KVBM host and disk tiers) and
``clear_kv_blocks`` (the prefix cache and every tier). It takes the JAX
worker's command line. Preempt-to-swap is on unless ``--no-preempt-swap``
(``--swap-host-gb`` its budget), and ``--kvbm-host-gb``,
``--kvbm-disk-dir`` and ``--kvbm-disk-gb`` configure the G2 and G3 tiers;
the swap counters and gauges go out under the JAX worker's names. The
flags of what the port does not serve yet (every ``EngineArgs`` knob in
``UNPORTED_KNOBS``, the G4 tier and the distributed block manager,
multimodal encode, multi-host, profiling) are refused with the ROADMAP id
that ports them. The guided-decoding alphabet comes from the tokenizer's
``tokenizer.json`` (``llm/tokenizer.py``). One flag is the port's own:
``--device`` (default "cuda"; "cpu" only when asked for). The model dtype
is the checkpoint config's, as the JAX worker reads it.

The disaggregated roles move KV device to device when they can
(``disagg/transfer.py``: CUDA IPC between two workers on one card);
``--no-kv-transfer-direct`` (the JAX package's ``EngineArgs.
kv_transfer_direct`` off) keeps every transfer host-staged.

``--speculative-tokens``, ``--speculative-method`` and
``--speculative-draft-layers`` turn on speculative decoding (prompt lookup
or the layer-skip draft); the ``spec_disabled_total`` counter counts the
times its governor suspended it.

``--quantization int8 | int8-gN | int4-gN`` loads the checkpoint's matmul
weights quantized on the card, each as it is stacked, and every product
through them runs the dequant-GEMM kernel (``ops/qmm.py``).

The worker prints ``WORKER_READY`` once registered, and at exit a line
``WORKER_EXIT {json}`` with its engine steps (verify forwards and draft
bursts among them) and speculative decoding's counts, the launches of each kernel
wrapper in this process, the blocks still in use, its role's transfer
counts and records (the decode side's transfers by link path), the direct
transfer's offers, pulls, pull failures, offers still outstanding and
handles still mapped, and its allocated device bytes when it registered
and at exit.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import logging
import os
import signal
from typing import Optional

from dynamo_tpu_torch.disagg.handlers import (
    DecodeWorkerHandler, DisaggConfigWatcher, KvPullHandler,
    PrefillWorkerHandler,
)
from dynamo_tpu_torch.disagg.protocols import DisaggConfig
from dynamo_tpu_torch.disagg.queue import (
    PrefillQueueClient, PrefillQueueWorker, engine_capacity_gate,
)
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.llm.model_card import (
    ModelDeploymentCard, register_llm, resolve_eos_token_ids,
)
from dynamo_tpu_torch.router.publisher import (
    KvEventPublisher, WorkerMetricsPublisher,
)
from dynamo_tpu_torch.runtime import DistributedRuntime
from dynamo_tpu_torch.runtime.config import setup_logging

logger = logging.getLogger("dynamo_torch.engine.main")

#: flags of the JAX worker the port does not serve yet: dest → (the value
#: that means "off", the ROADMAP item that ports it). Any other value is
#: refused at startup. (EngineArgs refuses its own UNPORTED_KNOBS.)
REFUSED_FLAGS = {
    "dp_rank": (None, "A11"),
    "num_ranks": (1, "A11"),
    "kvbm_g4_gb": (0.0, "A8e"),
    "kvbm_distributed": (False, "A8e"),
    "kvbm_leader_workers": (0, "A8e"),
    "profile_dir": (None, "A12"),
    "mm_encode": (False, "A9"),
    "mm_vision_model": (None, "A9"),
    "mm_projector": (None, "A9"),
    "jax_coordinator": (None, "A11"),
    "jax_num_processes": (None, "A11"),
    "jax_process_id": (None, "A11"),
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="dynamo-tpu torch engine worker")
    ap.add_argument("--model", default="torch-model", help="served model name")
    ap.add_argument("--model-path", default=None,
                    help="HF checkpoint dir (config.json + safetensors); "
                         "omit for random weights (testing)")
    ap.add_argument("--arch", default=None,
                    help="architecture preset when no --model-path (see "
                         "dynamo_tpu_torch.models.PRESETS)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the worker runs on the card unless "
                         "given cpu")
    ap.add_argument("--namespace", default="dynamo")
    ap.add_argument("--component", default=None, help="default: backend")
    ap.add_argument("--role", default="aggregated",
                    choices=["aggregated", "decode", "prefill"],
                    help="aggregated serving, or one side of disaggregated "
                         "prefill/decode serving")
    # the decode role's knobs
    ap.add_argument("--prefill-component", default="prefill")
    ap.add_argument("--prefill-queue", action="store_true", default=True)
    ap.add_argument("--no-prefill-queue", dest="prefill_queue",
                    action="store_false")
    ap.add_argument("--max-local-prefill-length", type=int, default=512)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=None)
    ap.add_argument("--max-num-seqs", type=int, default=64)
    ap.add_argument("--max-num-batched-tokens", type=int, default=2048)
    ap.add_argument("--max-model-len", type=int, default=4096)
    ap.add_argument("--tp-size", type=int, default=1)
    ap.add_argument("--pp-size", type=int, default=1)
    ap.add_argument("--dp-size", type=int, default=1)
    ap.add_argument("--kv-cache-dtype", default=None,
                    choices=["auto", "int8"])
    ap.add_argument("--dp-rank", type=int, default=None)
    ap.add_argument("--num-ranks", type=int, default=1)
    ap.add_argument("--use-pallas-attention", action="store_true")
    ap.add_argument("--quantization", default=None,
                    help="on-device weight quantization: int8 | int8-gN | "
                         "int4-gN; weights stay quantized in HBM with "
                         "dequant fused into the matmuls")
    ap.add_argument("--speculative-method", default="prompt_lookup",
                    choices=["prompt_lookup", "draft_layers"])
    ap.add_argument("--speculative-draft-layers", type=int, default=0)
    ap.add_argument("--speculative-tokens", type=int, default=0)
    ap.add_argument("--multi-step-decode", type=int, default=1,
                    help="K > 1: decode K tokens a burst (one captured "
                         "graph)")
    ap.add_argument("--warmup-buckets", action="store_true",
                    help="run every token bucket's step signatures before "
                         "registering, so no request pays a first capture "
                         "(engine.warmup())")
    ap.add_argument("--warmup-seq-lens", default=None,
                    help="comma-separated sequence lengths for "
                         "--warmup-buckets; accepted, as by the JAX worker, "
                         "and choose nothing (no signature has a table "
                         "width)")
    ap.add_argument("--no-pipeline-decode", dest="pipeline_decode",
                    action="store_false", default=True,
                    help="disable the depth-2 pipelined decode loop")
    ap.add_argument("--no-structured-device", dest="structured_device",
                    action="store_false", default=True,
                    help="keep guided-decoding constraints on the host "
                         "oracle instead of compiling them into device FSM "
                         "tables fused into the sampling step")
    ap.add_argument("--structured-table-mb", type=float, default=None,
                    help="byte budget (MiB) for the device FSM arena; "
                         "default DYN_STRUCTURED_TABLE_MB or 64")
    ap.add_argument("--no-preempt-swap", dest="preempt_swap",
                    action="store_false", default=True,
                    help="disable preempt-to-swap (KV of preempted "
                         "sequences staged in host DRAM and swapped back "
                         "instead of recomputed); preemption then always "
                         "releases + re-prefills")
    ap.add_argument("--kv-layer-groups", type=int, default=4,
                    help="layer groups the last prefill chunk's KV ships "
                         "in (<= 1: one bundle)")
    ap.add_argument("--no-kv-transfer-direct", dest="kv_transfer_direct",
                    action="store_false", default=True,
                    help="move disagg KV host-staged only: offer no direct "
                         "device-to-device pull, advertise none")
    ap.add_argument("--no-prefix-caching", action="store_true")
    ap.add_argument("--tool-call-parser", default=None,
                    choices=["hermes", "llama3_json", "mistral", "phi4",
                             "pythonic", "nemotron_deci", "deepseek_v3_1",
                             "harmony"])
    ap.add_argument("--reasoning-parser", default=None,
                    choices=["deepseek_r1", "qwen3", "basic", "granite",
                             "gpt_oss"])
    ap.add_argument("--eos-token-ids", default=None,
                    help="comma-separated EOS ids (default: read from "
                         "generation_config.json next to --model-path)")
    ap.add_argument("--tokenizer", default=None,
                    help="tokenizer dir for the model card (default: "
                         "--model-path)")
    ap.add_argument("--allow-test-metadata", action="store_true",
                    help="permit the toy tokenizer + eos=[2] defaults when "
                         "no --model-path is given (tests only)")
    ap.add_argument("--migration-limit", type=int, default=None)
    ap.add_argument("--swap-host-gb", type=float, default=None,
                    help="host-byte budget for swapped-out KV (default: "
                         "share the G2 tier budget when --kvbm-host-gb is "
                         "set, else 1 GiB)")
    ap.add_argument("--kvbm-host-gb", type=float, default=0.0,
                    help="host-DRAM KV tier size (0 = off)")
    ap.add_argument("--kvbm-disk-dir", default=None)
    ap.add_argument("--kvbm-disk-gb", type=float, default=0.0)
    ap.add_argument("--kvbm-g4-gb", type=float, default=0.0)
    ap.add_argument("--kvbm-distributed", action="store_true")
    ap.add_argument("--kvbm-leader-workers", type=int, default=0)
    ap.add_argument("--profile-dir", default=None)
    ap.add_argument("--profile-seconds", type=float, default=30.0)
    ap.add_argument("--mm-vision-model", default=None)
    ap.add_argument("--mm-projector", default=None)
    ap.add_argument("--mm-encode", action="store_true")
    ap.add_argument("--jax-coordinator", default=None)
    ap.add_argument("--jax-num-processes", type=int, default=None)
    ap.add_argument("--jax-process-id", type=int, default=None)
    return ap


def configure(cli) -> tuple[ModelConfig, EngineArgs, list[int], str]:
    """Everything the command line decides, checked before any heavy work:
    (model config, engine args, EOS ids, tokenizer reference). Raises
    SystemExit naming what is wrong or not ported."""
    for dest, (off, item) in REFUSED_FLAGS.items():
        if getattr(cli, dest) != off:
            flag = "--" + dest.replace("_", "-")
            raise SystemExit(f"{flag}={getattr(cli, dest)!r} is not "
                             f"supported by the torch worker yet (ROADMAP "
                             f"{item})")
    if cli.model_path:
        if not os.path.isfile(os.path.join(cli.model_path, "config.json")):
            raise SystemExit(f"--model-path {cli.model_path}: no config.json "
                             "there (the torch worker loads local HF "
                             "checkpoint directories only)")
        cfg = ModelConfig.from_pretrained(cli.model_path)
    else:
        from dynamo_tpu_torch.models import get_model_config
        cfg = get_model_config(cli.arch or "tiny")

    eos: list[int] = []
    if cli.eos_token_ids:
        try:
            eos = [int(x) for x in cli.eos_token_ids.split(",") if x.strip()]
        except ValueError:
            raise SystemExit(f"--eos-token-ids must be comma-separated ints, "
                             f"got {cli.eos_token_ids!r}")
    elif cli.model_path:
        try:
            eos = resolve_eos_token_ids(cli.model_path)
        except ValueError as e:
            raise SystemExit(f"{e}; pass --eos-token-ids")
    elif cli.allow_test_metadata:
        eos = [2]
    if not eos:
        raise SystemExit("no EOS ids: pass --model-path (reads "
                         "generation_config.json), --eos-token-ids, or "
                         "--allow-test-metadata for tests")
    warmup_seq_lens(cli)
    tokenizer_ref = cli.tokenizer or cli.model_path
    if not tokenizer_ref:
        if not cli.allow_test_metadata:
            raise SystemExit(
                "no --model-path given: refusing to register with test-only "
                "tokenizer/EOS metadata. Pass --model-path, or "
                "--eos-token-ids plus --tokenizer, or --allow-test-metadata "
                "for tests.")
        tokenizer_ref = "test"

    try:
        args = EngineArgs(
            block_size=cli.block_size, num_blocks=cli.num_blocks,
            max_num_seqs=cli.max_num_seqs,
            max_num_batched_tokens=cli.max_num_batched_tokens,
            max_model_len=cli.max_model_len,
            enable_prefix_caching=not cli.no_prefix_caching,
            tp_size=cli.tp_size, dp_size=cli.dp_size, pp_size=cli.pp_size,
            use_pallas_attention=cli.use_pallas_attention,
            multi_step_decode=cli.multi_step_decode,
            speculative_tokens=cli.speculative_tokens,
            speculative_method=cli.speculative_method,
            speculative_draft_layers=cli.speculative_draft_layers,
            kvbm_host_bytes=int(cli.kvbm_host_gb * (1 << 30)),
            kvbm_disk_dir=cli.kvbm_disk_dir,
            kvbm_disk_bytes=int(cli.kvbm_disk_gb * (1 << 30)),
            preempt_swap=cli.preempt_swap,
            swap_host_bytes=(int(cli.swap_host_gb * (1 << 30))
                             if cli.swap_host_gb is not None else None),
            quantization=cli.quantization,
            kv_cache_dtype=cli.kv_cache_dtype,
            pipeline_decode=cli.pipeline_decode,
            structured_device=cli.structured_device,
            structured_table_mb=cli.structured_table_mb,
            warmup_buckets=cli.warmup_buckets,
            kv_transfer_layer_groups=cli.kv_layer_groups,
            kv_transfer_direct=cli.kv_transfer_direct)
    except ValueError as e:
        raise SystemExit(str(e))
    return cfg, args, eos, tokenizer_ref


def warmup_seq_lens(cli) -> Optional[list[int]]:
    """``--warmup-seq-lens`` as ints (None when not given)."""
    if not cli.warmup_seq_lens:
        return None
    try:
        return [int(x) for x in cli.warmup_seq_lens.split(",") if x.strip()]
    except ValueError:
        raise SystemExit(f"--warmup-seq-lens must be comma-separated ints, "
                         f"got {cli.warmup_seq_lens!r}")


def guided_vocab_for(cli, tokenizer_ref: str):
    """The guided-decoding alphabet of the served tokenizer (read from its
    ``tokenizer.json`` with ``json`` alone), or None: guided requests are
    then refused. Test fleets (``--allow-test-metadata`` with no tokenizer)
    take the test tokenizer's words, as the frontend serves with it."""
    from dynamo_tpu_torch.llm.tokenizer import (
        load_guided_vocab, wordlevel_test_vocab,
    )
    if tokenizer_ref != "test":
        return load_guided_vocab(tokenizer_ref)
    return wordlevel_test_vocab() if cli.allow_test_metadata else None


def build_engine(cli, cfg: ModelConfig, args: EngineArgs,
                 tokenizer_ref: Optional[str] = None):
    """Construct the engine BEFORE joining the control plane: loading the
    weights and allocating the pool block the event loop long enough to
    starve the lease keepalive. ``tokenizer_ref`` (default: ``--tokenizer``,
    else ``--model-path``, else the test tokenizer) gives the guided
    alphabet."""
    tokenizer_ref = tokenizer_ref or cli.tokenizer or cli.model_path or "test"
    from dynamo_tpu_torch.engine.engine import AsyncTorchEngine, resolve_device

    device = resolve_device(cli.device)
    params = None
    if cli.model_path:
        from dynamo_tpu_torch.engine.loader import load_hf_params
        params = load_hf_params(cfg, cli.model_path, device,
                                quantization=args.quantization)
    return AsyncTorchEngine(cfg, args, params=params, device=device,
                            guided_vocab=guided_vocab_for(cli, tokenizer_ref))


def kernel_launches() -> dict:
    """Launches of each kernel wrapper in this process (a graph replay
    counts the launches it holds)."""
    from dynamo_tpu_torch.engine.graphs import COUNTED

    return {w.__name__: w.launches for w in COUNTED}


async def serve(cli, engine, args: EngineArgs, eos: list[int],
                tokenizer_ref: str, stop: asyncio.Event) -> dict:
    """Join the plane (after ``engine.warmup()`` when ``--warmup-buckets``
    is given: no request can race the dummy steps), serve the role's
    endpoints until ``stop`` is set, then drain and leave. Returns the
    exit report (engine steps, kernel launches, captures, blocks in use,
    the role's transfer counts)."""
    if args.warmup_buckets:
        await engine.warmup(seq_lens=warmup_seq_lens(cli))
    runtime = await DistributedRuntime.create()
    handles, stoppers = [], []
    try:
        lease = await runtime.primary_lease()
        kv_pub = KvEventPublisher(runtime.plane, worker_id=lease,
                                  kv_block_size=args.block_size)
        await kv_pub.start_resync_responder()
        engine.event_cb = kv_pub.publish_sync
        engine.metrics_cb = WorkerMetricsPublisher(
            runtime.plane, worker_id=lease).publish_sync
        runtime.metrics.counter(
            "spec_disabled_total",
            "times the engine auto-suspended losing speculative "
            "decode").add_callback(
            lambda: {None: engine.spec_disabled_total})
        register_swap_metrics(runtime.metrics, engine)

        prefill = cli.role == "prefill"
        component = cli.component or ("prefill" if prefill else "backend")
        ns = runtime.namespace(cli.namespace)
        comp = ns.component(component)
        ep = comp.endpoint("generate")
        decode = None
        if prefill:
            serve_fn = PrefillWorkerHandler(engine).generate
        else:
            prefill_client = prefill_queue = None
            # restore pull sources: peers of this component, and in a
            # disagg deployment the prefill fleet (it still holds the
            # prompts it prefilled)
            pull_clients = [await comp.endpoint("kv_pull").client().start()]
            dconf = DisaggConfig(
                max_local_prefill_length=cli.max_local_prefill_length)
            if cli.role == "decode":
                pcomp = ns.component(cli.prefill_component)
                prefill_client = await pcomp.endpoint(
                    "generate").client().start()
                pull_clients.append(
                    await pcomp.endpoint("kv_pull").client().start())
                if cli.prefill_queue:
                    prefill_queue = PrefillQueueClient(
                        runtime.plane, metrics=runtime.metrics)
                watcher = await DisaggConfigWatcher(runtime.plane,
                                                    dconf).start()
                stoppers.append(watcher.stop)
            stoppers += [c.stop for c in pull_clients]
            if prefill_client is not None:
                stoppers.append(prefill_client.stop)
            decode = DecodeWorkerHandler(
                engine, prefill_client, dconf, prefill_queue=prefill_queue,
                metrics=runtime.metrics, pull_clients=pull_clients,
                plane=runtime.plane)
            decode.instance_id = lease
            serve_fn = decode.generate
        handle = await ep.serve_endpoint(serve_fn, lease_id=lease)
        puller = KvPullHandler(engine, metrics=runtime.metrics)
        handles.append(await comp.endpoint("kv_pull").serve_endpoint(
            puller.generate, lease_id=lease))
        if not prefill:  # embeddings ride the decode/aggregated fleet
            handles.append(await comp.endpoint("embed").serve_endpoint(
                engine.embed_handler, lease_id=lease))

        async def clear_kv_handler(request, ctx):
            """Admin flush: the device prefix cache and every KVBM tier."""
            engine.pool.clear()
            if engine.kvbm is not None:
                await asyncio.to_thread(engine.kvbm.clear)
            yield {"ok": True, "message": "KV cache cleared"}

        handles.append(await comp.endpoint("clear_kv_blocks").serve_endpoint(
            clear_kv_handler, lease_id=lease))
        if prefill and cli.prefill_queue:
            queue_worker = await PrefillQueueWorker(
                runtime.plane, instance_id=lease,
                capacity_gate=engine_capacity_gate(engine),
                metrics=runtime.metrics).start()
            stoppers.insert(0, queue_worker.stop)
        if not prefill:  # the prefill fleet is internal, not a model server
            card = ModelDeploymentCard(
                display_name=cli.model, kv_cache_block_size=args.block_size,
                eos_token_ids=eos, tokenizer_ref=tokenizer_ref)
            card.runtime_config.total_kv_blocks = engine.num_blocks
            card.runtime_config.max_num_seqs = args.max_num_seqs
            card.runtime_config.max_num_batched_tokens = \
                args.max_num_batched_tokens
            if cli.migration_limit is not None:
                card.migration_limit = cli.migration_limit
            card.runtime_config.tool_call_parser = cli.tool_call_parser
            card.runtime_config.reasoning_parser = cli.reasoning_parser
            await register_llm(runtime, ep, card, lease_id=lease)

        ready_bytes = device_bytes(engine)
        print("WORKER_READY", flush=True)
        await stop.wait()
        for fn in stoppers:
            await fn()
        for h in handles:
            await h.stop(graceful=False)
        await handle.stop(graceful=True, timeout=runtime.config.drain_timeout)
        await kv_pub.stop()
        if decode is not None:
            await decode.drain_releases()
        report = {"steps": engine.steps,
                  "pipelined_steps": engine.pipelined_steps,
                  "forward_steps": engine.forward_steps,
                  "verify_steps": engine.verify_steps,
                  "draft_steps": engine.draft_steps,
                  "spec": dataclasses.asdict(engine.spec_stats),
                  "spec_disabled": engine.spec_disabled_total,
                  "launches": kernel_launches(),
                  "compile_events": engine.compile_events,
                  "active_blocks": engine.pool.num_active_blocks,
                  "served_pulls": puller.served}
        if decode is not None:
            report["disagg"] = decode.report()
        if prefill:
            report["extract"] = engine.extract_records()
        mgr = engine.direct_transfer
        if mgr is not None:
            # the sweep frees what the decode side released
            report["direct"] = {**mgr.stats,
                                "outstanding": mgr.outstanding(),
                                "held_bytes": mgr.held_bytes(),
                                "mapped": getattr(mgr.ipc, "mapped", 0)}
        # at rest: the bytes allocated when registered, and now (offers
        # freed, digests read back)
        report["device_bytes"] = {"ready": ready_bytes,
                                  "exit": device_bytes(engine)}
        await engine.close()
    finally:
        await runtime.shutdown()
    return report


def register_swap_metrics(metrics, engine) -> None:
    """The preempt-to-swap counters and gauges, under the JAX worker's
    names, read from ``engine.swap_stats()`` at each scrape."""
    def field(name):
        return lambda: {None: engine.swap_stats()[name]}

    for name, fld, help_ in (
            ("swap_out_blocks_total", "swap_out_blocks",
             "KV blocks swapped out to the host tier by preemption"),
            ("swap_in_blocks_total", "swap_in_blocks",
             "KV blocks swapped back to device from the host tier"),
            ("preempt_swap_total", "preempt_swap",
             "preemptions resolved by swap-out (KV preserved)"),
            ("swap_in_seqs_total", "swap_in_seqs",
             "swapped-out sequences re-activated by swap-in"),
            ("preempt_recompute_total", "preempt_recompute",
             "preemptions resolved by release-and-recompute (including "
             "swap-outs whose swap-in later fell back)"),
            ("preempt_recomputed_tokens_total", "recomputed_tokens",
             "tokens discarded by recompute preemptions (re-prefilled)")):
        metrics.counter(name, help_).add_callback(field(fld))
    metrics.gauge(
        "swap_host_bytes",
        "host bytes held by swapped-out KV bundles").add_callback(
        field("swap_host_bytes"))
    metrics.gauge(
        "swapped_blocks",
        "KV blocks currently host-resident via preempt-to-swap").add_callback(
        field("swapped_blocks"))
    metrics.counter(
        "swap_in_blocked_total",
        "swap-in head-of-line candidates re-parked by the starvation "
        "guard (failed block reservations)").add_callback(
        field("swap_in_blocked"))


def device_bytes(engine) -> Optional[int]:
    """Bytes the caching allocator holds allocated on the engine's card
    (None on the CPU)."""
    if engine.device.type != "cuda":
        return None
    import torch

    torch.cuda.synchronize(engine.device)
    return torch.cuda.memory_allocated(engine.device)


async def amain(argv=None) -> None:
    cli = build_parser().parse_args(argv)
    # command-line mistakes fail in milliseconds, not after the load
    cfg, args, eos, tokenizer_ref = configure(cli)
    engine = build_engine(cli, cfg, args, tokenizer_ref)
    loop = asyncio.get_running_loop()
    stop = asyncio.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    report = await serve(cli, engine, args, eos, tokenizer_ref, stop)
    print("WORKER_EXIT " + json.dumps(report), flush=True)


def main():
    setup_logging()
    asyncio.run(amain())


if __name__ == "__main__":
    main()
