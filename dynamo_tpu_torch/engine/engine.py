"""AsyncTorchEngine: the token-generation engine of the torch port.

The port of ``AsyncJaxEngine``'s main path: the engine loop executes
scheduler plans as packed ragged steps,

    plan() → one packed ragged launch (prefill chunks + decode rows) →
    commit → sample → emit LLMEngineOutput per sequence → KV events

with the same ``generate(req, ctx)`` contract, the same packing, the same
sampling and the same KV stored/removed events, so a torch worker and a
JAX worker produce the same streams (greedy, and seeded draws bit for
bit) and block hashes. Sampling (``engine/sampling.py``) takes each row's
temperature, top-k, top-p, key (seed, absolute position) and FSM state;
the sparse logit edits of penalties, ``logit_bias`` and host-oracle
guided rows are applied to the step's logits first, and logprob rows get
their top logprobs from the same edited logits. Every plan goes through
the one packed launch. While every running sequence decodes and none
needs a host round trip (logprobs, logit edits, host-oracle guided rows),
the depth-2 pipelined loop (``EngineArgs.pipeline_decode``, on by default
as in the JAX package) launches step N+1 with step N's tokens and FSM
states fed on the device before step N's tokens reach the host. Each
step's operands, sampling operands included, cross to the card as one
non-blocking copy out of pinned staging memory into one device buffer that
never moves, and its tokens come back the same way. With
``EngineArgs.multi_step_decode`` K > 1, a decode-only batch that needs no
host round trip runs K steps and their draws in one burst
(``model.make_multi_decode_fn``) and each sequence gets one output per
burst. With ``EngineArgs.speculative_tokens`` K > 0, a greedy decode-only
batch that needs no host round trip drafts up to K tokens a row (prompt
lookup in the row's own history, or the layer-skip draft: a greedy burst
through the first ``speculative_draft_layers`` layers) and verifies them
in ONE ragged forward, each row a chunk of K + 1 tokens
(``model.make_ragged_verify_fn``; FSM-constrained rows under per-position
mask words walked on the host). Each row accepts its longest matching
draft prefix plus the verify's own next token, the tokens plain greedy
decode gives, in one output. A governor suspends speculation while it
loses (the JAX engine's ``spec_gain_window`` and ``spec_reprobe_steps``);
``spec_stats`` counts drafts and acceptance. Multimodal requests are
refused at ``generate()``.

On the card every step runs as a CUDA graph (``engine/graphs.py``): the
first use of a signature (a mixed step's or a decode-only step's token
bucket, a sampler's rows and branches, a burst's rows) runs eagerly and
is captured, and every later use replays the capture, as the JAX engine
compiles one program per signature (speculative decoding adds
``("verify" | "verify_fsm", T)`` and a draft burst's ``("draft", R,
K, D)``). ``warmup()`` runs every token bucket's signatures, and the verify
and draft signatures the batch sizes can reach, before serving; ``compiled_signatures``, ``compile_events`` and
``compile_seconds`` count them as the JAX engine does. ``use_graphs =
False`` runs the same steps eagerly. Batches whose sampler needs the host
(logit edits, top logprobs) sample eagerly after a captured forward.

Models: Llama-family GQA, and DeepSeek MLA with its MoE (the latent KV
pool is sized from ``ModelConfig.kv_cache_spec``; MLA decode rows go
through the MLA latent-decode kernel, chunk tokens through the MLA
flash-prefill kernel, and a plan with decode rows only passes no chunk
grid).

``embed`` is the port of ``AsyncJaxEngine.embed``: mean-pooled sequence
embeddings through the dense forward and a flash prefill kernel (GQA or
MLA), over a scratch cache of its own.
``EngineArgs.kv_cache_dtype="int8"`` serves from an int8 KV pool: GQA
through the ragged kernel's int8 pages, MLA through the int8 latent and
rope pages of both MLA kernels.

Disaggregated serving and KV pulls (the JAX engine's disagg support):
``prefill_extract`` / ``prefill_extract_stream`` run a prefill only and
hand back its first token and its blocks (whole, or as chunk frames while
later chunks compute and layer frames of the last chunk);
``alloc_inject``, ``scatter_chunk`` and ``generate_prefilled`` (or
``generate_injected`` for a whole bundle) decode a prompt whose KV was
computed elsewhere; ``export_blocks`` serves a peer's pull from the device
prefix cache and its host and disk tiers, and ``attach_restored``
registers pulled blocks in the prefix cache.

Preempt-to-swap (``EngineArgs.preempt_swap``, on by default as in the JAX
package) and the KVBM tiers (``kvbm_host_bytes``, ``kvbm_disk_dir``,
``kvbm_disk_bytes``): the engine is the scheduler's swapper and onboarding
hook. A victim's pages are gathered on the engine's stream before its
blocks are released, copied to pinned host memory on a copy stream of their
own (the next step does not queue behind the PCIe transfer), and scattered
back in place before the sequence's next step. Full blocks are offloaded to
the host tier as they register, and a prompt prefix the device pool lost is
written back from it at admission (from disk, after a background promotion
to the host tier). Gathers and scatters are ``ops/block_copy.py``'s; they
write the caches in place, so the graphs' addresses hold.

The engine runs on the card: ``device=None`` means "cuda" and raises when
CUDA is missing. Only an explicit ``device="cpu"`` runs on the CPU, where
attention takes its plain PyTorch version. Every launch, copy and event of
a step is issued on the device's default stream, from whichever thread
runs it (a worker thread for the serial loop's steps, the event loop's
thread for the pipelined loop's), so a step, the token feed into the next
step and the tokens' copy to the host stay in issue order.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import itertools
import logging
import math
import secrets
import threading
import time
from typing import AsyncIterator, Callable, Optional

import numpy as np
import torch

from dynamo_tpu_torch.engine import sampling
from dynamo_tpu_torch.engine.cache import (
    NULL_BLOCK, BlockPool, SwapStore, allocate_device_cache, cache_shape,
    is_quant_cache, kv_block_bytes, memory_sized_num_blocks,
    packed_block_width,
)
from dynamo_tpu_torch.engine.config import (
    RAGGED_MAX_CHUNKS, EngineArgs, ModelConfig,
)
from dynamo_tpu_torch.engine.graphs import GraphCache
from dynamo_tpu_torch.engine.model import (
    RAGGED_TILE, check_kernel_geometry, check_quant_geometry,
    check_supported, f32_sinks, init_params, make_draft_fn, make_embed_fn,
    make_multi_decode_fn, make_ragged_step_fn, make_ragged_verify_fn,
    torch_dtype,
)
from dynamo_tpu_torch.engine.quant import quantize_params
from dynamo_tpu_torch.engine.scheduler import Scheduler, SeqState, StepPlan
from dynamo_tpu_torch.ops.block_copy import (
    blocks_digest, gather_blocks, scatter_blocks,
)
from dynamo_tpu_torch.protocols import (
    FinishReason, LLMEngineOutput, PreprocessedRequest,
)
from dynamo_tpu_torch.router.protocols import (
    ForwardPassMetrics, KvCacheEvent, KvStats, SpecDecodeStats, StoredBlock,
    WorkerStats,
)
from dynamo_tpu_torch.tokens import KV_HASH_SEED, TokenBlockSequence

logger = logging.getLogger("dynamo_torch.engine")

#: most top logprobs a row may ask for (OpenAI's limit); the top-k pass
#: always computes this many and each row keeps its own count
TOP_LOGPROBS = 20

#: most page bytes (k and v) one disagg transfer frame carries, well under
#: the response plane's 256 MiB frame cap (``runtime/codec.py``)
FRAME_BYTES = 64 << 20

#: preempt-to-swap's host budget of its own, when no G2 tier is configured
DEFAULT_SWAP_HOST_BYTES = 1 << 30


class _SwapEntry:
    """One swapped-out sequence's host bundle and budget reservation.

    Created when the gather is enqueued (budget reserved), ready when the
    host copy has landed, freed when swap-in's copy to the card has landed
    or at teardown. ``dropped`` marks a teardown that raced the copy: the
    copy's task frees the reservation when it ends."""

    __slots__ = ("n", "nbytes", "k", "v", "ready", "failed", "freed",
                 "dropped")

    def __init__(self, n: int, nbytes: int):
        self.n = n              # device blocks captured
        self.nbytes = nbytes    # reserved against the SwapStore budget
        self.k = None           # host bundle [L, n, bs, KV, hd] or packed
        self.v = None
        self.ready = False
        self.failed = False
        self.freed = False
        self.dropped = False


def _has_penalties(s) -> bool:
    """True when the sequence asks for a sampling penalty (OpenAI presence
    and frequency over the generated text, HF repetition over prompt and
    generated): they need the host's token history every step."""
    so = s.req.sampling_options
    return bool(so.presence_penalty or so.frequency_penalty
                or (so.repetition_penalty not in (None, 1.0)))


def _guided_fsm(s):
    """The sequence's device FSM cursor (structured.FsmCursor), or None for
    unconstrained rows and host-oracle rows."""
    gs = s.guided_state
    return gs if gs is not None and getattr(gs, "device", False) else None


def _guided_host_only(s) -> bool:
    """True when the sequence's constraint runs on the host oracle (tables
    over budget, min_tokens, no device arena): its mask is a host edit
    every step, and its advance a walk of the oracle."""
    gs = s.guided_state
    return gs is not None and not getattr(gs, "device", False)


def resolve_device(device=None) -> torch.device:
    """``None`` → the card. A CUDA device without CUDA raises: the port
    never carries on on the CPU unless asked to."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the port on the CPU")
    return dev


def refusal(req: PreprocessedRequest) -> Optional[str]:
    """Why the port cannot serve ``req`` yet, or None: only multimodal
    input is not ported."""
    if req.mm_embeds or req.mm_refs:
        return "multimodal input (ROADMAP A9)"
    return None


class AsyncTorchEngine:
    """Continuously-batched paged-KV inference engine on PyTorch.

    Args:
      cfg/args: model + engine config.
      params: the port's params dict (None → random init from args.seed).
      device: None = "cuda"; "cpu" only when asked for explicitly.
      event_cb: fn(KvCacheEvent) — KV events toward the router.
      metrics_cb: fn(ForwardPassMetrics) — per-step load metrics.
      guided_vocab: id → the text each token contributes
        (``llm/tokenizer.py``); None = guided requests are refused.
    """

    def __init__(self, cfg: ModelConfig, args: EngineArgs, params=None,
                 device=None, event_cb: Optional[Callable] = None,
                 metrics_cb: Optional[Callable] = None,
                 guided_vocab: Optional[list] = None):
        check_supported(cfg)
        self.cfg, self.args = cfg, args
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            check_kernel_geometry(cfg)
        self.dtype = torch_dtype(cfg)
        self.event_cb = event_cb
        self.metrics_cb = metrics_cb
        self._event_id = itertools.count()
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(args.seed)
            params = init_params(cfg, gen, self.device, args.quantization)
        elif args.quantization is not None:
            # the JAX engine quantizes params handed in unquantized; here
            # leaf by leaf and layer by layer on the device (quantized
            # leaves pass through), and the engine keeps no original
            params = quantize_params(params, args.quantization)
        if self.device.type == "cuda":
            check_quant_geometry(params, self.dtype)
        # sink logits in the kernels' f32, once (no step converts them)
        self.params = f32_sinks(params)
        del params
        if self.device.type == "cuda":
            # the draw's and the quantizer's scratch, cached by the
            # allocator, would otherwise count as used below
            torch.cuda.empty_cache()
        # the pool takes its share of what is free once the weights are
        # resident
        kv_dtype = "int8" if args.kv_cache_dtype == "int8" else None
        nb = args.num_blocks or memory_sized_num_blocks(
            cfg, args.block_size, args.kv_cache_memory_fraction,
            self.device, self.dtype, kv_dtype)
        self.num_blocks = nb
        self.k_cache, self.v_cache = allocate_device_cache(
            cfg, nb, args.block_size, self.device, self.dtype, kv_dtype)
        #: the KVBM host and disk tiers (None = off; they need the prefix
        #: cache, whose hashes key them)
        self.kvbm = None
        if args.kvbm_host_bytes > 0 and args.enable_prefix_caching:
            from dynamo_tpu_torch.kvbm import KvbmManager
            self.kvbm = KvbmManager(args.kvbm_host_bytes,
                                    disk_dir=args.kvbm_disk_dir,
                                    disk_bytes=args.kvbm_disk_bytes,
                                    # the router hears of a removal only
                                    # when the last local copy dies
                                    on_change=self._on_kvbm_change)
        #: the offloads', promotions' and swap copies' tasks: close()
        #: waits for them
        self._offload_tasks: set = set()
        self._promoting: set = set()
        self._loop_ref: Optional[asyncio.AbstractEventLoop] = None
        #: device-to-host copies of swap-outs and offloads run here, off
        #: the stream the steps run on
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self.pool = BlockPool(nb, args.enable_prefix_caching,
                              on_removed=self._on_removed)
        #: preempt-to-swap's host budget, shared with the G2 tier when one
        #: is configured and swap_host_bytes is not given
        self._swap: Optional[SwapStore] = None
        if args.preempt_swap:
            budget = args.swap_host_bytes
            shared = room = None
            if budget is None:
                if self.kvbm is not None:
                    budget = args.kvbm_host_bytes
                    shared = lambda: self.kvbm.host.used  # noqa: E731
                    # a full G2 LRU yields its bytes to swap reservations
                    room = self.kvbm.make_host_room
                else:
                    budget = DEFAULT_SWAP_HOST_BYTES
            self._swap = SwapStore(budget, external_used=shared,
                                   make_room=room)
            if shared is not None:
                # the other direction: G2's puts evict down to the budget
                # less the swap reservations
                self.kvbm.host.external_used = lambda: self._swap.used
        self.swap_out_blocks = 0
        self.swap_in_blocks = 0
        self.scheduler = Scheduler(
            args, self.pool, on_stored=self._on_stored,
            onboard_cb=self._onboard if self.kvbm is not None else None,
            swapper=self if self._swap is not None else None)
        self.step_fn = make_ragged_step_fn(cfg, args.block_size)
        self._seq_counter = itertools.count()
        self._wake = asyncio.Event()
        # memory-starved plan(): park on _wake until a release frees blocks
        self.pool.on_freed = self._wake.set
        self._task: Optional[asyncio.Task] = None
        self._closed = False
        #: engine steps executed (a burst counts once), and those of them
        #: whose plan held prefill chunks (an MLA model's chunk grid)
        self.steps = 0
        self.chunk_steps = 0
        #: decode steps run by the depth-2 pipelined loop
        self.pipelined_steps = 0
        #: forward passes run (K a burst), and the bursts among the steps
        self.forward_steps = 0
        self.bursts = 0
        #: tokens launched beyond the plans' real work because shapes
        #: bucket up (the JAX engine's dynamo_step_padded_tokens_total)
        self.padded_tokens_total = 0
        #: distinct step signatures dispatched, as the JAX engine names
        #: them: ("ragged" | "ragged_dec", T), ("multi" | "multi_fsm", R),
        #: ("verify" | "verify_fsm", T) and ("draft", R)
        self.compiled_signatures: set = set()
        #: captures (the port's compiles) and their seconds by kind
        #: ("ragged", "ragged_dec", "sample", "multi", "multi_fsm",
        #: "verify", "verify_fsm", "draft"), the eager first use included
        self.compile_events: dict[str, int] = {}
        self.compile_seconds: dict[str, float] = {}
        #: warmup asked for (the worker runs it before registering), and
        #: done: a capture after it is logged as a warning
        self.warmup_requested = args.warmup_buckets
        self.warmed_up = False
        self._staging = _Staging(staging_words(args, cfg.vocab_size),
                                 self.device)
        #: steps run as CUDA graphs (the card's default); False runs the
        #: same steps eagerly
        self.use_graphs = self.device.type == "cuda"
        self.graphs = (GraphCache(self.device)
                       if self.device.type == "cuda" else None)
        self._graph_owner: Optional[tuple] = None
        #: rows -> the [R, V] f32 buffer every step with R rows writes its
        #: logits into (its sampler's static input)
        self._logits: dict = {}
        #: (K, fsm) -> the burst function
        self._multi_fns: dict = {}
        #: speculative decoding: masked -> the verify function, (D, K) ->
        #: the draft burst; the one f32 [T, V] buffer every verify bucket's
        #: logits land in (the largest bucket's rows), sized, as the staging
        #: buffer's mask words are, for the K the engine was made with
        self._verify_fns: dict = {}
        self._draft_fns: dict = {}
        self._verify_logits = (torch.empty(
            (max(verify_buckets(args)), cfg.vocab_size),
            dtype=torch.float32, device=self.device)
            if args.speculative_tokens > 0 else None)
        #: spec rounds that verified, their verify forwards (one a group)
        #: and draft bursts
        self.spec_rounds = 0
        self.verify_steps = 0
        self.draft_steps = 0
        self.spec_stats = SpecDecodeStats()
        #: the auto-disable governor: tokens a row of the last
        #: spec_gain_window verify dispatches; while the measured gain stays
        #: < 1 speculation is suspended until step _spec_resume_step
        self._spec_window: collections.deque = collections.deque(
            maxlen=max(1, args.spec_gain_window))
        self._spec_resume_step = 0
        self.spec_disabled_total = 0
        self.spec_measured_gain: Optional[float] = None
        #: measured walls (EWMA, ms) of one spec round (draft, verify and
        #: the host's part) and of one plain decode-only step: the
        #: governor's cost ratio (_spec_dispatch_cost)
        self._spec_round_ms: Optional[float] = None
        self._decode_step_ms: Optional[float] = None
        if (args.speculative_tokens > 0
                and args.speculative_method == "draft_layers"):
            self._draft_fn(args.speculative_tokens)  # refusals raise here
        self.guided_vocab = guided_vocab
        #: the device FSM arena constraints compile into; None = every
        #: constraint runs on the host oracle (no vocabulary,
        #: structured_device off, DYN_STRUCTURED=0, or a byte budget too
        #: small for this vocabulary width)
        self.structured = None
        if args.structured_device and guided_vocab is not None:
            from dynamo_tpu_torch.structured import (
                StructuredRuntime, arena_states, env_enabled,
                table_budget_bytes,
            )
            if env_enabled():
                cap = arena_states(cfg.vocab_size, table_budget_bytes(
                    args.structured_table_mb))
                if cap:
                    self.structured = StructuredRuntime(
                        cfg.vocab_size, cap, self.device)
                else:
                    logger.info("structured device tables disabled: the "
                                "budget buys too few states at vocab %d",
                                cfg.vocab_size)
        # embeddings: one forward fn and ONE scratch cache, replaced when
        # the (B, S) bucket changes, apart from the serving pool
        self._embed_fn = make_embed_fn(cfg, args.block_size)
        self._embed_cache: Optional[tuple] = None
        self._embed_lock = threading.Lock()
        #: the last prefill extractions' transfers, one record a request:
        #: its context id, its transfer mode ("proc", "ipc", "host") and,
        #: for each frame, (kind, bytes, gather time, bytes-ready time) on
        #: the wall clock (a direct frame's bytes are ready when offered)
        self.extract_log: collections.deque = collections.deque(maxlen=256)
        #: direct device-to-device KV transfer for disagg
        #: (``disagg/transfer.py``); None = host-staged bundles only
        self.direct_transfer = None
        if args.kv_transfer_direct:
            from dynamo_tpu_torch.disagg.transfer import DirectTransferManager

            self.direct_transfer = DirectTransferManager(device=self.device)

    def direct_capability(self) -> Optional[str]:
        """The annotation a decode worker sends so that the prefill worker
        can offer direct device-to-device KV pulls."""
        if self.direct_transfer is None:
            return None
        return self.direct_transfer.capability()

    # ------------------------------------------------------------------ api

    async def generate(self, req: PreprocessedRequest, ctx=None
                       ) -> AsyncIterator[LLMEngineOutput]:
        """EngineFn-compatible async stream of per-token outputs."""
        why = refusal(req)
        if why is not None:
            raise ValueError(f"the torch port cannot serve this request "
                             f"yet: it needs {why}")
        self._ensure_loop()
        sink: asyncio.Queue = asyncio.Queue()
        seq = await self._new_seq(req, ctx, sink)
        self.scheduler.add(seq)
        self._wake.set()
        while True:
            out = await sink.get()
            if out is None:
                return
            yield out
            if out.finish_reason is not None:
                return

    async def _new_seq(self, req: PreprocessedRequest, ctx, sink, **kw
                       ) -> SeqState:
        """A SeqState with its request-scoped sampling state: the guided
        cursor (compiled off the event loop: a cold constraint walks the
        vocabulary once per DFA state and packs its tables) and the key
        seed of an unseeded request. Every entry path (generate, the
        disagg prefill and decode sides) builds its sequence here; ``kw``
        sets SeqState fields (``hold_blocks``, ``progress_cb``)."""
        seq = SeqState(request_id=f"seq-{next(self._seq_counter)}", req=req,
                       ctx=ctx or _NullCtx(), sink=sink, **kw)
        if req.sampling_options.seed is None:
            # drawn once per request, so recompute preemption redraws the
            # same keys (ROADMAP C3)
            seq.unseeded_seed = secrets.randbits(31)
        if req.sampling_options.guided:
            from dynamo_tpu_torch.structured import build_guided_state
            if self.guided_vocab is None:
                raise ValueError(
                    "guided decoding requested but this worker has no "
                    "tokenizer vocabulary (engine started without "
                    "guided_vocab)")
            # min_tokens rows stay on the host oracle: their EOS gating
            # depends on per-step counts the static tables cannot express
            seq.guided_state = await asyncio.to_thread(
                build_guided_state, req.sampling_options.guided,
                self.guided_vocab, req.eos_token_ids or [],
                self.structured,
                not (req.stop_conditions.min_tokens or 0) > 0)
        return seq

    async def embed(self, token_id_lists: list[list[int]]
                    ) -> list[list[float]]:
        """Mean-pooled L2-normalised embeddings for a batch of token lists,
        through the dense forward (a flash prefill kernel) over a scratch
        cache. B and S bucket to powers of two, S at least one block."""
        if not token_id_lists:
            return []
        # bound inputs by the serving context the same way generate does
        limit = self.args.max_model_len
        too_long = max(len(t) for t in token_id_lists)
        if too_long > limit:
            raise ValueError(
                f"embedding input of {too_long} tokens exceeds "
                f"max_model_len {limit}")
        total = len(token_id_lists) * too_long  # padded batch footprint
        budget = max(4096, 8 * limit)
        if total > budget:
            raise ValueError(
                f"embedding batch of {len(token_id_lists)}×{too_long} tokens "
                f"exceeds the per-request budget {budget}; split the batch")
        bs = self.args.block_size
        B = 1 << (len(token_id_lists) - 1).bit_length()
        S = max(bs, 1 << (too_long - 1).bit_length())
        tokens = np.zeros((B, S), np.int32)
        lengths = np.zeros((B,), np.int32)
        for i, ids in enumerate(token_id_lists):
            tokens[i, :len(ids)] = ids
            lengths[i] = len(ids)

        def run():  # the forward and the host copy off the event loop
            return self._embed_forward(tokens, lengths).cpu().numpy()

        host = await asyncio.to_thread(run)
        return [host[i].tolist() for i in range(len(token_id_lists))]

    def _embed_forward(self, tokens: np.ndarray, lengths: np.ndarray):
        """One embed forward on the scratch cache: [B, D] f32 on the
        engine's device."""
        bs = self.args.block_size
        B, S = tokens.shape
        with self._embed_lock:
            if self._embed_cache is None or self._embed_cache[0] != (B, S):
                # keep ONE scratch cache: mixed-shape embed traffic must not
                # accumulate memory the serving pool never budgeted for
                self._embed_cache = None
                self._embed_cache = ((B, S), allocate_device_cache(
                    self.cfg, B * (S // bs) + 1, bs, self.device,
                    self.dtype))
            kc, vc = self._embed_cache[1]
            dev = self.device
            return self._embed_fn(self.params,
                                  torch.from_numpy(tokens).to(dev),
                                  torch.from_numpy(lengths).to(dev), kc, vc)

    async def embed_handler(self, request: dict, ctx=None):
        """Endpoint handler: {"token_ids": [[...]]} → one embeddings frame."""
        try:
            vecs = await self.embed(request.get("token_ids") or [])
        except (ValueError, NotImplementedError) as e:
            # input too long, or a model without embeddings: an error
            # frame, not a crash
            yield {"error": str(e)}
            return
        yield {"embeddings": vecs}

    def _ensure_loop(self) -> None:
        self._loop_ref = asyncio.get_running_loop()
        if self._task is None or self._task.done():
            self._task = self._loop_ref.create_task(self._run())

    async def close(self) -> None:
        self._closed = True
        self._wake.set()
        if self._task:
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        if self._offload_tasks:
            await asyncio.gather(*list(self._offload_tasks),
                                 return_exceptions=True)
        if self.direct_transfer is not None:
            self.direct_transfer.close()

    # ------------------------------------------------------------ main loop

    async def _run(self) -> None:
        logger.info("engine loop starting: %d blocks × %d tokens on %s",
                    self.num_blocks, self.args.block_size, self.device)
        while not self._closed:
            if not self.scheduler.has_work:
                self._wake.clear()
                await self._wake.wait()
                continue
            plan = self.scheduler.plan()
            if plan.empty:
                # memory-starved and nothing runnable: park until a release
                # or a finishing sequence sets _wake (timeout: safety net)
                self._wake.clear()
                try:
                    await asyncio.wait_for(self._wake.wait(), timeout=0.05)
                except asyncio.TimeoutError:
                    pass
                continue
            try:
                await self._execute(plan)
            except Exception:
                logger.exception("engine step failed; failing in-flight seqs")
                for s in list(self.scheduler.running):
                    self.scheduler.finish(s, FinishReason.ERROR)
                    s.sink.put_nowait(LLMEngineOutput(
                        finish_reason=FinishReason.ERROR,
                        text="engine step failed"))
            self.steps += 1
            self.chunk_steps += bool(plan.prefill)
            if self.metrics_cb:
                self.metrics_cb(self._metrics())
            await asyncio.sleep(0)  # let ingress / cancellation run

    async def _execute(self, plan: StepPlan) -> None:
        if (not plan.prefill and plan.decode
                and self._can_pipeline(plan.decode)):
            if await self._run_decode_pipelined(plan.decode):
                return
        # decode-only plans may take a spec round or the burst before
        # falling back to the one packed launch
        if not plan.prefill and plan.decode:
            if await self._run_decode_fast(plan.decode):
                return
        t0 = time.perf_counter()
        await self._run_ragged(plan)
        if not plan.prefill and plan.decode:
            # a plain decode-only step's wall: the spec governor's baseline
            wall = (time.perf_counter() - t0) * 1000
            self._decode_step_ms = (
                wall if self._decode_step_ms is None
                else 0.8 * self._decode_step_ms + 0.2 * wall)

    # --------------------------------------------------------------- warmup

    async def warmup(self, seq_lens: Optional[list] = None,
                     prefill_batches: Optional[list] = None) -> dict:
        """Run every ragged token bucket's signatures once before serving,
        so no request pays a first use (on the card: the eager run and the
        capture). The signature space is the token-bucket list: each bucket
        T as a mixed step and as a decode-only step, and a greedy sampler
        for each row count R. With speculative decoding on, also every
        verify bucket that 1 .. max_num_seqs rows can pick
        (:func:`verify_groups`), masked too when the engine has a device
        FSM arena, and the layer-skip draft burst of each row count.
        ``seq_lens`` and ``prefill_batches`` are accepted, as the JAX
        engine accepts them, and choose nothing: the table width never
        enters a signature. The dummy steps write only the null block.
        Refused once work is scheduled. Returns the JAX engine's report:
        ``{"ragged": [(kind, T, R, W), ...], "sample": [R, ...], "seconds":
        s}``, with ``"verify": [(kind, T), ...]`` and ``"draft": [R, ...]``
        when speculation is on."""
        if self.scheduler.has_work:
            raise RuntimeError(
                "bucket warmup must run before serving traffic (sequences "
                "are already scheduled)")
        args = self.args
        t_start = time.perf_counter()

        def run():
            report: dict = {"ragged": [], "sample": []}
            W = args.max_blocks_per_seq
            out = None
            for T in args.ragged_token_buckets:
                R = args.ragged_rows(T)
                C, _ = ragged_grid_shape(T)
                ints5 = np.zeros((5, T), np.int32)
                ints5[3] = C
                rows3 = np.zeros((R, 3), np.int32)
                rows3[0] = (0, 1, 1)  # one row attending a null slot
                bt = np.full((R, W), NULL_BLOCK, np.int32)
                operands = (ints5, rows3, np.zeros((C,), np.int32), bt)
                samp = self._sampling_plan([None] * R)
                for kind, chunks in (("ragged", True), ("ragged_dec", False)):
                    out = self._step(operands, chunks, None, samp)
                    report["ragged"].append((kind, T, R, W))
                if R not in report["sample"]:
                    report["sample"].append(R)
            K = args.speculative_tokens
            if K > 0:
                report["verify"], report["draft"] = [], []
                S = K + 1
                masks = (False, True) if self.structured is not None else (
                    False,)
                row = ([0] * S, 0, [NULL_BLOCK * args.block_size
                                    + p % args.block_size for p in range(S)],
                       S, [])
                for T in verify_buckets(args):
                    ops = self._verify_operands([row], T)
                    for masked in masks:
                        mw = (np.full((T, -(-self.cfg.vocab_size // 32)),
                                      -1, np.int32) if masked else None)
                        out = self._verify(ops, mw)
                        report["verify"].append(
                            ("verify_fsm" if masked else "verify", T))
                if args.speculative_method == "draft_layers":
                    W = args.max_blocks_per_seq
                    for R in sorted({
                            args.ragged_rows(args.bucket_ragged_tokens(n))
                            for n in range(1, args.max_num_seqs + 1)}):
                        ints3 = np.zeros((3, R), np.int32)
                        ints3[2, 0] = 1  # one row attending a null slot
                        out = self._draft(
                            ints3, np.full((R, W), NULL_BLOCK, np.int32), K)
                        report["draft"].append(R)
            if out is not None and out["copied"] is not None:
                out["copied"].synchronize()
            return report

        # its own captures are not warnings, also when it runs again after
        # a knob (speculative_tokens, the draft depth) widened the set
        self.warmed_up = False
        report = await asyncio.to_thread(run)
        self.warmed_up = True
        report["seconds"] = round(time.perf_counter() - t_start, 2)
        logger.info("ragged warmup: %d token-bucket signatures, %d verify "
                    "and %d draft signatures in %.1fs",
                    len(report["ragged"]), len(report.get("verify", ())),
                    len(report.get("draft", ())), report["seconds"])
        return report

    def _note_compile(self, kind: str, sig: tuple, seconds: float) -> None:
        """A dispatch just captured a NEW signature (on the CPU nothing is
        captured): count it, time it, and warn when it happened after
        warmup, the latency cliff warmup exists to remove."""
        self.compile_events[kind] = self.compile_events.get(kind, 0) + 1
        self.compile_seconds[kind] = (self.compile_seconds.get(kind, 0.0)
                                      + seconds)
        if self.warmed_up:
            logger.warning(
                "steady-state capture: signature %s captured in %.2fs at "
                "step %d (warmup did not cover this shape)",
                (kind,) + tuple(sig), seconds, self.steps)

    def pack(self, plan: StepPlan):
        """The plan's packed operands (numpy), with the JAX engine's layout:
        decode rows first, then prefill chunks, each row's tokens
        consecutive. Returns (operands, rows) where rows lists
        (seq, samples?, work) in row order."""
        args = self.args
        bs = args.block_size
        works = plan.prefill
        total = len(plan.decode) + sum(w.chunk for w in works)
        T = args.bucket_ragged_tokens(total)
        R = args.ragged_rows(T)
        W = args.max_blocks_per_seq
        C, S_C = ragged_grid_shape(T)

        ints5 = np.zeros((5, T), np.int32)
        ints5[3] = C
        rows3 = np.zeros((R, 3), np.int32)  # q_start/q_len/kv_len; 0 = pad
        grid_rows = np.zeros((C,), np.int32)
        bt = np.full((R, W), NULL_BLOCK, np.int32)
        rows = [(s, True, None) for s in plan.decode]
        rows += [(w.seq, w.sample, w) for w in works]
        t = 0
        tile = 0
        for i, (seq, _sample, w) in enumerate(rows):
            if w is None:  # decode row: one token, the sequence's newest
                start, chunk = len(seq.tokens) - 1, 1
            else:
                start, chunk = w.start, w.chunk
            end = start + chunk
            ints5[0, t:t + chunk] = seq.tokens[start:end]
            ints5[1, t:t + chunk] = np.arange(start, end)
            for j, pos in enumerate(range(start, end)):
                ints5[2, t + j] = seq.block_table[pos // bs] * bs + pos % bs
            if chunk > 1:
                # chunk grid tiling, as the JAX engine packs it (the MLA
                # step reads it; the GQA kernel does not need it)
                for off in range(0, chunk, S_C):
                    width = min(S_C, chunk - off)
                    grid_rows[tile] = i
                    ints5[3, t + off:t + off + width] = tile
                    ints5[4, t + off:t + off + width] = np.arange(width)
                    tile += 1
            rows3[i] = (t, chunk, end)
            n = min(len(seq.block_table), W)
            bt[i, :n] = seq.block_table[:n]
            t += chunk
        return (ints5, rows3, grid_rows, bt), rows

    async def _run_ragged(self, plan: StepPlan) -> None:
        """Execute the whole plan — decode rows and prefill chunks — as one
        packed ragged launch, and sample every row that reaches the end of
        its tokens."""
        operands, rows = self.pack(plan)
        T, R = operands[0].shape[1], operands[1].shape[0]
        self.padded_tokens_total += T - (
            len(plan.decode) + sum(w.chunk for w in plan.prefill))
        samp = self._sampling_plan([s if smp else None
                                    for s, smp, _w in rows]
                                   + [None] * (R - len(rows)))
        # launches off the event loop: on the CPU the step computes here, on
        # the card the launches take host time
        out = await asyncio.to_thread(self._step, operands,
                                      bool(plan.prefill), None, samp)

        # commit BEFORE the tokens reach the host, as the JAX engine commits
        # before sampling: chunk progress (and disagg block shipping, whose
        # gathers are enqueued here behind this step and ahead of the next)
        # never waits for the sampler
        for w in plan.prefill:
            self.scheduler.commit_computed(w.seq, w.start + w.chunk)
            if w.seq.progress_cb is not None:
                try:
                    w.seq.progress_cb(w.start + w.chunk)
                except Exception:
                    logger.exception("prefill progress callback failed; "
                                     "disabling chunk shipping for %s",
                                     w.seq.request_id)
                    w.seq.progress_cb = None
        for s in plan.decode:
            self.scheduler.commit_computed(s, len(s.tokens))

        host = await self._host_tokens(out)
        toks, logps = host[0], host[1]
        guided = [(s, toks[i]) for i, (s, smp, _w) in enumerate(rows)
                  if smp and s.guided_state is not None]
        if guided:
            # in a worker thread: a host-oracle row's newly visited DFA
            # state walks the vocabulary once (FsmCursor: one lookup)
            await asyncio.to_thread(
                lambda: [s.guided_state.advance(t) for s, t in guided])
        tops = _top_logprobs(samp, host)
        for i, (seq, smp, _w) in enumerate(rows):
            if smp:
                self._deliver(seq, toks[i], logps[i], tops.get(i))

    def _sampling_plan(self, seqs: list, off: int = 0) -> dict:
        """The host side of a step's sampling, for logit rows ``seqs`` (None:
        a row that does not sample): each row's temperature, top-k, top-p
        and key (seed, step_idx + ``off``, ``off`` tokens of the sequence
        still in flight), the rows that want top logprobs, whether device
        FSM rows mask on the device (then their states), and whether any
        row needs host logit edits."""
        n = len(seqs)
        temp = np.zeros((n,), np.float32)
        top_k = np.zeros((n,), np.int32)
        top_p = np.ones((n,), np.float32)
        seeds, steps = [0] * n, [0] * n
        want_tops: dict[int, int] = {}
        edits = False
        for i, s in enumerate(seqs):
            if s is None:
                continue
            t, k, p, seed = s.sampling_tuple()
            temp[i], top_k[i], top_p[i] = t, k, p
            seeds[i] = seed if seed is not None else s.unseeded_seed
            steps[i] = s.step_idx + off
            lp = s.req.output_options.logprobs
            if lp is not None:  # 0 still captures the selected token's entry
                want_tops[i] = max(1, min(int(lp), TOP_LOGPROBS))
            edits = edits or bool(s.req.sampling_options.logit_bias
                                  or _has_penalties(s)
                                  or _guided_host_only(s))
        # a logprob row's top-k must read the same masked logits the draw
        # saw, so device FSM rows then mask by host edits too
        fsm = [(i, c) for i, s in enumerate(seqs)
               if s is not None and (c := _guided_fsm(s)) is not None]
        states = None
        if fsm and not want_tops:
            states = np.zeros((n,), np.int32)
            for i, c in fsm:
                states[i] = c.state
        return {"seqs": seqs, "temp": temp, "top_k": top_k, "top_p": top_p,
                "keys": sampling.make_keys(seeds, steps),
                "want_tops": want_tops, "states": states,
                "edits": edits or bool(fsm and want_tops)}

    def _step(self, operands, chunks: bool, feed, samp: dict,
              feed_states=None) -> dict:
        """One packed step on the device; runs in a worker thread (serial
        loop) or on the event loop's thread (pipelined loop). Stages
        ``samp``'s sampling operands (:meth:`_sampling_plan`, one row a
        step row) and the step's operands in one copy, substitutes
        ``feed`` (the previous step's tokens on the device, [n] for the
        first n rows) into the token column and ``feed_states`` for the FSM
        states, runs the forward and the sampler, and starts the copy of
        the tokens (and top logprobs) to the host. Feeds are copies into
        the staged operands, queued before the step that reads them.
        Returns the tokens and next FSM states on the device, their host
        copies and the event that marks the copy done (None on the CPU).
        Under graphs the tokens and states are a graph's static outputs:
        the next replay of that graph overwrites them, so they are read
        (fed, copied) only by work queued before it."""
        R = len(samp["seqs"])
        states = (samp["states"] if samp["states"] is not None
                  else np.zeros((R,), np.int32))
        rows, states_t, ints5, rows3, grid_rows, bt = self._staging.put(
            [sampling.pack_rows(samp["temp"], samp["top_k"], samp["top_p"],
                                samp["keys"]), states, *operands])
        if feed is not None:
            ints5[0, :feed.shape[0]].copy_(feed)
        if feed_states is not None:
            states_t.copy_(feed_states)
        logits = self._forward(ints5, rows3, grid_rows if chunks else None,
                               bt)
        toks, new_states, host = self._sample(
            logits, samp, rows,
            states_t if samp["states"] is not None else None, captured=True)
        return self._to_host(toks, new_states, host)

    def _to_host(self, toks, states, host) -> dict:
        """Start the copies of ``host`` to pinned memory behind an event
        (on the CPU: copies, made now). Copies, because a replay of the
        same graph overwrites its outputs."""
        if self.device.type == "cpu":
            return {"toks": toks, "states": states,
                    "host": [t.clone() for t in host], "copied": None}
        pinned = []
        for t in host:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            pinned.append(h)
        copied = torch.cuda.Event()
        copied.record()
        return {"toks": toks, "states": states, "host": pinned,
                "copied": copied}

    # --------------------------------------------------------------- graphs

    def _graph_cache(self) -> Optional[GraphCache]:
        """The graph cache when steps run captured (the card, unless
        ``use_graphs`` is off), else None. Graphs read the weights and
        caches they were captured with: if those were replaced since, the
        graphs go first."""
        if self.graphs is None or not self.use_graphs:
            return None
        owner = (self.params, self.k_cache, self.v_cache)
        if self._graph_owner is None or any(
                a is not b for a, b in zip(owner, self._graph_owner)):
            self.drop_graphs()
            self._graph_owner = owner
        return self.graphs

    def drop_graphs(self) -> None:
        """Forget every captured graph and the tensors it holds (weights,
        caches, arenas): before they are replaced or freed. Later steps
        capture again."""
        if self.graphs is not None:
            self.graphs.clear()
        self._graph_owner = None
        self._logits.clear()

    def _forward(self, ints5, rows3, grid_rows, bt):
        """The packed step's forward (``grid_rows`` None: decode rows only)
        -> logits [R, V] f32. Under graphs it replays its signature's
        capture, ("ragged" or "ragged_dec", T), and the logits land in the
        buffer of its row count."""
        kind = "ragged" if grid_rows is not None else "ragged_dec"
        T = ints5.shape[1]
        self.compiled_signatures.add((kind, T))
        self.forward_steps += 1
        graphs = self._graph_cache()
        if graphs is None:
            return self.step_fn(self.params, ints5, rows3, grid_rows, bt,
                                self.k_cache, self.v_cache)[0]
        R = rows3.shape[0]
        out = self._logits.get(R)
        if out is None:
            out = self._logits[R] = torch.empty(
                (R, self.cfg.vocab_size), dtype=torch.float32,
                device=self.device)
        step, params = self.step_fn, self.params
        kc, vc = self.k_cache, self.v_cache
        logits, secs = graphs.run((kind, T), lambda: step(
            params, ints5, rows3, grid_rows, bt, kc, vc, logits_out=out)[0])
        if secs is not None:
            self._note_compile(kind, (T,), secs)
        return logits

    def _sample(self, logits, samp: dict, rows=None, states=None,
                captured: bool = False):
        """Sample the first ``len(samp["seqs"])`` rows of ``logits`` as
        ``samp`` (:meth:`_sampling_plan`) says: the logit edits, then the
        draw (FSM-masked from ``states`` when the plan has device FSM
        rows), then the top logprobs. ``rows`` and ``states`` are the
        staged operands on the device (None: copied here). ``captured``
        (the step's own call: ``logits`` is the rows' logits buffer,
        ``rows`` and ``states`` staged): under graphs a batch with no edits
        and no top logprobs replays the sampler captured for its rows and
        branches (("sample", R, branches), the FSM arena's address with
        it). Returns (tokens, next FSM states or
        None, the tensors for the host: tokens, logprobs, and top ids, top
        logprobs and selected logprobs when a row asked for them)."""
        lg = logits[:len(samp["seqs"])]
        host_edits = samp["edits"] or bool(samp["want_tops"])
        if samp["edits"]:
            lg = _apply_edits(lg, _build_edits(samp["seqs"], lg.shape[-1],
                                               bool(samp["want_tops"])))
        branch = (samp["temp"], samp["top_k"], samp["top_p"])
        fsm = samp["states"] is not None
        mask_t = next_t = None
        if fsm:
            if states is None:
                states = torch.from_numpy(samp["states"]).to(lg.device)
            mask_t, next_t = self.structured.device_tables()

        def draw():
            if fsm:
                return sampling.sample_masked(lg, *branch, samp["keys"],
                                              states, mask_t, next_t,
                                              rows=rows)
            return (*sampling.sample(lg, *branch, samp["keys"], rows=rows),
                    None)

        graphs = self._graph_cache()
        if graphs is not None and captured and not host_edits:
            flags = sampling.branches(*branch, lg.shape[-1])
            key = ("sample", lg.shape[0], flags,
                   mask_t.data_ptr() if fsm else None)
            (toks, logps, new_states), secs = graphs.run(key, draw)
            if secs is not None:
                self._note_compile("sample", key[1:3], secs)
        else:
            toks, logps, new_states = draw()
        host = [toks, logps]
        if samp["want_tops"]:
            host += sampling.topk_logprobs(lg, toks, TOP_LOGPROBS)
        return toks, new_states, host

    @staticmethod
    async def _host_tokens(out: dict) -> list:
        """The step's host copies as lists (tokens, logprobs, then the top
        ids, top logprobs and selected logprobs when asked for), once
        their copy has landed (waited for off the event loop if it has
        not)."""
        copied = out["copied"]
        if copied is not None and not copied.query():
            await asyncio.to_thread(copied.synchronize)
        return [t.tolist() for t in out["host"]]

    # ------------------------------------------------- pipelined decode loop

    #: re-plan (admission, preemption, metrics) at least this often even
    #: when the pipeline could keep running
    PIPELINE_REPLAN_STEPS = 64

    def _can_pipeline(self, seqs: list[SeqState]) -> bool:
        """True when the decode batch qualifies for the depth-2 pipelined
        loop: every running sequence decodes in this batch, nothing waits
        for admission, neither the burst nor speculative decoding is
        configured (as in the JAX engine), and no row needs a host round
        trip between its draw and its emission (logprob capture, logit
        edits, host-oracle guided rows; device FSM rows ride the loop,
        their mask and advance inside the sampling step)."""
        # swapped sequences need plan() for their swap-in pass
        if (not self.args.pipeline_decode or self.scheduler.waiting
                or self.scheduler.swapped
                or self.args.multi_step_decode > 1
                or self.args.speculative_tokens > 0):
            return False
        # a running seq still mid-prefill needs plan() interleaving
        if len(seqs) != len(self.scheduler.running):
            return False
        for s in seqs:
            if (s.req.output_options.logprobs is not None
                    or s.req.sampling_options.logit_bias
                    or _has_penalties(s) or _guided_host_only(s)):
                return False
        return True

    def _decode_operands(self, seqs: list[SeqState], off: int):
        """Packed operands of a decode-only step over ``seqs``, with ``off``
        tokens per sequence still in flight (their ids unknown to the host:
        positions, slots and tables need only the counts). None when block
        allocation fails."""
        args = self.args
        bs = args.block_size
        for s in seqs:
            # this step writes KV at position len(s.tokens) - 1 + off
            if not self.scheduler._ensure_blocks(s, len(s.tokens) + off):
                return None
        T = args.bucket_ragged_tokens(len(seqs))
        R = args.ragged_rows(T)
        W = args.max_blocks_per_seq
        C, _ = ragged_grid_shape(T)
        ints5 = np.zeros((5, T), np.int32)
        ints5[3] = C  # every token is decode: the grid's dump tile
        rows3 = np.zeros((R, 3), np.int32)
        bt = np.full((R, W), NULL_BLOCK, np.int32)
        for i, s in enumerate(seqs):
            pos = len(s.tokens) - 1 + off
            ints5[0, i] = s.tokens[-1]  # replaced on the device when off
            ints5[1, i] = pos
            ints5[2, i] = s.block_table[pos // bs] * bs + pos % bs
            rows3[i] = (i, 1, pos + 1)
            n = min(len(s.block_table), W)
            bt[i, :n] = s.block_table[:n]
        return ints5, rows3, np.zeros((C,), np.int32), bt

    async def _dispatch_decode_step(self, seqs: list[SeqState], feed=None):
        """Launch ONE decode step without waiting for the previous one's
        tokens on the host: ``feed`` is the previous (uncommitted) step's
        handle, whose tokens and FSM states on the device fill this step's
        token column and states, and its keys step one position on. The
        launches run on the event loop's thread, as the JAX engine
        dispatches: a worker thread launching beside the loop's commit
        contends for the interpreter lock, and measured slower than the
        serial loop on the card (PERF.md). Returns a handle for
        _commit_decode_step, or None when block allocation fails (the caller
        drains and falls back to plan(), which preempts)."""
        off = 1 if feed is not None else 0
        operands = self._decode_operands(seqs, off)
        if operands is None:
            return None
        T, R = operands[0].shape[1], operands[1].shape[0]
        self.padded_tokens_total += T - len(seqs)
        samp = self._sampling_plan(list(seqs) + [None] * (R - len(seqs)),
                                   off)
        prev = feed_states = None
        if feed is not None:
            prev = feed["out"]["toks"][:len(seqs)]
            feed_states = feed["out"]["states"]
        return {"seqs": list(seqs),
                "out": self._step(operands, False, prev, samp, feed_states)}

    async def _commit_decode_step(self, handle) -> None:
        """Land one launched step: wait for its tokens' copy, then commit +
        emit. Rows of sequences that finished at an earlier step are
        overshoot: their KV write targeted a block that no sequence holds
        registered, and is discarded."""
        toks, logps = (await self._host_tokens(handle["out"]))[:2]
        for i, s in enumerate(handle["seqs"]):
            if s.finished is not None:
                continue
            self.scheduler.commit_computed(s, len(s.tokens))
            gs = _guided_fsm(s)
            if gs is not None:
                # the host mirror of the table advance on the device (one
                # lookup), before check_finish reads done/exhausted
                gs.advance(toks[i])
            self._deliver(s, toks[i], logps[i])
        self.pipelined_steps += 1

    async def _run_decode_pipelined(self, seqs: list[SeqState]) -> bool:
        """Depth-2 software pipeline over single-step decode.

        Serial loop per token: launch → device compute → host copy →
        commit/emit → plan. Pipelined: step N+1 is launched (token column
        and FSM states fed device to device from step N's draw) BEFORE step
        N's tokens are awaited, so step N's copy, commit and emission
        overlap step N+1's device time. Positions, PRNG keys and commits
        are exactly the serial loop's.

        Drains (commits every launched step) and returns whenever the
        steady state breaks: a sequence finished, was cancelled or ran out
        of time, new work arrived, allocation failed, or
        PIPELINE_REPLAN_STEPS elapsed. Returns True when at least one step
        ran.
        """
        prev = None
        done = 0
        while True:
            handle = await self._dispatch_decode_step(seqs, feed=prev)
            if handle is None:
                break  # allocation failure: plan() handles preemption
            done += 1
            committed, prev = prev, handle
            if committed is not None:
                await self._commit_decode_step(committed)
            await asyncio.sleep(0)  # the streams take their tokens
            if (done >= self.PIPELINE_REPLAN_STEPS or self._closed
                    or self.scheduler.waiting or self.scheduler.swapped
                    or any(s.finished is not None for s in seqs)
                    or any(getattr(s.ctx, "cancelled", False)
                           or getattr(s.ctx, "expired", False)
                           for s in seqs)):
                break
        if prev is not None:
            await self._commit_decode_step(prev)
        # _run adds 1 per _execute; top up so self.steps counts every
        # committed pipelined step exactly once
        self.steps += max(0, done - 1)
        return done > 0

    # ---------------------------------------------- speculative decoding

    @staticmethod
    def _draft_tokens(s, k: int) -> list[int]:
        """Prompt-lookup draft (the JAX engine's): match the trailing 3- or
        2-gram earlier in the sequence and propose up to ``k`` tokens that
        followed it, the newest match first.

        O(new tokens) a call: ``s.ngram_pos`` maps each n-gram to the END
        position of its newest occurrence and is extended incrementally.
        The current trailing gram's own end stays unindexed until the
        sequence grows past it, so a lookup never matches itself."""
        tokens = s.tokens
        n_tok = len(tokens)
        idx = s.ngram_pos
        for e in range(max(s.ngram_indexed + 1, 2), n_tok):  # end-exclusive
            idx[(tokens[e - 2], tokens[e - 1])] = e
            if e >= 3:
                idx[(tokens[e - 3], tokens[e - 2], tokens[e - 1])] = e
        s.ngram_indexed = max(s.ngram_indexed, n_tok - 1)
        for n in (3, 2):
            if n_tok <= n:
                continue
            e = idx.get(tuple(tokens[-n:]))
            if e is not None:
                cont = tokens[e:e + k]
                if cont:
                    return cont
        return []

    def _draft_fn(self, K: int):
        D = self.args.speculative_draft_layers
        fn = self._draft_fns.get((D, K))
        if fn is None:
            fn = self._draft_fns[D, K] = make_draft_fn(
                self.cfg, self.args.block_size, D, K)
        return fn

    def _verify_fn(self, masked: bool):
        fn = self._verify_fns.get(masked)
        if fn is None:
            fn = self._verify_fns[masked] = make_ragged_verify_fn(
                self.cfg, self.args.block_size, masked=masked)
        return fn

    async def _run_draft_model(self, seqs: list[SeqState],
                               K: int) -> list[list[int]]:
        """Layer-skip draft dispatch: K greedy tokens a row from the first
        ``speculative_draft_layers`` layers, in one burst of the row count
        a decode-only step of these rows has. Draft KV lands in the tokens'
        real slots: the caller has preallocated their blocks."""
        args = self.args
        R = args.ragged_rows(args.bucket_ragged_tokens(len(seqs)))
        W = args.max_blocks_per_seq
        ints3 = np.zeros((3, R), np.int32)
        bt = np.full((R, W), NULL_BLOCK, np.int32)
        for i, s in enumerate(seqs):
            ints3[:, i] = (s.tokens[-1], len(s.tokens) - 1, len(s.tokens))
            n = min(len(s.block_table), W)
            bt[i, :n] = s.block_table[:n]
        out = await asyncio.to_thread(self._draft, ints3, bt, K)
        toks = (await self._host_tokens(out))[0]
        return [[t[i] for t in toks] for i in range(len(seqs))]

    def _draft(self, ints3, bt, K: int) -> dict:
        """One draft burst on the device (a worker thread): its operands
        staged, the burst replayed under graphs as ("draft", R, K, D), and
        the copy of the tokens [K, R] to the host started."""
        R = ints3.shape[1]
        ints3_t, bt_t = self._staging.put([ints3, bt])
        fn = self._draft_fn(K)
        params, kc, vc = self.params, self.k_cache, self.v_cache

        def run():
            return fn(params, ints3_t, bt_t, kc, vc)

        self.compiled_signatures.add(("draft", R))
        self.draft_steps += 1
        graphs = self._graph_cache()
        if graphs is None:
            toks = run()
        else:
            # the depth joins the key: a draft of another depth is another
            # launch sequence
            D = self.args.speculative_draft_layers
            toks, secs = graphs.run(("draft", R, K, D), run)
            if secs is not None:
                self._note_compile("draft", (R, K, D), secs)
        return self._to_host(toks, None, [toks])

    async def _run_spec_decode(self, seqs: list[SeqState]) -> bool:
        """Draft and verify: one forward over [newest token, draft...] a
        row accepts the longest greedy-matching draft prefix plus one
        token of the verify's own, 1 .. K + 1 tokens a row, exactly the
        tokens plain greedy decode gives. False (the plain step runs) when
        no row drafts anything or the blocks cannot be preallocated."""
        args = self.args
        K = args.speculative_tokens
        t0 = time.perf_counter()
        if args.speculative_method == "draft_layers":
            # the draft writes KV into the draft slots: blocks first
            if not self._prealloc_blocks(seqs, K):
                return False
            drafts = await self._run_draft_model(seqs, K)
        else:
            drafts = [self._draft_tokens(s, K) for s in seqs]
            if not any(drafts):
                return False
            if not self._prealloc_blocks(seqs, K):
                return False
        await self._verify_and_commit(seqs, drafts)
        self.spec_rounds += 1
        wall = (time.perf_counter() - t0) * 1000
        self._spec_round_ms = (wall if self._spec_round_ms is None
                               else 0.8 * self._spec_round_ms + 0.2 * wall)
        return True

    def _verify_operands(self, rows: list, T: int):
        """Packed operands of a verify step of bucket ``T``: each row one
        chunk of S tokens, given as (tokens [S], position of the first,
        slots [S], kv_len, block table), over ceil(S / tile) chunk-grid
        tiles; padding tokens point at the grid's dump tile."""
        args = self.args
        R = args.ragged_rows(T)
        W = args.max_blocks_per_seq
        C, S_C = ragged_grid_shape(T)
        ints5 = np.zeros((5, T), np.int32)
        ints5[3] = C
        rows3 = np.zeros((R, 3), np.int32)
        grid_rows = np.zeros((C,), np.int32)
        bt = np.full((R, W), NULL_BLOCK, np.int32)
        t = tile = 0
        for i, (toks, base, slots, kv_len, table) in enumerate(rows):
            S = len(toks)
            ints5[0, t:t + S] = toks
            ints5[1, t:t + S] = base + np.arange(S)
            ints5[2, t:t + S] = slots
            for off in range(0, S, S_C):
                width = min(S_C, S - off)
                grid_rows[tile] = i
                ints5[3, t + off:t + off + width] = tile
                ints5[4, t + off:t + off + width] = np.arange(width)
                tile += 1
            rows3[i] = (t, S, kv_len)
            n = min(len(table), W)
            bt[i, :n] = table[:n]
            t += S
        if tile > C:
            raise AssertionError(f"verify grid overflow: {tile} > {C}")
        return ints5, rows3, grid_rows, bt

    async def _verify_and_commit(self, seqs: list[SeqState],
                                 drafts: list[list[int]]) -> None:
        """Verify on the packed ragged layout: each row is a ragged chunk
        of S = K + 1 tokens, its draft padded with token 0 (kv_len is
        len(tokens) + K all the same: slots past the accepted tokens hold
        garbage that no read reaches). The rows go in one step of the
        smallest token bucket that holds their tokens and their chunk-grid
        tiles, or in groups when even the largest cannot
        (:func:`verify_groups`). Constrained rows verify under mask words
        walked on the host along each draft. Each row then gets its
        accepted drafts and the verify's next token as ONE output, and
        ``spec_stats`` counts what was delivered."""
        args = self.args
        K = args.speculative_tokens
        S = K + 1
        bs = args.block_size
        total_emitted = 0
        for grp, T in verify_groups(args, len(seqs), S):
            rows = []
            for gi in grp:
                s = seqs[gi]
                base = len(s.tokens) - 1
                slots = [s.block_table[p // bs] * bs + p % bs
                         for p in range(base, base + S)]
                d = drafts[gi]
                rows.append(([s.tokens[-1]] + d + [0] * (K - len(d)), base,
                             slots, len(s.tokens) + K, s.block_table))
            operands = self._verify_operands(rows, T)
            self.padded_tokens_total += T - len(grp) * S
            cursors = [_guided_fsm(seqs[gi]) for gi in grp]
            mw = None
            if any(c is not None for c in cursors):
                # walk each constrained row's table along its draft: a
                # draft token the mask forbids never matches the masked
                # argmax, so it is rejected where masked single-step decode
                # would reject it, and the token at the first mismatch
                # comes from the correctly advanced state
                mw = np.full((T, -(-self.cfg.vocab_size // 32)),
                             0xFFFFFFFF, np.uint32)  # padding: all allowed
                for i, c in enumerate(cursors):
                    if c is None:
                        continue
                    d = drafts[grp[i]]
                    fsm = c.seg.fsm
                    st = 0 if c.done else (c.state - c.seg.offset)
                    for j in range(S):
                        mw[i * S + j] = fsm.mask[st]
                        if j < len(d):
                            tok = d[j]
                            if tok in c._eos_set or not 0 <= tok < fsm.V:
                                st = 0
                            else:
                                st = int(fsm.next[st, tok])
                mw = mw.view(np.int32)
            out = await asyncio.to_thread(self._verify, operands, mw)
            ids, lps = await self._host_tokens(out)
            for i, gi in enumerate(grp):
                s, d = seqs[gi], drafts[gi]
                row_ids = ids[i * S:(i + 1) * S]
                row_lps = lps[i * S:(i + 1) * S]
                accepted = 0
                while accepted < len(d) and d[accepted] == row_ids[accepted]:
                    accepted += 1
                # each commit marks the current tokens' KV resident (the
                # verify computed it: accepted drafts are the real tokens)
                emitted = self._deliver_batch(s, row_ids[:accepted + 1],
                                              row_lps[:accepted + 1])
                # what was DELIVERED: a row finishing mid-way must not
                # inflate the acceptance counts
                self.spec_stats.num_drafts += 1
                self.spec_stats.num_draft_tokens += len(d)
                self.spec_stats.num_accepted_tokens += min(accepted, emitted)
                self.spec_stats.num_spec_tokens += emitted
                total_emitted += emitted
        self._note_spec_result(total_emitted, len(seqs))

    def _verify(self, operands, mask_words) -> dict:
        """One verify step on the device (a worker thread): the operands
        (and the mask words) staged, the forward replayed under graphs as
        ("verify" | "verify_fsm", T) with its logits in the one scratch
        buffer, and the copy of the ids and logprobs [T] to the host
        started."""
        masked = mask_words is not None
        kind = "verify_fsm" if masked else "verify"
        T = operands[0].shape[1]
        graphs = self._graph_cache()
        buf = self._verify_logits
        staged = self._staging.put(
            [*operands, mask_words] if masked else list(operands))
        ints5, rows3, grid_rows, bt = staged[:4]
        fn = self._verify_fn(masked)
        params, kc, vc = self.params, self.k_cache, self.v_cache
        extra = staged[4:]

        def run():
            ids, lps, _, _ = fn(params, ints5, rows3, grid_rows, bt, *extra,
                                kc, vc, logits_out=buf)
            return ids, lps

        self.compiled_signatures.add((kind, T))
        self.verify_steps += 1
        if graphs is None:
            ids, lps = run()
        else:
            (ids, lps), secs = graphs.run((kind, T), run)
            if secs is not None:
                self._note_compile(kind, (T,), secs)
        return self._to_host(ids, None, [ids, lps])

    # ------------------------------------------ spec auto-disable governor

    def _spec_active(self) -> bool:
        """False while the governor has speculation suspended (the rolling
        measured gain fell below 1); it re-probes once
        ``spec_reprobe_steps`` engine steps have passed."""
        return self.steps >= self._spec_resume_step

    def _spec_dispatch_cost(self) -> float:
        """A spec round's cost in plain decode steps: the measured ratio
        of the two walls when both exist, floored at 1.01 (a round computes
        more than a step) and capped at the static estimate (1 + K·D/L for
        the layer-skip draft, 1.05 for prompt lookup), so a noisy sample
        never suspends harder than the estimate would."""
        args = self.args
        if (args.speculative_method == "draft_layers"
                and args.speculative_draft_layers > 0):
            static = 1.0 + (args.speculative_tokens
                            * args.speculative_draft_layers
                            / max(1, self.cfg.num_layers))
        else:
            static = 1.05  # prompt lookup: free drafts, small overhead
        if (self._spec_round_ms is not None
                and self._decode_step_ms is not None
                and self._decode_step_ms > 0):
            return min(static,
                       max(1.01, self._spec_round_ms / self._decode_step_ms))
        return static

    def _note_spec_result(self, emitted: int, n_seqs: int) -> None:
        """Feed the governor one verify round's outcome: when the mean
        tokens a row over the window, divided by the round's cost, stays
        under 1, suspend speculation for ``spec_reprobe_steps`` steps."""
        if self.args.spec_gain_window <= 0:
            return
        self._spec_window.append(emitted / max(1, n_seqs))
        if len(self._spec_window) < (self._spec_window.maxlen or 1):
            return
        gain = (sum(self._spec_window) / len(self._spec_window)
                / self._spec_dispatch_cost())
        self.spec_measured_gain = gain
        if gain < 1.0:
            self.spec_disabled_total += 1
            self._spec_resume_step = (self.steps
                                      + max(1, self.args.spec_reprobe_steps))
            self._spec_window.clear()
            logger.warning(
                "speculative decode suspended: measured gain %.3f < 1 over "
                "%d dispatches (accept rate %.3f); re-probing after %d "
                "steps", gain, self.args.spec_gain_window,
                self.spec_stats.num_accepted_tokens
                / max(1, self.spec_stats.num_draft_tokens),
                self.args.spec_reprobe_steps)

    # ------------------------------------------------------ multi-step burst

    async def _run_decode_fast(self, seqs: list[SeqState]) -> bool:
        """The decode-only fast paths, gated as the JAX engine gates them:
        no row wants logprobs, ``logit_bias``, penalties or the host oracle
        (device FSM rows verify under mask words, or mask and advance
        inside the burst). A speculative round comes first, for greedy
        batches while the governor has speculation on and every row is at
        least 2 tokens from its limit; then K = ``multi_step_decode`` steps
        in one burst, where a row within K of its limit does not disqualify
        the batch (its overshoot is dropped). False: the caller's packed
        ragged step runs."""
        args = self.args
        if not seqs or (args.speculative_tokens <= 0
                        and args.multi_step_decode <= 1):
            return False
        for s in seqs:
            if (s.req.output_options.logprobs is not None
                    or s.req.sampling_options.logit_bias
                    or _has_penalties(s) or _guided_host_only(s)):
                return False
        if (args.speculative_tokens > 0 and self._spec_active()
                and all(s.sampling_tuple()[0] == 0.0 for s in seqs)
                and all(s.req.stop_conditions.max_tokens is None
                        or s.req.stop_conditions.max_tokens - s.generated >= 2
                        for s in seqs)
                and await self._run_spec_decode(seqs)):
            return True
        if args.multi_step_decode <= 1:
            return False
        return await self._run_multi_decode(seqs)

    def _prealloc_blocks(self, seqs: list[SeqState], extra: int) -> bool:
        """All-or-nothing block preallocation for the burst and the spec
        round: a partial extension left behind would deepen the memory
        pressure that made it fail."""
        extended: list = []
        for s in seqs:
            before = len(s.block_table)
            if not self.scheduler._ensure_blocks(s, len(s.tokens) + extra):
                for s2, b2 in extended:
                    self.pool.release(s2.block_table[b2:])
                    del s2.block_table[b2:]
                return False
            if len(s.block_table) > before:
                extended.append((s, before))
        return True

    async def _run_multi_decode(self, seqs: list[SeqState]) -> bool:
        """K decode steps of ``seqs`` in one burst, one coalesced output
        per sequence. False when block preallocation fails (the caller
        falls back to the single step)."""
        args = self.args
        K = args.multi_step_decode
        # the burst writes positions len-1 .. len+K-2
        if not self._prealloc_blocks(seqs, K - 1):
            return False
        # the row count derives from the token bucket, as a decode-only
        # step's does, so the burst adds no shape lattice of its own
        n = len(seqs)
        R = args.ragged_rows(args.bucket_ragged_tokens(n))
        W = args.max_blocks_per_seq
        ints3 = np.zeros((3, R), np.int32)
        bt = np.full((R, W), NULL_BLOCK, np.int32)
        for i, s in enumerate(seqs):
            ints3[:, i] = (s.tokens[-1], len(s.tokens) - 1, len(s.tokens))
            m = min(len(s.block_table), W)
            bt[i, :m] = s.block_table[:m]
        samp = self._sampling_plan(list(seqs) + [None] * (R - n))
        kind = "multi_fsm" if samp["states"] is not None else "multi"
        self.compiled_signatures.add((kind, R))
        self.padded_tokens_total += (R - n) * K
        out = await asyncio.to_thread(self._burst, ints3, bt, samp, K)
        toks, logps = await self._host_tokens(out)
        for i, s in enumerate(seqs):
            self._deliver_batch(s, [t[i] for t in toks],
                                [lp[i] for lp in logps])
        self.bursts += 1
        return True

    def _burst(self, ints3, bt, samp: dict, K: int) -> dict:
        """One burst on the device (a worker thread): stage its operands
        (sampling rows and FSM states first, as a step's), run the K
        steps (``model.make_multi_decode_fn``), replayed under graphs as
        ("multi" or "multi_fsm", R, K, branches), and start the copy of
        the tokens [K, R] and logprobs [K, R] to the host."""
        R = ints3.shape[1]
        fsm = samp["states"] is not None
        states = samp["states"] if fsm else np.zeros((R,), np.int32)
        rows, states_t, ints3_t, bt_t = self._staging.put(
            [sampling.pack_rows(samp["temp"], samp["top_k"], samp["top_p"],
                                samp["keys"]), states, ints3, bt])
        mask_t = next_t = None
        if fsm:
            mask_t, next_t = self.structured.device_tables()
        fn = self._multi_fns.get((K, fsm))
        if fn is None:
            fn = self._multi_fns[K, fsm] = make_multi_decode_fn(
                self.cfg, self.args.block_size, K, fsm)
        branch = (samp["temp"], samp["top_k"], samp["top_p"])
        params, kc, vc = self.params, self.k_cache, self.v_cache

        def run():
            return fn(params, ints3_t, rows, bt_t, kc, vc, branch,
                      states_t if fsm else None, mask_t, next_t)

        self.forward_steps += K
        graphs = self._graph_cache()
        if graphs is None:
            toks, logps = run()
        else:
            kind = "multi_fsm" if fsm else "multi"
            key = (kind, R, K, sampling.branches(*branch, self.cfg.vocab_size),
                   mask_t.data_ptr() if fsm else None)
            (toks, logps), secs = graphs.run(key, run)
            if secs is not None:
                self._note_compile(kind, (R,), secs)
        return self._to_host(toks, None, [toks, logps])

    def _deliver_batch(self, seq: SeqState, tokens, logps) -> int:
        """A burst's tokens for one sequence: commit and append each, but
        put ONE output on the sink for the whole burst. Tokens past a
        finish are dropped (overshoot). Returns the tokens delivered."""
        ids: list[int] = []
        lps: list[float] = []
        reason = None
        gs = seq.guided_state
        for t, lp in zip(tokens, logps):
            self.scheduler.commit_computed(seq, len(seq.tokens))
            self.scheduler.append_token(seq, int(t))
            ids.append(int(t))
            lps.append(float(lp))
            if gs is not None:
                # device-FSM cursor (only device rows ride the burst): one
                # table lookup, before check_finish reads done/exhausted
                gs.advance(int(t))
            reason = self.scheduler.check_finish(seq, int(t))
            if reason is not None:
                break
        if not ids:
            return 0
        if reason is not None:
            self.scheduler.finish(seq, reason)
        seq.sink.put_nowait(LLMEngineOutput(token_ids=ids, log_probs=lps,
                                            finish_reason=reason))
        if reason is not None:
            seq.sink.put_nowait(None)
        return len(ids)

    def _deliver(self, seq: SeqState, token: int, logp: float,
                 top: Optional[list] = None) -> None:
        self.scheduler.append_token(seq, token)
        reason = self.scheduler.check_finish(seq, token)
        out = LLMEngineOutput(token_ids=[token], log_probs=[logp],
                              top_logprobs=[top] if top is not None else None,
                              finish_reason=reason)
        if reason is not None:
            self.scheduler.finish(seq, reason)
        seq.sink.put_nowait(out)
        if reason is not None:
            seq.sink.put_nowait(None)

    # ------------------------------------------------------- disagg support
    #
    # The port's cache tensors are written in place and never rebound: the
    # captured graphs hold their addresses. A gather is an indexing copy
    # enqueued on the device's stream, so it reads the cache as every step
    # launched before it left it, and no later step can change what it
    # copied; a scatter writes only the freshly allocated blocks it is
    # given. Host staging goes through pinned memory and is waited for off
    # the event loop.

    async def _stage_host(self, *tensors) -> list:
        """Host copies of device tensors (the gathers' outputs), waited for
        in a worker thread; on the CPU the gathers are copies already."""
        if self.device.type == "cpu":
            return list(tensors)
        pinned = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            pinned.append(h)
        landed = torch.cuda.Event()
        landed.record()
        await asyncio.to_thread(landed.synchronize)
        return pinned

    async def stage_bundle(self, bundle) -> tuple:
        """A received bundle's k and v on the engine's device: pinned in a
        worker thread, then one non-blocking copy each, queued on the
        stream ahead of the scatter that reads them."""
        if self.device.type == "cpu":
            return bundle.k, bundle.v
        k, v = await asyncio.to_thread(
            lambda: (bundle.k.pin_memory(), bundle.v.pin_memory()))
        return (k.to(self.device, non_blocking=True),
                v.to(self.device, non_blocking=True))

    def _prefill_only(self, req: PreprocessedRequest) -> PreprocessedRequest:
        """``req`` cut to its prefill: one token, whatever it is."""
        sc = dataclasses.replace(req.stop_conditions, max_tokens=1,
                                 min_tokens=1, ignore_eos=True)
        return dataclasses.replace(req, stop_conditions=sc)

    async def prefill_extract(self, req: PreprocessedRequest, ctx=None):
        """Run the prefill only and return a PrefillResponse: the first
        token, its logprob and the prompt's blocks as one KvBundle (token
        -1 and no bundle when the step failed). The blocks are held past
        the sequence's finish for the gather, then released, whatever
        happens (cancellation included)."""
        from dynamo_tpu_torch.disagg.protocols import KvBundle, PrefillResponse

        self._ensure_loop()
        sink: asyncio.Queue = asyncio.Queue()
        seq = await self._new_seq(self._prefill_only(req), ctx, sink,
                                  hold_blocks=True)
        self.scheduler.add(seq)
        self._wake.set()
        token, logp = None, None
        try:
            while True:
                out = await sink.get()
                if out is None:
                    break
                if out.token_ids:
                    token = out.token_ids[0]
                    logp = (out.log_probs or [None])[0]
                if out.finish_reason is not None:
                    break
            if token is None or not seq.block_table:
                return PrefillResponse(token_id=-1, logprob=None, bundle=None)
            bs = self.args.block_size
            n = (seq.prompt_len + bs - 1) // bs
            k, v = await self._stage_host(
                gather_blocks(self.k_cache, seq.block_table[:n],
                              block_size=bs),
                gather_blocks(self.v_cache, seq.block_table[:n],
                              block_size=bs))
            return PrefillResponse(token_id=token, logprob=logp,
                                   bundle=KvBundle(k=k, v=v,
                                                   num_tokens=seq.prompt_len,
                                                   block_size=bs))
        finally:
            self.scheduler.abort(seq)
            self._wake.set()

    async def prefill_extract_stream(self, req: PreprocessedRequest,
                                     ctx=None):
        """Pipelined prefill: yields KvChunkFrame wires for blocks whose KV
        is final WHILE later chunks still compute, then (when the decode
        worker advertised ``kv_layers``) the last chunk's blocks as
        KvLayerFrames of a layer group each, then the final
        PrefillResponse with what was not shipped yet.

        When the decode worker's ``kv_direct`` capability allows a direct
        pull (``disagg/transfer.py``), every such frame is a KvDirectFrame
        instead, an offer of the gathered device tensors: one a chunk
        event, one a layer group of the tail, else one for the rest of the
        tail, and the response carries no bundle. Offers of a stream that
        ends early are retracted (unclaimed ones are freed after a grace).

        A chunk's gather is enqueued inside the progress callback, right
        after the chunk commits and before any later step is launched.
        Shipping is monotonic: a preemption recompute re-fires progress
        with smaller ends, which are skipped (their content is the same).
        When more than four frames wait for the consumer, a chunk is not
        shipped (it rides the next one or the tail). No frame carries more
        than ``FRAME_BYTES`` of pages: a larger range ships as several
        frames of consecutive blocks (the JAX engine ships one frame a
        chunk, which the response plane's 256 MiB frame cap refuses for a
        2048-token chunk of Llama-3-8B's bf16 KV)."""
        from dynamo_tpu_torch.disagg.protocols import (
            KvBundle, KvChunkFrame, KvLayerFrame, PrefillResponse,
        )
        from dynamo_tpu_torch.disagg.transfer import KvDirectFrame

        self._ensure_loop()
        mgr = self.direct_transfer
        mode = mgr.choose_mode(req.annotations) if mgr is not None else None
        layer_groups = self._kv_layer_groups(req.annotations)
        bs = self.args.block_size
        sink: asyncio.Queue = asyncio.Queue()
        events: asyncio.Queue = asyncio.Queue()
        state = {"shipped": 0}
        rec = {"id": getattr(ctx, "id", None), "prompt": len(req.token_ids),
               "mode": mode or "host", "frames": []}
        offered: list = []  # this stream's direct descriptors
        completed = False

        L = cache_shape(self.k_cache)[0]
        per_frame = self._frame_blocks(L)

        def gather(lo: int, hi: int, offers: int = 1) -> tuple:
            """k and v of blocks [lo, hi), and for a direct mode one ready
            marker a coming offer of them."""
            ids = seq.block_table[lo:hi]
            kb = gather_blocks(self.k_cache, ids, block_size=bs)
            vb = gather_blocks(self.v_cache, ids, block_size=bs)
            ready = [mgr.ready(mode) for _ in range(offers)] if mode else None
            return kb, vb, ready

        def on_progress(end: int) -> None:
            if layer_groups is not None and end >= seq.prompt_len:
                return  # the final commit: the last chunk is the tail
            full = end // bs
            while state["shipped"] < full and events.qsize() < 4:
                lo = state["shipped"]
                hi = min(full, lo + per_frame)
                t0 = time.time()
                events.put_nowait(("chunk", (lo, *gather(lo, hi), t0)))
                state["shipped"] = hi

        seq = await self._new_seq(self._prefill_only(req), ctx, sink,
                                  hold_blocks=True, progress_cb=on_progress)

        async def drain_sink():
            while True:
                out = await sink.get()
                events.put_nowait(("out", out))
                if out is None or out.finish_reason is not None:
                    return

        drainer = asyncio.get_running_loop().create_task(drain_sink())
        self.scheduler.add(seq)
        self._wake.set()
        token, logp = None, None

        def frame(kind, bundle, t0, wrap):
            wire = wrap(bundle).to_wire()
            rec["frames"].append((kind, bundle.nbytes, t0, time.time()))
            return wire

        def direct(kind, k, v, ready, t0, num_tokens, start_block,
                   **layer):
            # the JAX engine's descriptor keys, in its order
            desc = mgr.offer(mode, [k, v], {
                "num_tokens": num_tokens, "n": k.shape[1], "block_size": bs,
                "start_block": start_block, **layer}, ready=ready)
            offered.append(desc)
            rec["frames"].append((kind, k.numel() * k.element_size()
                                  + v.numel() * v.element_size(), t0,
                                  time.time()))
            return KvDirectFrame(desc).to_wire()

        try:
            done = False
            while not done:
                kind, val = await events.get()
                if kind == "chunk":
                    start, kb, vb, ready, t0 = val
                    num_tokens = (start + kb.shape[1]) * bs
                    if mode is not None:
                        yield direct("chunk", kb, vb, ready[0], t0,
                                     num_tokens=num_tokens,
                                     start_block=start)
                        continue
                    k, v = await self._stage_host(kb, vb)
                    yield frame("chunk", KvBundle(
                        k=k, v=v, num_tokens=num_tokens, block_size=bs,
                        start_block=start), t0, KvChunkFrame)
                elif val is None:
                    done = True
                else:
                    if val.token_ids:
                        token = val.token_ids[0]
                        logp = (val.log_probs or [None])[0]
                    if val.finish_reason is not None:
                        done = True
            if token is None or not seq.block_table:
                completed = True
                yield PrefillResponse(token_id=-1, logprob=None,
                                      bundle=None).to_wire()
                return
            total = (seq.prompt_len + bs - 1) // bs
            bundle = None
            if layer_groups:
                # a gather a frame's blocks, then a layer group at a time:
                # the wire and scatter of group g overlap the staging of
                # g + 1 (host), or the pulls interleave the same way
                step = self._frame_blocks(max(g1 - g0
                                              for g0, g1 in layer_groups))
                for lo in range(state["shipped"], total, step):
                    t0 = time.time()
                    kb, vb, ready = gather(lo, min(total, lo + step),
                                           len(layer_groups))
                    for i, (g0, g1) in enumerate(layer_groups):
                        if mode is not None:
                            yield direct("layer", kb[g0:g1], vb[g0:g1],
                                         ready[i], t0,
                                         num_tokens=seq.prompt_len,
                                         start_block=lo, start_layer=g0,
                                         total_layers=L)
                        else:
                            k, v = await self._stage_host(kb[g0:g1],
                                                          vb[g0:g1])
                            yield frame("layer", KvBundle(
                                k=k, v=v, num_tokens=seq.prompt_len,
                                block_size=bs, start_block=lo,
                                start_layer=g0, total_layers=L), t0,
                                KvLayerFrame)
                        t0 = time.time()
            else:
                # chunk frames, then the last frame's worth in the
                # response (direct: offers to the end, and no bundle)
                for lo in range(state["shipped"], total, per_frame):
                    hi = min(total, lo + per_frame)
                    t0 = time.time()
                    kb, vb, ready = gather(lo, hi)
                    num_tokens = min(hi * bs, seq.prompt_len)
                    if mode is not None:
                        yield direct("chunk", kb, vb, ready[0], t0,
                                     num_tokens=num_tokens, start_block=lo)
                        continue
                    k, v = await self._stage_host(kb, vb)
                    b = KvBundle(k=k, v=v, num_tokens=num_tokens,
                                 block_size=bs, start_block=lo)
                    if hi < total:
                        yield frame("chunk", b, t0, KvChunkFrame)
                    else:
                        bundle = b
            # what the decode worker's placed blocks must hold
            rec["digest"] = self.blocks_digest(seq.block_table[:total])
            wire = PrefillResponse(token_id=token, logprob=logp,
                                   bundle=bundle).to_wire()
            if bundle is not None:
                rec["frames"].append(("tail", bundle.nbytes, t0, time.time()))
            completed = True
            yield wire
        finally:
            drainer.cancel()
            self.scheduler.abort(seq)
            self._wake.set()
            self.extract_log.append(rec)
            if not completed:
                for desc in offered:
                    mgr.retract(desc)

    def blocks_digest(self, ids) -> torch.Tensor:
        """``ops.block_copy.blocks_digest`` of blocks ``ids`` of both
        caches, enqueued behind every step launched so far."""
        return blocks_digest((self.k_cache, self.v_cache), ids,
                             block_size=self.args.block_size)

    def extract_records(self) -> list:
        """``extract_log`` with each digest read back (the device waits);
        the log keeps the ints, so it holds no device memory after."""
        for r in self.extract_log:
            if isinstance(r.get("digest"), torch.Tensor):
                r["digest"] = int(r["digest"])
        return [dict(r) for r in self.extract_log]

    def _frame_blocks(self, layers: int) -> int:
        """Blocks one transfer frame of ``layers`` layers carries while its
        pages (k and v) stay within ``FRAME_BYTES``."""
        kv_dtype = "int8" if is_quant_cache(self.k_cache) else None
        per = (kv_block_bytes(self.cfg, self.args.block_size, self.dtype,
                              kv_dtype) * layers // self.cfg.num_layers)
        return max(1, FRAME_BYTES // max(1, per))

    def _kv_layer_groups(self, annotations) -> Optional[list]:
        """Contiguous (start, end) layer ranges of the layer-interleaved
        tail, or None for a whole-bundle tail: only when the decode peer
        advertised ``kv_layers``, this engine splits
        (``kv_transfer_layer_groups`` > 1) and the model is deep enough."""
        from dynamo_tpu_torch.disagg.handlers import KV_LAYERS_ANNOTATION

        g = self.args.kv_transfer_layer_groups or 0
        if g <= 1 or KV_LAYERS_ANNOTATION not in (annotations or []):
            return None
        L = cache_shape(self.k_cache)[0]
        g = min(g, L)
        if g <= 1:
            return None
        base, rem = divmod(L, g)
        out, s = [], 0
        for i in range(g):
            e = s + base + (1 if i < rem else 0)
            out.append((s, e))
            s = e
        return out

    # ------------------------------------------------- decode-side injection

    def alloc_inject(self, n_blocks: int) -> Optional[list[int]]:
        """Blocks for externally computed KV, within the admission limits
        (injection bypasses the waiting queue). None = cannot place."""
        free_frac = self.pool.num_free_blocks / max(1, self.pool.num_blocks)
        if (len(self.scheduler.running) >= self.args.max_num_seqs
                or free_frac < self.args.watermark):
            return None
        return self.pool.allocate(n_blocks)

    def release_inject(self, ids) -> None:
        self.pool.release(ids)

    def check_bundle_dims(self, bundle) -> bool:
        """True when ``bundle`` fits this cache: the block size, the k
        pages' geometry (a packed int8 bundle's byte width) and, for a
        layer slice, the depth and the slice's range. An MLA bundle is
        checked on its latent (k) pages, as the JAX engine checks it."""
        L, _slots, KV, hd = cache_shape(self.k_cache)
        bs = self.args.block_size
        if bundle.block_size != bs:
            return False
        k = bundle.k
        tl = bundle.total_layers
        if tl is None:
            want_layers = L
        else:
            sl = bundle.start_layer or 0
            if tl != L or sl < 0 or sl + k.shape[0] > L:
                return False
            want_layers = k.shape[0]
        if k.dim() == 3:  # packed int8 bundle [nL, n, X]
            return (k.shape[0] == want_layers and k.dtype == torch.uint8
                    and k.shape[2] == packed_block_width(bs, KV, hd))
        return (k.dim() == 5 and k.shape[0] == want_layers
                and tuple(k.shape[2:]) == (bs, KV, hd))

    def scatter_chunk(self, ids, k, v, start_layer=None) -> None:
        """Write received pages (device tensors: :meth:`stage_bundle`) into
        blocks ``ids`` of the caches, in place; ``start_layer`` set means
        k and v are a layer slice from that layer on."""
        bs = self.args.block_size
        scatter_blocks(self.k_cache, ids, k, block_size=bs,
                       start_layer=start_layer)
        scatter_blocks(self.v_cache, ids, v, block_size=bs,
                       start_layer=start_layer)

    async def generate_prefilled(self, req: PreprocessedRequest,
                                 token_id: int, logprob, ids, ctx=None
                                 ) -> AsyncIterator[LLMEngineOutput]:
        """Decode a request whose prompt KV is already scattered into
        ``ids`` (their ownership passes to the sequence). The prefill
        worker's token is the stream's first output: the guided cursor
        (and so the device FSM state the next step reads) advances past
        it, the draws resume at the next position, and the penalty
        history counts it as a generated token."""
        self._ensure_loop()
        sink: asyncio.Queue = asyncio.Queue()
        seq = await self._new_seq(req, ctx, sink)
        if seq.guided_state is not None:
            # a new DFA state on the host oracle walks the vocabulary once
            await asyncio.to_thread(seq.guided_state.advance, token_id)
        self.scheduler.add_prefilled(seq, ids)
        first = LLMEngineOutput(token_ids=[token_id],
                                log_probs=[logprob]
                                if logprob is not None else None)
        self.scheduler.append_token(seq, token_id)
        reason = self.scheduler.check_finish(seq, token_id)
        if reason is not None:
            first.finish_reason = reason
            self.scheduler.finish(seq, reason)
            yield first
            return
        yield first
        self._wake.set()
        while True:
            out = await sink.get()
            if out is None:
                return
            yield out
            if out.finish_reason is not None:
                return

    async def generate_injected(self, req: PreprocessedRequest, prefill,
                                ctx=None) -> AsyncIterator[LLMEngineOutput]:
        """Decode a request whose prompt KV arrives as one whole KvBundle
        (the unpipelined path). A bundle that cannot be placed (token -1,
        wrong geometry, no blocks, a failed scatter) is recomputed by a
        local generate."""
        bundle = prefill.bundle
        ok = (bundle is not None and prefill.token_id >= 0
              and bundle.start_block == 0 and self.check_bundle_dims(bundle))
        ids = self.alloc_inject(bundle.num_blocks) if ok else None
        if ids is not None:
            try:
                self.scatter_chunk(ids, *await self.stage_bundle(bundle))
            except Exception:
                logger.exception("KV bundle scatter failed; local prefill")
                self.pool.release(ids)
                ids = None
        if ids is None:
            if bundle is not None and not ok:
                logger.warning("KV bundle %s does not fit cache %s; local "
                               "prefill", tuple(bundle.k.shape),
                               cache_shape(self.k_cache))
            async for out in self.generate(req, ctx):
                yield out
            return
        async for out in self.generate_prefilled(req, prefill.token_id,
                                                 prefill.logprob, ids, ctx):
            yield out

    # ------------------------------------------------- KV-restore migration
    #
    # A migrated request's recoverable prefix is pulled from peers and
    # attached HERE through the prefix cache (registered, announced), so the
    # following generate() prefix-matches it and recomputes only the tail.
    # The attach charges nothing to QoS: prefix hits never do. A pull is
    # served from the device prefix cache, then the KVBM host and disk
    # tiers.

    def restore_probe(self, req: PreprocessedRequest):
        """The hash chain over the request's matchable full blocks, which
        restore pulls and attaches against; None when restore cannot apply
        (prefix caching off, or nothing matchable)."""
        if not self.args.enable_prefix_caching:
            return None
        bs = self.args.block_size
        # never the whole prompt: one token is computed to give logits
        matchable = (len(req.token_ids) - 1) // bs
        if matchable <= 0:
            return None
        return TokenBlockSequence.from_tokens(
            list(req.token_ids[: matchable * bs]), bs, KV_HASH_SEED)

    def resident_prefix_blocks(self, probe) -> int:
        """Leading blocks of ``probe`` recoverable here without a pull: in
        the device prefix cache, or in the host tier that admission's
        onboarding reads. The disk tier does not count: it only feeds a
        background promotion, and counting it would skip pulls the stream
        needs."""
        hashes = probe.sequence_hashes()
        in_host = (self.kvbm.host_resident(hashes)
                   if self.kvbm is not None else frozenset())
        n = 0
        for h in hashes:
            if self.pool.lookup(h) is None and h not in in_host:
                break
            n += 1
        return n

    def attach_restored(self, probe, start: int, blocks: list) -> int:
        """Scatter pulled blocks [(seq_hash, k, v), ...] into fresh blocks
        and register them, extending the restored prefix from block
        ``start``. Validation stops at the first torn entry (a hash out of
        order, a shape that does not fit); a torn run is cut there, never
        half-scattered. Returns the blocks attached; 0 leaks nothing."""
        if not blocks:
            return 0
        bs = self.args.block_size
        hashes = probe.sequence_hashes()

        def per_block(cache):
            L, _s, H, d = cache_shape(cache)
            if is_quant_cache(cache):
                return (L, packed_block_width(bs, H, d)), torch.uint8
            return (L, bs, H, d), None

        (want_k, kdt), (want_v, vdt) = (per_block(self.k_cache),
                                        per_block(self.v_cache))
        ks, vs = [], []
        for i, (h, k, v) in enumerate(blocks):
            pos = start + i
            if pos >= len(hashes) or h != hashes[pos]:
                logger.warning("restore bundle torn at block %d (hash "
                               "mismatch); keeping %d blocks", pos, len(ks))
                break
            if (tuple(k.shape) != want_k or tuple(v.shape) != want_v
                    or (kdt is not None and k.dtype != kdt)
                    or (vdt is not None and v.dtype != vdt)):
                logger.warning("restore bundle block %d shape %s does not "
                               "fit cache %s; truncating", pos,
                               tuple(k.shape), want_k)
                break
            ks.append(k)
            vs.append(v)
        if not ks:
            return 0
        ids = self._scatter_register(probe, start, ks, vs)
        if ids is None:
            return 0
        # park in the LRU (refcount 0): generate()'s prefix match takes
        # them moments later; a failed restore leaks nothing
        self.pool.release(ids)
        return len(ks)

    def _scatter_register(self, probe, start: int, ks: list, vs: list):
        """Attach externally sourced blocks: allocate, scatter the per-block
        k and v stacks, register each block's hash, announce ONE chained
        stored event. Returns the ids (refcount 1) or None, leaking
        nothing."""
        bs = self.args.block_size
        ids = self.pool.allocate(len(ks))
        if ids is None:
            return None
        try:
            scatter_blocks(self.k_cache, ids, self._stack_blocks(ks),
                           block_size=bs)
            scatter_blocks(self.v_cache, ids, self._stack_blocks(vs),
                           block_size=bs)
        except Exception:
            self.pool.release(ids)
            logger.exception("block attach scatter failed")
            return None
        stored = []
        parent = (probe.blocks[start].parent_sequence_hash
                  if start < len(probe.blocks) else None)
        for i, bid in enumerate(ids):
            blk = probe.blocks[start + i]
            if self.pool.register(bid, blk.sequence_hash):
                stored.append(StoredBlock(block_hash=blk.sequence_hash,
                                          tokens_hash=blk.block_hash))
        if stored and self.event_cb:
            self.event_cb(KvCacheEvent.stored(next(self._event_id), parent,
                                              stored))
        return ids

    def _stack_blocks(self, blocks: list) -> torch.Tensor:
        """Per-block host tensors as one [L, n, ...] bundle on the engine's
        device: on the card each block is copied on its own (pinned ones
        asynchronously, the host allocator keeping them until the copy has
        landed) into a block-major device buffer, whose transposed view
        the scatter takes; no host-side stack of the whole run."""
        if self.device.type == "cpu":
            return torch.stack(blocks, 1)
        first = blocks[0]
        out = torch.empty((len(blocks), *first.shape), dtype=first.dtype,
                          device=self.device)
        for dst, b in zip(out, blocks):
            dst.copy_(b, non_blocking=True)
        return out.transpose(0, 1)

    async def export_blocks(self, hashes: list[int],
                            max_blocks: Optional[int] = None):
        """Serve a peer's pull: yield (seq_hash, k, v) host tensors for the
        longest LEADING run of ``hashes`` recoverable here (at most
        ``max_blocks``): from the device prefix cache (pinned across the
        asynchronous gather), then from the host and disk tiers (read in a
        worker thread). Stops at the first hash found nowhere: a restore
        attaches contiguous prefixes only."""
        bs = self.args.block_size
        budget = max_blocks if max_blocks is not None else len(hashes)
        run: list[tuple[int, int]] = []  # (hash, block id) on the device

        async def flush_run():
            if not run:
                return
            ids = [bid for _, bid in run]
            self.pool.acquire(ids)
            try:
                kb, vb = await self._stage_host(
                    gather_blocks(self.k_cache, ids, block_size=bs),
                    gather_blocks(self.v_cache, ids, block_size=bs))
            finally:
                self.pool.release(ids)
            for i, (h, _bid) in enumerate(run):
                yield h, kb[:, i], vb[:, i]
            run.clear()

        served = 0
        for h in hashes:
            if served >= budget:
                break
            bid = self.pool.lookup(h)
            if bid is not None:
                run.append((h, bid))
                served += 1
                continue
            async for item in flush_run():
                yield item
            e = None
            if self.kvbm is not None:
                e = await asyncio.to_thread(self.kvbm.get_local, h)
            if e is None:
                break  # contiguity ends here
            served += 1
            yield h, e[0], e[1]
        async for item in flush_run():
            yield item

    # ------------------------------------------------------------- events

    def _on_stored(self, parent_hash, blocks: list[StoredBlock],
                   block_ids: Optional[list[int]] = None) -> None:
        if self.event_cb:
            self.event_cb(KvCacheEvent.stored(next(self._event_id),
                                              parent_hash, blocks))
        if self.kvbm is not None and block_ids:
            fresh = [(b.block_hash, bid) for b, bid in zip(blocks, block_ids)
                     if b.block_hash not in self.kvbm]
            if fresh:
                self._spawn_offload([h for h, _ in fresh],
                                    [bid for _, bid in fresh])

    def _on_removed(self, seq_hashes) -> None:
        if self.event_cb is None:
            return
        if seq_hashes is None:  # BlockPool.clear()
            self.event_cb(KvCacheEvent.clear(next(self._event_id)))
            return
        # a block evicted from the device but still in the host or disk
        # tier is not gone: admission onboards it and pulls serve it, so it
        # stays in the router's index until its last local copy dies
        # (_on_kvbm_change)
        if self.kvbm is not None:
            seq_hashes = self.kvbm.filter_not_local(seq_hashes)
        if seq_hashes:
            self.event_cb(KvCacheEvent.removed(next(self._event_id),
                                               list(seq_hashes)))

    def _on_kvbm_change(self, stored, removed) -> None:
        """``KvbmManager.on_change``: a hash that left the last tier and is
        not on the device either is announced removed, or the router would
        keep sending pulls and requests for KV this worker cannot serve.
        Stored hashes need no event (they came from the device, which
        announced them). Called under the manager's lock, perhaps from a
        worker thread: the event goes out on the engine's loop."""
        if self.event_cb is None or not removed:
            return

        def emit():
            gone = [h for h in removed if self.pool.lookup(h) is None]
            if gone and self.event_cb is not None:
                self.event_cb(KvCacheEvent.removed(next(self._event_id),
                                                   gone))

        try:
            asyncio.get_running_loop()
        except RuntimeError:
            loop = self._loop_ref
            if loop is not None and not loop.is_closed():
                loop.call_soon_threadsafe(emit)
            return
        emit()

    # ------------------------------------------------------- host copies

    def _track(self, coro) -> None:
        """Run ``coro`` as a task that close() waits for."""
        task = asyncio.get_running_loop().create_task(coro)
        self._offload_tasks.add(task)
        task.add_done_callback(self._offload_tasks.discard)

    def _gathered(self) -> Optional[torch.cuda.Event]:
        """An event recorded on the engine's stream right after gathers
        (None on the CPU): the copy stream waits for it."""
        if self.device.type == "cpu":
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def _copy_out(self, tensors, gathered, per_block: bool) -> tuple:
        """Device-to-host copies of the gathers' outputs into pinned
        memory, on the copy stream behind ``gathered``. ``per_block``: each
        [L, n, ...] tensor comes back as n contiguous [L, ...] host tensors
        (made block-major on the device first, on the copy stream). Returns
        (host tensors or lists of them, the event that marks the copies
        done); the device tensors are kept until then
        (``record_stream``). On the CPU: copies made now, and no event."""
        if self.device.type == "cpu":
            if per_block:
                return [[t[:, i].clone() for i in range(t.shape[1])]
                        for t in tensors], None
            return list(tensors), None
        def pinned_copy(t):
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return h.copy_(t, non_blocking=True)

        cs = self._copy_stream
        out = []
        with torch.cuda.stream(cs):
            cs.wait_event(gathered)
            for t in tensors:
                t.record_stream(cs)
                out.append([pinned_copy(b) for b in
                            t.transpose(0, 1).contiguous()]
                           if per_block else pinned_copy(t))
            done = torch.cuda.Event()
            done.record(cs)
        return out, done

    # ----------------------------------------------------- KVBM offload

    def _spawn_offload(self, seq_hashes: list, block_ids: list[int]) -> None:
        """G1 → G2: pin the blocks, enqueue their gathers now (behind the
        step that filled them), and put their pages into the host tier once
        the copy has landed."""
        self.pool.acquire(block_ids)
        try:
            bs = self.args.block_size
            kb = gather_blocks(self.k_cache, block_ids, block_size=bs)
            vb = gather_blocks(self.v_cache, block_ids, block_size=bs)
            gathered = self._gathered()
        except Exception:
            logger.exception("KVBM offload gather failed")
            self.pool.release(block_ids)
            return
        self._track(self._offload(seq_hashes, block_ids, (kb, vb),
                                  gathered))

    async def _offload(self, seq_hashes: list, block_ids: list[int],
                       pages: tuple, gathered) -> None:
        def work():  # the copies, their wait and the tier writes
            (ks, vs), done = self._copy_out(pages, gathered, per_block=True)
            if done is not None:
                done.synchronize()
            for h, k, v in zip(seq_hashes, ks, vs):
                self.kvbm.put(h, k, v)

        try:
            await asyncio.to_thread(work)
        except Exception:
            logger.exception("KVBM offload failed")
        finally:
            self.pool.release(block_ids)

    def _spawn_promote(self, hashes: list) -> None:
        """G3 → G2 in a worker thread (the file reads stay off the event
        loop); the next admission of the prefix onboards from the host."""
        todo = [h for h in hashes if h not in self._promoting]
        if not todo:
            return
        self._promoting.update(todo)

        async def run():
            try:
                # the earliest blocks last: if the host tier cannot hold the
                # whole run it keeps those (a prefix is usable from its
                # first block on)
                for h in reversed(todo):
                    await asyncio.to_thread(self.kvbm.get, h)
            except Exception:
                logger.exception("KVBM disk promotion failed")
            finally:
                self._promoting.difference_update(todo)

        self._track(run())

    def _onboard(self, probe, start: int, end: int) -> list[int]:
        """G2 → G1 at admission: prefix blocks [start, end) found in the
        host tier are written into fresh device blocks now (it replaces a
        far dearer recompute). A block found only on disk is not read here
        (a file read inside plan() would stall every decode): a background
        promotion brings the rest of the run to the host tier."""
        hashes = probe.sequence_hashes()[start:end]
        ks, vs = [], []
        for i, h in enumerate(hashes):
            e = self.kvbm.get_host(h)
            if e is None:
                if self.kvbm.in_lower_tier(h):
                    self._spawn_promote(hashes[i:])
                break
            ks.append(e[0])
            vs.append(e[1])
        if not ks:
            return []
        ids = self._scatter_register(probe, start, ks, vs)
        if ids is None:
            return []
        self.kvbm.onboarded_blocks += len(ks)
        return ids

    # ---------------------------------------------------- preempt-to-swap
    #
    # The scheduler's swapper: under KV pressure a victim's pages move to
    # host memory (swap_out) and come back before its next step (swap_in)
    # instead of being recomputed. The bundles are the G2 tier's and the
    # disagg wire's formats (values, or packed (q, s) uint8 for int8
    # caches), so the round trip is bit-exact.

    def _swap_block_bytes(self) -> int:
        """Host bytes one swapped block costs (k and v, every layer)."""
        kv_dtype = "int8" if is_quant_cache(self.k_cache) else None
        return kv_block_bytes(self.cfg, self.args.block_size, self.dtype,
                              kv_dtype)

    def swap_out(self, seq: SeqState) -> bool:
        """Stage ``seq``'s computed KV in host memory; True = the scheduler
        may release its blocks and park it in the swapped queue.

        The gathers are enqueued here on the engine's stream, before the
        release: stream order makes them read the pages before any later
        step reuses them. The copy to pinned memory runs on the copy stream
        in a task, which marks the entry ready once it has landed."""
        bs = self.args.block_size
        n = (seq.num_computed + bs - 1) // bs  # blocks holding computed KV
        if n <= 0 or n > len(seq.block_table):
            return False
        nbytes = n * self._swap_block_bytes()
        if not self._swap.reserve(nbytes):
            return False  # host budget exhausted: recompute
        entry = _SwapEntry(n, nbytes)
        try:
            ids = seq.block_table[:n]
            kb = gather_blocks(self.k_cache, ids, block_size=bs)
            vb = gather_blocks(self.v_cache, ids, block_size=bs)
            gathered = self._gathered()
        except Exception:
            logger.exception("swap-out gather failed for %s",
                             seq.request_id)
            self._swap.release(nbytes)
            return False
        seq.swap = entry
        self.swap_out_blocks += n
        self.pool.note_swapped_out(n)

        async def copy():
            def work():
                (k, v), done = self._copy_out((kb, vb), gathered,
                                              per_block=False)
                if done is not None:
                    done.synchronize()
                return k, v

            try:
                entry.k, entry.v = await asyncio.to_thread(work)
                entry.ready = True
            except Exception:
                logger.exception("swap-out host copy failed for %s",
                                 seq.request_id)
                entry.failed = True
                self._swap_free(entry)
            finally:
                if entry.dropped:
                    self._swap_free(entry)
                self._wake.set()  # a ready bundle can unblock plan()

        self._track(copy())
        return True

    def swap_status(self, seq: SeqState) -> str:
        entry = seq.swap
        if entry is None or entry.failed or entry.freed:
            return "failed"
        return "ready" if entry.ready else "pending"

    def swap_in(self, seq: SeqState) -> bool:
        """Write the host bundle into the freshly allocated blocks, in
        place and on the engine's stream, before the next step is enqueued;
        the bundle is freed once its copy to the card has landed. Returning
        full blocks are registered again, and those the prefix cache no
        longer held are announced again."""
        entry: _SwapEntry = seq.swap
        if (entry is None or not entry.ready or entry.failed or entry.freed
                or len(seq.block_table) < entry.n):
            return False
        bs = self.args.block_size
        ids = seq.block_table[:entry.n]
        try:
            scatter_blocks(self.k_cache, ids, entry.k, block_size=bs)
            scatter_blocks(self.v_cache, ids, entry.v, block_size=bs)
        except Exception:
            logger.exception("swap-in scatter failed for %s", seq.request_id)
            entry.failed = True
            self.pool.note_swapped_in(entry.n)
            self._swap_free(entry)
            seq.swap = None
            return False
        self.swap_in_blocks += entry.n
        self.pool.note_swapped_in(entry.n)
        seq.swap = None
        if self.device.type == "cpu":
            self._swap_free(entry)
        else:
            landed = torch.cuda.Event()
            landed.record()

            async def free():
                try:
                    await asyncio.to_thread(landed.synchronize)
                finally:
                    self._swap_free(entry)

            self._track(free())
        stored: list[StoredBlock] = []
        stored_ids: list[int] = []
        parent = None
        for i in range(min(seq.num_registered_blocks, entry.n)):
            blk = seq.hashes.blocks[i]
            if self.pool.register(seq.block_table[i], blk.sequence_hash):
                if not stored:
                    parent = blk.parent_sequence_hash
                stored.append(StoredBlock(block_hash=blk.sequence_hash,
                                          tokens_hash=blk.block_hash))
                stored_ids.append(seq.block_table[i])
        if stored:
            self._on_stored(parent, stored, stored_ids)
        return True

    def swap_drop(self, seq: SeqState) -> None:
        """Teardown: free the bundle and its budget, or mark the copy in
        flight to free them when it ends."""
        entry: _SwapEntry = seq.swap
        if entry is None:
            return
        seq.swap = None
        entry.dropped = True
        self.pool.note_swapped_in(entry.n)
        if entry.ready or entry.failed:
            self._swap_free(entry)

    def _swap_free(self, entry: _SwapEntry) -> None:
        if entry.freed:
            return
        entry.freed = True
        entry.k = entry.v = None
        self._swap.release(entry.nbytes)

    def swap_stats(self) -> dict:
        """The swap counters and gauges, under the JAX engine's names."""
        sched = self.scheduler
        return {
            "swap_out_blocks": self.swap_out_blocks,
            "swap_in_blocks": self.swap_in_blocks,
            "preempt_swap": sched.preempt_swap_total,
            "preempt_recompute": sched.preempt_recompute_total,
            "swap_in_seqs": sched.swap_in_total,
            "recomputed_tokens": sched.recomputed_tokens_total,
            "swapped_seqs": len(sched.swapped),
            "swapped_blocks": self.pool.swapped_blocks,
            "swap_host_bytes": self._swap.used if self._swap else 0,
            "swap_host_budget": self._swap.budget if self._swap else 0,
            "swap_in_blocked": sched.swap_in_blocked_total,
        }

    def kv_tier_occupancy(self) -> dict:
        """{tier: {"blocks": n, "bytes": n}} for G1 (the device pool's
        active blocks) to G4; tiers that are not configured report zeros
        (G4 always, in the port)."""
        g1 = self.pool.num_active_blocks
        out = {"g1": {"blocks": g1, "bytes": g1 * self._swap_block_bytes()}}
        st = self.kvbm.stats() if self.kvbm is not None else None
        for tier, key in (("g2", "host"), ("g3", "disk"), ("g4", "remote")):
            out[tier] = {"blocks": st[f"{key}_blocks"] if st else 0,
                         "bytes": st[f"{key}_bytes"] if st else 0}
        return out

    def _metrics(self) -> ForwardPassMetrics:
        sched = self.scheduler
        return ForwardPassMetrics(
            worker_stats=WorkerStats(
                request_active_slots=len(sched.running),
                request_total_slots=self.args.max_num_seqs,
                # swapped sequences are waiting load: they hold no blocks
                # but take capacity back before new admissions
                num_requests_waiting=sched.num_waiting() + len(sched.swapped),
                # workers that never asked for warmup report None, as the
                # JAX engine's do
                warmed_up=(self.warmed_up if self.warmup_requested
                           else None)),
            kv_stats=KvStats(
                kv_active_blocks=self.pool.num_active_blocks,
                kv_total_blocks=self.num_blocks - 1,
                gpu_cache_usage_perc=self.pool.usage(),
                gpu_prefix_cache_hit_rate=(
                    sched.prefix_hit_tokens / sched.prefix_query_tokens
                    if sched.prefix_query_tokens else 0.0)),
            spec_decode_stats=(self.spec_stats
                               if self.spec_stats.num_drafts else None))


class _Staging:
    """Host-to-device operand staging through pinned memory into ONE device
    buffer that never moves. A step's int32 operands (its sampling rows
    and FSM states first, then its four; a burst's sampling rows, states,
    ints3 and tables; float32 and uint32 values by their bits) are written
    into a pinned buffer and cross in ONE non-blocking copy into the head
    of the device buffer. The device tensors are views of it at offsets
    that depend only on the shapes, so every step of a signature finds its
    operands where that signature's graph reads them, and the sampling
    rows of R rows lie at the same place for every step with R rows.

    Stream order keeps copies and steps apart: each copy is queued on the
    stream behind every launch (or replay) that read the buffer before it,
    and ahead of the step that reads what it brings. Two pinned buffers
    are used in turn, and one is rewritten only after the event recorded
    behind its last copy has completed, so a copy in flight never reads a
    buffer that is being rewritten."""

    def __init__(self, words: int, device: torch.device):
        self.cuda = device.type == "cuda"
        self._done: list = [None, None]
        self._turn = 0
        self.dev = torch.empty(words, dtype=torch.int32, device=device)
        # on the CPU the same layout, copied synchronously
        self._bufs = [torch.empty(words, dtype=torch.int32,
                                  pin_memory=self.cuda) for _ in range(2)]

    def put(self, arrays) -> list:
        i, self._turn = self._turn, self._turn ^ 1
        if self._done[i] is not None:
            self._done[i].synchronize()
        buf = self._bufs[i]
        host = buf.numpy()
        spans, off = [], 0
        for a in arrays:
            host[off:off + a.size] = a.ravel()
            spans.append((off, a.shape))
            off += a.size
        self.dev[:off].copy_(buf[:off], non_blocking=self.cuda)
        if self.cuda:
            self._done[i] = torch.cuda.Event()
            self._done[i].record()
        return [self.dev[o:o + math.prod(shape)].view(shape)
                for o, shape in spans]


def staging_words(args: EngineArgs, vocab_size: int) -> int:
    """int32 words of the staging buffer: a step of the largest token
    bucket (``pack_rows``' [5, R] and the FSM states [R], then ints5,
    rows3, the grid rows and the tables; a burst, a draft and a verify
    need no more), and with speculative decoding the verify's mask words
    [T, ceil(V/32)] at its largest bucket. Sized once, for the K the engine
    is made with: a live engine may switch speculation off and on again,
    never to a larger K."""
    T = args.ragged_token_buckets[-1]
    R = args.ragged_rows(T)
    C, _ = ragged_grid_shape(T)
    n = 6 * R + 5 * T + 3 * R + C + R * args.max_blocks_per_seq
    if args.speculative_tokens > 0:
        n += max(verify_buckets(args)) * -(-vocab_size // 32)
    return n


def verify_bucket(args: EngineArgs, n: int, S: int) -> Optional[int]:
    """The smallest token bucket that holds n verify rows of S tokens and
    their chunk-grid tiles (ceil(S / tile) a row), or None."""
    for T in args.ragged_token_buckets:
        C, S_C = ragged_grid_shape(T)
        if T >= n * S and n * -(-S // S_C) <= C:
            return T
    return None


def verify_groups(args: EngineArgs, n: int, S: int) -> list:
    """The verify steps of n rows of S tokens, as the JAX engine splits
    them: [(row indices, T)], one step when a bucket holds every row, else
    groups of as many rows as the largest bucket's tokens and tiles take."""
    T = verify_bucket(args, n, S)
    if T is not None:
        return [(range(n), T)]
    Tmax = args.ragged_token_buckets[-1]
    C, S_C = ragged_grid_shape(Tmax)
    cap = max(1, min(C // -(-S // S_C), Tmax // S))
    return [(range(i, min(i + cap, n)),
             verify_bucket(args, min(i + cap, n) - i, S))
            for i in range(0, n, cap)]


def verify_buckets(args: EngineArgs) -> list:
    """Every verify bucket that 1 .. max_num_seqs rows can pick, for K =
    ``speculative_tokens`` (what ``warmup()`` runs)."""
    S = args.speculative_tokens + 1
    return sorted({T for n in range(1, args.max_num_seqs + 1)
                   for _, T in verify_groups(args, n, S)})


def ragged_grid_shape(t_bucket: int) -> tuple[int, int]:
    """(tiles, tile_width) of the chunk grid for ``t_bucket`` packed
    tokens, as in the JAX package."""
    width = min(RAGGED_TILE, t_bucket)
    return t_bucket // width + RAGGED_MAX_CHUNKS, width


def _build_edits(seqs: list, V: int, want_tops: bool):
    """The step's sparse logit edits, as the JAX engine builds them
    (``_sample.build_triples``), never a dense [B, V] array: additive
    (logit_bias, presence and frequency over the generated tokens),
    multiplicative repetition (HF: a logit > 0 is divided by the penalty,
    else multiplied, over prompt and generated tokens), and the allowed
    ids of host-oracle guided rows (with a logprob row, of device FSM rows
    too). Folds each sequence's new tokens into its penalty history; runs
    where the step runs, off the event loop on the serial loop."""
    b_rows, b_cols, b_vals = [], [], []
    r_rows, r_cols, r_pens = [], [], []
    g_rows = []
    for i, s in enumerate(seqs):
        if s is None:
            continue
        so = s.req.sampling_options
        for tid, v in (so.logit_bias or {}).items():
            t = int(tid)
            if 0 <= t < V:
                b_rows.append(i)
                b_cols.append(t)
                b_vals.append(v)
        pres = so.presence_penalty or 0.0
        freq = so.frequency_penalty or 0.0
        rep = so.repetition_penalty
        rep_on = rep is not None and rep > 0 and rep != 1.0
        if pres or freq or rep_on:
            for j in range(s.pen_indexed, len(s.tokens)):
                t = s.tokens[j]
                s.seen_tokens.add(t)
                if j >= s.prompt_len:
                    s.gen_counts[t] = s.gen_counts.get(t, 0) + 1
            s.pen_indexed = len(s.tokens)
        if pres or freq:
            for tid, cnt in s.gen_counts.items():
                if 0 <= tid < V:
                    b_rows.append(i)
                    b_cols.append(int(tid))
                    b_vals.append(-(pres + freq * cnt))
        if rep_on:
            for tid in s.seen_tokens:
                if 0 <= tid < V:
                    r_rows.append(i)
                    r_cols.append(int(tid))
                    r_pens.append(float(rep))
        if _guided_host_only(s) or (want_tops and _guided_fsm(s) is not None):
            ids = s.guided_state.allowed_token_ids(V)
            if (s.req.stop_conditions.min_tokens or 0) > s.generated:
                # min_tokens: EOS leaves the allowed set, unless EOS is all
                # the constraint has left
                non_eos = [t for t in ids if t not in s.guided_state.eos_ids]
                ids = non_eos or ids
            g_rows.append((i, ids))
    return (b_rows, b_cols, b_vals), (r_rows, r_cols, r_pens), g_rows


def _apply_edits(lg, edits):
    """Apply :func:`_build_edits`' edits to the step's logits in place:
    repetition first, then the additive terms, then the guided masks
    (fill ``FSM_MASK_FILL``). Where a token takes two additive terms (a
    bias and a penalty) they add in list order, as XLA's scatter-add
    applies them: one pass per occurrence, so no pass holds an index
    twice."""
    (b_rows, b_cols, b_vals), (r_rows, r_cols, r_pens), g_rows = edits
    dev, dt = lg.device, lg.dtype
    if r_rows:
        rr = torch.tensor(r_rows, device=dev)
        rc = torch.tensor(r_cols, device=dev)
        rp = torch.tensor(r_pens, dtype=dt, device=dev)
        v = lg[rr, rc]
        lg[rr, rc] = torch.where(v > 0, v / rp, v * rp)
    if b_rows:
        passes: list = []
        seen: dict = {}
        for r, c, v in zip(b_rows, b_cols, b_vals):
            k = seen[r, c] = seen.get((r, c), -1) + 1
            if k == len(passes):
                passes.append(([], [], []))
            for lst, x in zip(passes[k], (r, c, v)):
                lst.append(x)
        for rows, cols, vals in passes:
            idx = (torch.tensor(rows, device=dev),
                   torch.tensor(cols, device=dev))
            lg.index_put_(idx, torch.tensor(vals, dtype=dt, device=dev),
                          accumulate=True)
    for i, allowed in g_rows:
        masked = torch.full((lg.shape[-1],), sampling.FSM_MASK_FILL,
                            dtype=dt, device=dev)
        if allowed:
            ai = torch.tensor(allowed, device=dev)
            masked[ai] = lg[i, ai]
        lg[i] = masked
    return lg


def _top_logprobs(samp: dict, host: list) -> dict:
    """Row → its top logprobs as [[token_id, logprob], ...] for the rows
    that asked for them; their selected logprob (``host[1]``) is replaced
    by the one from the same log_softmax as the alternatives."""
    if not samp["want_tops"]:
        return {}
    ids, vals, sel = host[2:5]
    tops = {}
    for i, n in samp["want_tops"].items():
        tops[i] = [[int(j), float(v)] for j, v in zip(ids[i][:n],
                                                      vals[i][:n])]
        host[1][i] = sel[i]
    return tops


class _NullCtx:
    cancelled = False
    expired = False
    id = "local"
