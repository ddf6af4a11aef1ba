#!/usr/bin/env python3
"""Smoke run of the torch port on one CUDA card (an H100 for this port).

    python3 chip_smoke.py [--seed N]

Phases, each of which must pass or the script exits non-zero before it
prints any result:

1. Device: the card's name and power limit (nvidia-smi), and the build of
   every CUDA kernel of the main paths from the sources in this checkout
   (one nvcc per source, started together).
2. Kernels: each kernel against its plain PyTorch version on the card,
   with its tolerance, and its time beside the plain version's, a PyTorch
   library call's (a yardstick the port never calls: SDPA, flash for
   calls without a mask and cuDNN for those with one, ``LIBRARY_BACKENDS``;
   for the GQA kernels only in each kernel's main case) and the least time
   the card could take (each timed with the host's work kept out of the
   window, see ``time_ms``):
   - ragged paged attention on bf16/f32 pages: small mixed cases (f32 and
     bf16, window, sinks, both head dims), the tile edges of the bf16 body
     (group sizes 1 to 16, rows that see no key or one key, a window edge
     inside a key tile, int8 pages) and the Llama-3-8B geometry, whose
     mixed case is also timed row kind by row kind;
   - the same kernel on int8 pages: the Llama-3-8B mixed and decode cases,
     window + sinks, and a layer-rebased scale table (scale_slot_base);
   - flash prefill: f32 and bf16, hd 64 and 128, window, sinks, pos_base
     > 0 with S < T, a kv_len 0 row, and the Llama-3-8B embeddings
     geometry (B 8, S = T = 2048);
   - paged decode (the ragged kernel under the one-query-per-row
     contract): the Llama-3-8B decode geometry (8 rows at kv 900-1100),
     window + sinks, int8 pages (also with a rebased scale table), f32,
     and a kv_len 0 row;
   - the same three GQA kernels at head dim 256 and with the attention
     logit softcap 50 (``gemma_kernel_phase``): small mixed cases on f32,
     bf16 and int8 pages with window 7, sinks and the cap with and
     without a window, tile edges at groups 1 and 2, a group of 7 at hd
     128 (Qwen2-7B: 63 of the 64 query rows), flash prefill and paged
     decode cases, and the Gemma-2-9B geometry (H 16, KV 8): the mixed
     case on bf16 and int8 pages with window 4096 on a row at kv 6000, 8
     decode rows, embeddings (B 8, S = T = 2048) and paged decode. Every
     capped case runs on queries scaled by 12, so that the cap bends its
     scores by several units, and the kernel run on it with the cap off
     and with the cap doubled must both fail its check;
   - MLA latent decode: f32 and bf16 with a kv_len 0 row, a one-page row
     and a long split-K row, and the DeepSeek-V2-Lite geometry (8 decode
     rows at kv 65-3000, H = 16, R = 512, PR = 128); the MLA cases pass a
     q_rot of the live rope width (64 of the pages' 128 columns) as the
     engine does, and a few the whole width; bf16 is held row by row, and
     three planted wrong outputs must fail that check;
   - the same kernel on int8 pages: the DeepSeek-V2-Lite decode case, and
     the same behind a layer-rebased scale table;
   - MLA flash prefill: f32 and bf16 dense chunks deep into their context
     (pos_base > 0, S < T) with a kv_len 0 row and a row whose last query
     tile straddles kv_len, int8 pages on a rebased scale table, and the
     DeepSeek-V2-Lite geometry: a dense 2 x 1024-token prefill and a chunk
     grid of 68 tiles x 32 tokens at kv up to 3000 (bf16 and int8 pages),
     where the same three planted wrong outputs must fail the row check;
   - the seeded Gumbel draw (no TPU kernel behind it): jax.random's known
     answers (``SAMPLE_KNOWN``: the plain version's threefry words and
     uniforms, the kernel's tokens of an [8, 128256] draw), then the
     kernel against its plain version on [8, 128256] logits with the
     top-k/top-p cuts of a mixed batch: the tokens must be equal;
   - the dequant-GEMM (no TPU kernel behind it: XLA fuses the JAX
     package's dequant chain into the dot), ``qmm_kernel_phase``:
     ``quantize`` on the card bit-equal to the CPU's; every format
     (int8, int8-g128, int4-g32, int4-g128, int8-g128 with a zero point)
     at M 8 and 2048 on the Llama-3-8B (4096->4096, 4096->1024,
     4096->14336, 14336->4096, the 4096->128256 head) and Llama-3-70B
     (8192->8192, 8192->28672, 28672->8192) shapes, each row within
     ``ROW_RTOL`` of its largest |value|; int8 and int4-g32 timed beside
     the plain version, their bound and the yardstick (``torch.matmul`` of
     x with the weight already in bf16, 2-4x the bytes); Llama-3-70B's
     w_gate in int4-g32 timed at M 1, 8, 16, 64, 128, 512 and 2048, a
     table of both bodies (decode up to ``qmm.DECODE_MAX_M`` rows, the
     ``wgmma`` prefill body above); DeepSeek-V2-Lite's expert stack (64 x
     2048->1408, x shared and per expert); the edges (M 1, 13, 37, 100; O
     1000; g16).
3. Serving: ``AsyncTorchEngine`` with the llama3_8b preset at full width
   and depth on random weights from a seeded generator, ``warmup()``
   first (every token bucket's steps and the greedy sampler captured, so
   no measured run pays a capture: every serving engine below runs it),
   eight concurrent greedy requests after one warm-up request, on the
   depth-2 pipelined decode loop (the default). The kernels' launch counts are set to 0 just
   before and read just after; the ragged kernel must have launched 32
   times a step. Then, on the same engine and an emptied prefix cache
   each time, the same requests on the serial loop, whose eight streams
   must equal the pipelined run's, and two of the prompts each served
   alone on both loops, whose tokens must agree; TTFT, ITL, tok/s and the
   decode step wall of both loops are printed. Every later serving run
   (phases 7, 9 and 10) compares its eight streams across the two loops
   in the same way, and none of the greedy runs may capture anything.
   Then sampling on the same engine: one short unmeasured request a
   sampler branch set (their captures), then eight seeded sampled
   requests (mixed temperature, top-k, top-p) on both loops, capturing
   nothing,
   whose streams must be equal (the draw kernel's launches counted in the
   pipelined run), with the decode step wall and ITL beside the greedy
   run's; a logprobs, a penalties and a logit_bias request on the serial
   loop (top logprobs finite and sorted); and a json_schema request over a
   synthetic alphabet of 128256 entries, whose device-FSM stream must
   match the schema's pattern (``CharDfa.fullmatch``) and equal the host
   oracle's.
   Every step of every serving run is the engine's CUDA graphs: the first
   use of a signature runs eagerly and is captured, later uses replay, and
   a replay adds the launches it holds to each kernel's count, so the
   launch checks count replays. After the solo prompts, the eight requests
   twice more on the pipelined loop, with the engine's graphs off
   (``use_graphs``) and on: equal streams, and the decode step wall, ITL,
   tok/s and TTFT of both runs, with the engine's captures, their seconds
   and the graph pool's size. After the sampled requests,
   ``multi_step_decode=4`` on the same engine: the eight greedy and the
   eight seeded sampled requests in bursts of four steps, every stream
   equal to the K = 1 run's, the per-token decode wall beside K = 1's.
   Then speculative decoding on the same engine (``spec_serving``; the
   engine is made with ``speculative_tokens=4``, which sizes its staging
   buffer and verify scratch, and runs with 0 until here):
   ``speculative_tokens=4`` with the governor off, ``warmup()`` again
   (every verify bucket, plain and FSM-masked; the step signatures
   replay), the K = 1 references phase 3 lacks (eight repetitive
   prompts, a random 48-token segment repeated to 300-900 tokens, on both
   loops; a greedy json_schema request on the device FSM), then,
   capturing nothing, prompt lookup on the eight greedy requests, the
   repetitive prompts and the guided request (verified under mask words,
   matching the schema), and the layer-skip draft at D = 32 and 8 (a
   warmup of its burst each). First ``spec_path_check`` (24 rows): the
   same positions as decode rows and as verify rows, and every packed
   position of the verify through the kernels and through the plain
   attention, held by :func:`tie_gate`. Every spec stream equals its
   K = 1 stream up to its first difference, where the K = 1 run's best
   token and the spec stream's token (a serial re-run with top logprobs)
   lie within SPEC_TIE_STEPS bf16 steps at the row's logit scale,
   printed; the ragged kernel launches L times a verify forward and a
   plain forward step and D times a draft step; drafts, acceptance,
   tokens a verify, the round's wall, ITL and tok/s are printed beside
   the K = 1 runs'.
   Then the captured step against the eager step on the same operands (a
   decode-only and a mixed step, replayed in the reverse of their capture
   order): logits and written cache slots bit-equal, the same launches.
4. Full-width step: one packed ragged step through the kernel against the
   same step through the plain attention; logits must agree.
5. Step profile: a decode-only and a prefill step at full width, timed on
   the host and traced with torch.profiler (device busy time by kernel).
   Then one full-width S == 1 dense decode step (``make_forward_fn``, 8
   rows at kv 900-1100) through the paged decode kernel (32 launches)
   against the same step through its plain version.
6. Embeddings: ``AsyncTorchEngine.embed`` of 8 inputs of 100-2048 tokens
   at full width through the flash prefill kernel (32 launches a call):
   unit norm, padding invariance, and agreement with the same embeddings
   through the plain attention. Then the engine's weights are written as
   an HF-layout checkpoint (safetensors shards, ``config.json``,
   ``generation_config.json``) into ``.smoke_ckpt/`` beside this script
   (the depth cut, and printed, if the disk cannot hold it), and read back:
   ``ModelConfig.from_pretrained`` must equal the preset field by field
   and ``load_hf_params`` the weights bit for bit.
7. int8 KV serving: the eight requests again on an engine with
   ``kv_cache_dtype="int8"`` (the ragged kernel's int8 pages must launch),
   after ``warmup()`` on the fresh engine (every token bucket's mixed and
   decode-only step, the greedy sampler; no greedy request may capture
   anything after it), its pool beside the bf16 one's, the captured step
   against the eager one, one full-width int8 step against the plain
   version, and the step profile of phase 5 on int8 pages. Then the
   disagg block copy at full width on that pool: 56 blocks gathered
   (packed uint8), scattered into other blocks, gathered back bit-exact,
   gather and scatter timed against the blocks' bytes at HBM rate.
8. The worker, once the Llama engines are released: the port's
   ``ControlPlaneServer``, ``python -m dynamo_tpu_torch.engine.main
   --model-path .smoke_ckpt`` spawned with ``DYN_CONTROL_PLANE`` set, and
   a port ``Client`` on a second runtime (responses over the TCP response
   plane): the eight requests concurrently (TTFT, ITL, tok/s beside the
   direct engine's, and the requests running and waiting after each of
   the first steps, read from the worker's load metrics on the plane,
   beside the engine's; none may wait for the runtime's request timeout,
   the mark of a dispatch the worker never answered), the two solo
   prompts (tokens equal to phase 3's), the KV stored events on the
   plane's stream (the solo prompts' blocks under the direct engine's
   hashes), one embedding (cosine against the direct engine's),
   ``clear_kv_blocks``; then SIGTERM: exit 0 within
   ``WORKER_EXIT_S`` and no instance left in discovery. The worker runs
   with ``--warmup-buckets`` and reports its kernel launches and captures
   at exit: the ragged kernel 32 times a forward step (the warmup's
   included), the flash prefill kernel 32 times for the embedding,
   nothing else; no capture but the warmup's. It also serves each of the
   eight prompts alone on an emptied prefix cache.
   Then disaggregated serving on the same checkpoint: a ``--role
   prefill --warmup-buckets`` and a ``--role decode
   --max-local-prefill-length 64 --warmup-buckets`` worker process, 4096
   blocks each, sharing the card behind a new hub; their KV moves device
   to device over CUDA IPC (``disagg/transfer.py``). Each of the eight prompts alone (both caches
   emptied) must stream what the aggregated worker streamed for it alone;
   the eight together give TTFT, ITL and tok/s beside the aggregated
   worker's, and each request's transfer (MB, chunk and layer frames,
   gather + staging, wire and scatter seconds, joined from the two
   workers' exit reports), and where each stream first differs from the
   aggregated worker's; a 3000-token prompt (two chunks) prefilled
   remotely must stream what it streams prefilled locally once the live
   threshold (the control-plane key) is raised; a restore plan naming the
   prefill worker pulls the prompt's full blocks, computed for the prompt
   alone by a seeding run that must stream what the aggregated worker
   streamed for the prompt alone (outcome restored), and must stream what
   the remote run over the prefill worker's blocks streams (where it
   leaves the stream alone is printed: its tail runs in a smaller step).
   Every request past the threshold must have
   gone remote and been placed (no fallback), over ``ipc`` (no pull
   failure), with blocks whose digest equals the prefill worker's; no
   block may stay in use on either worker, no offer outstanding and no
   handle mapped, and the prefill worker's allocated device bytes at exit
   must equal those at its registration; each worker's ragged launches
   must be 32 a forward step, and neither may capture anything past its
   warmup. Then a host-staged pair (both ``--no-kv-transfer-direct``)
   serves the warm-up, the eight together and the long prompt under the
   same gates (paths ``host``): TTFT, ITL and tok/s of both pairs beside
   the aggregated worker's, and each request's split (direct: gather,
   open, scatter and release; host-staged: gather + staging, wire and
   scatter) and the open time a pull. Each request of a pair fails the
   phase after ``DISAGG_REQUEST_S``.
9. DeepSeek-V2-Lite serving (the Llama engines released first: the two
   models never share the card): ``AsyncTorchEngine`` with the
   deepseek_v2_lite preset at full width and depth (MLA + MoE, random
   seeded weights), ``warmup()``, the eight requests of phase 3 (79-881 prompt tokens
   from the same seed); the MLA decode kernel must launch 27 times a step,
   the MLA prefill kernel 27 times in each step with chunk tokens, and no
   other attention kernel at all; the eager and captured runs of phase 3;
   then the eight seeded sampled requests on both loops, streams equal;
   prompt-lookup speculative decoding as in phase 3 on the eight greedy
   requests and the repetitive prompts (the MLA prefill kernel 27 times a
   verify: a verify's rows are all chunks; the decode kernel 27 times a
   plain step and a verify, whose rows it sees at kv_len 0; DeepSeek has
   no layer-skip draft: its dense first layer);
   the captured step against the eager step. Then one full-width MLA
   ragged step
   through the kernels against the same step through their plain
   versions, the step profile, and one embedding call (2 inputs of up to
   1024 tokens) through the MLA prefill kernel against the plain attention,
   and the block copy of phase 7 on the latent and rope pools.
10. DeepSeek-V2-Lite from an int8 latent pool, on the same weights:
   ``warmup()``, the eight requests again (both MLA kernels on int8 pages, the same launch
   rule), the pool's blocks beside the bf16 pool's, one full-width int8
   step against its plain version, and the step profile.

11. Gemma-2-9B (the DeepSeek engines released first), from the published
   ``google/gemma-2-9b`` config's fields (``GEMMA2_9B``) at full width and
   depth on seeded random weights (9.24 B parameters): ``warmup()``, the
   eight requests of phase 3 and one of ``GEMMA_LONG_PROMPT`` (6000)
   tokens, past the even layers' 4096-token window, on both loops (the
   ragged kernel 42 times a step at hd 256 with the softcap, no capture);
   the seeded sampled requests on both loops; the captured step against
   the eager one; a full-width step through the kernel against the plain
   attention (a decode row at kv 6000; every logit within the final
   softcap 30, a bound that random weights' logits, below 8, never
   test); the final softcap on hidden rows scaled until their uncapped
   logits reach 90 (``final_cap_check``); the S == 1 dense step through the paged decode kernel;
   one embedding call through the flash prefill kernel; then the same
   weights from an int8 KV pool: the requests and the full-width step.
12. Mistral-7B (its 4096 window on a 4500-token row), Qwen2-7B (q/k/v
   biases with seeded noise, a group of 7) and Qwen3-8B (q/k norms with
   seeded noise) at full width and 2 layers: the captured step bit-equal
   to the eager one, and a full-width step through the kernel against the
   plain attention.
13. Quantized weights (ROADMAP A5), the earlier engines released:
   a. Llama-3-8B at full width in int8, int8-g128 and int4-g32, drawn and
      quantized on the card from the serving seed: the dequant-GEMM 225
      times a step (7 a layer and the head) in an eager 2048-token
      prefill and an 8-row decode step, whose transient bytes must stay
      within 1.05x the bf16 step's plus the kernel's workspace while the
      same steps through ``quant_matmul_ref`` break that bound by more
      than w_gate's bf16 size; a full-width step through the kernel
      against the same step through ``quant_matmul_ref``; the captured
      step bit-equal to the eager one; the int4-g32 step profile.
   b. Llama-3-70B at full width and depth (80 layers, 69.50 B quantized
      parameters) in int4-g32 with int8 KV on one card, drawn and
      quantized matrix by matrix on the card (about 45.5 GB resident):
      ``warmup()``, the eight requests of phase 3 on both loops (equal
      streams; the dequant-GEMM 561 launches a step, the ragged kernel
      80), the decode step wall beside its weight-read bound, a
      full-width step through the kernel against the plain version, the
      step profile.
14. Preempt-to-swap and the KVBM tiers (ROADMAP A8e), Llama-3-8B at full
   width and depth on the serving seed's weights, every engine warmed up,
   steps captured, the pipelined loop on (``swap_phase``): 16 requests of
   1024 + 256 tokens on a pool of half their working set, in bf16 and int8
   KV: swap preemptions and no recompute, blocks out = in, no host byte or
   swapped block left, each victim's block digest equal before its
   swap-out and after its swap-in, streams equal to a never-preempting
   pool's or parting first at a near tie, the ragged kernel once a layer a
   step; the same requests with recompute preemption; tok/s, TTFT and ITL
   of the three; swap-out and swap-in GB/s beside a plain pinned copy.
   Then a 4096-token prompt onboarded from a 2 GiB host tier after
   ``pool.clear()`` (both TTFTs), and a 1024-token prompt cascading from a
   4-block host tier to disk, promoted back and onboarded.
The full-width steps of phases 11-13 hold the argmax up to the bf16 tie
rule of the S == 1 step (``check_logits``); the earlier ones strictly.
No earlier path was cut for time: the GQA kernels' secondary cases no
longer time the SDPA yardstick, whose cuDNN kernel builds (one a shape)
had taken most of the kernel phase's wall.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without CUDA, or without
the rest of the repository beside it, the script fails.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import functools
import gc
import json
import math
import os
import pathlib
import shutil
import signal
import statistics
import struct
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from dynamo_tpu_torch.engine import sampling
from dynamo_tpu_torch.engine.cache import (
    allocate_device_cache, kv_block_bytes, quantize_kv,
)
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.engine.loader import load_hf_params
from dynamo_tpu_torch.engine.model import (
    init_params, lm_logits, make_embed_fn, make_forward_fn,
    make_ragged_step_fn, mla_attention_seg,
)
from dynamo_tpu_torch.engine.quant import (
    is_qtensor, materialize, parse_spec, quantize,
)
from dynamo_tpu_torch.engine.scheduler import PrefillWork, SeqState, StepPlan
from dynamo_tpu_torch.models import get_model_config
from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.ops.flash_prefill import (
    flash_mla_prefill, flash_mla_prefill_paged, flash_mla_prefill_paged_ref,
    flash_mla_prefill_ref, flash_prefill, flash_prefill_paged,
    flash_prefill_ref,
)
from dynamo_tpu_torch.ops.mla_decode import (
    BF16_ROW_RTOL, mla_paged_decode, mla_paged_decode_ref,
)
from dynamo_tpu_torch.ops.paged_attention import (
    paged_attention_decode, paged_attention_decode_ref,
)
from dynamo_tpu_torch.ops.qmm import (
    ROW_RTOL, prepare_call, quant_matmul, quant_matmul_ref, workspace_bytes,
)
from dynamo_tpu_torch.ops.ragged_attention import (
    ragged_attention_ref, ragged_paged_attention,
)
from dynamo_tpu_torch.disagg.protocols import DisaggConfig
from dynamo_tpu_torch.ops.block_copy import gather_blocks, scatter_blocks
from dynamo_tpu_torch.ops.sample import (
    gumbel_argmax, gumbel_argmax_ref, random_bits_ref, uniform_ref,
)
from dynamo_tpu_torch.protocols import (
    LLMEngineOutput, OutputOptions, PreprocessedRequest, SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.router.protocols import KV_METRICS_SUBJECT, RouterEvent
from dynamo_tpu_torch.router.publisher import parse_load_event
from dynamo_tpu_torch.runtime.codec import unpackb
from dynamo_tpu_torch.runtime.context import Context

#: DeepSeek-V2-Lite's softmax scale, qk_head_dim 192 to the -1/2
MLA_SCALE = 1.0 / float(np.sqrt(192))
#: published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and dense
#: operations/s by input type (bf16 on tensor cores, f32 without them)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
#: kernel-vs-plain tolerances (absolute and relative): f32 differs by
#: summation order only; in bf16 both round the output to 8 mantissa bits
#: and the kernel also rounds P (with int8 pages, p·v_scale) to bf16 before
#: P.V, a step or two apart
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: full-width step: the kernel rounds P to bf16 before P.V where the plain
#: version keeps it in f32, so each of 32 layers' attention outputs may
#: differ by a bf16 step or two, carried through the residual stream: the
#: logits may differ by this share of their largest magnitude
STEP_RTOL = 0.05
#: the backends of scaled_dot_product_attention for the library yardstick,
#: in priority order: flash for the calls without a mask (decode rows),
#: cuDNN for those with one (flash takes none, and the efficient backend no
#: GQA). cuDNN compiles a kernel for every new shape, 10-50 s a shape on an
#: H100 host (PERF.md §6), so only each kernel's main case is timed
#: against the yardstick (``yardstick=True``)
LIBRARY_BACKENDS = [SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH]
#: embeddings through the kernel against the same through the plain
#: attention: per-row cosine, for the same reason as STEP_RTOL
EMBED_COS = 0.999
#: a row embedded alone against the same row in a padded batch (other
#: bucket shapes, so other GEMM tilings in bf16)
PAD_COS = 0.9999

#: every kernel of the main paths: the ragged kernel once for each page
#: dtype (its launches are those of the bf16 and the int8 serving run) and
#: once under the paged decode contract (the S == 1 dense step); the MLA
#: decode kernel once for each page dtype (the DeepSeek-V2-Lite bf16 and
#: int8 serving runs); the MLA prefill kernel (its bf16 serving run)
KERNELS = [{
    "name": "ragged_paged_attention",
    "route": "cuda",
    "source": "dynamo_tpu_torch/ops/csrc/ragged_attention.cu",
    "replaces": "dynamo_tpu/ops/ragged_attention.py:78",
    "build": "ragged_attention",
    "wrapper": ragged_paged_attention,
}, {
    "name": "ragged_paged_attention_int8",
    "route": "cuda",
    "source": "dynamo_tpu_torch/ops/csrc/ragged_attention.cu",
    "replaces": "dynamo_tpu/ops/ragged_attention.py:78",
    "build": "ragged_attention",
    "wrapper": ragged_paged_attention,
}, {
    "name": "flash_prefill",
    "route": "cuda",
    "source": "dynamo_tpu_torch/ops/csrc/flash_prefill.cu",
    "replaces": "dynamo_tpu/ops/flash_prefill.py:46",
    "build": "flash_prefill",
    "wrapper": flash_prefill,
}, {
    "name": "paged_attention_decode",
    "route": "cuda",
    "source": "dynamo_tpu_torch/ops/csrc/ragged_attention.cu",
    "replaces": "dynamo_tpu/ops/paged_attention.py:48",
    "build": "ragged_attention",
    "wrapper": paged_attention_decode,
}, {
    "name": "mla_paged_decode",
    "route": "cuda",
    "source": "dynamo_tpu_torch/ops/csrc/mla_decode.cu",
    "replaces": "dynamo_tpu/ops/paged_attention.py:389",
    "build": "mla_decode",
    "wrapper": mla_paged_decode,
}, {
    "name": "mla_paged_decode_int8",
    "route": "cuda",
    "source": "dynamo_tpu_torch/ops/csrc/mla_decode.cu",
    "replaces": "dynamo_tpu/ops/paged_attention.py:389",
    "build": "mla_decode",
    "wrapper": mla_paged_decode,
}, {
    "name": "flash_mla_prefill",
    "route": "cuda",
    "source": "dynamo_tpu_torch/ops/csrc/mla_prefill.cu",
    "replaces": "dynamo_tpu/ops/flash_prefill.py:46",
    "build": "mla_prefill",
    "wrapper": flash_mla_prefill_paged,
}, {
    # no TPU kernel stands behind the draw: the JAX package leaves
    # jax.random.categorical (``_cat``) to XLA
    "name": "gumbel_argmax",
    "route": "cuda",
    "source": "dynamo_tpu_torch/ops/csrc/sample.cu",
    "replaces": "dynamo_tpu/engine/sampling.py:82",
    "build": "sample",
    "wrapper": gumbel_argmax,
}, {
    # the GQA kernels at Gemma-2-9B's geometry: head dim 256 and the
    # attention softcap (their launches: phase 11's runs)
    "name": "ragged_paged_attention_gemma2",
    "route": "cuda",
    "source": "dynamo_tpu_torch/ops/csrc/ragged_attention.cu",
    "replaces": "dynamo_tpu/ops/ragged_attention.py:78",
    "build": "ragged_attention",
    "wrapper": ragged_paged_attention,
}, {
    "name": "ragged_paged_attention_int8_gemma2",
    "route": "cuda",
    "source": "dynamo_tpu_torch/ops/csrc/ragged_attention.cu",
    "replaces": "dynamo_tpu/ops/ragged_attention.py:78",
    "build": "ragged_attention",
    "wrapper": ragged_paged_attention,
}, {
    "name": "flash_prefill_gemma2",
    "route": "cuda",
    "source": "dynamo_tpu_torch/ops/csrc/flash_prefill.cu",
    "replaces": "dynamo_tpu/ops/flash_prefill.py:46",
    "build": "flash_prefill",
    "wrapper": flash_prefill,
}, {
    "name": "paged_attention_decode_gemma2",
    "route": "cuda",
    "source": "dynamo_tpu_torch/ops/csrc/ragged_attention.cu",
    "replaces": "dynamo_tpu/ops/paged_attention.py:48",
    "build": "ragged_attention",
    "wrapper": paged_attention_decode,
}, {
    # no TPU kernel stands behind the dequant-GEMM: XLA fuses the JAX
    # package's dequant chain (materialize) into the dot's operand read.
    # Its main case: Llama-3-70B's w_gate at decode M in int4-g32; its
    # launches: phase 13b's serving run
    "name": "quant_matmul",
    "route": "cuda",
    "source": "dynamo_tpu_torch/ops/csrc/qmm.cu",
    "replaces": "dynamo_tpu/engine/quant.py:107",
    "build": "qmm",
    "wrapper": quant_matmul,
}]

#: jax.random's answers (jax 0.9.0, threefry2x32, jax_threefry_partitionable)
#: for fixed keys (seed, step): the first 8 words of ``jax.random.bits``,
#: the bits of the first 8 ``jax.random.uniform``s, and the tokens of the
#: JAX package's ``sample`` on :func:`known_draw_inputs`. This script
#: imports no JAX; ``tests/test_torch_sampling.py`` recomputes them.
SAMPLE_KNOWN = {
    "bits": {
        (0, 0): [4070199207, 4202968722, 1427181096, 2012915765,
                 2447653815, 710830403, 1332275837, 2961296638],
        (7, 123): [3480654396, 142690056, 4241128056, 3337712547,
                   2846293478, 39586046, 315257592, 924206494],
        (2**31 - 1, 2**32 - 1): [1546250463, 1420535966, 2636973641,
                                 3128703886, 4076704060, 2873412253,
                                 3490362789, 2649989376],
    },
    "uniform": {
        (0, 0): [1064475214, 1064993846, 1051337244, 1055913296,
                 1058137146, 1042905504, 1050595796, 1060143564],
        (7, 123): [1062172306, 1023939680, 1065142906, 1061613938,
                   1059694332, 1008140800, 1033261968, 1046239504],
        (2**31 - 1, 2**32 - 1): [1052267472, 1051285328, 1058876678,
                                 1060797498, 1064500624, 1059800266,
                                 1062210228, 1058927520],
    },
    "tokens": [109589, 61445, 48174, 47814, 121282, 105863, 36378, 5134],
}
#: 32-bit operations of the draw for each element, from csrc/sample.cu:
#: threefry2x32 72 (20 rounds of add, funnel shift and xor; 5 key
#: injections of 2 adds; the first add; the final xor), the uniform 5
#: (shift, or, subtract, add, max), the Gumbel noise 4 (two logs, two
#: negations), the division, the cut's compare and select, the add and
#: the running maximum's 2 compares: 87
SAMPLE_OPS_PER_ELEMENT = 87


def known_draw_inputs():
    """[8, 128256] float32 logits, temperatures and keys of the known
    answers' draw (numpy, seed 20261017)."""
    rng = np.random.default_rng(20261017)
    lg = rng.standard_normal((8, 128256)).astype(np.float32)
    temp = np.asarray([0.5, 0.8, 1.0, 1.2, 0.7, 1.5, 0.9, 1.1], np.float32)
    keys = sampling.make_keys([0, 1, 7, 2**31 - 1, 12345, 99, 3, 2024],
                              [0, 1, 500, 2**32 - 1, 77, 4096, 65, 1])
    return lg, temp, keys


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_counts() -> None:
    for k in KERNELS:
        k["wrapper"].launches = 0


# ------------------------------------------------------------------ phase 1


def device_phase() -> tuple[str, str]:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this script needs a "
                 "CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"device: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.build(sorted({k["build"] for k in KERNELS}))
    log(f"kernel build: {time.perf_counter() - t0:.3f} s wall")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry function" in line):
                log(f"  ptxas {name}: {line.strip()}")
    return smi, torch.cuda.get_device_name(0)


# ------------------------------------------------------------------ phase 2


@functools.lru_cache(maxsize=None)
def spin_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on this card,
    measured once with CUDA events."""
    n = 2_000_000
    torch.cuda._sleep(n)  # first use
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    torch.cuda._sleep(n)
    e.record()
    torch.cuda.synchronize()
    return n / s.elapsed_time(e)


def time_ms(fn, iters: int) -> float:
    """Median device time of ``fn`` with L2 evicted before each call (the
    engine reads each layer's pages once per step, cold). After the flush
    the stream spins (``torch.cuda._sleep``) for twice the host time that
    ``fn`` took to enqueue its work in the warm-up call, so the start event
    fires only once ``fn``'s launches are queued behind it: the wrapper's
    host work (checks, ctypes, scratch) stays out of the window. A plain
    version that reads the device on the host (``rows3.tolist()``) waits
    for the start event there, and its host time after that read stays
    in."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin = int(spin_cycles_per_ms() * (2 * host_ms + 0.05))
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(spin)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        times.append((s, e))
        torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in times)


def row_close(got, want, rtol: float, label: str) -> float:
    """Each row's largest |got - want| within ``rtol`` of the row's largest
    |want| (a row of zeros must come out zeros); returns the worst row's
    share."""
    err = (got - want).abs().flatten(1).amax(1)
    scale = want.abs().flatten(1).amax(1)
    share = torch.where(scale > 0, err / scale.clamp_min(1e-30),
                        torch.where(err > 0, float("inf"), 0.0))
    worst = float(share.max())
    if not bool((err <= rtol * scale).all()):
        raise AssertionError(f"{label}: row errors {err.tolist()} against "
                             f"row scales {scale.tolist()} (rtol {rtol})")
    return worst


def measure(label, kernel, plain, library, bound, tol, pick=lambda o: o,
            iters=20, row_rtol=None, controls=()):
    """The kernel against its plain version on the same inputs (outputs
    cut by ``pick`` to their defined part), then the times of kernel,
    plain version and library yardstick (None: none). ``bound`` is
    (ms, "bytes" or "operations"). The outputs must agree elementwise
    within ``tol`` (absolute and relative), or with ``row_rtol`` by
    :func:`row_close`. ``controls``: (name, run) pairs, runs of the kernel
    with a setting changed that must fail that same check against the
    plain version (the case can see the setting). The log line ends with
    the host seconds of the check and of the three timings."""
    w0 = time.perf_counter()
    got = pick(kernel()).float()
    want = pick(plain()).float()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: non-finite kernel output")
    err = float((got - want).abs().max())

    def check(out, lbl):
        if row_rtol is None:
            torch.testing.assert_close(out, want, atol=tol, rtol=tol,
                                       msg=lambda m: f"{lbl}: {m}")
            return tol
        return (f"row rtol {row_rtol}; worst row "
                f"{row_close(out, want, row_rtol, lbl):.3e}")
    shown = check(got, label)
    for name, run in controls:
        out = pick(run()).float()
        try:
            check(out, label)
        except AssertionError:
            log(f"  {label}: the kernel with {name} fails the check "
                f"(max_abs_err {float((out - want).abs().max()):.3e})")
            continue
        raise AssertionError(f"{label}: the kernel with {name} passes the "
                             f"check too: the case cannot see the setting")
    tol = shown
    walls = [time.perf_counter() - w0]
    res = dict(max_abs_err=err, tol=tol, ms=time_ms(kernel, iters))
    walls.append(time.perf_counter() - w0 - sum(walls))
    res["plain_ms"] = time_ms(plain, max(3, iters // 5))
    walls.append(time.perf_counter() - w0 - sum(walls))
    with sdpa_kernel(LIBRARY_BACKENDS, set_priority=True):
        res["library_ms"] = (None if library is None
                             else time_ms(library, iters))
    walls.append(time.perf_counter() - w0 - sum(walls))
    res.update(bound_ms=bound[0], bound_by=bound[1])
    lib = "n/a" if res["library_ms"] is None else f"{res['library_ms']:.4f}"
    log(f"  {label}: max_abs_err {err:.3e} (tol {tol}) kernel "
        f"{res['ms']:.4f} ms plain {res['plain_ms']:.4f} ms library "
        f"{lib} ms bound {res['bound_ms']:.5f} ms ({res['bound_by']}) "
        f"[host s: check, kernel, plain, library "
        f"{' '.join(f'{w:.2f}' for w in walls)}]")
    return res


def bound_of(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ragged paged attention ------------------------------------------------------


def make_case(rows, *, H, KV, hd, bs, dtype, pad_rows, pad_tokens, seed,
              width=None):
    """Attention operands on the card for rows of (q_len, kv_len), each row
    on its own random blocks of a shared paged cache; block tables of
    ``width`` blocks (default: the longest row's)."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    need = [-(-kv // bs) for _, kv in rows]
    num_blocks = sum(need) + 8
    W = max(need) if width is None else width
    perm = rng.permutation(np.arange(1, num_blocks))
    R = len(rows) + pad_rows
    rows3 = np.zeros((R, 3), np.int32)
    bt = np.zeros((R, W), np.int32)
    t = used = 0
    for i, (ql, kv) in enumerate(rows):
        rows3[i] = (t, ql, kv)
        bt[i, :need[i]] = perm[used:used + need[i]]
        used += need[i]
        t += ql

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return dict(q=randn(t + pad_tokens, H, hd),
                kc=randn(num_blocks * bs, KV, hd),
                vc=randn(num_blocks * bs, KV, hd),
                bt=torch.from_numpy(bt).cuda(),
                rows3=torch.from_numpy(rows3).cuda(),
                sinks=torch.randn((H,), generator=gen, device="cuda"),
                rows=rows, bs=bs, t=t, dtype=dtype)


def int8_case(case, rebase: bool = False):
    """The case's pages quantized (scales per slot and KV head); with
    ``rebase``, behind a junk layer that the block tables and
    ``scale_slot_base`` step over, as a layer-stacked caller passes them."""
    kq, ks = quantize_kv(case["kc"].float())
    vq, vs = quantize_kv(case["vc"].float())
    out = dict(case, kc=kq, vc=vq, ks=ks, vs=vs, base=0)
    if rebase:
        slots = kq.shape[0]
        out.update(kc=torch.cat([torch.full_like(kq, 7), kq]),
                   vc=torch.cat([torch.full_like(vq, 7), vq]),
                   bt=case["bt"] + slots // case["bs"], base=slots)
    return out


def ragged_bound(case, window: int) -> tuple[float, str]:
    """Least time for this case's work: the bytes it must move (q and out of
    the real tokens, every K/V row a token can see with its scales when
    int8, the tables) over HBM bandwidth, or its operations over the peak
    rate for its input type."""
    H, hd = case["q"].shape[1:]
    KV = case["kc"].shape[1]
    esz = case["q"].element_size()
    kv_row = (hd + 4 if "ks" in case else hd * esz) * KV  # one key, K or V
    nbytes = case["bt"].numel() * 4 + case["rows3"].numel() * 4
    ops = 0
    for ql, kv in case["rows"]:
        first = max(kv - ql - window + 1, 0) if window else 0
        nbytes += 2 * ql * H * hd * esz + 2 * (kv - first) * kv_row
        for p in range(kv - ql, kv):
            seen = min(p + 1, window) if window else p + 1
            ops += 4 * hd * H * seen
    return bound_of(nbytes, ops, case["dtype"])


def sdpa_ragged(case, window: int):
    """PyTorch's scaled_dot_product_attention over each row's gathered K/V
    (gather done up front; int8 pages dequantize inside the timed call):
    the library yardstick. No sinks."""
    bs = case["bs"]
    calls = []
    for r, (ql, kv) in enumerate(case["rows"]):
        q0 = int(case["rows3"][r, 0])
        keys = torch.arange(kv, device="cuda")
        slots = case["bt"][r, keys // bs].long() * bs + keys % bs
        k = case["kc"][slots].permute(1, 0, 2)[None]  # [1, KV, kv, hd]
        v = case["vc"][slots].permute(1, 0, 2)[None]
        sc = None
        if "ks" in case:
            sidx = slots - case["base"]
            sc = (case["ks"][sidx].T[None, :, :, None],
                  case["vs"][sidx].T[None, :, :, None])
        q = case["q"][q0:q0 + ql].permute(1, 0, 2)[None]  # [1, H, ql, hd]
        pos = torch.arange(kv - ql, kv, device="cuda")
        mask = keys[None, :] <= pos[:, None]
        if window:
            mask &= keys[None, :] > pos[:, None] - window
        calls.append((q, k, v, sc, None if bool(mask.all()) else mask))

    def run():
        for q, k, v, sc, m in calls:
            if sc is not None:
                k = (k.float() * sc[0]).to(q.dtype)
                v = (v.float() * sc[1]).to(q.dtype)
            F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                           enable_gqa=True)
    return run


def cap_controls(kernel, softcap: float) -> list:
    """The controls of a capped case (:func:`measure`): the kernel run
    ``kernel(cap)`` with the cap off and doubled must both fail the check,
    so that the case would catch a kernel that drops or misscales it."""
    if not softcap:
        return []
    return [(f"softcap={c:g}", functools.partial(kernel, c))
            for c in (0.0, 2 * softcap)]


def check_ragged(label, case, window=0, sinks=False, iters=20,
                 softcap=0.0, yardstick=False):
    """The ragged kernel vs its plain version on one case (bf16/f32 or
    int8 pages); returns the numbers. ``yardstick``: also SDPA's time
    (no sinks), which has no softcap: on a capped case it does less work
    than the kernel. A capped case has the controls of
    :func:`cap_controls`."""
    args = (case["q"], case["kc"], case["vc"], case["bt"], case["rows3"])
    kw = dict(block_size=case["bs"], window=window,
              sinks=case["sinks"] if sinks else None)
    if "ks" in case:
        kw.update(k_scales=case["ks"], v_scales=case["vs"],
                  scale_slot_base=case["base"])
    t = case["t"]

    def kernel(cap):
        return ragged_paged_attention(*args, softcap=cap, **kw)
    return measure(
        label, lambda: kernel(softcap),
        lambda: ragged_attention_ref(*args, softcap=softcap, **kw),
        sdpa_ragged(case, window) if yardstick and not sinks else None,
        ragged_bound(case, window), TOL[case["dtype"]],
        pick=lambda o: o[:t], iters=iters,
        controls=cap_controls(kernel, softcap))


# flash prefill ---------------------------------------------------------------


def make_dense(B, S, T, H, KV, hd, dtype, pos_base, kv_lens, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return dict(q=randn(B, S, H, hd), k=randn(B, T, KV, hd),
                v=randn(B, T, KV, hd),
                pos_base=torch.tensor(pos_base, dtype=torch.int32,
                                      device="cuda"),
                kv_lens=torch.tensor(kv_lens, dtype=torch.int32,
                                     device="cuda"),
                sinks=torch.randn((H,), generator=gen, device="cuda"),
                dtype=dtype)


def dense_mask(case, window: int):
    """[B, 1, S, T] visibility: key <= pos, key < kv_len, the window."""
    B, S = case["q"].shape[:2]
    T = case["k"].shape[1]
    pos = case["pos_base"][:, None].long() + torch.arange(S, device="cuda")
    keys = torch.arange(T, device="cuda")
    m = (keys[None, None, :] <= pos[:, :, None]) & (
        keys[None, None, :] < case["kv_lens"][:, None, None].long())
    if window:
        m &= keys[None, None, :] > pos[:, :, None] - window
    return m[:, None]


def flash_bound(case, window: int) -> tuple[float, str]:
    """q read and out written for every query, the K/V rows below each
    row's kv_len read once, and 4·hd·H operations for each visible
    (query, key) pair."""
    B, S, H, hd = case["q"].shape
    KV = case["k"].shape[2]
    esz = case["q"].element_size()
    lens = case["kv_lens"].clamp(max=case["k"].shape[1])
    nbytes = (2 * B * S * H * hd * esz + int(lens.sum()) * 2 * KV * hd * esz
              + 8 * B)
    seen = int(dense_mask(case, window).sum())
    return bound_of(nbytes, 4 * hd * H * seen, case["dtype"])


def check_flash(label, case, window=0, sinks=False, iters=20, softcap=0.0,
                yardstick=False):
    args = (case["q"], case["k"], case["v"], case["pos_base"],
            case["kv_lens"])
    kw = dict(sliding_window=window or None,
              sinks=case["sinks"] if sinks else None)
    library = None
    if yardstick and not sinks:
        q, k, v = (case[n].transpose(1, 2) for n in ("q", "k", "v"))
        mask = dense_mask(case, window)

        def library():
            F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                           enable_gqa=True)

    def kernel(cap):
        return flash_prefill(*args, softcap=cap, **kw)
    return measure(label, lambda: kernel(softcap),
                   lambda: flash_prefill_ref(*args, softcap=softcap, **kw),
                   library, flash_bound(case, window), TOL[case["dtype"]],
                   iters=iters, controls=cap_controls(kernel, softcap))


# paged decode ------------------------------------------------------------------


def check_decode(label, case, window=0, sinks=False, iters=20,
                 softcap=0.0, yardstick=False):
    """The paged decode contract (one query per row, rows of q_len 1) on a
    ragged case: the kernel vs its plain version, SDPA per row as the
    library yardstick, and the ragged case's bound."""
    kv_lens = case["rows3"][:, 2].contiguous()
    args = (case["q"], case["kc"], case["vc"], case["bt"], kv_lens)
    kw = dict(block_size=case["bs"], window=window or None,
              sinks=case["sinks"] if sinks else None)
    if "ks" in case:
        kw.update(k_scales=case["ks"], v_scales=case["vs"],
                  scale_slot_base=case["base"])
    library = None
    if yardstick and not sinks and all(kv for _, kv in case["rows"]):
        library = sdpa_ragged(case, window)

    def kernel(cap):
        return paged_attention_decode(*args, softcap=cap, **kw)
    return measure(label, lambda: kernel(softcap),
                   lambda: paged_attention_decode_ref(*args, softcap=softcap,
                                                      **kw),
                   library, ragged_bound(case, window), TOL[case["dtype"]],
                   iters=iters, controls=cap_controls(kernel, softcap))


# MLA latent decode -------------------------------------------------------------


def make_mla(kv_lens, *, H, R, PR, rope_dim, bs, dtype, seed, live=True):
    """MLA decode operands on the card: one row per kv_len on its own random
    blocks; the rope pages zero past ``rope_dim``, as the engine pads
    them, and q_rot ``rope_dim`` wide (``live``, as the engine passes it)
    or PR wide with the same zero pad."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    need = [-(-kv // bs) for kv in kv_lens]
    num_blocks = sum(need) + 8
    W = max(max(need), 1)
    perm = rng.permutation(np.arange(1, num_blocks))
    bt = np.zeros((len(kv_lens), W), np.int32)
    used = 0
    for i, n in enumerate(need):
        bt[i, :n] = perm[used:used + n]
        used += n

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q_rot, rope = randn(len(kv_lens), H, PR), randn(num_blocks * bs, PR)
    q_rot[..., rope_dim:] = 0
    rope[:, rope_dim:] = 0
    if live:
        q_rot = q_rot[..., :rope_dim].contiguous()
    return dict(q_eff=randn(len(kv_lens), H, R), q_rot=q_rot,
                lat=randn(num_blocks * bs, R).to(dtype), rope=rope.to(dtype),
                bt=torch.from_numpy(bt).cuda(),
                kv_lens=torch.tensor(kv_lens, dtype=torch.int32,
                                     device="cuda"),
                kvs=list(kv_lens), bs=bs, dtype=dtype, scale=MLA_SCALE)


def mla_int8(case, rebase: bool = False):
    """The MLA case's pages quantized per slot, one scale per stream; with
    ``rebase``, behind a junk layer that the block tables and
    ``scale_slot_base`` step over, as a layer-stacked caller passes them."""
    cq, cs = quantize_kv(case["lat"].float()[:, None])
    rq, rs = quantize_kv(case["rope"].float()[:, None])
    out = dict(case, lat=cq[:, 0], rope=rq[:, 0], cs=cs[:, 0], rs=rs[:, 0],
               base=0, dtype=torch.int8)
    if rebase:
        slots = cq.shape[0]
        out.update(lat=torch.cat([torch.full_like(out["lat"], 7),
                                  out["lat"]]),
                   rope=torch.cat([torch.full_like(out["rope"], 7),
                                   out["rope"]]),
                   bt=case["bt"] + slots // case["bs"], base=slots)
    return out


def mla_scales(case) -> dict:
    return (dict(c_scales=case["cs"], r_scales=case["rs"],
                 scale_slot_base=case["base"]) if "cs" in case else {})


def mla_compute_dtype(case):
    """The type the MLA kernels compute in: f32 pages on CUDA cores, bf16
    and int8 pages on the tensor cores at the 16-bit rate (fp16 operands;
    the SDPA yardstick runs in bf16)."""
    return torch.float32 if case["dtype"] == torch.float32 else torch.bfloat16


def mla_bound(case) -> tuple[float, str]:
    """q_eff and q_rot read and the output written (f32), every key's
    latent and the rope columns it reads (q_rot's width PR, of the pages'
    PR or more) read once (int8: with its two scales), the tables;
    2·(R + PR) operations per (head, key) for the score and 2·R for P·V."""
    B, H, R = case["q_eff"].shape
    PR = case["q_rot"].shape[2]
    esz = case["lat"].element_size()
    key_bytes = (R + PR) * esz + (8 if "cs" in case else 0)
    keys = sum(case["kvs"])
    nbytes = (B * H * (2 * R + PR) * 4 + keys * key_bytes
              + case["bt"].numel() * 4 + B * 4)
    return bound_of(nbytes, keys * H * 2 * (2 * R + PR),
                    mla_compute_dtype(case))


def sdpa_mla(case):
    """PyTorch's scaled_dot_product_attention per row over the row's
    gathered keys (gather done up front; int8 pages dequantize inside the
    timed call): q = [q_eff | q_rot], K = [c | k_rot] as one KV head, V = c.
    The library yardstick."""
    bs = case["bs"]
    dt = mla_compute_dtype(case)
    calls = []
    for r, kv in enumerate(case["kvs"]):
        keys = torch.arange(kv, device="cuda")
        slots = case["bt"][r, keys // bs].long() * bs + keys % bs
        sc = None
        if "cs" in case:
            sidx = slots - case["base"]
            sc = (case["cs"][sidx][:, None], case["rs"][sidx][:, None])
        q = torch.cat([case["q_eff"][r], case["q_rot"][r]], -1)
        calls.append((q.to(dt)[None, :, None], case["lat"][slots],
                      case["rope"][slots, :case["q_rot"].shape[-1]], sc))

    def run():
        for q, c, kr, sc in calls:
            if sc is not None:
                c = (c.float() * sc[0]).to(dt)
                kr = (kr.float() * sc[1]).to(dt)
            F.scaled_dot_product_attention(
                q, torch.cat([c, kr], -1)[None, None], c[None, None],
                scale=case["scale"], enable_gqa=True)
    return run


def mla_fns(case):
    """(kernel, plain version) of the MLA decode case, as callables."""
    args = (case["q_eff"], case["q_rot"], case["lat"], case["rope"],
            case["bt"], case["kv_lens"])
    kw = dict(block_size=case["bs"], scale=case["scale"], **mla_scales(case))
    return (lambda: mla_paged_decode(*args, **kw),
            lambda: mla_paged_decode_ref(*args, **kw))


def check_mla(label, case, iters=20):
    """The MLA kernel vs its plain version: f32 pages within TOL, bf16 and
    int8 pages (q and P rounded to fp16 for the tensor cores) row by
    row within BF16_ROW_RTOL of each row's scale."""
    library = sdpa_mla(case) if all(case["kvs"]) else None
    f32 = case["dtype"] == torch.float32
    return measure(label, *mla_fns(case), library, mla_bound(case),
                   TOL[torch.float32], iters=iters,
                   row_rtol=None if f32 else BF16_ROW_RTOL)


# MLA flash prefill --------------------------------------------------------------


def make_mla_prefill(rows, *, S, H, R, PR, rope_dim, bs, dtype, seed,
                     dense_T=None, live=True):
    """MLA prefill operands on the card. ``rows``: (seq, pos_base, kv_len)
    per batch row of S query tokens, rows of one seq sharing its blocks (the
    tiles of a chunk grid); seq None is a spare tile (no keys). With
    ``dense_T`` the keys are dense [B, T, .] arrays instead of pages. The
    rope keys are zero past ``rope_dim``, and q_rot is ``rope_dim`` wide
    (``live``) or PR wide, as :func:`make_mla`."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    B = len(rows)
    q_rot = randn(B, S, H, PR)
    q_rot[..., rope_dim:] = 0
    if live:
        q_rot = q_rot[..., :rope_dim].contiguous()
    case = dict(q_eff=randn(B, S, H, R), q_rot=q_rot,
                pos_base=torch.tensor([p for _, p, _ in rows],
                                      dtype=torch.int32, device="cuda"),
                kv_lens=torch.tensor([k for _, _, k in rows],
                                     dtype=torch.int32, device="cuda"),
                rows=rows, bs=bs, dtype=dtype, scale=MLA_SCALE)
    if dense_T is not None:
        c, kr = randn(B, dense_T, R), randn(B, dense_T, PR)
        kr[..., rope_dim:] = 0
        case.update(c=c.to(dtype), kr=kr.to(dtype))
        return case
    seq_kv = {}
    for seq, _, kv in rows:
        if seq is not None:
            seq_kv[seq] = max(seq_kv.get(seq, 0), kv)
    need = {q: -(-kv // bs) for q, kv in seq_kv.items()}
    num_blocks = sum(need.values()) + 8
    W = max(need.values())
    perm = rng.permutation(np.arange(1, num_blocks))
    tables, used = {}, 0
    for q, n in need.items():
        tables[q] = perm[used:used + n]
        used += n
    bt = np.zeros((B, W), np.int32)
    for i, (seq, _, _) in enumerate(rows):
        if seq is not None:
            bt[i, :need[seq]] = tables[seq]
    rope = randn(num_blocks * bs, PR)
    rope[:, rope_dim:] = 0
    case.update(lat=randn(num_blocks * bs, R).to(dtype), rope=rope.to(dtype),
                bt=torch.from_numpy(bt).cuda(), seq_kv=seq_kv)
    return case


def mla_prefill_bound(case) -> tuple[float, str]:
    """For the real tokens (a dense row's S; a chunk-grid tile's tokens
    below its kv_len, the rest being the grid's padding): q_eff and q_rot
    read and the output written (f32), per visible (token, key) pair
    2·(R + PR)·H operations for the scores and 2·R·H for P·V, PR q_rot's
    width; the latent and the PR rope columns of the keys each sequence's
    tokens can see read once (int8: with their scales), the tables."""
    B, S, H, R = case["q_eff"].shape
    PR = case["q_rot"].shape[3]
    dense = "c" in case
    esz = (case["c"] if dense else case["lat"]).element_size()
    key_bytes = (R + PR) * esz + (8 if "cs" in case else 0)
    tokens = pairs = 0
    seen = {}
    for i, (seq, pos, kv) in enumerate(case["rows"]):
        n = S if dense else max(0, min(S, kv - pos))
        tokens += n
        pairs += sum(max(0, min(kv, pos + s + 1)) for s in range(n))
        key = i if dense else seq
        seen[key] = max(seen.get(key, 0), max(0, min(kv, pos + n)))
    nbytes = (tokens * H * (2 * R + PR) * 4 + sum(seen.values()) * key_bytes
              + 8 * B + (0 if dense else case["bt"].numel() * 4))
    return bound_of(nbytes, pairs * H * 2 * (2 * R + PR),
                    mla_compute_dtype(case))


def sdpa_mla_prefill(case):
    """PyTorch's scaled_dot_product_attention over every row's keys at
    once (paged keys gathered up front; int8 pages dequantize inside the
    timed call), one KV head, a causal mask below kv_len: q = [q_eff |
    q_rot], K = [c | k_rot], V = c. The library yardstick."""
    dt = mla_compute_dtype(case)
    B, S = case["q_eff"].shape[:2]
    q = torch.cat([case["q_eff"], case["q_rot"]], -1).to(dt).transpose(1, 2)
    prl = case["q_rot"].shape[-1]
    sc = None
    if "c" in case:
        c, kr = case["c"], case["kr"][..., :prl]
    else:
        W = case["bt"].shape[1]
        bs = case["bs"]
        slots = (case["bt"].long()[:, :, None] * bs
                 + torch.arange(bs, device="cuda")).reshape(B, W * bs)
        c, kr = case["lat"][slots], case["rope"][slots][..., :prl]
        if "cs" in case:
            sidx = slots - case["base"]
            sc = (case["cs"][sidx][..., None], case["rs"][sidx][..., None])
    T = c.shape[1]
    keys = torch.arange(T, device="cuda")
    pos = case["pos_base"][:, None].long() + torch.arange(S, device="cuda")
    mask = ((keys[None, None, :] <= pos[:, :, None])
            & (keys[None, None, :]
               < case["kv_lens"][:, None, None].long()))[:, None]

    def run():
        cc, kk = c, kr
        if sc is not None:
            cc = (c.float() * sc[0]).to(dt)
            kk = (kr.float() * sc[1]).to(dt)
        F.scaled_dot_product_attention(
            q, torch.cat([cc, kk], -1)[:, None], cc[:, None], attn_mask=mask,
            scale=case["scale"], enable_gqa=True)
    return run


def mla_prefill_fns(case):
    """(kernel, plain version) of the MLA prefill case (dense or paged
    entry), as callables."""
    qs = (case["q_eff"], case["q_rot"])
    lens = (case["pos_base"], case["kv_lens"])
    if "c" in case:
        args = qs + (case["c"], case["kr"]) + lens
        kw = dict(scale=case["scale"])
        kernel, plain = flash_mla_prefill, flash_mla_prefill_ref
    else:
        args = qs + (case["lat"], case["rope"], case["bt"]) + lens
        kw = dict(block_size=case["bs"], scale=case["scale"],
                  **mla_scales(case))
        kernel, plain = flash_mla_prefill_paged, flash_mla_prefill_paged_ref
    return (lambda: kernel(*args, **kw), lambda: plain(*args, **kw))


def check_mla_prefill(label, case, iters=20):
    """The MLA prefill kernel (dense or paged entry) vs its plain version:
    f32 within TOL, bf16 and int8 pages each token's row within
    BF16_ROW_RTOL of its scale."""
    f32 = case["dtype"] == torch.float32
    return measure(label, *mla_prefill_fns(case), sdpa_mla_prefill(case),
                   mla_prefill_bound(case), TOL[torch.float32],
                   pick=lambda o: o.flatten(0, 1), iters=iters,
                   row_rtol=None if f32 else BF16_ROW_RTOL)


def mla_grid_rows(chunks, spare: int, tile: int = 32):
    """Chunk-grid tiles as the engine packs them: each (start, n) chunk of
    its own sequence cut into tiles of ``tile`` tokens, every tile of a
    chunk at kv_len start + n; then ``spare`` tiles with no tokens."""
    rows = []
    for seq, (start, n) in enumerate(chunks):
        rows += [(seq, start + off, start + n) for off in range(0, n, tile)]
    return rows + [(None, 0, 0)] * spare


def mla_controls(case) -> None:
    """The bf16 rule must tell a kernel that is wrong in a small way: the
    kernel's output (MLA decode, or MLA prefill for a case with pos_base)
    with the rope term dropped, with the last 32 keys (half a key tile) of
    every row longer than 256 dropped, and with the softmax scale 2% off,
    each against the plain version of the true inputs, must fail it."""
    prefill = "pos_base" in case
    fns = mla_prefill_fns if prefill else mla_fns
    pick = (lambda o: o.flatten(0, 1)) if prefill else (lambda o: o)
    want = pick(fns(case)[1]().float())
    lens = case["kv_lens"]
    wrong = {
        "rope term dropped": dict(case, q_rot=torch.zeros_like(
            case["q_rot"])),
        "last keys dropped": dict(case, kv_lens=torch.where(
            lens > 256, lens - 32, lens)),
        "scale 2% off": dict(case, scale=case["scale"] * 1.02),
    }
    for name, bad in wrong.items():
        got = pick(fns(bad)[0]().float())
        try:
            row_close(got, want, BF16_ROW_RTOL, name)
        except AssertionError:
            err = (got - want).abs().flatten(1).amax(1)
            share = float((err / want.abs().flatten(1).amax(1)
                           .clamp_min(1e-30)).max())
            log(f"  control, {name}: rejected (worst row share "
                f"{share:.3e} against rtol {BF16_ROW_RTOL})")
            continue
        raise AssertionError(f"the MLA bf16 check passed a wrong kernel "
                             f"output ({name})")


def mixed_parts(case, seed: int) -> None:
    """Which rows set the mixed case's time: each kind of row alone (the
    512-token prefill, the 128-token chunk at kv 2048, the two decode rows)
    in a launch of the same geometry (tokens, rows and table width padded
    to the mixed case's, so the same tiles split)."""
    R, W = case["bt"].shape
    T = case["q"].shape[0]
    rows = case["rows"]
    for part in ([r for r in rows if r[0] > 1 and r[1] == r[0]],
                 [r for r in rows if r[0] > 1 and r[1] > r[0]],
                 [r for r in rows if r[0] == 1]):
        t = sum(q for q, _ in part)
        sub = make_case(part, H=case["q"].shape[1], KV=case["kc"].shape[1],
                        hd=case["q"].shape[2], bs=case["bs"],
                        dtype=case["dtype"], pad_rows=R - len(part),
                        pad_tokens=T - t, seed=seed, width=W)
        check_ragged(f"  part of the mixed case {part}", sub, iters=10)


def kernel_phase(seed: int) -> dict:
    """Every kernel case; returns the main case of each kernel by name."""
    main = {}
    log("kernel phase: ragged_paged_attention vs ragged_attention_ref")
    small = [(1, 20), (6, 24), (1, 9), (11, 11), (37, 80)]
    for dtype in (torch.float32, torch.bfloat16):
        case = make_case(small, H=8, KV=2, hd=128, bs=16, dtype=dtype,
                         pad_rows=3, pad_tokens=5, seed=seed)
        for window, sinks in ((0, False), (7, False), (0, True)):
            check_ragged(f"small {str(dtype)[6:]} window={window} "
                         f"sinks={sinks}", case, window, sinks, iters=5)
        check_ragged(f"small {str(dtype)[6:]} int8 pages window=7 "
                     f"sinks=True", int8_case(case), 7, True, iters=5)
    case = make_case(small, H=16, KV=4, hd=64, bs=16, dtype=torch.bfloat16,
                     pad_rows=2, pad_tokens=0, seed=seed + 1)
    check_ragged("small bf16 hd=64 window=7 sinks=True", case, 7, True,
                 iters=5)
    check_ragged("small bf16 hd=64 int8 pages", int8_case(case), iters=5)
    # tile edges of the bf16 body (64 query rows, 64-key tiles): group sizes
    # 1 to 16 at both head dims; rows that see no key, one key, a page and
    # one, a decode row that splits, a 45-token prefill, a chunk of 37 at kv
    # 1300; a window edge inside a key tile; int8 pages on a rebased table
    edge_rows = [(1, 0), (1, 1), (1, 17), (1, 2000), (45, 45), (37, 1300)]
    for G, hd in ((1, 128), (4, 64), (8, 64), (16, 128)):
        case = make_case(edge_rows, H=2 * G, KV=2, hd=hd, bs=16,
                         dtype=torch.bfloat16, pad_rows=1, pad_tokens=3,
                         seed=seed + 30 + G)
        check_ragged(f"tile edges G={G} hd={hd} bf16 window=100 sinks=True",
                     case, 100, True, iters=3)
        check_ragged(f"tile edges G={G} hd={hd} int8 pages window=100 "
                     f"sinks=True, rebased scales",
                     int8_case(case, rebase=True), 100, True, iters=3)
    # Llama-3-8B attention geometry: decode rows, a fresh 512-token prefill
    # chunk, a 128-token chunk deep into its context, padding rows
    llama = make_case([(1, 1000), (1, 3000), (512, 512), (128, 2048)],
                      H=32, KV=8, hd=128, bs=16, dtype=torch.bfloat16,
                      pad_rows=4, pad_tokens=6, seed=seed + 2)
    main["ragged_paged_attention"] = check_ragged("llama3_8b mixed bf16",
                                                  llama, yardstick=True)
    mixed_parts(llama, seed + 2)
    check_ragged("llama3_8b mixed bf16 window=512 sinks=True", llama, 512,
                 True, iters=5)
    case = make_case([(1, 1500), (40, 700), (1, 9)], H=8, KV=2, hd=128,
                     bs=16, dtype=torch.float32, pad_rows=1, pad_tokens=2,
                     seed=seed + 4)
    check_ragged("long rows float32 sinks=True", case, 0, True, iters=5)
    check_ragged("long rows float32 int8 pages sinks=True",
                 int8_case(case), 0, True, iters=5)
    rng = np.random.default_rng(seed)
    decode = make_case([(1, int(k)) for k in rng.integers(65, 1057, 8)],
                       H=32, KV=8, hd=128, bs=16, dtype=torch.bfloat16,
                       pad_rows=0, pad_tokens=0, seed=seed + 3)
    check_ragged("llama3_8b 8 decode rows bf16", decode)

    log("kernel phase: ragged_paged_attention on int8 pages")
    main["ragged_paged_attention_int8"] = check_ragged(
        "llama3_8b mixed int8 pages", int8_case(llama), yardstick=True)
    check_ragged("llama3_8b mixed int8 pages window=512 sinks=True",
                 int8_case(llama), 512, True, iters=5)
    check_ragged("llama3_8b mixed int8 pages, rebased scales",
                 int8_case(llama, rebase=True), iters=5)
    check_ragged("llama3_8b 8 decode rows int8 pages", int8_case(decode))

    log("kernel phase: flash_prefill vs flash_prefill_ref")
    for dtype in (torch.float32, torch.bfloat16):
        for hd in (64, 128):
            # a chunk deep into its context (S < T, pos_base > 0, split
            # keys), a kv_len 0 row, a fresh row
            case = make_dense(3, 48, 700, 8, 2, hd, dtype, (600, 0, 0),
                              (648, 0, 500), seed + hd)
            name = f"{str(dtype)[6:]} hd={hd}"
            check_flash(f"small {name}", case, iters=5)
            check_flash(f"small {name} window=33 sinks=True", case, 33,
                        True, iters=5)
    # tile edges: S = 45 tokens over T = 300 keys at group sizes 1 to 16
    # (a fresh row, a chunk at pos_base 255, a kv_len 0 row, kv_len 131
    # inside a key tile), a window edge inside a key tile
    for G, hd in ((1, 64), (8, 128), (16, 64)):
        case = make_dense(4, 45, 300, 2 * G, 2, hd, torch.bfloat16,
                          (0, 255, 0, 100), (45, 300, 0, 131), seed + 40 + G)
        check_flash(f"tile edges G={G} hd={hd} bf16 window=100 sinks=True",
                    case, 100, True, iters=3)
    # Llama-3-8B embeddings geometry: 8 rows, S = T = 2048, lengths
    # 100-2048 (the longest fills the bucket)
    lens = [2048] + [int(x) for x in rng.integers(100, 2049, 7)]
    emb = make_dense(8, 2048, 2048, 32, 8, 128, torch.bfloat16, [0] * 8,
                     lens, seed + 5)
    main["flash_prefill"] = check_flash(f"llama3_8b embed bf16 lengths "
                                        f"{lens}", emb, iters=10,
                                        yardstick=True)

    log("kernel phase: paged_attention_decode vs paged_attention_decode_ref")
    # the Llama-3-8B S == 1 step's geometry: 8 rows at kv 900-1100
    kvs = [int(k) for k in rng.integers(900, 1101, 8)]
    dec = make_case([(1, k) for k in kvs], H=32, KV=8, hd=128, bs=16,
                    dtype=torch.bfloat16, pad_rows=0, pad_tokens=0,
                    seed=seed + 6)
    main["paged_attention_decode"] = check_decode(
        f"llama3_8b 8 decode rows bf16 kv {kvs}", dec, yardstick=True)
    check_decode("llama3_8b 8 decode rows bf16 window=512 sinks=True", dec,
                 512, True, iters=5)
    check_decode("llama3_8b 8 decode rows int8 pages", int8_case(dec),
                 iters=5)
    check_decode("llama3_8b 8 decode rows int8 pages window=512 sinks=True, "
                 "rebased scales", int8_case(dec, rebase=True), 512, True,
                 iters=5)
    small = make_case([(1, 0), (1, 16), (1, 700), (1, 9)], H=8, KV=2,
                      hd=64, bs=16, dtype=torch.float32, pad_rows=0,
                      pad_tokens=0, seed=seed + 7)
    check_decode("small float32 kv_len 0 row window=7 sinks=True", small, 7,
                 True, iters=5)
    # rows at kv 1, at page boundaries and one past them, and kv 0
    edges = make_case([(1, k) for k in (1, 16, 17, 32, 33, 64, 65, 0)],
                      H=32, KV=8, hd=128, bs=16, dtype=torch.bfloat16,
                      pad_rows=0, pad_tokens=0, seed=seed + 50)
    check_decode("tile edges kv 1, 16, 17, 32, 33, 64, 65, 0 bf16 window=17 "
                 "sinks=True", edges, 17, True, iters=3)
    check_decode("tile edges int8 pages window=17 sinks=True, rebased "
                 "scales", int8_case(edges, rebase=True), 17, True, iters=3)

    main.update(gemma_kernel_phase(seed))
    main.update(mla_kernel_phase(seed))
    return main


#: Gemma-2's attention logit softcap (``attn_logit_softcapping``)
GEMMA_CAP = 50.0
#: a capped case's queries are scaled by this: unit-variance q and k give
#: scores of about N(0, 1) after the 1/sqrt(hd) scale, where a cap of 50
#: moves a score by under 0.01 and no check could tell a kernel with the
#: cap from one without it; at N(0, 144) the top scores reach 30-50, where
#: the cap bends them by several units (the controls of cap_controls show
#: it on every capped case)
CAP_Q_GAIN = 12.0


def bent(case, key: str = "q"):
    """The case with its queries scaled by CAP_Q_GAIN (exact in bf16)."""
    return dict(case, **{key: case[key] * CAP_Q_GAIN})


def gemma_kernel_phase(seed: int) -> dict:
    """The GQA kernels at head dim 256 and with the attention softcap
    (Gemma-2), and at a group of 7 (Qwen2-7B); returns the Gemma-2-9B
    cases of each kernel by name (``*_gemma2``). Every capped case runs
    on queries scaled by CAP_Q_GAIN (``q x12`` in its label), where the
    cap bends the scores, with the controls of :func:`cap_controls`."""
    main = {}
    cap = GEMMA_CAP
    log("kernel phase: head dim 256 and the softcap (ragged, paged decode, "
        "flash prefill)")
    small = [(1, 20), (6, 24), (1, 9), (11, 11), (37, 80)]
    for dtype in (torch.float32, torch.bfloat16):
        case = make_case(small, H=8, KV=2, hd=256, bs=16, dtype=dtype,
                         pad_rows=3, pad_tokens=5, seed=seed + 60)
        name = f"small {str(dtype)[6:]} hd=256"
        for window, sinks, c in ((0, False, 0.0), (7, False, 0.0),
                                 (0, True, 0.0), (0, False, cap),
                                 (7, True, cap)):
            check_ragged(f"{name} window={window} sinks={sinks} "
                         f"softcap={c:g}{' q x12' if c else ''}",
                         bent(case) if c else case, window, sinks, iters=3,
                         softcap=c)
        for c in (0.0, cap):
            check_ragged(f"{name} int8 pages window=7 sinks=True "
                         f"softcap={c:g}{' q x12' if c else ''}",
                         int8_case(bent(case) if c else case), 7, True,
                         iters=3, softcap=c)
    # tile edges at hd 256 (groups 1 and 2), and a group of 7 at hd 128
    # (Qwen2-7B: 9 tokens x 7 heads = 63 of the 64 rows)
    edge_rows = [(1, 0), (1, 1), (1, 17), (1, 2000), (45, 45), (37, 1300)]
    for G, KV, hd in ((1, 2, 256), (2, 2, 256), (7, 4, 128)):
        case = make_case(edge_rows, H=G * KV, KV=KV, hd=hd, bs=16,
                         dtype=torch.bfloat16, pad_rows=1, pad_tokens=3,
                         seed=seed + 70 + G)
        c = cap if hd == 256 else 0.0
        if c:
            case = bent(case)
        q12 = " q x12" if c else ""
        check_ragged(f"tile edges G={G} hd={hd} bf16 window=100 sinks=True "
                     f"softcap={c:g}{q12}", case, 100, True, iters=3,
                     softcap=c)
        check_ragged(f"tile edges G={G} hd={hd} int8 pages window=100 "
                     f"sinks=True softcap={c:g}{q12}, rebased scales",
                     int8_case(case, rebase=True), 100, True, iters=3,
                     softcap=c)
    dcase = make_case([(1, 0), (1, 16), (1, 700), (1, 9)], H=8, KV=2,
                      hd=256, bs=16, dtype=torch.float32, pad_rows=0,
                      pad_tokens=0, seed=seed + 61)
    check_decode("paged decode small float32 hd=256 kv_len 0 row window=7 "
                 "sinks=True softcap=50 q x12", bent(dcase), 7, True,
                 iters=3, softcap=cap)
    for dtype in (torch.float32, torch.bfloat16):
        case = make_dense(3, 48, 700, 8, 2, 256, dtype, (600, 0, 0),
                          (648, 0, 500), seed + 62)
        name = f"flash small {str(dtype)[6:]} hd=256"
        check_flash(name, case, iters=3)
        check_flash(f"{name} window=33 sinks=True softcap=50 q x12",
                    bent(case), 33, True, iters=3, softcap=cap)
    case = make_dense(4, 45, 300, 2, 2, 256, torch.bfloat16,
                      (0, 255, 0, 100), (45, 300, 0, 131), seed + 63)
    check_flash("flash tile edges G=1 hd=256 bf16 window=100 sinks=True "
                "softcap=50 q x12", bent(case), 100, True, iters=3,
                softcap=cap)

    # Gemma-2-9B attention geometry (H 16, KV 8, hd 256, softcap 50;
    # sliding window 4096 on even layers): decode rows at kv 1000 and 6000
    # (the window masks 1904 of the latter's keys), a fresh 512-token
    # prefill, a 128-token chunk at kv 2048; queries scaled by CAP_Q_GAIN
    rng = np.random.default_rng(seed + 64)
    geo = dict(H=16, KV=8, hd=256, bs=16, dtype=torch.bfloat16)
    gemma = bent(make_case([(1, 1000), (1, 6000), (512, 512), (128, 2048)],
                           pad_rows=4, pad_tokens=6, seed=seed + 65, **geo))
    main["ragged_paged_attention_gemma2"] = check_ragged(
        "gemma2_9b mixed bf16 window=4096 softcap=50 q x12", gemma, 4096,
        softcap=cap, yardstick=True)
    check_ragged("gemma2_9b mixed bf16 softcap=50 q x12 (a global layer)",
                 gemma, softcap=cap, iters=10)
    main["ragged_paged_attention_int8_gemma2"] = check_ragged(
        "gemma2_9b mixed int8 pages window=4096 softcap=50 q x12",
        int8_case(gemma), 4096, softcap=cap, yardstick=True)
    decode = bent(make_case([(1, int(k)) for k in rng.integers(65, 1057, 8)],
                            pad_rows=0, pad_tokens=0, seed=seed + 66, **geo))
    check_ragged("gemma2_9b 8 decode rows bf16 softcap=50 q x12", decode,
                 softcap=cap)
    check_ragged("gemma2_9b 8 decode rows int8 pages softcap=50 q x12",
                 int8_case(decode), softcap=cap, iters=10)
    lens = [2048] + [int(x) for x in rng.integers(100, 2049, 7)]
    emb = bent(make_dense(8, 2048, 2048, 16, 8, 256, torch.bfloat16, [0] * 8,
                          lens, seed + 67))
    main["flash_prefill_gemma2"] = check_flash(
        f"gemma2_9b embed bf16 softcap=50 q x12 lengths {lens}", emb, iters=10,
        softcap=cap, yardstick=True)
    kvs = [int(k) for k in rng.integers(900, 1101, 8)]
    dec = bent(make_case([(1, k) for k in kvs], pad_rows=0, pad_tokens=0,
                         seed=seed + 68, **geo))
    main["paged_attention_decode_gemma2"] = check_decode(
        f"gemma2_9b 8 decode rows bf16 softcap=50 q x12 kv {kvs}", dec,
        softcap=cap, yardstick=True)
    check_decode("gemma2_9b 8 decode rows int8 pages window=4096 "
                 "softcap=50 q x12", int8_case(dec), 4096, iters=5,
                 softcap=cap)
    return main


def mla_decode_kvs(seed: int) -> list:
    """The kv_lens of the DeepSeek-V2-Lite decode case: the generator's
    fourth draw after the GQA cases' three, as the kernel phase has drawn
    them since the MLA kernels came (8 rows at kv 73-2582 for seed 0)."""
    rng = np.random.default_rng(seed)
    rng.integers(65, 1057, 8)
    rng.integers(100, 2049, 7)
    rng.integers(900, 1101, 8)
    return [int(k) for k in rng.integers(65, 3001, 8)]


def mla_kernel_phase(seed: int) -> dict:
    """The MLA kernels' cases of the kernel phase; returns the main case of
    each by name."""
    main = {}
    log("kernel phase: mla_paged_decode vs mla_paged_decode_ref")
    v2 = dict(H=16, R=512, PR=128, rope_dim=64, bs=16)
    for dtype in (torch.float32, torch.bfloat16):
        # a kv_len 0 row, a one-page row, a long row split over CTAs
        check_mla(f"{str(dtype)[6:]} kv 0, 16, 3000, 9", make_mla(
            [0, 16, 3000, 9], dtype=dtype, seed=seed + 8, **v2), iters=5)
    # the whole rope width read (R + PR = 640: the 32-key tiles)
    whole = make_mla([0, 16, 3000, 9], dtype=torch.bfloat16, seed=seed + 8,
                     live=False, **v2)
    check_mla("bf16 kv 0, 16, 3000, 9, whole rope width", whole, iters=5)
    check_mla("int8 pages kv 0, 16, 3000, 9, whole rope width",
              mla_int8(whole), iters=5)
    check_mla("bf16 H=32 R=128 PR=64 kv 0, 16, 3000, 9", make_mla(
        [0, 16, 3000, 9], H=32, R=128, PR=64, rope_dim=64, bs=16,
        dtype=torch.bfloat16, seed=seed + 9), iters=5)
    kvs = mla_decode_kvs(seed)
    v2_case = make_mla(kvs, dtype=torch.bfloat16, seed=seed + 10, **v2)
    main["mla_paged_decode"] = check_mla(
        f"deepseek_v2_lite 8 decode rows bf16 kv {kvs}", v2_case)
    mla_controls(v2_case)

    log("kernel phase: mla_paged_decode on int8 pages")
    main["mla_paged_decode_int8"] = check_mla(
        f"deepseek_v2_lite 8 decode rows int8 pages kv {kvs}",
        mla_int8(v2_case))
    check_mla("deepseek_v2_lite 8 decode rows int8 pages, rebased scales",
              mla_int8(v2_case, rebase=True), iters=5)
    check_mla("kv 0, 16, 3000, 9 int8 pages, rebased scales", mla_int8(
        make_mla([0, 16, 3000, 9], dtype=torch.float32, seed=seed + 8, **v2),
        rebase=True), iters=5)

    log("kernel phase: flash_mla_prefill vs flash_mla_prefill_ref")
    geo = dict(H=16, R=512, PR=128, rope_dim=64)
    for dtype in (torch.float32, torch.bfloat16):
        # a chunk deep into its context (S < T, pos_base > 0), a kv_len 0
        # row, a row whose last query tile straddles kv_len
        case = make_mla_prefill([(0, 600, 640), (1, 0, 0), (2, 5, 30)],
                                S=40, bs=16, dtype=dtype, seed=seed + 20,
                                dense_T=700, **geo)
        check_mla_prefill(f"small dense {str(dtype)[6:]}", case, iters=5)
    rows = mla_grid_rows([(600, 40), (0, 30), (1000, 3)], spare=2)
    small = make_mla_prefill(rows, S=32, bs=16, dtype=torch.bfloat16,
                             seed=seed + 21, **geo)
    check_mla_prefill("small chunk grid int8 pages, rebased scales",
                      mla_int8(small, rebase=True), iters=5)
    whole = make_mla_prefill(rows, S=32, bs=16, dtype=torch.bfloat16,
                             seed=seed + 21, live=False, **geo)
    check_mla_prefill("small chunk grid bf16, whole rope width", whole,
                      iters=5)
    check_mla_prefill("small chunk grid int8 pages, whole rope width",
                      mla_int8(whole), iters=5)
    check_mla_prefill("small chunk grid f32 pages", make_mla_prefill(
        rows, S=32, bs=16, dtype=torch.float32, seed=seed + 22, **geo),
        iters=5)
    # DeepSeek-V2-Lite: a dense 2 x 1024-token prefill (embeddings, the
    # S > 1 forward) and a chunk grid of 68 tiles of 32 tokens at kv up to
    # 3000 (the ragged step's chunk tokens)
    dense = make_mla_prefill([(0, 0, 1024), (1, 0, 1024)], S=1024, bs=16,
                             dtype=torch.bfloat16, seed=seed + 23,
                             dense_T=1024, **geo)
    check_mla_prefill("deepseek_v2_lite dense 2 x 1024 bf16", dense,
                      iters=10)
    chunks = [(1976, 1024), (0, 512), (1500, 480), (900, 100)]
    grid = make_mla_prefill(mla_grid_rows(chunks, spare=1), S=32, bs=16,
                            dtype=torch.bfloat16, seed=seed + 24, **geo)
    main["flash_mla_prefill"] = check_mla_prefill(
        f"deepseek_v2_lite chunk grid {len(grid['rows'])} tiles x 32 bf16, "
        f"chunks (start, tokens) {chunks}", grid)
    mla_controls(grid)
    check_mla_prefill("deepseek_v2_lite chunk grid int8 pages",
                      mla_int8(grid), iters=10)
    return main


# seeded draw -------------------------------------------------------------


def _draw_operands(temp, keys):
    """The draw kernel's per-row operands on the card: temperature floored
    at 1e-6 (as the sampler divides), and the key words as int32 bits."""
    k = torch.from_numpy(np.ascontiguousarray(keys).view(np.int32))
    return (torch.from_numpy(np.maximum(temp, 1e-6)).cuda(),
            k[:, 0].contiguous().cuda(), k[:, 1].contiguous().cuda())


def sample_kernel_phase(seed: int) -> dict:
    """The seeded draw: jax.random's known answers (the plain version's
    threefry words and uniforms, the kernel's tokens), then the kernel
    against its plain version at the serving shape [8, 128256] with the
    top-k/top-p cuts of a mixed batch, and its time beside its bound."""
    log("kernel phase: gumbel_argmax vs gumbel_argmax_ref and jax.random")
    dev = "cuda"
    for (sd, st), words in SAMPLE_KNOWN["bits"].items():
        bits = random_bits_ref(torch.tensor([sd], device=dev),
                               torch.tensor([st], device=dev), len(words))[0]
        u = uniform_ref(bits).view(torch.int32)
        if (bits.tolist() != words
                or u.tolist() != SAMPLE_KNOWN["uniform"][sd, st]):
            raise AssertionError(f"threefry words or uniforms of key "
                                 f"({sd}, {st}) differ from jax.random's")
    lg, temp, keys = known_draw_inputs()
    t, sd, st = _draw_operands(temp, keys)
    lg = torch.from_numpy(lg).cuda()
    ninf = torch.full((8,), float("-inf"), device=dev)
    got = gumbel_argmax(lg, t, ninf, sd, st).tolist()
    if got != SAMPLE_KNOWN["tokens"]:
        raise AssertionError(f"kernel tokens {got}, jax.random's "
                             f"{SAMPLE_KNOWN['tokens']}")
    log(f"  known answers: the threefry words and uniforms of "
        f"{len(SAMPLE_KNOWN['bits'])} keys and the 8 tokens of an "
        f"[8, 128256] draw equal jax.random's")

    rng = np.random.default_rng(seed + 91)
    B, V = 8, 128256
    lg = torch.from_numpy((rng.standard_normal((B, V)) * 2).astype(
        np.float32)).cuda()
    temp = np.asarray([0.6, 0.8, 1.0, 1.2, 0.7, 0.9, 1.1, 1.3], np.float32)
    top_k = torch.tensor([0, 40, 0, 64, 0, 5, 0, 20], dtype=torch.int32,
                         device=dev)
    top_p = torch.tensor([1.0, 1.0, 0.9, 1.0, 0.5, 1.0, 0.95, 0.8],
                         device=dev)
    keys = sampling.make_keys(rng.integers(0, 2**31, B),
                              rng.integers(0, 4096, B))
    t, sd, st = _draw_operands(temp, keys)
    scaled = lg / t[:, None]
    cut = sampling._mask_top_k(scaled, top_k, ninf)
    masked = torch.where(scaled >= cut[:, None], scaled, float("-inf"))
    cut = torch.maximum(cut, sampling._mask_top_p(masked, top_p, cut))
    nbytes = B * V * 4 + B * 4 * 4 + B * 8
    bound = bound_of(nbytes, B * V * SAMPLE_OPS_PER_ELEMENT, torch.float32)
    res = measure("gumbel_argmax [8, 128256], top-k and top-p cuts on 6 of "
                  "8 rows (tokens must be equal)",
                  lambda: gumbel_argmax(lg, t, cut, sd, st),
                  lambda: gumbel_argmax_ref(lg, t, cut, sd, st),
                  None, bound, 0.0, iters=50)
    return {"gumbel_argmax": res}


# ------------------------------------------------------------------ phase 3


class StepClock:
    """Records each ``_execute`` of an engine: its start and end on the host
    clock, the full-depth forward steps it ran (the pipelined loop runs many
    in one, a burst K, a spec round its verify forwards), whether its plan
    held prefill chunks, the requests running and waiting after it (as the
    engine's load metrics report them), and its verify forwards."""

    def __init__(self, engine):
        self.records = []
        #: executes running now (the engine counts a step when one returns)
        self.inflight = 0
        run = engine._execute

        async def timed(plan):
            f0, t0 = engine.forward_steps, time.perf_counter()
            v0 = engine.verify_steps
            self.inflight += 1
            try:
                await run(plan)
            finally:
                self.inflight -= 1
            self.records.append((t0, time.perf_counter(),
                                 engine.forward_steps - f0
                                 + engine.verify_steps - v0,
                                 bool(plan.prefill),
                                 len(engine.scheduler.running),
                                 engine.scheduler.num_waiting(),
                                 engine.verify_steps - v0))

        engine._execute = timed

    def decode_step_ms(self) -> tuple[float, int]:
        """Host wall of the run's last stretch of decode-only steps (from
        the first one's start to the last one's end, the loop's work
        between them included) over its forward steps: the decode step wall
        under serving, pipelined or not, and a burst's wall per token."""
        stretch = []
        for rec in reversed(self.records):
            if rec[3]:
                break
            stretch.append(rec)
        if not stretch:
            raise AssertionError("the run had no decode-only step")
        steps = sum(r[2] for r in stretch)
        return (stretch[0][1] - stretch[-1][0]) / steps * 1e3, steps

    def spec_round_ms(self) -> tuple[float, int]:
        """Mean host wall of the run's spec rounds (draft, verify and the
        host's part), and their count (nan, 0 without one)."""
        walls = [r[1] - r[0] for r in self.records if r[6] and not r[3]]
        if not walls:
            return math.nan, 0
        return statistics.mean(walls) * 1e3, len(walls)

    def admission(self, n: int = 4) -> list:
        """(running, waiting) after each of the run's first ``n`` steps:
        the requests admitted, and those that had arrived and waited."""
        return [tuple(r[4:6]) for r in self.records[:n]]


def serving_stats(res, wall: float) -> dict:
    ttft = [st[0] - t0 for t0, st, _, _ in res]
    itl = [b - a for _, st, _, _ in res for a, b in zip(st, st[1:])]
    return {"ttft_mean": statistics.mean(ttft) * 1e3,
            "ttft_max": max(ttft) * 1e3,
            "itl_mean": statistics.mean(itl) * 1e3,
            "itl_p50": statistics.median(itl) * 1e3,
            "tok_s": sum(len(r[2]) for r in res) / wall, "wall": wall}


def stats_line(st: dict) -> str:
    line = (f"TTFT mean {st['ttft_mean']:.2f} ms max {st['ttft_max']:.2f} "
            f"ms; ITL mean {st['itl_mean']:.2f} ms p50 {st['itl_p50']:.2f} "
            f"ms; {st['tok_s']:.2f} tok/s over {st['wall']:.2f} s")
    if "step_ms" in st:
        line += (f"; decode step wall {st['step_ms']:.3f} ms "
                 f"({st['step_n']} decode-only steps)")
    return line


async def serve(engine, model, prompts, max_tokens, events=None,
                solo=(), extra=None, compare_eager=False):
    """One short warm-up request (cuBLAS handles, allocator growth), then
    the kernels' counts set to 0 and the prompts served concurrently;
    returns the streams, the wall time, the steps of the measured run, those
    of them with chunk tokens, the launches of each kernel wrapper in it,
    and the run's stats (with the requests running and waiting after its
    first steps).

    Then the prompts again on the serial loop (``pipeline_decode`` off) on
    an emptied prefix cache: each of the streams must equal the pipelined
    run's (the plans, the packing and so every step's shapes are the
    same). ``solo`` (indices into ``prompts``) adds each solo prompt served
    alone on both loops, each run on an emptied prefix cache; the KV
    blocks the pipelined solo runs store are returned with them (from
    ``events``).

    ``compare_eager`` then serves the prompts on the pipelined loop with
    the engine's graphs off (``use_graphs``), then on again: their streams
    must equal the first run's, and both runs' stats are
    ``out["eager_vs_graphs"]`` (False: eager, True: captured; both after
    the first run, so neither pays a first use of a signature).

    ``extra``, an async function of (engine, clock, settle, out), runs
    last, on the same engine and loop; what it returns is
    ``out["extra"]``."""
    async def one(p, n):
        req = PreprocessedRequest(
            model=model, token_ids=p,
            stop_conditions=StopConditions(max_tokens=n, ignore_eos=True))
        t0 = time.perf_counter()
        stamps, toks, reason = [], [], None
        async for out in engine.generate(req):
            stamps.append(time.perf_counter())
            toks.extend(out.token_ids)
            reason = out.finish_reason or reason
        return t0, stamps, toks, reason

    clock = StepClock(engine)

    async def run(pipeline: bool):
        engine.args.pipeline_decode = pipeline
        engine.pool.clear()  # every run computes its prompts
        clock.records.clear()
        t0 = time.perf_counter()
        res = await asyncio.gather(*(one(p, max_tokens) for p in prompts))
        st = serving_stats(res, time.perf_counter() - t0)
        # the loop's last step recorded too: when a long request decodes
        # alone at the end, its pipelined steps are the run's only
        # decode-only stretch, and that execute returns after the streams
        await settle()
        st["step_ms"], st["step_n"] = clock.decode_step_ms()
        return res, st

    async def settle():
        """Until the engine's loop has counted its last step: a stream ends
        at the commit that finished it, and the pipelined loop then commits
        the step it launched behind that one."""
        while clock.inflight or engine.scheduler.has_work:
            await asyncio.sleep(0.001)

    try:
        await one(list(range(1, 17)), 2)  # shares no prefix with prompts
        await settle()
        steps0, chunk_steps0 = engine.forward_steps, engine.chunk_steps
        reset_counts()
        res, st = await run(True)
        await settle()
        launches = {k["wrapper"]: k["wrapper"].launches for k in KERNELS}
        st["admission"] = clock.admission()
        out = {"res": res, "stats": st,
               "steps": engine.forward_steps - steps0,
               "chunk_steps": engine.chunk_steps - chunk_steps0,
               "launches": launches}
        res_off, out["stats_serial"] = await run(False)
        await settle()
        for i, (on, off) in enumerate(zip(res, res_off)):
            if on[2] != off[2]:
                raise AssertionError(
                    f"stream {i}: the pipelined loop gave {on[2]}, the "
                    f"serial loop {off[2]}")
        if solo:
            streams = {}
            for pipeline in (True, False):
                engine.args.pipeline_decode = pipeline
                for i in solo:
                    engine.pool.clear()
                    n0 = len(events)
                    streams[pipeline, i] = (await one(prompts[i],
                                                      max_tokens))[2]
                    if pipeline:
                        out.setdefault("solo_hashes", set()).update(
                            b.block_hash for e in events[n0:]
                            for b in e.stored_blocks)
            engine.args.pipeline_decode = True
            for i in solo:
                if streams[True, i] != streams[False, i]:
                    raise AssertionError(
                        f"solo prompt {i}: the pipelined loop gave "
                        f"{streams[True, i]}, the serial loop "
                        f"{streams[False, i]}")
            out["solo"] = [(prompts[i], streams[True, i]) for i in solo]
        if compare_eager:
            out["eager_vs_graphs"] = {}
            for graphs in (False, True):
                engine.use_graphs = graphs
                res_g, out["eager_vs_graphs"][graphs] = await run(True)
                await settle()
                for i, (a, b) in enumerate(zip(res, res_g)):
                    if a[2] != b[2]:
                        raise AssertionError(
                            f"stream {i}: graphs {graphs} gave {b[2]}, the "
                            f"first run {a[2]}")
            engine.use_graphs = True
        # the captures of the greedy runs (sampled and burst runs capture
        # their own samplers and bursts: each checks its measured runs)
        out["captures_greedy"] = dict(engine.compile_events)
        if extra is not None:
            out["extra"] = await extra(engine, clock, settle, out)
        return out
    finally:
        await engine.close()


#: the phase 3 prompts served alone on both decode loops, whose streams the
#: worker phase must reproduce
SOLO = (0, 5)


def serving_phase(seed: int, smi: str, kv_cache_dtype=None,
                  model: str = "llama3_8b", params=None,
                  solo: bool = False, extra=None,
                  compare_eager: bool = False, warmup: bool = False,
                  spec_k: int = 0, cfg=None, max_model_len: int = 4096,
                  prompts=None, quantization=None, kv_fraction: float = 0.6):
    """Eight concurrent greedy requests at full width (on ``params``, or
    weights drawn from ``seed``); returns the engine, its attention
    kernels' launches in the run by wrapper name, the streams, and what
    ``serve`` returns (the serial loop's stats, and with ``solo`` the solo
    streams). The pipelined and the serial loop must give the same
    streams. The ragged kernel (GQA), or the MLA decode kernel, must
    launch once a layer every step; an MLA model's prefill kernel once a
    layer in every step with chunk tokens; no other kernel at all. Steps
    run as the engine's captured graphs (a replay counts the launches it
    holds); ``compare_eager`` adds an eager and a captured run of the
    same requests (``serve``). ``warmup`` runs ``engine.warmup()`` first,
    and then no greedy request may capture anything (the sampled and
    burst runs of ``extra`` check their measured runs themselves).
    ``spec_k`` makes the engine with ``speculative_tokens=spec_k`` (its
    staging buffer and verify scratch sized for it) and sets it to 0 at
    once: :func:`spec_serving` switches it on. ``cfg`` (default: the
    preset ``model``), ``max_model_len`` and ``prompts`` (default:
    :func:`serving_prompts`) serve another model or other requests.
    ``quantization`` draws the weights quantized on the card: the
    dequant-GEMM must then launch once for each quantized weight of each
    layer and for a quantized head every step. ``kv_fraction`` is the
    pool's share of the memory left free after the weights."""
    cfg = cfg or get_model_config(model)
    args = EngineArgs(block_size=16, max_num_seqs=8,
                      max_num_batched_tokens=2048,
                      max_model_len=max_model_len,
                      seed=seed, kv_cache_dtype=kv_cache_dtype,
                      speculative_tokens=spec_k, quantization=quantization,
                      kv_cache_memory_fraction=kv_fraction)
    label = (f"{model}, {quantization + ' weights, ' if quantization else ''}"
             f"{kv_cache_dtype or cfg.dtype} KV")
    t0 = time.perf_counter()
    events = []
    engine = AsyncTorchEngine(cfg, args, params=params,
                              event_cb=events.append)
    args.speculative_tokens = 0
    torch.cuda.synchronize()
    n_params, qbytes, _ = weight_stats(engine.params)
    resident = sum(t.numel() * t.element_size()
                   for t in _leaves(engine.params))
    block_bytes = kv_block_bytes(cfg, args.block_size, engine.dtype,
                                 kv_cache_dtype)
    (kh, kd), (vh, vd) = cfg.kv_cache_spec
    shape = (f"MLA r{cfg.kv_lora_rank} rope{cfg.qk_rope_head_dim} "
             f"E{cfg.num_experts} top{cfg.num_experts_per_tok} "
             f"Fm{cfg.moe_ffn_size} shared{cfg.n_shared_experts} "
             f"dense prefix {cfg.num_dense_prefix_layers}"
             if cfg.is_mla else f"KV{cfg.num_kv_heads} hd{cfg.head_dim}")
    log(f"serving phase ({label}): V{cfg.vocab_size} D{cfg.hidden_size} "
        f"F{cfg.intermediate_size} L{cfg.num_layers} H{cfg.num_heads} "
        f"{shape} {cfg.dtype}: {resident / 1e9:.2f} GB of random "
        f"weights ({n_params / 1e9:.2f} B parameters"
        + (f"; {qbytes / 1e9:.2f} GB of them quantized q and s"
           if quantization else "")
        + f"; {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated), "
        f"{engine.num_blocks} KV blocks of {block_bytes} bytes "
        f"([{kh}, {kd}] + [{vh}, {vd}] a slot a layer; "
        f"{engine.num_blocks * block_bytes / 1e9:.2f} GB, "
        f"{engine.num_blocks * args.block_size} tokens), set up in "
        f"{time.perf_counter() - t0:.1f} s")
    if warmup:
        rep = asyncio.run(engine.warmup())
        warm = dict(engine.compile_events)
        log(f"  [{smi}] warmup(): {len(rep['ragged'])} step signatures "
            f"(each ragged token bucket {list(args.ragged_token_buckets)} "
            f"as a mixed and a decode-only step) and the greedy sampler of "
            f"rows {rep['sample']} in {rep['seconds']:.2f} s: "
            f"{graph_line(engine)}")
        if (sorted(rep["ragged"]) != sorted(set(rep["ragged"]))
                or len(engine.graphs) != len(rep["ragged"])
                + len(rep["sample"])):
            raise AssertionError(f"warmup report {rep}, {len(engine.graphs)} "
                                 f"graphs")
    prompts = prompts or serving_prompts(cfg, seed)
    max_tokens = 32
    out = asyncio.run(serve(engine, model, prompts, max_tokens, events,
                            SOLO if solo else (), extra, compare_eager))
    if warmup and out["captures_greedy"] != warm:
        raise AssertionError(f"captures after warmup: {warm} -> "
                             f"{out['captures_greedy']}")
    res, steps, chunk_steps = out["res"], out["steps"], out["chunk_steps"]
    # launches each attention wrapper must show: one a layer per step (per
    # step with chunk tokens for the MLA prefill kernel), none elsewhere
    L = cfg.num_layers
    want = ({mla_paged_decode: L * steps,
             flash_mla_prefill_paged: L * chunk_steps} if cfg.is_mla
            else {ragged_paged_attention: L * steps})
    if quantization:
        want[quant_matmul] = quant_calls(engine.params) * steps
    launches = {w.__name__: out["launches"][w] for w in want}
    other = {k["name"]: out["launches"][k["wrapper"]] for k in KERNELS
             if k["wrapper"] not in want}

    for i, (_t0, _st, toks, reason) in enumerate(res):
        if reason != "length" or len(toks) != max_tokens:
            raise AssertionError(f"stream {i}: finish {reason!r} after "
                                 f"{len(toks)} tokens, want length/"
                                 f"{max_tokens}")
    for w, n in want.items():
        if n == 0 or out["launches"][w] != n:
            raise AssertionError(f"{w.__name__} launched "
                                 f"{out['launches'][w]} times in {steps} "
                                 f"steps ({chunk_steps} with chunk tokens), "
                                 f"want {n}")
    if any(other.values()):
        raise AssertionError(f"serving launched other kernels: {other}")
    stored = sum(len(e.stored_blocks) for e in events)
    if stored == 0:
        raise AssertionError("no KV stored events")
    log(f"  [{smi}] {label}: {len(prompts)} streams x {max_tokens} "
        f"tokens, prompts "
        f"{sorted(len(p) for p in prompts)} (after a warm-up request): "
        f"{steps} ragged steps ({chunk_steps} with chunk tokens), "
        f"launches {launches}, {stored} KV blocks stored")
    log(f"  [{smi}] {label}, pipelined decode loop: "
        f"{stats_line(out['stats'])}")
    log(f"  [{smi}] {label}, serial decode loop: "
        f"{stats_line(out['stats_serial'])}")
    log("  the 8 streams are the same on both loops")
    if compare_eager:
        eager, graphs = (out["eager_vs_graphs"][g] for g in (False, True))
        log(f"  [{smi}] {label}, pipelined, eager steps: {stats_line(eager)}")
        log(f"  [{smi}] {label}, pipelined, captured steps: "
            f"{stats_line(graphs)}")
        log(f"  [{smi}] {label}, eager vs captured (same 8 streams): decode "
            f"step wall {eager['step_ms']:.3f} vs {graphs['step_ms']:.3f} "
            f"ms, ITL mean {eager['itl_mean']:.2f} vs "
            f"{graphs['itl_mean']:.2f} ms, p50 {eager['itl_p50']:.2f} vs "
            f"{graphs['itl_p50']:.2f} ms, {eager['tok_s']:.2f} vs "
            f"{graphs['tok_s']:.2f} tok/s, TTFT mean "
            f"{eager['ttft_mean']:.2f} vs {graphs['ttft_mean']:.2f} ms")
    log(f"  [{smi}] {label}: {graph_line(engine)}")
    if warmup:
        log(f"  no greedy run captured anything after warmup: "
            f"{out['captures_greedy']}")
    if solo:
        log(f"  solo prompts {[len(p) for p, _ in out['solo']]} tokens: the "
            f"same {max_tokens} tokens on both loops; "
            f"{len(out['solo_hashes'])} KV blocks stored")
    return engine, launches, [r[2] for r in res], out


def graph_line(engine) -> str:
    """The engine's captured graphs: how many, of which kind, the seconds
    of their captures (eager first uses included) and their pool."""
    g = engine.graphs
    return (f"{len(g)} graphs captured {engine.compile_events}, "
            f"{g.seconds:.2f} s with their eager first uses "
            f"{ {k: round(v, 2) for k, v in engine.compile_seconds.items()} }"
            f", graph pool {g.pool_bytes / 2**20:.1f} MiB")


#: the sampled requests: (temperature, top_k, top_p), each with its own
#: seed
SAMPLED = [(0.6, 0, 1.0), (0.8, 40, 1.0), (1.0, 0, 0.9), (1.2, 64, 1.0),
           (0.7, 0, 0.5), (0.9, 5, 1.0), (1.1, 0, 0.95), (1.3, 20, 0.8)]
#: the guided request's schema: bounded, so every stream ends at "}"
GUIDED_SCHEMA = {"type": "object", "properties": {
    "ok": {"type": "boolean"}, "tag": {"enum": ["red", "green", "blue"]},
    "n": {"enum": [1, 2, 3]}}}


async def stream(engine, model, tokens, n, sampling=None, output=None,
                 eos=(), frames=None):
    """One request; (start, token arrival stamps, tokens, finish reason),
    its output frames appended to ``frames``."""
    req = PreprocessedRequest(
        model=model, token_ids=tokens,
        sampling_options=sampling or SamplingOptions(),
        output_options=output or OutputOptions(),
        stop_conditions=StopConditions(max_tokens=n, ignore_eos=not eos),
        eos_token_ids=list(eos))
    t0 = time.perf_counter()
    stamps, toks, reason = [], [], None
    async for out in engine.generate(req):
        stamps.append(time.perf_counter())
        toks.extend(out.token_ids)
        reason = out.finish_reason or reason
        if frames is not None:
            frames.append(out)
    return t0, stamps, toks, reason


def synthetic_vocab(V: int, seed: int) -> list:
    """A guided alphabet of V entries (no tokenizer file is in the
    repository): the printable ASCII characters, a few JSON pieces, random
    lowercase words of 2-6 letters, and "" for Llama-3's EOS ids."""
    rng = np.random.default_rng(seed + 5)
    vocab = [chr(32 + i) for i in range(95)]
    vocab += ['{"', '":', '",', '"}', "true", "false", "ok", "tag", "red",
              "green", "blue"]
    n = V - len(vocab)
    letters = rng.integers(97, 123, (n, 6), dtype=np.uint8)
    lens = rng.integers(2, 7, n)
    vocab += [bytes(row[:k]).decode() for row, k in zip(letters, lens)]
    for e in LLAMA3_EOS:
        vocab[e] = ""
    return vocab


def sampled_options(seed: int) -> list:
    """The eight sampled requests' options (SAMPLED), each with its seed."""
    return [SamplingOptions(temperature=t, top_k=k or None, top_p=p,
                            seed=seed * 8 + i + 1)
            for i, (t, k, p) in enumerate(SAMPLED)]


async def burst_serving(engine, model, prompts, clock, settle, smi: str,
                        seed: int, served: dict, sampled: dict,
                        K: int = 4) -> dict:
    """``multi_step_decode`` = K on the same engine: the eight greedy
    requests, then the eight seeded sampled ones. Every stream must equal
    the K = 1 run's (``served``, ``sampled``), decode-only plans must run
    as bursts, the ragged kernel must launch once a layer a forward step (K
    a burst) and the draw kernel at least once a sampled burst step.
    Returns each run's stats; its decode step wall is per token (forward
    steps), printed beside the K = 1 captured runs'."""
    L = engine.cfg.num_layers
    engine.args.multi_step_decode = K
    out = {}
    try:
        # a short greedy and a short sampled request first (one row makes
        # the same 8-row burst, the same sampler branches as the batch):
        # the bursts' first uses and captures stay out of the measured runs,
        # as serve()'s warm-up request keeps the steps'
        for o in (None, SamplingOptions(temperature=0.7, top_k=20,
                                        top_p=0.9, seed=1)):
            await stream(engine, model, list(range(1, 17)), 2 + K, o)
        await settle()
        bursts_captured = engine.compile_events.get("multi")
        for name, opts, want in (
                ("greedy", [None] * len(prompts),
                 [r[2] for r in served["res"]]),
                ("sampled", sampled_options(seed), sampled["streams"])):
            engine.pool.clear()
            clock.records.clear()
            reset_counts()
            f0, b0 = engine.forward_steps, engine.bursts
            t0 = time.perf_counter()
            res = await asyncio.gather(*(stream(engine, model, p, 32, o)
                                         for p, o in zip(prompts, opts)))
            st = serving_stats(res, time.perf_counter() - t0)
            st["step_ms"], st["step_n"] = clock.decode_step_ms()
            await settle()
            fwd, bursts = engine.forward_steps - f0, engine.bursts - b0
            ragged, draws = (ragged_paged_attention.launches,
                             gumbel_argmax.launches)
            for i, (r, w) in enumerate(zip(res, want)):
                if r[3] != "length" or r[2] != w:
                    raise AssertionError(
                        f"{name} stream {i}, K = {K}: {r[2]} ({r[3]}), "
                        f"K = 1: {w}")
            if (bursts == 0 or ragged != L * fwd
                    or (name == "sampled" and draws < K * bursts)):
                raise AssertionError(
                    f"{name}, K = {K}: {bursts} bursts in {fwd} forward "
                    f"steps, ragged launches {ragged} (want {L * fwd}), "
                    f"draw launches {draws}")
            log(f"  [{smi}] {model}, multi_step_decode={K}, 8 {name} "
                f"streams x 32 tokens equal to K = 1's: {bursts} bursts, "
                f"{fwd} forward steps, launches ragged {ragged}, draw "
                f"{draws}; {stats_line(st)}")
            out[name] = st
        if engine.compile_events.get("multi") != bursts_captured:
            raise AssertionError(f"a burst was captured in a measured run: "
                                 f"{engine.compile_events}")
    finally:
        engine.args.multi_step_decode = 1
    k1 = (served["eager_vs_graphs"][True] if "eager_vs_graphs" in served
          else served["stats"])
    log(f"  [{smi}] {model}, decode wall per token, captured: K = 1 "
        f"{k1['step_ms']:.3f} (greedy) / {sampled['stats']['step_ms']:.3f} "
        f"(sampled) ms, K = {K} burst {out['greedy']['step_ms']:.3f} / "
        f"{out['sampled']['step_ms']:.3f} ms")
    return out


# ------------------------------------------------------ speculative decoding

#: draft tokens a spec round on the card
SPEC_K = 4
#: the layer-skip draft depths run on Llama-3-8B: its full depth (the draft
#: is the model: the plumbing check) and a quarter of it
SPEC_DRAFT_DEPTHS = (32, 8)
#: at a stream's first difference from the K = 1 stream, the K = 1 run's
#: logits of its own token and of the spec stream's may lie this many bf16
#: steps apart at the row's logit scale, by model: a verify computes the
#: position inside a chunk of K + 1 tokens, at another GEMM shape (and
#: MoE batch) and on the kernel's chunk path, so near ties may flip. The
#: largest distance of one logit through a decode step and through a
#: verify, measured on 24 rows of each model on an H100 (2.88 and 6.56
#: steps, the same with plain attention), rounded up to a whole step
SPEC_TIE_STEPS = {"llama3_8b": 3.0, "deepseek_v2_lite": 7.0}
#: top logprobs the tie rule's re-run asks for: the two best decide, the
#: rest show where the spec stream's token stood
TIE_TOPS = 5


def repetitive_prompts(cfg, seed: int) -> list:
    """Eight prompts prompt lookup drafts from: each a random 48-token
    segment repeated up to a length drawn in 300-900 tokens."""
    rng = np.random.default_rng(seed + 11)
    out = []
    for n in rng.integers(300, 901, 8):
        seg = list(map(int, rng.integers(0, cfg.vocab_size, 48)))
        out.append((seg * -(-int(n) // 48))[:int(n)])
    return out


def row_logit_scale(engine, tokens) -> float:
    """The largest |logit| of the position after ``tokens``: eager ragged
    steps over them as prefill chunks of at most the largest token bucket,
    on fresh blocks."""
    bs = engine.args.block_size
    cap = engine.args.ragged_token_buckets[-1]
    s = SeqState(request_id="scale", req=None, ctx=None, sink=None)
    s.tokens = list(tokens)
    s.block_table = engine.pool.allocate(-(-len(tokens) // bs))
    try:
        for start in range(0, len(tokens), cap):
            ops, _ = engine.pack(StepPlan(prefill=[PrefillWork(
                s, start, min(cap, len(tokens) - start), True)]))
            logits, _, _ = engine.step_fn(
                engine.params, *(torch.from_numpy(x).to(engine.device)
                                 for x in ops), engine.k_cache,
                engine.v_cache)
        return float(logits[0].abs().max())
    finally:
        engine.pool.release(s.block_table)


async def tie_rule(engine, model, label, prompts, want, got, n,
                   opts=None, eos=(), names=("K = 1", "spec")) -> list:
    """Hold spec streams ``got`` against the K = 1 streams ``want`` of the
    same requests: a spec stream equals its K = 1 stream up to its first
    difference; there the spec stream's token must be a near tie of the
    K = 1 run's: among its TIE_TOPS best (a three-way tie can hand the
    verify a third token), its logit within SPEC_TIE_STEPS[model] bf16
    steps of the best at that row's logit scale. The logits come from a
    serial re-run of the same requests with top logprobs and speculation
    off (a logprob gap is a logit gap; the re-run must stream ``want``),
    the scale from :func:`row_logit_scale`. Past that position nothing is
    compared. Every such position is printed with the two best's gap and
    the spec token's; any other difference fails. Returns [(stream,
    position, gap of the two best, gap of the spec token, allowed)].
    ``names`` name the reference and the tested streams in what it prints
    (another path held by the same rule: preempt-to-swap, onboarding)."""
    diffs = [(i, first_diff(w, g)) for i, (w, g) in enumerate(zip(want, got))
             if w != g]
    if not diffs:
        log(f"  {label}: all {len(got)} streams equal to {names[0]}'s")
        return []
    K = engine.args.speculative_tokens
    engine.args.speculative_tokens = 0
    engine.args.pipeline_decode = False
    engine.pool.clear()
    frames = [[] for _ in prompts]
    try:
        rerun = await asyncio.gather(*(
            stream(engine, model, p, n, o, OutputOptions(logprobs=TIE_TOPS),
                   eos, frames=f)
            for p, o, f in zip(prompts, opts or [None] * len(prompts),
                               frames)))
    finally:
        engine.args.speculative_tokens = K
        engine.args.pipeline_decode = True
    out = []
    for i, p in diffs:
        if rerun[i][2] != want[i]:
            raise AssertionError(f"{label} stream {i}: the logprobs re-run "
                                 f"streamed {rerun[i][2]}, {names[0]} "
                                 f"{want[i]}")
        if p >= min(len(want[i]), len(got[i])):
            raise AssertionError(f"{label} stream {i}: ends at {p} where "
                                 f"{names[0]}'s does not: {got[i]} vs "
                                 f"{want[i]}")
        tops = [t for f in frames[i] for t in f.top_logprobs]
        (a, lp_a), (b, lp_b) = tops[p][:2]
        gap = lp_a - lp_b
        spec_gap = {t: lp_a - lp for t, lp in tops[p]}.get(got[i][p])
        scale = row_logit_scale(engine, prompts[i] + want[i][:p])
        steps = SPEC_TIE_STEPS[model]
        allowed = steps * 2.0 ** (math.floor(math.log2(scale)) - 7)
        log(f"  {label} stream {i}: first differs at token {p} ({names[0]} "
            f"{want[i][p]}, {names[1]} {got[i][p]}); the {names[0]} run's "
            f"two best {a}, {b} lie {gap:.5f} apart, {steps:.2f} bf16 steps "
            f"at the row's logit scale {scale:.3f} are {allowed:.5f}; the "
            f"{names[1]} token lies "
            + (f"{spec_gap:.5f} below the best" if spec_gap is not None
               else f"outside the {names[0]} run's {TIE_TOPS} best"))
        if a != want[i][p] or spec_gap is None or spec_gap > allowed:
            raise AssertionError(f"{label} stream {i}: not a near tie at "
                                 f"token {p}: top {tops[p]}, spec "
                                 f"{got[i][p]} {spec_gap} below the best, "
                                 f"allowed {allowed}")
        out.append((i, p, gap, spec_gap, allowed))
    return out


def token_itl(frames_of) -> tuple[float, float]:
    """(mean, p50) ms between tokens when a frame of m tokens spreads its
    gap from the previous frame over its m tokens (a spec round delivers
    a row's accepted tokens in one frame)."""
    itl = []
    for frames in frames_of:
        for (a, _), (b, m) in zip(frames, frames[1:]):
            itl += [(b - a) / m] * m
    return statistics.mean(itl) * 1e3, statistics.median(itl) * 1e3


def tie_gate(label: str, got, want, steps: float,
             one_step: bool = False) -> dict:
    """Rows of logits ``got`` [N, V] (the path under test) against ``want``
    (the path held as the reference), on the card: finite, every row within
    STEP_RTOL of its logit scale (its largest |logit| in ``want``; with
    ``one_step``, the largest of all the rows: the rows are one step's,
    held by the full-width step's rule, :func:`check_logits`), and the same
    greedy token, but where ``want``'s logit of ``got``'s pick lies within
    ``steps`` bf16 steps at the row's scale of its best (a near tie).
    Returns per row the max |Δlogit| in bf16 steps at the row's scale, and
    the near ties excused with their gaps in steps."""
    torch.cuda.synchronize()
    scale = want.abs().amax(-1)
    step_of = torch.exp2(torch.floor(torch.log2(scale)) - 7)
    if one_step:
        scale = scale.amax().expand_as(scale)
    diff = (got - want).abs().amax(-1)
    pick = got.argmax(-1)
    same = pick == want.argmax(-1)
    gap = (want.max(-1).values
           - want.gather(1, pick[:, None])[:, 0]) / step_of
    ties = [round(g, 2) for g, ok in zip(gap.tolist(), same.tolist())
            if not ok]
    if (not bool(torch.isfinite(got).all())
            or bool((diff > STEP_RTOL * scale).any())
            or not bool((same | (gap <= steps)).all())):
        raise AssertionError(
            f"{label}: |Δlogit| {diff.tolist()} against {STEP_RTOL} of the "
            f"scale {scale.tolist()}; picks {pick.tolist()} against "
            f"{want.argmax(-1).tolist()}, gaps in bf16 steps "
            f"{gap.tolist()} (allowed {steps})")
    return {"steps": (diff / step_of).tolist(), "ties": ties}


def spec_path_check(engine, model: str, seed: int, smi: str,
                    rounds: int = 3) -> float:
    """The verify step on the serving engine's weights and cache (fresh
    blocks), ``rounds`` times: 8 rows at kv 100-900 prefilled to their
    last token, then that token as a decode row (the 8-token bucket) and as
    the first token of a verify row of K + 1 (K = SPEC_K random drafts;
    the verify bucket of 8 rows), through the kernels and through the
    plain attention. Held by :func:`tie_gate` at SPEC_TIE_STEPS[model]:
    the verify row's first position against the decode row (each path),
    and every packed position of the verify through the kernels against
    the same verify through the plain attention, as one step (which
    leaves the GEMM shapes, the MoE and the rounding as the
    decode-vs-verify difference).
    Prints each comparison's largest |Δlogit| in bf16 steps at the row's
    scale and its near ties. Returns the largest decode-vs-verify distance
    through the kernels, in bf16 steps."""
    worst = 0.0
    for r in range(rounds):
        paths = _path_round(engine, model, seed + 41 + r, smi)
        worst = max(worst, max(paths["kernels"]["steps"]))
    return worst


def _path_round(engine, model: str, seed: int, smi: str) -> dict:
    """One round of :func:`spec_path_check`."""
    from dynamo_tpu_torch.engine.engine import verify_bucket
    from dynamo_tpu_torch.engine.model import make_ragged_verify_fn

    cfg, bs, args = engine.cfg, engine.args.block_size, engine.args
    rng = np.random.default_rng(seed)
    K, S = SPEC_K, SPEC_K + 1
    steps = SPEC_TIE_STEPS[model]
    seqs = []
    for n in rng.integers(100, 900, 8):
        s = SeqState(request_id="path", req=None, ctx=None, sink=None)
        s.tokens = list(map(int, rng.integers(0, cfg.vocab_size, int(n))))
        s.block_table = engine.pool.allocate(-(-(int(n) + K) // bs))
        seqs.append(s)

    def dev(ops):
        return [torch.from_numpy(x).to(engine.device) for x in ops]

    kc, vc, params = engine.k_cache, engine.v_cache, engine.params
    for s in seqs:  # the context: everything but the newest token
        ops, _ = engine.pack(StepPlan(prefill=[
            PrefillWork(s, 0, len(s.tokens) - 1, False)]))
        engine.step_fn(params, *dev(ops), kc, vc)
    if cfg.is_mla:
        plain = dict(attention=mla_paged_decode_ref,
                     chunk_attention=mla_attention_seg)
    else:
        plain = dict(attention=ragged_attention_ref)
    T = verify_bucket(args, len(seqs), S)
    rows = []
    for s in seqs:
        base = len(s.tokens) - 1
        rows.append(([s.tokens[-1]] + list(map(int, rng.integers(
            0, cfg.vocab_size, K))), base,
            [s.block_table[p // bs] * bs + p % bs
             for p in range(base, base + S)],
            len(s.tokens) + K, s.block_table))
    n = len(seqs) * S  # the rows' packed positions; padding follows
    out, every = {}, {}
    try:
        for label, kw in (("kernels", {}), ("plain attention", plain)):
            step = make_ragged_step_fn(cfg, bs, **kw)
            verify = make_ragged_verify_fn(cfg, bs, **kw)
            dec_ops, _ = engine.pack(StepPlan(decode=seqs))
            dec = step(params, *dev(dec_ops), kc, vc)[0][:len(seqs)]
            buf = torch.empty((T, cfg.vocab_size), dtype=torch.float32,
                              device=engine.device)
            verify(params, *dev(engine._verify_operands(rows, T)), kc, vc,
                   logits_out=buf)
            every[label] = buf[:n].clone()
            out[label] = g = tie_gate(
                f"{model}: verify row's first position vs the decode row, "
                f"{label}", every[label][::S], dec, steps)
            log(f"  [{smi}] {model}, the same position as a decode row (T "
                f"8) and a verify row's first token (T {T}), {label}: max "
                f"|Δlogit| in bf16 steps at the row's scale "
                f"{[round(x, 2) for x in g['steps']]}, near ties (gap in "
                f"steps) {g['ties']}")
        g = tie_gate(f"{model}: verify through the kernels vs the plain "
                     f"attention, every packed position",
                     every["kernels"], every["plain attention"], steps,
                     one_step=True)
        log(f"  [{smi}] {model}, verify (T {T}), all {n} packed positions "
            f"through the kernels vs the plain attention: max |Δlogit| "
            f"{max(g['steps']):.2f} bf16 steps at the row's scale, near ties "
            f"(gap in steps) {g['ties']}, allowed {steps}")
        out["every"] = g
    finally:
        for s in seqs:
            engine.pool.release(s.block_table)
    return out


async def spec_run(engine, model, label, prompts, want, clock, settle, smi,
                   n=32, draft_layers=0, require_verify=True) -> dict:
    """One measured spec run of greedy ``prompts`` on an emptied prefix
    cache: the tie rule against the K = 1 streams ``want``, the launches of
    each attention kernel against the forwards run (ragged: L a verify
    forward and a plain forward step and D a draft step; MLA: the decode
    kernel L a plain step and a verify, the prefill kernel L a verify and a
    step with chunk tokens), no capture, at least one verify when
    ``require_verify``, and the run's counts and stats, printed: ITL per
    frame (stats_line) and per token (:func:`token_itl`)."""
    L = engine.cfg.num_layers
    K = engine.args.speculative_tokens
    engine.pool.clear()
    clock.records.clear()
    caps = dict(engine.compile_events)
    s0 = dataclasses.replace(engine.spec_stats)
    f0, v0, d0, c0 = (engine.forward_steps, engine.verify_steps,
                      engine.draft_steps, engine.chunk_steps)
    r0 = engine.spec_rounds
    reset_counts()
    frames = [[] for _ in prompts]
    t0 = time.perf_counter()
    res = await asyncio.gather(*(stream(engine, model, p, n, frames=f)
                                 for p, f in zip(prompts, frames)))
    st = serving_stats(res, time.perf_counter() - t0)
    st["itl_tok_mean"], st["itl_tok_p50"] = token_itl(
        [list(zip(r[1], (len(f.token_ids) for f in fr)))
         for r, fr in zip(res, frames)])
    st["step_ms"], st["step_n"] = clock.decode_step_ms()
    st["round_ms"], st["rounds_timed"] = clock.spec_round_ms()
    await settle()
    fwd, ver, drafts, chunks = (engine.forward_steps - f0,
                                engine.verify_steps - v0,
                                engine.draft_steps - d0,
                                engine.chunk_steps - c0)
    rounds = engine.spec_rounds - r0
    stats = {k: getattr(engine.spec_stats, k) - getattr(s0, k)
             for k in vars(s0)}
    launches = {k["wrapper"]: k["wrapper"].launches for k in KERNELS}
    if engine.cfg.is_mla:
        want_l = {mla_paged_decode: L * (fwd + ver),
                  flash_mla_prefill_paged: L * (chunks + ver)}
    else:
        want_l = {ragged_paged_attention: L * (fwd + ver)
                  + draft_layers * K * drafts}
    for w, k in want_l.items():
        if launches[w] != k or (require_verify and ver == 0):
            raise AssertionError(
                f"{label}: {w.__name__} launched {launches[w]} times, want "
                f"{k} ({fwd} plain forward steps, {chunks} with chunk "
                f"tokens, {ver} verify forwards, {drafts} draft bursts)")
    if engine.compile_events != caps:
        raise AssertionError(f"{label}: a measured spec run captured: "
                             f"{caps} -> {engine.compile_events}")
    ends = [r[3] for r in res]
    got = [r[2] for r in res]
    if any(e != "length" or len(g) != n for e, g in zip(ends, got)):
        raise AssertionError(f"{label}: finishes {ends}")
    ties = await tie_rule(engine, model, label, prompts, want, got, n)
    st.update(stats=stats, rounds=rounds, verify=ver, drafts=drafts,
              forward=fwd, ties=ties, streams=got,
              launches={w.__name__: launches[w] for w in want_l})
    acc = stats["num_accepted_tokens"] / max(1, stats["num_draft_tokens"])
    log(f"  [{smi}] {label}: {rounds} spec rounds ({ver} verify forwards, "
        f"{drafts} draft bursts) beside {fwd} plain forward steps; drafts "
        f"{stats['num_drafts']}, drafted {stats['num_draft_tokens']}, "
        f"accepted {stats['num_accepted_tokens']} ({acc:.3f}), "
        f"{stats['num_spec_tokens']} tokens from verifies "
        f"({stats['num_spec_tokens'] / max(1, ver):.2f} a verify forward, "
        f"{stats['num_spec_tokens'] / max(1, stats['num_drafts']):.2f} a "
        f"row a round); "
        f"launches {st['launches']}; spec round wall {st['round_ms']:.3f} "
        f"ms ({st['rounds_timed']} rounds); {stats_line(st)}; ITL a token "
        f"mean {st['itl_tok_mean']:.2f} p50 {st['itl_tok_p50']:.2f} ms; "
        f"{len(ties)} streams cut at a near tie")
    return st


async def spec_serving(engine, model, prompts, clock, settle, smi: str,
                       seed: int, served: dict, guided: bool,
                       repetitive: bool, draft_depths=()) -> dict:
    """Speculative decoding on the serving engine, its knobs switched as
    :func:`burst_serving` switches the burst's (the same weights and pool):
    K = SPEC_K, the governor off (``spec_gain_window`` 0: every decode-only
    plan with a draft verifies), ``warmup()`` again first (the verify
    signatures, masked too with ``guided``; the engine was made with
    ``speculative_tokens=SPEC_K``, so its staging buffer and verify scratch
    already hold them, and the step signatures replay); then
    :func:`spec_path_check`. Then, with
    speculation off, the K = 1 references phase 3 has not run: with
    ``repetitive`` eight repetitive prompts on the serial and the
    pipelined loop, with ``guided`` a greedy json_schema request over a
    synthetic alphabet on the device FSM. Then, capturing nothing, prompt
    lookup on the eight greedy requests, the repetitive prompts, and the
    guided request (``verify_fsm``, matching the schema); then the
    layer-skip draft at each of ``draft_depths`` on the greedy requests,
    each after a warmup of its draft burst. Every stream passes
    :func:`tie_rule` against its K = 1 stream, and the launches add up
    (:func:`spec_run`). Returns
    each run's stats."""
    from dynamo_tpu_torch.llm.guided import CharDfa, guided_pattern
    from dynamo_tpu_torch.structured import (
        StructuredRuntime, arena_states, table_budget_bytes,
    )

    args = engine.args
    cfg = engine.cfg
    out = {}
    t_spec = time.perf_counter()
    marks = []

    def mark(what: str) -> None:
        marks.append(f"{what} {time.perf_counter() - t_spec:.1f}")

    k1_greedy = [r[2] for r in served["res"]]
    k1 = (served["eager_vs_graphs"][True] if "eager_vs_graphs" in served
          else served["stats"])
    rep_prompts = repetitive_prompts(cfg, seed) if repetitive else []
    g_opt = g_prompt = None
    if guided:
        V = cfg.vocab_size
        vocab = synthetic_vocab(V, seed)
        engine.guided_vocab = vocab
        engine.structured = StructuredRuntime(
            V, arena_states(V, table_budget_bytes()), engine.device)
        g_opt = SamplingOptions(temperature=0.0,
                                guided={"json": GUIDED_SCHEMA})
        g_prompt = prompts[3]
    try:
        args.speculative_tokens = SPEC_K
        args.speculative_method = "prompt_lookup"
        args.spec_gain_window = 0
        rep = await engine.warmup()
        mark("warmup")
        log(f"  [{smi}] {model}, speculative_tokens={SPEC_K} (prompt "
            f"lookup), warmup(): verify signatures {rep['verify']} in "
            f"{rep['seconds']:.2f} s with every step signature replayed; "
            f"{graph_line(engine)}")
        path_steps = spec_path_check(engine, model, seed, smi)
        mark("path check")
        out["path_steps"] = path_steps
        log(f"  [{smi}] {model}: the decode and verify paths put a logit up "
            f"to {path_steps:.2f} bf16 steps apart (24 rows); the tie rule "
            f"allows {SPEC_TIE_STEPS[model]:.2f}")
        # the K = 1 references that phase 3 has not run, speculation off
        args.speculative_tokens = 0
        for pipeline in (False, True) if repetitive else ():
            args.pipeline_decode = pipeline
            engine.pool.clear()
            clock.records.clear()
            t0 = time.perf_counter()
            res = await asyncio.gather(*(stream(engine, model, p, 32)
                                         for p in rep_prompts))
            st = serving_stats(res, time.perf_counter() - t0)
            st["step_ms"], st["step_n"] = clock.decode_step_ms()
            await settle()
            out["repetitive_k1", pipeline] = st
            streams = [r[2] for r in res]
            if pipeline and streams != out["repetitive_streams"]:
                raise AssertionError("repetitive prompts: the pipelined "
                                     "loop's streams differ from the serial "
                                     "loop's")
            out["repetitive_streams"] = streams
            log(f"  [{smi}] {model}, 8 repetitive prompts "
                f"{sorted(len(p) for p in rep_prompts)} x 32 tokens, K = 1, "
                f"{'pipelined' if pipeline else 'serial'} loop: "
                f"{stats_line(st)}")
        if guided:
            # also the greedy FSM sampler's capture (keyed by the arena)
            g_k1 = await stream(engine, model, g_prompt, 48, g_opt,
                                eos=LLAMA3_EOS)
            await settle()
        args.pipeline_decode = True
        args.speculative_tokens = SPEC_K
        mark("K = 1 references")
        # random prompts draft only once a stream repeats itself
        out["greedy"] = await spec_run(
            engine, model, f"{model}, prompt lookup K = {SPEC_K}, 8 greedy "
            f"requests", prompts, k1_greedy, clock, settle, smi,
            require_verify=False)
        if repetitive:
            out["repetitive"] = await spec_run(
                engine, model, f"{model}, prompt lookup K = {SPEC_K}, 8 "
                f"repetitive prompts", rep_prompts,
                out["repetitive_streams"], clock, settle, smi)
        if guided:
            caps = dict(engine.compile_events)
            g = await stream(engine, model, g_prompt, 48, g_opt,
                             eos=LLAMA3_EOS)
            await settle()
            ties = await tie_rule(engine, model, f"{model}, guided, prompt "
                                  f"lookup K = {SPEC_K}", [g_prompt],
                                  [g_k1[2]], [g[2]], 48, [g_opt], LLAMA3_EOS)
            text = "".join(vocab[t] for t in g[2] if t not in LLAMA3_EOS)
            sigs = {k for k in engine.compiled_signatures
                    if k[0] == "verify_fsm"}
            if (g[3] != "stop" or not sigs or engine.compile_events != caps
                    or not CharDfa(guided_pattern({"json": GUIDED_SCHEMA})
                                   ).fullmatch(text)):
                raise AssertionError(f"guided spec: {g[2:]} ({text!r}), "
                                     f"verify_fsm {sigs}, captures {caps} "
                                     f"-> {engine.compile_events}")
            json.loads(text)
            log(f"  [{smi}] {model}, guided json_schema, greedy, prompt "
                f"lookup K = {SPEC_K}: {text!r}, {len(g[2])} tokens, "
                f"verified under mask words ({sorted(sigs)}); K = 1 "
                f"device-FSM stream {'equal' if g[2] == g_k1[2] else 'cut at a near tie'}")
            out["guided"] = {"ties": ties, "tokens": len(g[2])}
        mark("prompt lookup runs")
        for D in draft_depths:
            args.speculative_method = "draft_layers"
            args.speculative_draft_layers = D
            rep = await engine.warmup()
            log(f"  [{smi}] {model}, layer-skip draft D = {D}: warmup() "
                f"draft bursts of rows {rep['draft']}; {graph_line(engine)}")
            out[f"draft_{D}"] = await spec_run(
                engine, model, f"{model}, layer-skip draft D = {D}, K = "
                f"{SPEC_K}, 8 greedy requests", prompts, k1_greedy, clock,
                settle, smi, draft_layers=D)
            mark(f"draft D = {D}")
    finally:
        args.speculative_tokens = 0
        args.speculative_method = "prompt_lookup"
        args.speculative_draft_layers = 0
        args.spec_gain_window = 64
        args.pipeline_decode = True
        engine.structured = None
        engine.guided_vocab = None
    k1s = served["stats_serial"]
    line = [f"K = 1 pipelined {k1['step_ms']:.3f} ms a step, ITL mean "
            f"{k1['itl_mean']:.2f} p50 {k1['itl_p50']:.2f} ms, "
            f"{k1['tok_s']:.2f} tok/s; K = 1 serial {k1s['step_ms']:.3f} "
            f"ms a step, ITL mean {k1s['itl_mean']:.2f} p50 "
            f"{k1s['itl_p50']:.2f} ms, {k1s['tok_s']:.2f} tok/s"]
    for name in ["greedy"] + [f"draft_{D}" for D in draft_depths]:
        st = out[name]
        line.append(f"{name}: round {st['round_ms']:.3f} ms, ITL a token "
                    f"mean {st['itl_tok_mean']:.2f} p50 "
                    f"{st['itl_tok_p50']:.2f} ms, {st['tok_s']:.2f} tok/s")
    log(f"  [{smi}] {model}, 8 greedy requests x 32 tokens, same call: "
        + "; ".join(line))
    log(f"  {model}: the spec phase took "
        f"{time.perf_counter() - t_spec:.1f} s (cumulative s: "
        f"{', '.join(marks)})")
    if repetitive:
        a, b = out["repetitive_k1", True], out["repetitive"]
        log(f"  [{smi}] {model}, 8 repetitive prompts x 32 tokens, same "
            f"call: K = 1 pipelined ITL mean {a['itl_mean']:.2f} p50 "
            f"{a['itl_p50']:.2f} ms, {a['tok_s']:.2f} tok/s; serial "
            f"{out['repetitive_k1', False]['tok_s']:.2f} tok/s; prompt lookup "
            f"K = {SPEC_K}: round {b['round_ms']:.3f} ms, ITL a token mean "
            f"{b['itl_tok_mean']:.2f} p50 {b['itl_tok_p50']:.2f} ms, "
            f"{b['tok_s']:.2f} tok/s")
    return out


async def sampled_serving(engine, model, prompts, clock, settle,
                          smi: str, seed: int, host_and_guided: bool):
    """Eight seeded sampled requests (SAMPLED) on the pipelined loop, the
    draw kernel's launches counted, then on the serial loop: the streams
    must be equal and every request must finish. With
    ``host_and_guided``, then the requests that need the host (logprobs,
    penalties, logit_bias; the serial loop) and a json_schema request over
    a synthetic alphabet of the vocabulary's width, on the device FSM and
    on the host oracle. Returns the kernel's launches and the two loops'
    stats."""
    opts = sampled_options(seed)
    # one short request a sampler branch set (the draw; with top-k; with
    # top-p; with both), unmeasured: the sampled samplers' captures stay
    # out of the measured runs, as warmup() keeps the greedy steps'
    for k, p in ((0, 1.0), (20, 1.0), (0, 0.9), (20, 0.9)):
        await stream(engine, model, list(range(1, 17)), 3, SamplingOptions(
            temperature=0.7, top_k=k or None, top_p=p, seed=1))
    await settle()
    captured = dict(engine.compile_events)

    async def run(pipeline: bool):
        engine.args.pipeline_decode = pipeline
        engine.pool.clear()
        clock.records.clear()
        t0 = time.perf_counter()
        res = await asyncio.gather(*(stream(engine, model, p, 32, o)
                                     for p, o in zip(prompts, opts)))
        st = serving_stats(res, time.perf_counter() - t0)
        st["step_ms"], st["step_n"] = clock.decode_step_ms()
        await settle()
        return res, st

    reset_counts()
    steps0 = engine.steps
    res, st = await run(True)
    launches, steps = gumbel_argmax.launches, engine.steps - steps0
    res_s, st_s = await run(False)
    engine.args.pipeline_decode = True
    for i, (on, off) in enumerate(zip(res, res_s)):
        if on[3] != "length" or len(on[2]) != 32 or on[2] != off[2]:
            raise AssertionError(f"sampled stream {i}: pipelined {on[2]} "
                                 f"({on[3]}), serial {off[2]} ({off[3]})")
    if launches < 32:
        raise AssertionError(f"gumbel_argmax launched {launches} times in "
                             f"{steps} steps of 8 sampled requests")
    if engine.warmed_up and engine.compile_events != captured:
        raise AssertionError(f"a measured sampled run captured: {captured} "
                             f"-> {engine.compile_events}")
    log(f"  [{smi}] {model}: 8 seeded sampled streams x 32 tokens "
        f"(temperature, top_k, top_p {SAMPLED}) equal on both loops; "
        f"gumbel_argmax launched {launches} times in {steps} steps; "
        f"captures before and after the measured runs {captured}")
    log(f"  [{smi}] {model}, sampled, pipelined decode loop: "
        f"{stats_line(st)}")
    log(f"  [{smi}] {model}, sampled, serial decode loop: "
        f"{stats_line(st_s)}")
    out = {"launches": launches, "stats": st, "stats_serial": st_s,
           "streams": [r[2] for r in res]}
    if not host_and_guided:
        return out

    pipelined0 = engine.pipelined_steps
    frames = []
    lp = await stream(engine, model, prompts[0], 16, SamplingOptions(
        temperature=0.8, seed=5), OutputOptions(logprobs=5), frames=frames)
    for f in frames:
        (top,) = f.top_logprobs
        vals = [v for _, v in top]
        if (len(top) != 5 or not all(map(math.isfinite, vals + f.log_probs))
                or vals != sorted(vals, reverse=True)
                or f.log_probs[0] > vals[0] + 1e-6):
            raise AssertionError(f"bad logprobs frame {f}")
    pen = await stream(engine, model, prompts[1], 16, SamplingOptions(
        temperature=0.9, seed=6, presence_penalty=0.5,
        frequency_penalty=0.3, repetition_penalty=1.2))
    biased = prompts[2][0]
    bias = await stream(engine, model, prompts[2], 16, SamplingOptions(
        logit_bias={str(biased): 100.0}))
    if (lp[3] != "length" or pen[3] != "length" or len(pen[2]) != 16
            or bias[2] != [biased] * 16):
        raise AssertionError(f"host requests: logprobs {lp[2:]}, penalties "
                             f"{pen[2:]}, logit_bias {bias[2:]}")
    if engine.pipelined_steps != pipelined0:
        raise AssertionError("a request that needs the host rode the "
                             "pipelined loop")
    log(f"  host requests on the serial loop: logprobs (5 top a token, "
        f"finite, sorted), penalties and logit_bias served, 16 tokens each")

    from dynamo_tpu_torch.llm.guided import CharDfa, guided_pattern
    from dynamo_tpu_torch.structured import (
        StructuredRuntime, arena_states, table_budget_bytes,
    )
    V = engine.cfg.vocab_size
    vocab = synthetic_vocab(V, seed)
    engine.guided_vocab = vocab
    engine.structured = StructuredRuntime(
        V, arena_states(V, table_budget_bytes()), engine.device)
    guided = {"json": GUIDED_SCHEMA}
    opt = SamplingOptions(temperature=0.7, seed=9, guided=guided)
    t0 = time.perf_counter()
    dev = await stream(engine, model, prompts[3], 48, opt, eos=LLAMA3_EOS)
    dev_s = time.perf_counter() - t0
    rows = engine.structured.stats()
    engine.structured = None  # the host oracle from here on
    host = await stream(engine, model, prompts[3], 48, opt, eos=LLAMA3_EOS)
    engine.guided_vocab = None
    text = "".join(vocab[t] for t in dev[2] if t not in LLAMA3_EOS)
    if (dev[2] != host[2] or dev[3] != "stop" or rows["rows_device"] != 1
            or not CharDfa(guided_pattern(guided)).fullmatch(text)):
        raise AssertionError(f"guided: device {dev[2:]} ({text!r}), host "
                             f"oracle {host[2:]}, arena {rows}")
    json.loads(text)
    log(f"  [{smi}] guided json_schema over a synthetic alphabet of {V}: "
        f"{text!r}, {len(dev[2])} tokens, equal on the device FSM "
        f"({rows['states_used']} of {rows['states_cap']} arena states; "
        f"{dev_s:.2f} s with the compile) and the host oracle")
    return out


def serving_prompts(cfg, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, cfg.vocab_size, int(n))))
            for n in rng.integers(64, 1025, 8)]


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# ------------------------------------------------------------------ phase 4


def full_width_step(engine, model: str, seed: int, decode_kv: int = 701,
                    ties: bool = False, plain_fn=None) -> float:
    """One mixed ragged step at full width, kernel vs plain attention, on
    the serving engine's weights and cache (fresh blocks): a decode row at
    kv ``decode_kv`` (its context written by earlier steps of at most 2048
    tokens), a 128-token chunk at kv 328 and a 64-token prefill. With a
    final logit softcap every logit must lie within it (random weights
    keep the logits far inside a cap of 30, so the log says how far;
    :func:`final_cap_check` holds the cap where it bends). ``ties``: the
    argmax is held up to :func:`check_logits`' bf16 tie rule. ``plain_fn``
    replaces the plain step (the default: the same step through the plain
    attention)."""
    cfg, bs = engine.cfg, engine.args.block_size
    rng = np.random.default_rng(seed + 7)

    def seq(n):
        s = SeqState(request_id="step", req=None, ctx=None, sink=None)
        s.tokens = list(map(int, rng.integers(0, cfg.vocab_size, n)))
        s.block_table = engine.pool.allocate(-(-n // bs))
        return s

    a, b, c = seq(decode_kv), seq(328), seq(64)

    def run(plan, fn):
        ops, _ = engine.pack(plan)
        tensors = [torch.from_numpy(x).cuda() for x in ops]
        logits, _, _ = fn(engine.params, *tensors, engine.k_cache,
                          engine.v_cache)
        return logits

    kernel_fn = engine.step_fn
    plain_fn = plain_fn or (
        make_ragged_step_fn(cfg, bs, attention=mla_paged_decode_ref,
                            chunk_attention=mla_attention_seg)
        if cfg.is_mla else
        make_ragged_step_fn(cfg, bs, attention=ragged_attention_ref))
    # context for the step under test
    if decode_kv <= 2048:
        run(StepPlan(prefill=[PrefillWork(a, 0, decode_kv - 1, False),
                              PrefillWork(b, 0, 200, False)]), kernel_fn)
    else:
        for off in range(0, decode_kv - 1, 2048):
            run(StepPlan(prefill=[PrefillWork(
                a, off, min(2048, decode_kv - 1 - off), False)]), kernel_fn)
        run(StepPlan(prefill=[PrefillWork(b, 0, 200, False)]), kernel_fn)
    plan = StepPlan(prefill=[PrefillWork(b, 200, 128, True),
                             PrefillWork(c, 0, 64, True)], decode=[a])
    # both runs write the same slots before reading them, so the plain run
    # and the kernel run see the same context
    want = run(plan, plain_fn)[:3]
    got = run(plan, kernel_fn)[:3]
    torch.cuda.synchronize()
    for s_ in (a, b, c):
        engine.pool.release(s_.block_table)
    kind = ("int8" if engine.args.kv_cache_dtype == "int8"
            else str(engine.dtype)[6:])
    label = (f"full-width step, {model}, {kind} KV (decode kv {decode_kv}, "
             f"chunk 128 at kv 328, prefill 64)")
    cap = cfg.final_logit_softcap
    if cap:
        top = float(got.abs().max())
        if top > cap:
            raise AssertionError(f"{label}: a logit of {top} past the final "
                                 f"softcap {cap}")
        log(f"{label}: largest |logit| {top:.4f} <= the final softcap "
            f"{cap} (uncapped {cap * math.atanh(top / cap):.4f}: the cap "
            f"moves it by {cap * math.atanh(top / cap) - top:.2e})")
    return check_logits(label, got, want, ties=ties)


def final_cap_check(engine, model: str, seed: int) -> None:
    """The final logit softcap where it bends: hidden rows scaled until
    their largest uncapped logit is three times the cap go through
    ``lm_logits`` at full width (the tied 256000-row head); every logit
    must lie within the cap and equal c·tanh(z/c) of the same rows'
    uncapped logits z within 1e-4, and z must pass twice the cap."""
    cfg, params = engine.cfg, engine.params
    cap = cfg.final_logit_softcap
    gen = torch.Generator(device=engine.device).manual_seed(seed + 8)
    x = torch.randn((8, cfg.hidden_size), generator=gen,
                    device=engine.device)
    plain = dataclasses.replace(cfg, final_logit_softcap=0.0)
    gain = 3 * cap / float(lm_logits(plain, params, x.to(engine.dtype))
                           .abs().max())
    x = (x * gain).to(engine.dtype)
    z = lm_logits(plain, params, x)
    got = lm_logits(cfg, params, x)
    want = cap * torch.tanh(z.double() / cap)
    top, ztop = float(got.abs().max()), float(z.abs().max())
    err = float((got.double() - want).abs().max())
    label = f"final softcap, {model}: 8 rows at gain {gain:.3f}"
    if top > cap or ztop <= 2 * cap or err > 1e-4:
        raise AssertionError(f"{label}: largest |logit| {top} (uncapped "
                             f"{ztop}, cap {cap}), max |got - want| {err}")
    log(f"{label}: uncapped logits to {ztop:.3f}, capped to {top:.4f} <= "
        f"{cap}; max |got - c·tanh(z/c)| {err:.2e} (tol 1e-4)")


def graph_step_check(engine, model: str, seed: int) -> None:
    """The captured step against the eager step on the same operands, on
    the serving engine's weights and cache (fresh blocks): a decode-only
    step (8 rows at kv 900-1100) and a mixed one (a decode row at kv 701, a
    128-token chunk at kv 328, a 64-token prefill). Each is captured (if
    serving has not), in that order; then both run eagerly, the slots they
    wrote are zeroed, and both replay in the other order. The logits and
    every written cache slot must be bit-equal to the eager run's, and
    each replay must count the kernel launches of one eager run."""
    cfg, bs = engine.cfg, engine.args.block_size
    rng = np.random.default_rng(seed + 29)
    seqs = []

    def seq(n):
        s = SeqState(request_id="graph", req=None, ctx=None, sink=None)
        s.tokens = list(map(int, rng.integers(0, cfg.vocab_size, n)))
        s.block_table = engine.pool.allocate(-(-n // bs))
        seqs.append(s)
        return s

    a, b, c = seq(701), seq(328), seq(64)
    cases = [("decode-only", StepPlan(decode=[
                  seq(int(n)) for n in rng.integers(900, 1100, 8)]), False),
             ("mixed", StepPlan(prefill=[PrefillWork(b, 200, 128, True),
                                         PrefillWork(c, 0, 64, True)],
                                decode=[a]), True)]
    ops, slots = {}, {}
    for name, plan, _ in cases:
        ops[name], _ = engine.pack(plan)
        n = len(plan.decode) + sum(w.chunk for w in plan.prefill)
        slots[name] = torch.from_numpy(
            ops[name][0][2, :n].astype(np.int64)).to(engine.device)
    leaves = [t for cache in (engine.k_cache, engine.v_cache)
              for t in (cache.values() if isinstance(cache, dict)
                        else (cache,))]

    def forward(name, chunks):
        R = ops[name][1].shape[0]
        ints5, rows3, grid, bt = engine._staging.put(
            [np.zeros((5, R), np.int32), np.zeros((R,), np.int32),
             *ops[name]])[2:]
        reset_counts()
        logits = engine._forward(ints5, rows3, grid if chunks else None,
                                 bt).clone()
        written = [t[:, slots[name]].clone() for t in leaves]
        torch.cuda.synchronize()
        return logits, written, {k["wrapper"].__name__: k["wrapper"].launches
                                 for k in KERNELS}

    engine.use_graphs = True
    keys = []
    for name, _, chunks in cases:
        forward(name, chunks)
        keys.append(("ragged" if chunks else "ragged_dec",
                     ops[name][0].shape[1]))
    engine.use_graphs = False
    want = {name: forward(name, chunks) for name, _, chunks in cases}
    for name, _, _ in cases:
        for t in leaves:
            t[:, slots[name]] = 0
    engine.use_graphs = True
    for key, (name, _, chunks) in reversed(list(zip(keys, cases))):
        if key not in engine.graphs:
            raise AssertionError(f"{key} was not captured")
        got = forward(name, chunks)
        same_kv = all(torch.equal(g, w) for g, w in zip(got[1], want[name][1]))
        if not torch.equal(got[0], want[name][0]) or not same_kv:
            diff = float((got[0] - want[name][0]).abs().max())
            raise AssertionError(
                f"{model} {name} step: the replay of {key} differs from the "
                f"eager step (max |logit diff| {diff}, written cache equal: "
                f"{same_kv})")
        if got[2] != want[name][2] or not any(got[2].values()):
            raise AssertionError(f"{model} {name} step: replay launches "
                                 f"{got[2]}, eager {want[name][2]}")
    for s in seqs:
        engine.pool.release(s.block_table)
    kind = ("int8" if engine.args.kv_cache_dtype == "int8"
            else str(engine.dtype)[6:])
    log(f"graph vs eager, {model}, {kind} KV: the decode-only step "
        f"({keys[0]}) and the mixed step ({keys[1]}) replayed in the "
        f"reverse of their capture order: logits and "
        f"{sum(len(v) for v in slots.values())} written cache slots "
        f"bit-equal to the eager steps', launches "
        f"{ {k: v for k, v in want['mixed'][2].items() if v} } a mixed "
        f"step in both")


def check_logits(label: str, got, want, ties: bool = False) -> float:
    """A full-width step's logits through the kernels against the same
    step through the plain versions: finite, within STEP_RTOL of the logit
    scale, and the same greedy token in every row. With ``ties``, a row
    whose plain logits of the two picks are equal in bf16 (within one bf16
    step at the logit scale: the plain argmax of a tie is only its first
    index) is excused and printed. Returns the max |Δlogit|."""
    torch.cuda.synchronize()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: bad logits")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    pick = got.argmax(-1)
    same = (pick == want.argmax(-1)).tolist()
    gap = (want.max(-1).values
           - want.gather(1, pick[:, None])[:, 0]).tolist()
    ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)  # bf16: 8-bit mantissa
    tied = [i for i, ok in enumerate(same)
            if ties and not ok and gap[i] <= ulp]
    log(f"{label}: max |logit diff| {err:.4e}, logit scale {scale:.3f} "
        f"(tolerance {STEP_RTOL} of it), argmax agree {same}"
        + (f"; bf16 ties (plain logit gap of the kernel's pick "
           f"{[gap[i] for i in tied]} <= one bf16 step {ulp}) in rows "
           f"{tied}" if tied else ""))
    if err > STEP_RTOL * scale or not all(ok or i in tied
                                          for i, ok in enumerate(same)):
        raise AssertionError(f"{label}: logits differ by {err}, argmax "
                             f"agree {same}, gaps {gap}")
    return err


def step_profile(engine, model: str, seed: int) -> None:
    """Where a step's time goes: a decode-only step (8 rows near kv 1000)
    and a full prefill step (2048 tokens), each timed on the host around a
    synchronised run and traced once with torch.profiler. Prints each
    step's wall time, the device's busy time by kernel and its idle share."""
    from torch.profiler import ProfilerActivity, profile

    cfg, bs = engine.cfg, engine.args.block_size
    rng = np.random.default_rng(seed + 11)

    def seq(n, computed):
        s = SeqState(request_id="prof", req=None, ctx=None, sink=None)
        s.tokens = list(map(int, rng.integers(0, cfg.vocab_size, n)))
        s.block_table = engine.pool.allocate(-(-n // bs))
        s.num_computed = computed
        return s

    decode = StepPlan(decode=[seq(int(n), int(n) - 1)
                              for n in rng.integers(900, 1100, 8)])
    prefill = StepPlan(prefill=[PrefillWork(seq(1024, 0), 0, 1024, True),
                                PrefillWork(seq(1024, 0), 0, 1024, True)])
    for name, plan in (("decode 8 rows", decode),
                       ("prefill 2x1024", prefill)):
        ops, _ = engine.pack(plan)

        def run():
            tensors = [torch.from_numpy(x).to(engine.device) for x in ops]
            if not plan.prefill:
                tensors[2] = None  # no chunk grid, as the engine runs it
            logits, _, _ = engine.step_fn(engine.params, *tensors,
                                          engine.k_cache, engine.v_cache)
            return logits.argmax(-1).tolist()

        run()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            traced_ms = (time.perf_counter() - t0) * 1e3
        # device-side events only (kernels, copies): one stream, so their
        # durations add up to the busy time
        by_name: dict = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                n, us = by_name.get(e.name, (0, 0.0))
                by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
        busy_ms = sum(us for _, us in by_name.values()) / 1e3
        log(f"step profile, {model} {name}: wall "
            f"{statistics.median(walls):.3f} ms "
            f"(traced {traced_ms:.3f} ms), device busy {busy_ms:.3f} ms, "
            f"idle share {max(0.0, 1 - busy_ms / traced_ms):.3f}")
        top = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)
        for kname, (n, us) in top[:6]:
            log(f"    {us / 1e3:9.3f} ms  x{n:<4d} {kname[:70]}")


def dense_decode_step(engine, seed: int, smi: str,
                      model: str = "llama3_8b") -> int:
    """One S == 1 step of the dense forward (``make_forward_fn``) at full
    width: 8 rows at kv 900-1100 whose context the engine's ragged step
    wrote first, through the paged decode kernel against the same step
    through its plain version. Returns the kernel's launches in the kernel
    run (one a layer)."""
    cfg, bs = engine.cfg, engine.args.block_size
    dev = engine.device
    rng = np.random.default_rng(seed + 17)
    seqs = []
    for n in rng.integers(900, 1101, 8):
        s = SeqState(request_id="dense", req=None, ctx=None, sink=None)
        s.tokens = list(map(int, rng.integers(0, cfg.vocab_size, int(n))))
        s.block_table = engine.pool.allocate(-(-int(n) // bs))
        seqs.append(s)
        # the context: every token but the last, one sequence a step
        ops, _ = engine.pack(StepPlan(prefill=[
            PrefillWork(s, 0, int(n) - 1, False)]))
        engine.step_fn(engine.params, *(torch.from_numpy(x).to(dev)
                                        for x in ops),
                       engine.k_cache, engine.v_cache)
    W = max(len(s.block_table) for s in seqs)
    bt = np.zeros((8, W), np.int32)
    for i, s in enumerate(seqs):
        bt[i, :len(s.block_table)] = s.block_table
    kv = np.asarray([len(s.tokens) for s in seqs], np.int32)
    pos = kv - 1
    step = [np.asarray([[s.tokens[-1]] for s in seqs], np.int32),
            pos[:, None], (bt[np.arange(8), pos // bs] * bs
                           + pos % bs)[:, None].astype(np.int32),
            bt, kv, np.zeros((8,), np.int32)]
    step = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in step]

    def run(fn):
        logits, _, _ = fn(engine.params, *step, engine.k_cache,
                          engine.v_cache)
        return logits

    kernel_fn = make_forward_fn(cfg, bs)
    plain_fn = make_forward_fn(cfg, bs,
                               decode_attention=paged_attention_decode_ref)
    run(kernel_fn)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    got = run(kernel_fn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_attention_decode.launches
    other = {k["name"]: k["wrapper"].launches for k in KERNELS
             if k["wrapper"] is not paged_attention_decode}
    t0 = time.perf_counter()
    want = run(plain_fn)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    if launches != cfg.num_layers:
        raise AssertionError(f"paged decode launched {launches} times in "
                             f"one S == 1 step, want {cfg.num_layers}")
    if any(other.values()):
        raise AssertionError(f"the S == 1 step launched other kernels: "
                             f"{other}")
    log(f"  [{smi}] S == 1 dense decode step, {model}, 8 rows at kv "
        f"{sorted(kv.tolist())}: {launches} paged decode launches; wall "
        f"{wall * 1e3:.3f} ms (plain attention {plain_wall * 1e3:.3f} ms)")
    check_logits(f"S == 1 dense decode step, {model}", got, want,
                 ties=True)
    for s in seqs:
        engine.pool.release(s.block_table)
    return launches


# ------------------------------------------------------------------ phase 6


def _cos(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def embedding_phase(engine, seed: int, smi: str) -> int:
    """``AsyncTorchEngine.embed`` at full width; returns the flash prefill
    kernel's launches in one call."""
    cfg = engine.cfg
    rng = np.random.default_rng(seed + 13)
    lens = [2048] + [int(n) for n in rng.integers(100, 2049, 7)]
    inputs = [list(map(int, rng.integers(0, cfg.vocab_size, n)))
              for n in lens]
    asyncio.run(engine.embed(inputs))  # first call: scratch cache, warm-up
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vecs = asyncio.run(engine.embed(inputs))
    wall = time.perf_counter() - t0
    launches = flash_prefill.launches
    other = {k["name"]: k["wrapper"].launches for k in KERNELS
             if k["wrapper"] is not flash_prefill}
    if launches != cfg.num_layers:
        raise AssertionError(f"flash prefill launched {launches} times in "
                             f"one embed call, want {cfg.num_layers}")
    if any(other.values()):
        raise AssertionError(f"embed launched other kernels: {other}")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        asyncio.run(engine.embed(inputs))
        walls.append(time.perf_counter() - t0)
    v = np.asarray(vecs)
    if v.shape != (8, cfg.hidden_size) or not np.isfinite(v).all():
        raise AssertionError(f"embed: bad output shape {v.shape} or values")
    norms = np.linalg.norm(v, axis=1)
    if np.abs(norms - 1).max() > 1e-3:
        raise AssertionError(f"embed: norms {norms}")
    # the same embeddings through the plain attention, on a scratch cache
    # of their own and the same weights
    B, S, bs = 8, 2048, engine.args.block_size
    tokens = np.zeros((B, S), np.int32)
    for i, ids in enumerate(inputs):
        tokens[i, :len(ids)] = ids
    plain_fn = make_embed_fn(cfg, bs, attention=functools.partial(
        flash_prefill_paged, attention=flash_prefill_ref))
    kc, vc = allocate_device_cache(cfg, B * S // bs + 1, bs, engine.device,
                                   engine.dtype)
    want = plain_fn(engine.params, torch.from_numpy(tokens).to(engine.device),
                    torch.tensor(lens, dtype=torch.int32, device=engine.device), kc,
                    vc).cpu().numpy()
    del kc, vc
    # padding invariance: the shortest row alone (a smaller bucket)
    short = int(np.argmin(lens))
    solo = asyncio.run(engine.embed([inputs[short]]))[0]
    pad_cos = _cos(solo, vecs[short])
    cos = [_cos(a, b) for a, b in zip(vecs, want)]
    med = statistics.median(walls)
    log(f"  [{smi}] embeddings: 8 inputs of {sorted(lens)} tokens (bucket "
        f"8 x 2048): {launches} flash prefill launches a call; wall "
        f"{med * 1e3:.2f} ms a call (median of 3; first timed call "
        f"{wall * 1e3:.2f} ms), {sum(lens) / med:.0f} input tokens/s "
        f"({B * S / med:.0f} padded tokens/s)")
    log(f"  embeddings: |norm - 1| max {np.abs(norms - 1).max():.2e}; "
        f"row of {lens[short]} tokens alone vs in the batch: cosine "
        f"{pad_cos:.6f} (>= {PAD_COS}); kernel vs plain-attention embed: "
        f"cosine min {min(cos):.6f} (>= {EMBED_COS})")
    if pad_cos < PAD_COS:
        raise AssertionError(f"embed: padding changed a row, cos {pad_cos}")
    if min(cos) < EMBED_COS:
        raise AssertionError(f"embed: kernel vs plain cosines {cos}")
    return launches


# ------------------------------------------------------------------ phase 7


def int8_phase(seed: int, smi: str, bf16_blocks: int, bf16_streams):
    """Serving with an int8 KV pool and one full-width int8 step; returns
    the ragged kernel's launches in the serving run."""
    engine, launches, streams, _ = serving_phase(seed, smi, "int8",
                                                 warmup=True)
    launches = launches["ragged_paged_attention"]
    same = sum(a == b for a, b in zip(streams, bf16_streams))
    log(f"  int8 KV pool {engine.num_blocks} blocks vs bf16 pool "
        f"{bf16_blocks} blocks ({engine.num_blocks / bf16_blocks:.3f}x); "
        f"{same} of 8 greedy streams equal to the bf16 run's")
    graph_step_check(engine, "llama3_8b", seed)
    full_width_step(engine, "llama3_8b", seed)
    step_profile(engine, "llama3_8b", seed)
    block_copy_check(engine, "llama3_8b int8 pool (packed uint8 bundles)",
                     smi)
    _release(engine)
    return launches


# ------------------------------------------------------------- phases 9-10


def mla_embedding(engine, seed: int, smi: str) -> int:
    """One ``AsyncTorchEngine.embed`` call of a DeepSeek-V2-Lite engine (2
    inputs of up to 1024 tokens: the all-experts MoE makes a larger bucket
    heavy) through the MLA prefill kernel, against the same embeddings
    through the plain attention. Returns the kernel's launches in it."""
    cfg, bs = engine.cfg, engine.args.block_size
    rng = np.random.default_rng(seed + 19)
    lens = [1024, int(rng.integers(300, 1024))]
    inputs = [list(map(int, rng.integers(0, cfg.vocab_size, n)))
              for n in lens]
    asyncio.run(engine.embed(inputs))  # first call: scratch cache, warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    vecs = asyncio.run(engine.embed(inputs))
    wall = time.perf_counter() - t0
    launches = flash_mla_prefill_paged.launches
    other = {k["name"]: k["wrapper"].launches for k in KERNELS
             if k["wrapper"] is not flash_mla_prefill_paged}
    if launches != cfg.num_layers:
        raise AssertionError(f"the MLA prefill kernel launched {launches} "
                             f"times in one embed call, want "
                             f"{cfg.num_layers}")
    if any(other.values()):
        raise AssertionError(f"embed launched other kernels: {other}")
    v = np.asarray(vecs)
    norms = np.linalg.norm(v, axis=1)
    if (v.shape != (2, cfg.hidden_size) or not np.isfinite(v).all()
            or np.abs(norms - 1).max() > 1e-3):
        raise AssertionError(f"embed: shape {v.shape}, norms {norms}")
    B, S = 2, 1024
    tokens = np.zeros((B, S), np.int32)
    for i, ids in enumerate(inputs):
        tokens[i, :len(ids)] = ids
    plain_fn = make_embed_fn(cfg, bs, attention=flash_mla_prefill_paged_ref)
    kc, vc = allocate_device_cache(cfg, B * S // bs + 1, bs, engine.device,
                                   engine.dtype)
    dev = engine.device
    want = plain_fn(engine.params, torch.from_numpy(tokens).to(dev),
                    torch.tensor(lens, dtype=torch.int32, device=dev), kc,
                    vc).cpu().numpy()
    del kc, vc
    cos = [_cos(a, b) for a, b in zip(vecs, want)]
    log(f"  [{smi}] embeddings, deepseek_v2_lite: 2 inputs of {lens} tokens "
        f"(bucket 2 x 1024): {launches} MLA prefill launches; wall "
        f"{wall * 1e3:.2f} ms a call, {sum(lens) / wall:.0f} input tokens/s; "
        f"|norm - 1| max {np.abs(norms - 1).max():.2e}; kernel vs "
        f"plain-attention embed: cosine min {min(cos):.6f} (>= {EMBED_COS})")
    if min(cos) < EMBED_COS:
        raise AssertionError(f"MLA embed: kernel vs plain cosines {cos}")
    return launches


def sampled_extra(model: str, seed: int, smi: str, host_and_guided: bool,
                  burst: bool = False, spec: Optional[dict] = None,
                  cfg=None):
    """The ``extra`` of ``serve`` that runs :func:`sampled_serving` on the
    serving run's eight prompts (of ``cfg``, default the preset ``model``),
    with ``burst`` then :func:`burst_serving`, and with ``spec``
    (:func:`spec_serving`'s keyword arguments) then :func:`spec_serving`."""
    prompts = serving_prompts(cfg or get_model_config(model), seed)
    async def extra(engine, clock, settle, served):
        out = await sampled_serving(engine, model, prompts, clock, settle,
                                    smi, seed, host_and_guided)
        if burst:
            out["burst"] = await burst_serving(
                engine, model, prompts, clock, settle, smi, seed, served,
                out)
        if spec is not None:
            out["spec"] = await spec_serving(
                engine, model, prompts, clock, settle, smi, seed, served,
                **spec)
        return out

    return extra


def mla_phase(seed: int, smi: str) -> dict:
    """DeepSeek-V2-Lite at full width: serving, one full-width MLA step
    against its plain version, the step profile and an embedding call; then
    the same weights from an int8 latent pool: serving, its pool against
    the bf16 one's, the full-width int8 step and its profile. Returns the
    MLA kernels' launches in the two serving runs by KERNELS name."""
    model = "deepseek_v2_lite"
    engine, served, streams, _ = serving_phase(
        seed, smi, model=model, extra=sampled_extra(
            model, seed, smi, False,
            spec=dict(guided=False, repetitive=True)),
        compare_eager=True, warmup=True, spec_k=SPEC_K)
    launches = {"mla_paged_decode": served["mla_paged_decode"],
                "flash_mla_prefill": served["flash_mla_prefill_paged"]}
    graph_step_check(engine, model, seed)
    full_width_step(engine, model, seed)
    step_profile(engine, model, seed)
    mla_embedding(engine, seed, smi)
    block_copy_check(engine, "deepseek_v2_lite bf16 latent and rope pools",
                     smi)
    params, bf16_blocks = engine.params, engine.num_blocks
    _release(engine)
    del engine
    # the int8 latent pool takes the freed pool's memory; same weights
    engine, served, streams8, _ = serving_phase(seed, smi, "int8",
                                                model=model, params=params,
                                                warmup=True)
    del params
    launches["mla_paged_decode_int8"] = served["mla_paged_decode"]
    same = sum(a == b for a, b in zip(streams8, streams))
    log(f"  int8 latent pool {engine.num_blocks} blocks vs bf16 pool "
        f"{bf16_blocks} blocks ({engine.num_blocks / bf16_blocks:.3f}x); "
        f"{same} of 8 greedy streams equal to the bf16 run's")
    if engine.num_blocks <= bf16_blocks:
        raise AssertionError("the int8 latent pool is not larger than the "
                             "bf16 one")
    full_width_step(engine, model, seed)
    step_profile(engine, model, seed)
    _release(engine)
    return launches


# ------------------------------------------------------------------ phase 11


#: google/gemma-2-9b's published ``config.json``, the fields
#: ``ModelConfig.from_hf_config`` reads (the weights are seeded random)
GEMMA2_9B = {
    "architectures": ["Gemma2ForCausalLM"], "vocab_size": 256000,
    "hidden_size": 3584, "intermediate_size": 14336,
    "num_hidden_layers": 42, "num_attention_heads": 16,
    "num_key_value_heads": 8, "head_dim": 256,
    "query_pre_attn_scalar": 256, "sliding_window": 4096,
    "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
    "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
    "max_position_embeddings": 8192,
    "hidden_activation": "gelu_pytorch_tanh", "tie_word_embeddings": True,
}
#: the long request of the Gemma-2 run: past the even layers' 4096-token
#: window
GEMMA_LONG_PROMPT = 6000


def gemma_phase(seed: int, smi: str) -> dict:
    """Gemma-2-9B at full width and depth (hd 256, the attention and final
    logit softcaps, windows of 4096 on even layers, sandwich norms, GeLU,
    the embedding scale; seeded random weights), ``warmup()`` first: the
    eight requests of phase 3 and one of GEMMA_LONG_PROMPT tokens on both
    loops (streams equal, the ragged kernel 42 times a step, no capture),
    the seeded sampled requests on both loops, the captured step against
    the eager one, a full-width step through the kernel against the plain
    attention (every logit within the final cap), the S == 1 dense step
    through the paged decode kernel, and an embedding call through the
    flash prefill kernel; then the same weights from an int8 KV pool: the
    requests and the full-width step again. Returns the launches of each
    ``*_gemma2`` kernel by KERNELS name."""
    model = "gemma2_9b"
    hf = GEMMA2_9B
    cfg = ModelConfig.from_hf_config(hf)
    want = (hf["head_dim"], (hf["sliding_window"], 0),
            hf["attn_logit_softcapping"], hf["final_logit_softcapping"],
            hf["query_pre_attn_scalar"], hf["num_hidden_layers"])
    got = (cfg.head_dim, cfg.layer_windows[:2], cfg.attn_logit_softcap,
           cfg.final_logit_softcap, cfg.query_pre_attn_scalar,
           cfg.num_layers)
    if got != want or not (cfg.sandwich_norms and cfg.embed_scale
                           and cfg.norm_plus_one and cfg.tie_word_embeddings
                           and cfg.hidden_activation == "gelu_tanh"):
        raise AssertionError(f"Gemma-2-9B config: {cfg}")
    rng = np.random.default_rng(seed + 80)
    prompts = serving_prompts(cfg, seed) + [
        list(map(int, rng.integers(0, cfg.vocab_size, GEMMA_LONG_PROMPT)))]
    engine, served, streams, out = serving_phase(
        seed, smi, model=model, cfg=cfg, max_model_len=8192,
        prompts=prompts, warmup=True,
        extra=sampled_extra(model, seed, smi, False, cfg=cfg))
    n_params = sum(t.numel() for t in _leaves(engine.params))
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(engine.params))
    st = out["stats"]
    log(f"  [{smi}] {model}: {n_params / 1e9:.3f} B parameters, "
        f"{nbytes / 1e9:.2f} GB of weights: the weight-read bound of a "
        f"decode step is {nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms against a "
        f"pipelined decode step wall of {st['step_ms']:.3f} ms")
    launches = {"ragged_paged_attention_gemma2":
                served["ragged_paged_attention"]}
    graph_step_check(engine, model, seed)
    full_width_step(engine, model, seed, decode_kv=GEMMA_LONG_PROMPT,
                    ties=True)
    final_cap_check(engine, model, seed)
    launches["paged_attention_decode_gemma2"] = dense_decode_step(
        engine, seed, smi, model)
    launches["flash_prefill_gemma2"] = embedding_phase(engine, seed, smi)
    params, bf16_blocks = engine.params, engine.num_blocks
    _release(engine)
    del engine
    engine, served, streams8, _ = serving_phase(
        seed, smi, "int8", model=model, params=params, cfg=cfg,
        max_model_len=8192, prompts=prompts, warmup=True)
    del params
    launches["ragged_paged_attention_int8_gemma2"] = served[
        "ragged_paged_attention"]
    same = sum(a == b for a, b in zip(streams8, streams))
    log(f"  int8 KV pool {engine.num_blocks} blocks vs bf16 pool "
        f"{bf16_blocks} blocks; {same} of {len(streams)} greedy streams "
        f"equal to the bf16 run's")
    full_width_step(engine, model, seed, decode_kv=GEMMA_LONG_PROMPT,
                    ties=True)
    _release(engine)
    return launches


#: the dense families' step checks: preset, the decode row's kv (Mistral's
#: past its 4096-token window), and the leaves the init draws as zeros or
#: ones that get seeded noise first (so a bias or norm the kernels' path
#: dropped would show)
FAMILY_CHECKS = (("mistral_7b", 4500, ()),
                 ("qwen2_7b", 701, ("bq", "bk", "bv")),
                 ("qwen3_8b", 701, ("q_norm", "k_norm")))


def family_checks(seed: int, smi: str) -> None:
    """Mistral-7B (its sliding window on a 4500-token row), Qwen2-7B (q/k/v
    biases, a group of 7) and Qwen3-8B (q/k norms) at full width and 2
    layers: the captured step bit-equal to the eager one, and a full-width
    step through the kernel against the plain attention (argmax up to the
    bf16 tie rule)."""
    for name, decode_kv, noisy in FAMILY_CHECKS:
        cfg = dataclasses.replace(get_model_config(name), num_layers=2)
        t0 = time.perf_counter()
        engine = AsyncTorchEngine(cfg, EngineArgs(
            block_size=16, max_num_seqs=8, max_num_batched_tokens=2048,
            max_model_len=8192, seed=seed, num_blocks=4096))
        gen = torch.Generator(device=engine.device).manual_seed(seed + 90)
        for leaf in noisy:
            t = engine.params["layers"][leaf]
            base = 1.0 if leaf.endswith("norm") else 0.0
            t.copy_(base + 0.3 * torch.randn(t.shape, generator=gen,
                                             device=engine.device))
        log(f"family check {name} (2 of {get_model_config(name).num_layers} "
            f"layers; D{cfg.hidden_size} H{cfg.num_heads} "
            f"KV{cfg.num_kv_heads} hd{cfg.head_dim}, window "
            f"{cfg.sliding_window}, qkv_bias {cfg.qkv_bias}, qk_norm "
            f"{cfg.qk_norm}; noise on {list(noisy)}): set up in "
            f"{time.perf_counter() - t0:.1f} s")
        graph_step_check(engine, name, seed)
        # two layers of random weights: exact bf16 ties at the top occur
        full_width_step(engine, name, seed, decode_kv=decode_kv, ties=True)
        _release(engine)
        del engine


# ------------------------------------------------- phases 6 (end) and 8


#: where the worker phase writes its checkpoint: inside the checkout (a
#: directory .gitignore lists), removed when the phase ends
CKPT_DIR = pathlib.Path(__file__).resolve().parent / ".smoke_ckpt"
#: the name the worker registers its model under
WORKER_MODEL = "llama3-8b-smoke"
#: seconds the worker has to exit after SIGTERM, and to register
WORKER_EXIT_S = 60
WORKER_READY_S = 600
#: Llama-3's special token ids, for the checkpoint's config files
LLAMA3_BOS, LLAMA3_EOS = 128000, [128001, 128009]
_ST_DTYPES = {torch.bfloat16: "BF16", torch.float16: "F16",
              torch.float32: "F32"}


def write_safetensors(path, tensors) -> int:
    """One ``.safetensors`` file: the 8-byte little-endian header length,
    the JSON header (padded with spaces to 8 bytes), then each tensor's
    bytes in order. ``tensors`` is [(name, fn)], ``fn()`` giving the
    tensor (a view), so only one tensor at a time is copied and crosses to
    the host. Returns the bytes of tensor data written."""
    header, off = {}, 0
    for name, fn in tensors:
        t = fn()  # a view: no copy yet
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for name, fn in tensors:
            host = fn().contiguous().cpu()
            f.write(host.view(torch.uint8).numpy().data)
    return off


def llama_hf_tensors(params: dict, layers) -> list:
    """[(HF name, fn)] of a Llama params dict's layers ``layers`` (and, for
    layer 0 / the last layer, the embedding / the final norm and the LM
    head), in HF's [out, in] layout."""
    lw = params["layers"]
    out = []
    first, last = layers[0] == 0, layers[-1] == lw["wq"].shape[0] - 1
    if first:
        out.append(("model.embed_tokens.weight", lambda: params["embed"]))
    for i in layers:
        pre = f"model.layers.{i}"
        out += [
            (f"{pre}.input_layernorm.weight", lambda i=i: lw["attn_norm"][i]),
            (f"{pre}.post_attention_layernorm.weight",
             lambda i=i: lw["mlp_norm"][i])]
        for key, name in (("wq", "self_attn.q_proj"),
                          ("wk", "self_attn.k_proj"),
                          ("wv", "self_attn.v_proj"),
                          ("wo", "self_attn.o_proj"),
                          ("w_gate", "mlp.gate_proj"),
                          ("w_up", "mlp.up_proj"),
                          ("w_down", "mlp.down_proj")):
            out.append((f"{pre}.{name}.weight",
                        lambda i=i, key=key: lw[key][i].T))
    if last:
        out.append(("model.norm.weight", lambda: params["final_norm"]))
        out.append(("lm_head.weight", lambda: params["lm_head"].T))
    return out


def write_llama_checkpoint(cfg, params: dict, path) -> int:
    """An HF-layout Llama checkpoint of ``params`` (``cfg``'s depth):
    safetensors shards of eight layers, their index, ``config.json`` and
    ``generation_config.json``. Returns the bytes of weights written."""
    path.mkdir(parents=True, exist_ok=True)
    L = cfg.num_layers
    groups = [list(range(k, min(k + 8, L))) for k in range(0, L, 8)]
    total, weight_map = 0, {}
    for k, layers in enumerate(groups):
        name = f"model-{k + 1:05d}-of-{len(groups):05d}.safetensors"
        tensors = llama_hf_tensors(params, layers)
        total += write_safetensors(path / name, tensors)
        weight_map.update({t: name for t, _ in tensors})
    (path / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map}))
    (path / "config.json").write_text(json.dumps({
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": L, "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
        "rope_theta": cfg.rope_theta, "rope_scaling": cfg.rope_scaling,
        "rms_norm_eps": cfg.rms_norm_eps,
        "max_position_embeddings": cfg.max_position_embeddings,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "torch_dtype": cfg.dtype, "hidden_act": "silu",
        "bos_token_id": LLAMA3_BOS, "eos_token_id": LLAMA3_EOS}, indent=1))
    (path / "generation_config.json").write_text(json.dumps(
        {"bos_token_id": LLAMA3_BOS, "eos_token_id": LLAMA3_EOS}))
    return total


def _layer_bytes(params: dict) -> tuple[int, int]:
    """(bytes of the per-layer stacks for one layer, bytes of the rest)."""
    lw = params["layers"]
    per = sum(t[0].numel() * t.element_size() for t in lw.values())
    rest = sum(t.numel() * t.element_size() for k, t in params.items()
               if k != "layers")
    return per, rest


def checkpoint_phase(engine, seed: int, smi: str, ref: dict) -> dict:
    """Write the Llama-3-8B engine's weights as an HF checkpoint (its KV
    pool freed first), then check that the port reads it back: the config
    field by field against the preset, the weights bit for bit. When the
    disk cannot hold the whole model, the checkpoint keeps the first
    layers that fit (the width is never cut), and the worker phase's
    reference streams come from a direct engine over those layers.
    Releases the engine. Returns what the worker phase checks against."""
    engine.k_cache = engine.v_cache = None
    engine._embed_cache = None
    gc.collect()
    torch.cuda.empty_cache()
    cfg, params = engine.cfg, engine.params
    per, rest = _layer_bytes(params)
    need = rest + cfg.num_layers * per
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(CKPT_DIR).free
    margin = 2 << 30
    L = cfg.num_layers
    if free < need + margin:
        L = (free - margin - rest) // per
        if L < 1:
            raise AssertionError(f"{free / 1e9:.1f} GB free on the disk: "
                                 "not enough for one layer's checkpoint")
        log(f"  checkpoint: {free / 1e9:.1f} GB free on the disk for "
            f"{need / 1e9:.2f} GB: depth cut to {L} of {cfg.num_layers} "
            "layers, width kept")
    ckpt_cfg = dataclasses.replace(cfg, num_layers=L)
    cut = {**params, "layers": {k: t[:L] for k, t in
                                params["layers"].items()}}
    t0 = time.perf_counter()
    nbytes = write_llama_checkpoint(ckpt_cfg, cut, CKPT_DIR)
    write_s = time.perf_counter() - t0
    got_cfg = ModelConfig.from_pretrained(str(CKPT_DIR))
    if dataclasses.asdict(got_cfg) != dataclasses.asdict(ckpt_cfg):
        raise AssertionError(f"from_pretrained: {got_cfg} != {ckpt_cfg}")
    t0 = time.perf_counter()
    loaded = load_hf_params(got_cfg, str(CKPT_DIR), "cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    want, got = dict(_named(cut)), dict(_named(loaded))
    if sorted(want) != sorted(got):
        raise AssertionError(f"loaded {sorted(got)}, want {sorted(want)}")
    for name, t in want.items():
        if got[name].dtype != t.dtype or not torch.equal(got[name], t):
            raise AssertionError(f"checkpoint weight {name} differs")
    del loaded, got
    log(f"  [{smi}] checkpoint: {nbytes / 1e9:.2f} GB of weights, {L} "
        f"layers, in {len(list(CKPT_DIR.glob('*.safetensors')))} "
        f"safetensors shards written in {write_s:.1f} s; from_pretrained "
        f"equals the preset field by field; load_hf_params read it back "
        f"in {load_s:.1f} s, bit-equal ({len(want)} tensors)")
    if L < cfg.num_layers:
        ref = direct_reference(ckpt_cfg, cut, seed, ref)
    _release(engine)
    del params, cut, want
    gc.collect()
    torch.cuda.empty_cache()
    return {**ref, "layers": L}


def direct_reference(cfg, params, seed: int, ref: dict) -> dict:
    """The worker phase's references from a direct engine over ``params``
    (a depth-cut checkpoint's): the solo streams, the KV blocks they store
    and the reference embedding."""
    events = []
    engine = AsyncTorchEngine(cfg, EngineArgs(
        block_size=16, max_num_seqs=8, max_num_batched_tokens=2048,
        max_model_len=4096, seed=seed), params=params,
        event_cb=events.append)

    async def run():
        solo, hashes = [], set()
        try:
            for prompt, _ in ref["solo"]:
                engine.pool.clear()
                n0 = len(events)
                toks = []
                async for o in engine.generate(PreprocessedRequest(
                        model=WORKER_MODEL, token_ids=prompt,
                        stop_conditions=StopConditions(
                            max_tokens=len(ref["solo"][0][1]),
                            ignore_eos=True))):
                    toks.extend(o.token_ids)
                solo.append((prompt, toks))
                hashes.update(b.block_hash for e in events[n0:]
                              for b in e.stored_blocks)
            vec = (await engine.embed([ref["embed"][0]]))[0]
        finally:
            await engine.close()
        return solo, hashes, vec

    solo, hashes, vec = asyncio.run(run())
    _release(engine)
    return {**ref, "streams": None, "solo": solo, "solo_hashes": hashes,
            "embed": (ref["embed"][0], vec)}


def _named(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


#: what warmup() captures on a worker: each token bucket (8 to 2048) as a
#: mixed and a decode-only step, and the greedy sampler of 8 rows
WARMUP_CAPTURES = {"ragged": 9, "ragged_dec": 9, "sample": 1}


async def _spawn_worker(addr: str, log_path, *extra: str):
    """``python -m dynamo_tpu_torch.engine.main`` on the checkpoint, joined
    to the hub at ``addr``, its stderr into ``log_path``."""
    with open(log_path, "w") as wlog:
        return await asyncio.create_subprocess_exec(
            sys.executable, "-m", "dynamo_tpu_torch.engine.main",
            "--model-path", str(CKPT_DIR), "--model", WORKER_MODEL,
            "--block-size", "16", "--max-num-seqs", "8",
            "--max-num-batched-tokens", "2048", "--max-model-len", "4096",
            *extra, stdout=asyncio.subprocess.PIPE, stderr=wlog,
            env={**os.environ, "DYN_CONTROL_PLANE": addr},
            cwd=str(pathlib.Path(__file__).resolve().parent))


async def _worker_run(ref: dict, smi: str) -> dict:
    """The worker phase on an event loop: the port's hub, the worker
    process, a client runtime; every check of the phase."""
    from dynamo_tpu_torch.runtime import ControlPlaneServer, DistributedRuntime

    hub = ControlPlaneServer()
    addr = await hub.start()
    log_path = CKPT_DIR / "worker.log"
    t_spawn = time.perf_counter()
    proc = await _spawn_worker(addr, log_path, "--warmup-buckets")
    rt = await DistributedRuntime.create(address=addr)
    try:
        deadline = time.perf_counter() + WORKER_READY_S
        while not await rt.plane.kv_get_prefix(f"models/{WORKER_MODEL}/"):
            if proc.returncode is not None:
                raise AssertionError(f"the worker exited with "
                                     f"{proc.returncode} before registering")
            if time.perf_counter() > deadline:
                raise AssertionError(f"the worker did not register within "
                                     f"{WORKER_READY_S} s")
            await asyncio.sleep(0.2)
        ready_s = time.perf_counter() - t_spawn
        ns = rt.namespace("dynamo").component("backend")
        gen = await ns.endpoint("generate").client().start()
        (lease,) = await gen.wait_for_instances()
        events = await rt.plane.stream_subscribe("kv_events")
        stored = set()

        async def drain_events():
            async for _seq, payload in events:
                ev = RouterEvent.from_wire(unpackb(payload))
                if ev.worker_id == lease:
                    stored.update(b.block_hash
                                  for b in ev.event.stored_blocks)

        drain = asyncio.get_running_loop().create_task(drain_events())

        async def one(prompt, n):
            t0 = time.perf_counter()
            stamps, toks, reason = [], [], None
            async for frame in await gen.generate(PreprocessedRequest(
                    model=WORKER_MODEL, token_ids=prompt,
                    stop_conditions=StopConditions(
                        max_tokens=n, ignore_eos=True)).to_wire()):
                out = LLMEngineOutput.from_wire(frame)
                stamps.append(time.perf_counter())
                toks.extend(out.token_ids)
                reason = out.finish_reason or reason
            return t0, stamps, toks, reason

        async def ask(endpoint, request):
            client = await ns.endpoint(endpoint).client().start()
            await client.wait_for_instances()
            async for frame in await client.generate(request):
                await client.stop()
                return frame
            raise AssertionError(f"{endpoint}: no answer")

        max_tokens = len(ref["solo"][0][1])
        await one(list(range(1, 17)), 2)  # the same warm-up as phase 3
        # the load metrics the worker publishes after each step: the
        # requests running and waiting there, read for the burst's first
        # steps (after the warm-up's last report has landed)
        await asyncio.sleep(0.5)
        loads = await rt.plane.subscribe(KV_METRICS_SUBJECT)
        admission = []

        async def drain_loads():
            async for _subject, payload in loads:
                worker, m = parse_load_event(payload)
                if worker == lease:
                    admission.append((m.worker_stats.request_active_slots,
                                      m.worker_stats.num_requests_waiting))

        drain_l = asyncio.get_running_loop().create_task(drain_loads())
        t0 = time.perf_counter()
        res = await asyncio.gather(*(one(p, max_tokens)
                                     for p in ref["prompts"]))
        st = serving_stats(res, time.perf_counter() - t0)
        drain_l.cancel()
        await loads.cancel()
        st["admission"] = admission[:4]
        # a request whose dispatch went unanswered is retried by the client
        # after the request timeout: it streams correctly, but late
        if st["ttft_max"] >= rt.config.request_timeout * 1e3:
            raise AssertionError(
                f"a worker request waited {st['ttft_max']:.0f} ms for its "
                f"first token: its dispatch went unanswered for the "
                f"{rt.config.request_timeout} s request timeout")
        for i, (_t, _s, toks, reason) in enumerate(res):
            if reason != "length" or len(toks) != max_tokens:
                raise AssertionError(f"worker stream {i}: {reason!r} after "
                                     f"{len(toks)} tokens")
        # each solo prompt alone on an emptied prefix cache, as in phase 3
        for prompt, want in ref["solo"]:
            cleared = await ask("clear_kv_blocks", {})
            if not cleared.get("ok"):
                raise AssertionError(f"clear_kv_blocks answered {cleared}")
            got = (await one(prompt, max_tokens))[2]
            if got != want:
                raise AssertionError(f"worker solo stream {got} != the "
                                     f"direct engine's {want}")
        # the eight prompts each alone on an emptied prefix cache: the
        # references of the disaggregated pair's solo pass
        alone = []
        for prompt in ref["prompts"]:
            await ask("clear_kv_blocks", {})
            alone.append((await one(prompt, max_tokens))[2])
        ids, want_vec = ref["embed"]
        frame = await ask("embed", {"token_ids": [ids]})
        cos = _cos(frame["embeddings"][0], want_vec)
        if cos < EMBED_COS:
            raise AssertionError(f"worker embedding cosine {cos}")
        for _ in range(100):
            if ref["solo_hashes"] <= stored:
                break
            await asyncio.sleep(0.05)
        if not ref["solo_hashes"] <= stored:
            raise AssertionError(
                f"{len(ref['solo_hashes'] - stored)} of the direct engine's "
                f"{len(ref['solo_hashes'])} solo-prompt blocks missing from "
                "the worker's KV events")
        # SIGTERM: a clean exit, and the instance leaves discovery
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = await asyncio.wait_for(proc.wait(), WORKER_EXIT_S)
        exit_s = time.perf_counter() - t0
        stdout = (await proc.stdout.read()).decode()
        if rc != 0:
            raise AssertionError(f"the worker exited with {rc}")
        for _ in range(100):
            if not gen.instance_ids():
                break
            await asyncio.sleep(0.05)
        left = await rt.plane.kv_get_prefix(f"models/{WORKER_MODEL}/")
        if gen.instance_ids() or left:
            raise AssertionError(f"the worker is still in discovery: "
                                 f"{gen.instance_ids()} {sorted(left)}")
        drain.cancel()
        await gen.stop()
        report = json.loads(stdout.split("WORKER_EXIT ", 1)[1].splitlines()[0])
        same = (sum(r[2] == want for r, want in zip(res, ref["streams"]))
                if ref["streams"] else None)
        return {"stats": st, "ready_s": ready_s, "exit_s": exit_s,
                "cos": cos, "report": report, "lease": lease,
                "blocks": len(stored), "same": same, "alone": alone,
                "streams": [r[2] for r in res]}
    except BaseException:
        log(f"worker log (tail):\n{log_path.read_text()[-4000:]}")
        raise
    finally:
        if proc.returncode is None:
            proc.kill()
            await proc.wait()
        await rt.shutdown()
        await hub.stop()


def worker_phase(ref: dict, smi: str, direct: dict) -> dict:
    """The worker: ``python -m dynamo_tpu_torch.engine.main`` on the
    checkpoint the checkpoint phase wrote, behind the port's own hub,
    driven by a port ``Client`` over the TCP response plane. Returns what
    the run measured: the stats, the eight streams, each prompt's stream
    alone, and the worker's kernel launches by wrapper name."""
    out = asyncio.run(_worker_run(ref, smi))
    L, report = ref["layers"], out["report"]
    launches = report["launches"]
    # the warmup's dummy steps (--warmup-buckets) are forward steps too
    want = {"ragged_paged_attention": L * report["forward_steps"],
            "flash_prefill": L}  # the one embed call
    for name, n in launches.items():
        if n != want.get(name, 0) or (name in want and n == 0):
            raise AssertionError(f"worker launches {launches}, want {want} "
                                 f"({report['steps']} steps)")
    # every capture is the warmup's
    if report["compile_events"] != WARMUP_CAPTURES:
        raise AssertionError(f"worker captures {report['compile_events']}: "
                             f"not only the warmup's")
    log(f"  [{smi}] worker: registered {out['ready_s']:.1f} s after spawn "
        f"(load and warmup included), instance {out['lease']:x}; "
        f"{report['steps']} engine steps ({report['pipelined_steps']} "
        f"pipelined, {report['forward_steps']} forward steps with the "
        f"warmup's), launches {launches}, captures "
        f"{report['compile_events']}; {out['blocks']} KV blocks stored on "
        f"the event stream")
    log(f"  [{smi}] worker over TCP, 8 streams x "
        f"{len(ref['solo'][0][1])} tokens: {stats_line(out['stats'])}")
    log(f"  [{smi}] direct engine, same requests: {stats_line(direct)}")
    log(f"  (running, waiting) requests after each of the first steps: "
        f"worker {out['stats']['admission']}, direct engine "
        f"{direct['admission']}")
    if out["same"] is not None:
        # not a gate: the requests reach the worker at other times, so its
        # steps hold other rows and shapes than the engine's
        log(f"  {out['same']} of the worker's 8 streams equal the direct "
            f"engine's")
    log(f"  worker: solo streams equal the direct engine's; embedding cosine "
        f"{out['cos']:.6f} (>= {EMBED_COS}); clear_kv_blocks ok; exit 0 "
        f"{out['exit_s']:.2f} s after SIGTERM (<= {WORKER_EXIT_S} s), "
        f"discovery empty")
    return {**out, "launches": launches}


#: the disaggregated pair's decode-side threshold, and the length of its
#: long prompt (two chunks at 2048 batched tokens)
DISAGG_THRESHOLD = 64
LONG_PROMPT = 3000
#: seconds one request of the pair may take before the phase fails
DISAGG_REQUEST_S = 120


def _exit_report(stdout: str) -> dict:
    return json.loads(stdout.split("WORKER_EXIT ", 1)[1].splitlines()[0])


def transfer_split(decode: dict, prefill: dict) -> dict:
    """One remote prefill's transfer from both workers' records (same
    request id, frames in the same order): its link path, MB moved, the
    chunk and layer frames, and its seconds summed over the frames: gather
    (prefill side: the gather's launch to the frame's bytes on the host,
    or to its offer on a direct path), wire (the frame ready to its arrival
    at the decode handler: the response plane's encoding, TCP, decoding),
    open (decode side: a direct pull's claim and CUDA IPC mapping), scatter
    (decode side: parsing and pinning on the host path, the copy and
    scatter launches) and release (a direct pull: the wait for its scatter
    on the device, the unmapping). Fails unless the decode worker's placed
    blocks hold the bytes of the prefill worker's blocks (their digests),
    whatever else ran beside the request."""
    pf, df = prefill["frames"], decode["frames"]
    if [f[0] for f in pf] != [f[0] for f in df]:
        raise AssertionError(f"request {decode['id']}: prefill frames "
                             f"{[f[0] for f in pf]}, decode frames "
                             f"{[f[0] for f in df]}")
    if decode.get("digest") is None or decode["digest"] != prefill["digest"]:
        raise AssertionError(f"request {decode['id']}: the decode worker's "
                             f"blocks digest {decode.get('digest')}, the "
                             f"prefill worker's {prefill['digest']}")
    if decode["path"] != prefill["mode"]:
        raise AssertionError(f"request {decode['id']}: the decode worker "
                             f"placed over {decode['path']}, the prefill "
                             f"worker offered {prefill['mode']}")
    return {"path": decode["path"], "mb": sum(f[1] for f in df) / 1e6,
            "chunks": sum(f[0] == "chunk" for f in df),
            "layers": sum(f[0] == "layer" for f in df),
            "stage_s": sum(t1 - t0 for _k, _n, t0, t1 in pf),
            "wire_s": sum(d[2] - p[3] for p, d in zip(pf, df)),
            "open_s": [f[4] for f in df if decode["path"] != "host"],
            "scatter_s": sum(f[3] for f in df),
            "release_s": decode["release_s"],
            "stream_s": decode["stream_s"]}


def split_line(sp: dict) -> str:
    """A transfer's split as ``disagg_phase`` prints it."""
    frames = (f"{sp['mb']:.1f} MB in {sp['chunks']} chunk + {sp['layers']} "
              f"layer frames")
    if sp["path"] == "host":
        return (f"{frames}; gather+staging {sp['stage_s'] * 1e3:.1f} ms, "
                f"wire {sp['wire_s'] * 1e3:.1f} ms, scatter "
                f"{sp['scatter_s'] * 1e3:.1f} ms (frame sums); stream "
                f"{sp['stream_s'] * 1e3:.1f} ms")
    return (f"{frames} over {sp['path']}; gather {sp['stage_s'] * 1e3:.1f} "
            f"ms, wire {sp['wire_s'] * 1e3:.1f} ms, open "
            f"{sum(sp['open_s']) * 1e3:.1f} ms ({len(sp['open_s'])} pulls), "
            f"scatter {sp['scatter_s'] * 1e3:.1f} ms, release "
            f"{sp['release_s'] * 1e3:.1f} ms (sums); stream "
            f"{sp['stream_s'] * 1e3:.1f} ms")


def first_diff(a: list, b: list):
    """The index of the first token where two streams differ, or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


async def _disagg_run(ref: dict, agg: dict, direct: bool = True) -> dict:
    """The disaggregated pair on an event loop: the hub, a prefill and a
    decode worker process, a client runtime; the requests of the phase.
    ``direct`` False: both workers host-staged (``--no-kv-transfer-
    direct``), and only the warm-up, the eight together and the long
    prompt remotely."""
    from dynamo_tpu_torch.runtime import ControlPlaneServer, DistributedRuntime

    hub = ControlPlaneServer()
    addr = await hub.start()
    tag = "" if direct else "-host"
    logs = {role: CKPT_DIR / f"{role}{tag}.log"
            for role in ("prefill", "decode")}
    off = () if direct else ("--no-kv-transfer-direct",)
    t_spawn = time.perf_counter()
    procs = {
        "prefill": await _spawn_worker(addr, logs["prefill"], "--role",
                                       "prefill", "--num-blocks", "4096",
                                       "--warmup-buckets", *off),
        "decode": await _spawn_worker(
            addr, logs["decode"], "--role", "decode",
            "--max-local-prefill-length", str(DISAGG_THRESHOLD),
            "--num-blocks", "4096", "--warmup-buckets", *off)}
    rt = await DistributedRuntime.create(address=addr)
    try:
        ns = rt.namespace("dynamo")
        gen = await ns.component("backend").endpoint(
            "generate").client().start()
        pre = await ns.component("prefill").endpoint(
            "generate").client().start()
        deadline = time.perf_counter() + WORKER_READY_S
        while (not await rt.plane.kv_get_prefix(f"models/{WORKER_MODEL}/")
               or not pre.instance_ids()):
            for role, proc in procs.items():
                if proc.returncode is not None:
                    raise AssertionError(f"the {role} worker exited with "
                                         f"{proc.returncode} before serving")
            if time.perf_counter() > deadline:
                raise AssertionError(f"the pair was not up within "
                                     f"{WORKER_READY_S} s")
            await asyncio.sleep(0.2)
        ready_s = time.perf_counter() - t_spawn
        (prefill_lease,) = pre.instance_ids()
        await asyncio.sleep(1.0)  # the decode worker's discovery sees it too
        clear = {c: await ns.component(c).endpoint(
            "clear_kv_blocks").client().start()
            for c in ("backend", "prefill")}
        await gen.wait_for_instances()
        max_tokens = len(ref["solo"][0][1])

        async def one(prompt, rid, restore=None):
            t0 = time.perf_counter()
            stamps, toks, reason = [], [], None

            async def stream():
                nonlocal reason
                async for frame in await gen.generate(PreprocessedRequest(
                        model=WORKER_MODEL, token_ids=prompt,
                        restore=restore, stop_conditions=StopConditions(
                            max_tokens=max_tokens, ignore_eos=True)
                        ).to_wire(), ctx=Context(id=rid)):
                    out = LLMEngineOutput.from_wire(frame)
                    stamps.append(time.perf_counter())
                    toks.extend(out.token_ids)
                    reason = out.finish_reason or reason

            try:
                await asyncio.wait_for(stream(), DISAGG_REQUEST_S)
            except asyncio.TimeoutError:
                raise AssertionError(f"disagg request {rid}: {len(toks)} "
                                     f"tokens in {DISAGG_REQUEST_S} s")
            if reason != "length" or len(toks) != max_tokens:
                raise AssertionError(f"disagg stream {rid}: {reason!r} "
                                     f"after {len(toks)} tokens")
            return t0, stamps, toks, reason

        async def emptied(*components):
            for c in components:
                async for frame in await clear[c].generate({}):
                    if not frame.get("ok"):
                        raise AssertionError(f"clear_kv_blocks: {frame}")

        async def threshold(n: int):
            await rt.plane.kv_put(DisaggConfig.KEY, str(n).encode())
            await asyncio.sleep(1.0)  # the decode worker's watch applies it

        log(f"  {'direct' if direct else 'host-staged'} pair up in "
            f"{ready_s:.1f} s; requests:")
        await one(list(range(1, 17)), "warmup")  # local: under the threshold
        log("    warm-up (local) done")
        if direct:
            # each prompt alone on emptied caches: the aggregated worker's
            # stream of the same prompt alone
            for i, (prompt, want) in enumerate(zip(ref["prompts"],
                                                   agg["alone"])):
                await emptied("backend", "prefill")
                got = (await one(prompt, f"solo-{i}"))[2]
                if got != want:
                    raise AssertionError(f"disagg solo stream {i}: {got} != "
                                         f"the aggregated worker's {want}")
                log(f"    solo-{i} done")
        # the eight concurrently, as the worker phase sent them
        await emptied("backend", "prefill")
        t0 = time.perf_counter()
        res = await asyncio.gather(*(one(p, f"burst-{i}") for i, p in
                                     enumerate(ref["prompts"])))
        st = serving_stats(res, time.perf_counter() - t0)
        burst = [r[2] for r in res]
        log("    burst done")
        # a long prompt: chunk frames, then the layer-group tail; then the
        # same prompt prefilled locally once the live threshold is raised
        vocab = ModelConfig.from_pretrained(str(CKPT_DIR)).vocab_size
        rng = np.random.default_rng(23)
        long = list(map(int, rng.integers(0, vocab, LONG_PROMPT)))
        await emptied("backend")  # the prefill worker keeps the burst's
        remote = (await one(long, "long-remote"))[2]
        out = {"ready_s": ready_s, "stats": st, "burst": burst,
               "long_tokens": LONG_PROMPT, "long": remote}
        if direct:
            await threshold(1 << 20)
            await emptied("backend")
            local = (await one(long, "long-local"))[2]
            if local != remote:
                raise AssertionError(f"the long prompt prefilled locally "
                                     f"gave {local}, remotely {remote}")
            log("    long prompt remote and local done")
            # a restore pull of blocks computed for the prompt alone: both
            # caches emptied, the prompt once through the pair (its prefill
            # on the prefill worker), the decode worker's cache emptied,
            # then the request with a plan naming the prefill worker; then
            # the prompt remotely again, its tail computed over those
            # blocks on the prefill worker: the same computation, without
            # the pull
            prompt = ref["prompts"][0]
            full = (len(prompt) - 1) // 16
            await threshold(DISAGG_THRESHOLD)
            await emptied("backend", "prefill")
            seeded = (await one(prompt, "restore-seed"))[2]
            await emptied("backend")
            restored = (await one(prompt, "restore", restore={
                "sources": [[prefill_lease, full, 1.0]],
                "block_size": 16}))[2]
            await emptied("backend")
            tail_ref = (await one(prompt, "restore-ref"))[2]
            # the seeding run computed the blocks as the aggregated worker
            # did for the prompt alone (and its digests matched); the
            # restore computes the 1-15 token tail over them in a smaller
            # step, so its stream is held against the same computation
            # without the pull, and where it leaves the stream alone is
            # printed
            if seeded != agg["alone"][0]:
                raise AssertionError(
                    f"the seeding stream {seeded} != the aggregated worker's "
                    f"stream of the prompt alone {agg['alone'][0]}")
            if restored != tail_ref:
                raise AssertionError(f"restored stream {restored} != the "
                                     f"stream over the prefill worker's "
                                     f"blocks {tail_ref}")
            out.update(full=full,
                       restored_diff=first_diff(restored, agg["alone"][0]))
        else:
            log("    long prompt remote done")
        for c in (gen, pre, *clear.values()):
            await c.stop()
        reports, exits = {}, {}
        for role, proc in procs.items():
            t0 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            rc = await asyncio.wait_for(proc.wait(), WORKER_EXIT_S)
            exits[role] = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"the {role} worker exited with {rc}")
            reports[role] = _exit_report((await proc.stdout.read()).decode())
        return {**out, "reports": reports, "exits": exits}
    except BaseException:
        for role, path in logs.items():
            log(f"{role} worker log (tail):\n{path.read_text()[-4000:]}")
        raise
    finally:
        for proc in procs.values():
            if proc.returncode is None:
                proc.kill()
                await proc.wait()
        await rt.shutdown()
        await hub.stop()


def _pair_gates(out: dict, ref: dict, remote: int, path: str) -> dict:
    """The gates every pair run holds (and returns each request's split):
    ``remote`` remote prefills, each placed over ``path`` with no fallback
    and no failed pull, its placed blocks' digest the prefill worker's; no
    block in use, offer outstanding or handle mapped at exit; the prefill
    worker's allocated device bytes at exit those at its registration;
    ragged launches 32 a forward step; no capture past the warmups."""
    L = ref["layers"]
    dec, pre = out["reports"]["decode"], out["reports"]["prefill"]
    dis = dec["disagg"]
    if dis.get("fallbacks") or dis.get("remote_prefills") != {
            "placed": remote}:
        raise AssertionError(f"remote prefills {dis.get('remote_prefills')}"
                             f", fallbacks {dis.get('fallbacks')}: want "
                             f"{remote} placed and no fallback")
    if (dis.get("transfer_paths") != {path: remote}
            or dis.get("direct_pull_failures")):
        raise AssertionError(f"transfers by path {dis.get('transfer_paths')}"
                             f", failed pulls "
                             f"{dis.get('direct_pull_failures')}: want "
                             f"{remote} over {path} and none failed")
    for role, rep in out["reports"].items():
        if rep["active_blocks"]:
            raise AssertionError(f"the {role} worker holds "
                                 f"{rep['active_blocks']} blocks after "
                                 "the requests ended")
        want = {"ragged_paged_attention": L * rep["forward_steps"]}
        got = {k: v for k, v in rep["launches"].items() if v}
        if got != want or not rep["forward_steps"]:
            raise AssertionError(f"the {role} worker's launches {got}, "
                                 f"want {want}")
        if rep["compile_events"] != WARMUP_CAPTURES:
            raise AssertionError(f"{role} worker captures "
                                 f"{rep['compile_events']}: not only the "
                                 "warmup's")
        direct = rep.get("direct") or {}
        if (direct.get("outstanding") or direct.get("held_bytes")
                or direct.get("mapped") or direct.get("pull_failures")):
            raise AssertionError(f"the {role} worker's direct transfer at "
                                 f"exit: {direct}")
    if path != "host" and (pre["direct"]["offers"]
                           != dec["direct"]["pulls"]):
        raise AssertionError(f"{pre['direct']['offers']} offers, "
                             f"{dec['direct']['pulls']} pulls")
    mem = pre["device_bytes"]
    if mem["exit"] != mem["ready"]:
        raise AssertionError(f"the prefill worker's allocated device bytes: "
                             f"{mem['ready']} when registered, "
                             f"{mem['exit']} at exit")
    records = {r["id"]: r for r in pre["extract"]}
    splits = {r["id"]: transfer_split(r, records[r["id"]])
              for r in dis["transfers"]}
    if len(splits) != remote:
        raise AssertionError(f"{len(splits)} transfers matched, want {remote}")
    return splits


def disagg_phase(ref: dict, smi: str, agg: dict) -> None:
    """Disaggregated serving: a ``--role prefill`` and a ``--role decode``
    worker process on the one card, behind the port's hub, on the
    checkpoint of the worker phase, their KV moved over CUDA IPC; then a
    host-staged pair on the same requests. ``agg`` is what the aggregated
    worker measured in the same call."""
    out = asyncio.run(_disagg_run(ref, agg, direct=True))
    dec, pre = out["reports"]["decode"], out["reports"]["prefill"]
    dis = dec["disagg"]
    # every request past the threshold went remote and was placed: the
    # eight alone, the eight together, the long prompt, the restore's
    # seeding and reference; the long prompt's local run and the restore
    # stayed local
    over = sum(len(p) > DISAGG_THRESHOLD for p in ref["prompts"])
    remote = 2 * over + 3
    splits = _pair_gates(out, ref, remote, "ipc")
    if (dis.get("migration") != {"restored": 1}
            or dis["migration_blocks"]["restored"] != out["full"]
            or pre["served_pulls"] != {"restore": out["full"]}):
        raise AssertionError(f"restore: {dis.get('migration')}, "
                             f"{dis.get('migration_blocks')} blocks, "
                             f"served {pre['served_pulls']}; want "
                             f"{out['full']} blocks restored")
    log(f"  [{smi}] disaggregated pair, direct: prefill and decode workers "
        f"up {out['ready_s']:.1f} s after spawn; {remote} remote prefills, "
        f"all placed over ipc, no fallback, no failed pull; "
        f"{pre['direct']['offers']} offers, {dec['direct']['pulls']} pulls; "
        f"launches prefill {pre['launches']['ragged_paged_attention']} in "
        f"{pre['forward_steps']} forward steps, decode "
        f"{dec['launches']['ragged_paged_attention']} in "
        f"{dec['forward_steps']}; captures prefill {pre['compile_events']},"
        f" decode {dec['compile_events']}; at exit no block in use, no "
        f"offer outstanding, no handle mapped, the prefill worker's "
        f"allocated device bytes {pre['device_bytes']['exit']} = "
        f"{pre['device_bytes']['ready']} at registration; exits "
        f"{out['exits']['prefill']:.2f} / {out['exits']['decode']:.2f} s "
        f"after SIGTERM")
    log(f"  every remote prefill's placed blocks equal the prefill worker's "
        f"(digests of {remote} requests); the eight prompts alone: streams "
        f"equal the aggregated worker's alone")
    # the eight together are not gated on their tokens: each worker batches
    # them as they arrive. Where each stream first leaves the aggregated
    # worker's concurrent stream and each prompt's stream alone, beside
    # where the aggregated worker's own concurrent streams leave theirs
    for i, (got, together, alone) in enumerate(zip(
            out["burst"], agg["streams"], agg["alone"])):
        log(f"  burst-{i}: first token differing from the aggregated "
            f"worker's concurrent stream {first_diff(got, together)}, from "
            f"the stream alone {first_diff(got, alone)}; the aggregated "
            f"worker's concurrent stream from its stream alone "
            f"{first_diff(together, alone)}")
    log(f"  restore pull: {out['full']} blocks, computed for the prompt "
        f"alone (the seeding run's stream equals the aggregated worker's "
        f"alone), from the prefill worker, outcome restored; the stream "
        f"equals the remote run over the prefill worker's blocks; first "
        f"token differing from the aggregated worker's stream alone: "
        f"{out['restored_diff']}")
    opens = [s for sp in splits.values() for s in sp["open_s"]]
    log(f"  CUDA IPC open a pull (claim, map, event wait): mean "
        f"{statistics.mean(opens) * 1e3:.3f} ms, median "
        f"{statistics.median(opens) * 1e3:.3f} ms, max "
        f"{max(opens) * 1e3:.3f} ms over {len(opens)} pulls; "
        f"PYTORCH_CUDA_ALLOC_CONF "
        f"{os.environ.get('PYTORCH_CUDA_ALLOC_CONF')!r}")

    host = asyncio.run(_disagg_run(ref, agg, direct=False))
    hsplits = _pair_gates(host, ref, over + 1, "host")
    hpre, hdec = host["reports"]["prefill"], host["reports"]["decode"]
    if host["long"] != out["long"]:
        raise AssertionError(f"the long prompt through the host-staged pair "
                             f"{host['long']}, the direct pair "
                             f"{out['long']}")
    log(f"  [{smi}] disaggregated pair, host-staged: up "
        f"{host['ready_s']:.1f} s after spawn; {over + 1} remote prefills, "
        f"all placed host-staged, no fallback; launches prefill "
        f"{hpre['launches']['ragged_paged_attention']} in "
        f"{hpre['forward_steps']} forward steps, decode "
        f"{hdec['launches']['ragged_paged_attention']} in "
        f"{hdec['forward_steps']}; no capture past the warmups, no block in "
        f"use at exit; the long prompt streams as over the direct pair")
    n = len(ref["solo"][0][1])
    log(f"  [{smi}] aggregated worker, 8 streams x {n} tokens: "
        f"{stats_line(agg['stats'])}")
    log(f"  [{smi}] disaggregated pair, direct (CUDA IPC), same requests: "
        f"{stats_line(out['stats'])}")
    log(f"  [{smi}] disaggregated pair, host-staged, same requests: "
        f"{stats_line(host['stats'])}")
    for name, sps in (("direct", splits), ("host-staged", hsplits)):
        for i in range(8):
            rid = f"burst-{i}"
            if rid in sps:
                log(f"  {name} {rid} ({len(ref['prompts'][i])} tokens): "
                    f"{split_line(sps[rid])}")
        log(f"  {name} long prompt ({out['long_tokens']} tokens): "
            f"{split_line(sps['long-remote'])}")
    log("  the long prompt prefilled locally after the live threshold rose: "
        "the same stream as remotely")


def block_copy_check(engine, label: str, smi: str, n: int = 56) -> dict:
    """The disagg block copy at full width on a serving engine's pool: ``n``
    blocks (an 881-token prompt's) gathered from both caches, scattered
    into other blocks, gathered back: bit-exact. Times the gather and the
    scatter of both caches; the bound is the blocks' bytes read once and
    written once at HBM rate."""
    bs = engine.args.block_size
    src = list(range(1, n + 1))
    dst = list(range(engine.num_blocks - n, engine.num_blocks))
    caches = (engine.k_cache, engine.v_cache)

    def gather(ids=src):
        return [gather_blocks(c, ids, block_size=bs) for c in caches]

    bundles = gather()

    def scatter():
        for c, b in zip(caches, bundles):
            scatter_blocks(c, dst, b, block_size=bs)

    scatter()
    back = gather(dst)
    torch.cuda.synchronize()
    if not all(bool((b != 0).any()) for b in bundles):
        raise AssertionError(f"{label}: the source blocks hold no KV")
    if not all(torch.equal(a, b) for a, b in zip(back, bundles)):
        raise AssertionError(f"{label}: block copy round trip not bit-exact")
    nbytes = sum(b.numel() * b.element_size() for b in bundles)
    bound = 2 * nbytes / HBM_BYTES_PER_S * 1e3
    res = {"gather_ms": time_ms(gather, 20), "scatter_ms": time_ms(scatter, 20),
           "bound_ms": bound, "mb": nbytes / 1e6}
    log(f"  [{smi}] block copy, {label}: {n} blocks ({res['mb']:.1f} MB, "
        f"{[tuple(b.shape) for b in bundles]} {bundles[0].dtype}): gather "
        f"{res['gather_ms']:.4f} ms, scatter {res['scatter_ms']:.4f} ms, "
        f"bound {bound:.5f} ms each (bytes); round trip into other blocks "
        f"bit-exact")
    return res


# ------------------------------------------------------------ dequant-GEMM

#: the matmul weights of a Llama-3-8B and a Llama-3-70B layer and head,
#: (label, I, O)
QMM_SHAPES = [("llama3_8b wq/wo", 4096, 4096),
              ("llama3_8b wk/wv", 4096, 1024),
              ("llama3_8b w_gate/w_up", 4096, 14336),
              ("llama3_8b w_down", 14336, 4096),
              ("llama3_8b lm_head", 4096, 128256),
              ("llama3_70b wq/wo", 8192, 8192),
              ("llama3_70b w_gate/w_up", 8192, 28672),
              ("llama3_70b w_down", 28672, 8192)]
#: (spec, zero point): every format of the kernel's main path, and one
#: affine (zero-point) case
QMM_FORMATS = [("int8", False), ("int8-g128", False), ("int4-g32", False),
               ("int4-g128", False), ("int8-g128", True)]
#: the formats whose cases are timed (the rest are checked)
QMM_TIMED = ("int8", "int4-g32")
#: the M of the 70B w_gate int4-g32 sweep: both bodies and the crossover
QMM_CROSSOVER_M = (1, 8, 16, 64, 128, 512, 2048)


def qmm_weight(spec: str, lead, I: int, O: int, z: bool, seed: int):
    """(the quantized weight, its bf16 materialization) of a seeded random
    [lead..., I, O] weight, drawn and quantized on the card."""
    bits, group = parse_spec(spec)
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = (torch.randn((*lead, I, O), generator=g, device="cuda")
         / math.sqrt(I)).to(torch.bfloat16)
    qt = quantize(w, bits, group)
    del w
    if z:
        qt["z"] = 0.01 * torch.rand(qt["s"].shape, generator=g,
                                    device="cuda")
    return qt


def qmm_bound(qt, M: int, I: int, O: int, batch: int = 1,
              x_batched: bool = False) -> tuple[float, str]:
    """The least time: every byte of the weight (q, s, z), x and the bf16
    output moved once, or 2·M·I·O bf16 operations a batch entry."""
    wbytes = sum(t.numel() * t.element_size() for t in qt.values())
    nbytes = (wbytes + 2 * M * I * (batch if x_batched else 1)
              + 2 * batch * M * O)
    return bound_of(nbytes, 2.0 * batch * M * I * O, torch.bfloat16)


def qmm_case(label, qt, x, timed: bool, iters: int = 20):
    """The kernel against its plain version (each row within ROW_RTOL of
    its largest |value|: per-channel where the kernel scales the output),
    timed beside its bound, the plain version and the yardstick
    (``torch.matmul`` of x with the weight already in bf16: 2-4x the
    bytes, a call the port never makes) when ``timed``."""
    I, O, M = x.shape[-1], qt["q"].shape[-1], x.shape[-2]
    batch = qt["q"].shape[0] if qt["q"].dim() == 3 else 1
    per_channel = (batch == 1 and qt["s"].shape[-2] == 1 and "z" not in qt)
    tol = ROW_RTOL["per_channel" if per_channel else "grouped"]
    if not timed:
        got = quant_matmul(x, qt)
        want = quant_matmul_ref(x, qt)
        worst = row_close(got.float().flatten(0, -2),
                          want.float().flatten(0, -2), tol, label)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{label}: non-finite output")
        log(f"  {label}: worst row {worst:.3e} (row rtol {tol})")
        return None
    wb = materialize(qt, torch.bfloat16)
    res = measure(label, lambda: quant_matmul(x, qt),
                  lambda: quant_matmul_ref(x, qt),
                  lambda: torch.matmul(x, wb),
                  qmm_bound(qt, M, I, O, batch, x.dim() == 3), None,
                  pick=lambda o: o.flatten(0, -2), iters=iters,
                  row_rtol=tol)
    del wb
    return res


def qmm_kernel_phase(seed: int, smi: str = "") -> dict:
    """The dequant-GEMM against its plain version on the card: every format
    at M 8 and 2048 on the Llama-3-8B and Llama-3-70B shapes (int8 and
    int4-g32 timed; Llama-3-70B's w_gate int4-g32 at every M of
    ``QMM_CROSSOVER_M``, through both bodies), DeepSeek-V2-Lite's expert
    stack (64 x 2048 -> 1408, x shared and per expert), and the edges (M
    not a multiple of the tile, O not a multiple of 128 or 16, g16);
    ``quantize`` on the card bit-equal to the CPU's."""
    log("kernel phase: quant_matmul vs quant_matmul_ref")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    main = {}
    g = torch.Generator(device="cuda").manual_seed(seed + 97)
    w = (torch.randn((4096, 1024), generator=g, device="cuda")
         * torch.rand((1024,), generator=g, device="cuda")).to(torch.bfloat16)
    for spec in ("int8", "int8-g128", "int4-g32"):
        got, want = quantize(w, *parse_spec(spec)), quantize(
            w.cpu(), *parse_spec(spec))
        if not all(torch.equal(got[k].cpu(), want[k]) for k in ("q", "s")):
            raise AssertionError(f"quantize {spec}: the card's q or s "
                                 f"differ from the CPU's")
    log("  quantize on the card: q and s bit-equal to the CPU's for int8, "
        "int8-g128 and int4-g32 ([4096, 1024] bf16)")
    xs = {M: torch.randn((M, 28672), generator=g, device="cuda").to(
        torch.bfloat16) for M in (8, 2048)}
    crossover = {}
    for label, I, O in QMM_SHAPES:
        for spec, z in QMM_FORMATS:
            qt = qmm_weight(spec, (), I, O, z, seed + I + O)
            sweep = (label, spec, z) == ("llama3_70b w_gate/w_up",
                                         "int4-g32", False)
            for M in QMM_CROSSOVER_M if sweep else (8, 2048):
                x = (xs[M] if M in xs else xs[2048][:M])[:, :I].contiguous()
                timed = spec in QMM_TIMED and not z
                plan = prepare_call(x, qt).plan
                name = (f"{label} {I}->{O} M={M} {spec}{'+z' if z else ''} "
                        f"({plan.body}, {plan.splits} split"
                        f"{'s' if plan.splits > 1 else ''})")
                res = qmm_case(name, qt, x, timed)
                if sweep:
                    crossover[M] = (plan, res)
                if sweep and M == 8:
                    main["quant_matmul"] = res
            del qt
    log(f"  [{smi}] the dequant-GEMM across M, llama3_70b w_gate "
        f"8192->28672 int4-g32 (ms: kernel / bound / bf16 torch.matmul; "
        f"the kernel's share of its bound):")
    for M, (plan, r) in crossover.items():
        log(f"    M={M}: {plan.body} body, tile {plan.rows}x{plan.cols}, "
            f"{plan.splits} split{'s' if plan.splits > 1 else ''}: "
            f"{r['ms']:.4f} / {r['bound_ms']:.5f} ({r['bound_by']}) / "
            f"{r['library_ms']:.4f}; {r['bound_ms'] / r['ms']:.1%}")
    # DeepSeek-V2-Lite's routed experts: x shared (the gate and up stacks)
    # and one x an expert (the down stack's input shape)
    for spec in ("int8", "int4-g32"):
        qt = qmm_weight(spec, (64,), 2048, 1408, False, seed + 5)
        x = xs[8][:, :2048].contiguous()
        qmm_case(f"deepseek_v2_lite experts 64 x 2048->1408 shared x M=8 "
                 f"{spec}", qt, x, True)
        xe = torch.randn((64, 8, 2048), generator=g, device="cuda").to(
            torch.bfloat16)
        qmm_case(f"deepseek_v2_lite experts 64 x 2048->1408 per-expert x "
                 f"M=8 {spec}", qt, xe, False)
        del qt
    # edges: M not a multiple of 16 or 64, O not a multiple of 128 (1000:
    # nor of 16, the 8-byte loads), g16 (five scale rows a 64-row step)
    for spec, z in (("int8", False), ("int8-g16", False), ("int4-g16", True),
                    ("int4-g32", False)):
        qt = qmm_weight(spec, (), 4096, 1000, z, seed + 11)
        for M in (1, 13, 37, 100):
            qmm_case(f"edges 4096->1000 M={M} {spec}{'+z' if z else ''}",
                     qt, xs[2048][:M, :4096].contiguous(), False)
    return main


def _qtensors(tree):
    for v in tree.values():
        if is_qtensor(v):
            yield v
        elif isinstance(v, dict):
            yield from _qtensors(v)


def weight_stats(params) -> tuple[int, int, int]:
    """(the model's parameters, the bytes of its quantized weights' q, s
    and z, the same weights' bytes in bf16); a packed int4 byte holds two
    parameters."""
    n = sum(t.numel() for t in _leaves(params))
    qbytes = wide = 0
    for v in _qtensors(params):
        k = v["q"].numel() * (2 if v["q"].dtype == torch.uint8 else 1)
        n += k - v["q"].numel() - sum(v[f].numel() for f in ("s", "z")
                                       if f in v)
        qbytes += sum(t.numel() * t.element_size() for t in v.values())
        wide += 2 * k
    return n, qbytes, wide


def quant_calls(params) -> int:
    """The dequant-GEMM calls of one forward step: one for each quantized
    weight of each layer, and the head's."""
    n = 0
    for key in ("layers", "dense_layers"):
        for v in params.get(key, {}).values():
            if is_qtensor(v):
                n += v["q"].shape[0]
    return n + int(is_qtensor(params.get("lm_head")))


# ------------------------------------------------------------ phase 13a

#: the Llama-3-8B formats of phase 13a
QUANT_8B_SPECS = ("int8", "int8-g128", "int4-g32")
#: the quantized step's transient bytes may exceed the bf16 step's by this
#: share (plus the dequant-GEMM's workspace)
TRANSIENT_SLACK = 1.05


def step_plan(engine, kind: str, seed: int):
    """(tensors, seqs) of an eager step on fresh blocks: "prefill", one
    2048-token prefill; "decode", 8 decode rows at kv 900-1100."""
    cfg, bs = engine.cfg, engine.args.block_size
    rng = np.random.default_rng(seed + 53)
    seqs = []

    def seq(n, computed):
        s = SeqState(request_id="mem", req=None, ctx=None, sink=None)
        s.tokens = list(map(int, rng.integers(0, cfg.vocab_size, n)))
        s.block_table = engine.pool.allocate(-(-n // bs))
        s.num_computed = computed
        seqs.append(s)
        return s

    plan = (StepPlan(prefill=[PrefillWork(seq(2048, 0), 0, 2048, True)])
            if kind == "prefill" else
            StepPlan(decode=[seq(int(n), int(n) - 1)
                             for n in rng.integers(900, 1100, 8)]))
    ops, _ = engine.pack(plan)
    tensors = [torch.from_numpy(x).to(engine.device) for x in ops]
    if kind == "decode":
        tensors[2] = None
    return tensors, seqs


def step_transient(engine, fn, tensors) -> int:
    """Peak bytes a step allocates beyond what was allocated before it
    (``max_memory_allocated`` after a peak reset), after a run that warms
    the allocator and the libraries' workspaces."""
    def run():
        return fn(engine.params, *tensors, engine.k_cache, engine.v_cache)[0]
    run()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def step_workspace(cfg, M: int, R: int, spec: str) -> int:
    """The largest workspace one dequant-GEMM call of a step allocates in
    format ``spec``: the layers' projections at M tokens, the head at R
    rows."""
    D, F, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    bits, group = parse_spec(spec)
    shapes = [(M, D, cfg.num_heads * hd), (M, D, cfg.num_kv_heads * hd),
              (M, cfg.num_heads * hd, D), (M, D, F), (M, F, D),
              (R, D, cfg.vocab_size)]
    return max(workspace_bytes(m, i, o, i // group if group else 1,
                               int4=bits == 4, dequant=group is not None)
               for m, i, o in shapes)


def quant_llama_phase(seed: int, smi: str) -> dict:
    """Phase 13a: Llama-3-8B at full width with quantized weights (int8,
    int8-g128, int4-g32, drawn and quantized on the card from the serving
    seed): the dequant-GEMM launched 7 times a layer plus the head (225) in
    each step, a full-width step through the kernel against the same step
    through ``quant_matmul_ref``, the captured step bit-equal to the eager
    one, and the transient bytes of an eager 2048-token prefill and an
    8-row decode step within 1.05x the bf16 step's plus the workspace,
    which the same steps through the plain version must break by at least
    the bf16 size of w_gate. Returns the kernel's launches in the checked
    steps."""
    cfg = get_model_config("llama3_8b")

    def args(q):
        return EngineArgs(block_size=16, num_blocks=2048, max_num_seqs=8,
                          max_num_batched_tokens=2048, max_model_len=4096,
                          seed=seed, quantization=q)

    engine = AsyncTorchEngine(cfg, args(None))
    bf16 = {}
    for kind in ("prefill", "decode"):
        tensors, seqs = step_plan(engine, kind, seed)
        bf16[kind] = step_transient(engine, engine.step_fn, tensors)
        for s in seqs:
            engine.pool.release(s.block_table)
    _release(engine)
    del engine
    log(f"phase 13a, llama3_8b: bf16 step transient bytes: prefill 2048 "
        f"{bf16['prefill'] / 1e6:.1f} MB, decode 8 rows "
        f"{bf16['decode'] / 1e6:.1f} MB")
    w_gate = cfg.hidden_size * cfg.intermediate_size * 2
    launches = 0
    for spec in QUANT_8B_SPECS:
        t0 = time.perf_counter()
        engine = AsyncTorchEngine(cfg, args(spec))
        torch.cuda.synchronize()
        n, qbytes, wide = weight_stats(engine.params)
        log(f"  [{smi}] llama3_8b {spec}: {n / 1e9:.2f} B parameters, "
            f"{qbytes / 1e9:.3f} GB of quantized matmul weights (q and s; "
            f"{wide / 1e9:.3f} GB in bf16), drawn and quantized on the card "
            f"in {time.perf_counter() - t0:.1f} s")
        label = f"llama3_8b {spec}"
        per_step = quant_calls(engine.params)
        if per_step != 7 * cfg.num_layers + 1:
            raise AssertionError(f"{label}: {per_step} quantized matmuls a "
                                 f"step, want 7 a layer and the head")
        plain = make_ragged_step_fn(cfg, engine.args.block_size,
                                    matmul=quant_matmul_ref)
        for kind in ("prefill", "decode"):
            tensors, seqs = step_plan(engine, kind, seed)
            quant_matmul.launches = 0
            got = step_transient(engine, engine.step_fn, tensors)
            n = quant_matmul.launches
            if n != 2 * per_step:
                raise AssertionError(f"{label} {kind}: the dequant-GEMM "
                                     f"launched {n} times in 2 steps, want "
                                     f"{2 * per_step}")
            launches += n
            T = tensors[0].shape[1]
            R = tensors[1].shape[0]
            ws = step_workspace(cfg, T, R, spec)
            bound = TRANSIENT_SLACK * bf16[kind] + ws
            ref = step_transient(engine, plain, tensors)
            for s in seqs:
                engine.pool.release(s.block_table)
            log(f"  [{smi}] {label} eager {kind} step (T {T}, {R} rows): "
                f"transient {got / 1e6:.1f} MB <= bound {bound / 1e6:.1f} MB "
                f"(1.05 x bf16 {bf16[kind] / 1e6:.1f} MB + workspace "
                f"{ws / 1e6:.2f} MB); the plain version {ref / 1e6:.1f} MB, "
                f"{(ref - bound) / 1e6:.1f} MB past it (w_gate in bf16: "
                f"{w_gate / 1e6:.1f} MB); {n // 2} launches a step")
            if got > bound:
                raise AssertionError(f"{label} {kind}: transient {got} "
                                     f"bytes past {bound}: a full-width "
                                     f"copy?")
            if ref - bound < w_gate:
                raise AssertionError(f"{label} {kind}: the plain version's "
                                     f"{ref} bytes do not break {bound} by "
                                     f"{w_gate}: the check cannot fail")
        quant_matmul.launches = 0
        full_width_step(engine, label, seed, ties=True, plain_fn=plain)
        # the context step and the step under test (the plain run counts
        # none)
        if quant_matmul.launches != 2 * per_step:
            raise AssertionError(f"{label}: full-width step launches "
                                 f"{quant_matmul.launches}, want "
                                 f"{2 * per_step}")
        launches += quant_matmul.launches
        graph_step_check(engine, label, seed)
        if spec == "int4-g32":
            step_profile(engine, label, seed)
        _release(engine)
        del engine
    return {"quant_matmul_8b": launches}


# ------------------------------------------------------------ phase 13b

#: the Llama-3-70B deployment of the JAX package's plan
#: (benchmarks/plan_70b.py): int4-g32 weights, int8 KV
LLAMA70B_QUANT = "int4-g32"
#: the 70B pool's share of what is free after the weights: the rest holds
#: the captured graphs' pool and the plain version's one dequantized
#: weight at a time (the head: 2.1 GB in bf16, 4.2 GB in f32 on the way)
LLAMA70B_KV_FRACTION = 0.5


def llama70b_phase(seed: int, smi: str) -> dict:
    """Phase 13b: Llama-3-70B at full width and depth (80 layers) on one
    card, int4-g32 weights drawn and quantized matrix by matrix on the card,
    int8 KV: ``warmup()``, the eight requests of phase 3 on both loops
    (equal streams; the dequant-GEMM 561 launches a step, the ragged kernel
    80), the decode step wall beside its weight-read bound, a full-width
    step through the kernel against the plain version, the step profile.
    Returns the kernel's launches in the serving run."""
    cfg = get_model_config("llama3_70b")
    engine, launches, streams, out = serving_phase(
        seed, smi, kv_cache_dtype="int8", model="llama3_70b", cfg=cfg,
        warmup=True, quantization=LLAMA70B_QUANT,
        kv_fraction=LLAMA70B_KV_FRACTION)
    _, qb, _ = weight_stats(engine.params)
    bound_ms = qb / HBM_BYTES_PER_S * 1e3
    st = out["stats"]
    log(f"  [{smi}] llama3_70b {LLAMA70B_QUANT} + int8 KV: decode step wall "
        f"{st['step_ms']:.3f} ms (pipelined) / "
        f"{out['stats_serial']['step_ms']:.3f} ms (serial) beside its "
        f"weight-read bound {bound_ms:.3f} ms ({qb / 1e9:.3f} GB of q and s "
        f"at {HBM_BYTES_PER_S / 1e12:.2f} TB/s); TTFT mean "
        f"{st['ttft_mean']:.2f} ms, ITL mean {st['itl_mean']:.2f} ms, "
        f"{st['tok_s']:.2f} tok/s")
    plain = make_ragged_step_fn(cfg, engine.args.block_size,
                                matmul=quant_matmul_ref)
    full_width_step(engine, "llama3_70b", seed, ties=True, plain_fn=plain)
    step_profile(engine, "llama3_70b", seed)
    _release(engine)
    return {"quant_matmul": launches["quant_matmul"]}


# ---------------------------------------------------------------- phase 14

#: the preempt-to-swap workload on Llama-3-8B: requests, prompt and output
#: tokens (ignore_eos), on a pool of about half its working set
SWAP_REQUESTS, SWAP_PROMPT, SWAP_OUTPUT = 16, 1024, 256
#: host bytes for swapped KV: enough that no preemption recomputes
SWAP_HOST_BYTES = 8 << 30
#: the G2 onboarding prompt and host tier, and the G3 cascade's prompt,
#: host tier (in blocks) and disk budget; the disk tier lives in
#: TIER_DIR, inside the checkout, removed at the end
TIER_PROMPT, TIER_HOST_BYTES = 4096, 2 << 30
CASCADE_PROMPT, CASCADE_HOST_BLOCKS, CASCADE_DISK_BYTES = 1024, 4, 1 << 30
TIER_DIR = pathlib.Path(__file__).resolve().parent / ".smoke_kvbm"
#: blocks a swap bandwidth measurement moves (one victim of the workload)
SWAP_COPY_BLOCKS = (SWAP_PROMPT + SWAP_OUTPUT) // 16


class SwapSpy:
    """Digests (``engine.blocks_digest``, enqueued in stream order) of each
    victim's blocks just before its swap-out and just after its swap-in,
    by wrapping the engine's swapper methods: a check of this script, not
    a knob of the program."""

    def __init__(self, engine):
        self.pairs: list = []
        self._open: dict = {}
        swap_out, swap_in = engine.swap_out, engine.swap_in
        bs = engine.args.block_size

        def out(seq):
            n = -(-seq.num_computed // bs)
            before = (engine.blocks_digest(seq.block_table[:n])
                      if 0 < n <= len(seq.block_table) else None)
            ok = swap_out(seq)
            if ok:
                self._open[id(seq)] = pair = [before, None]
                self.pairs.append(pair)
            return ok

        def back(seq):
            n = seq.swap.n if seq.swap is not None else 0
            ok = swap_in(seq)
            if ok:
                self._open.pop(id(seq))[1] = engine.blocks_digest(
                    seq.block_table[:n])
            return ok

        engine.swap_out, engine.swap_in = out, back

    def check(self, label: str) -> int:
        """Every victim's digests equal across its round trip; returns the
        round trips."""
        done = [(int(a), int(b)) for a, b in self.pairs if b is not None]
        bad = [d for d in done if d[0] != d[1]]
        if not done or bad or len(done) != len(self.pairs):
            raise AssertionError(f"{label}: {len(done)} of {len(self.pairs)} "
                                 f"swaps came back; digests differ: {bad}")
        return len(done)


def swap_prompts(cfg, seed: int, n: int, length: int) -> list:
    rng = np.random.default_rng(seed + 14)
    return [list(map(int, rng.integers(0, cfg.vocab_size, length)))
            for _ in range(n)]


def _swap_engine(cfg, params, seed: int, kv, num_blocks: int, **kw):
    return AsyncTorchEngine(cfg, EngineArgs(
        block_size=16, num_blocks=num_blocks, max_num_seqs=SWAP_REQUESTS,
        max_num_batched_tokens=2048, seed=seed, kv_cache_dtype=kv,
        **{"max_model_len": 2048, **kw}), params=params)


async def _idle(engine) -> None:
    """Until the engine has no work and no copy, offload or promotion in
    flight."""
    while engine.scheduler.has_work or engine._offload_tasks:
        await asyncio.sleep(0.001)


async def _warm(engine, model: str) -> None:
    """``warmup()`` and one short request (cuBLAS handles, allocator
    growth): no measured run pays a first use."""
    await engine.warmup()
    await stream(engine, model, list(range(1, 17)), 2)
    await _idle(engine)


async def _measured(engine, model: str, prompts, n: int, label: str) -> dict:
    """The prompts served concurrently on an emptied prefix cache, the
    kernels' counts set to 0 just before and read just after: the ragged
    kernel once a layer every forward step, nothing else. Returns the
    streams, the serving stats and the steps."""
    engine.pool.clear()
    await _idle(engine)
    steps0 = engine.forward_steps
    reset_counts()
    t0 = time.perf_counter()
    res = await asyncio.gather(*(stream(engine, model, p, n)
                                 for p in prompts))
    st = serving_stats(res, time.perf_counter() - t0)
    await _idle(engine)
    steps = engine.forward_steps - steps0
    want = engine.cfg.num_layers * steps
    other = {k["name"]: k["wrapper"].launches for k in KERNELS
             if k["wrapper"] is not ragged_paged_attention}
    if (steps == 0 or ragged_paged_attention.launches != want
            or any(other.values())):
        raise AssertionError(f"{label}: ragged kernel "
                             f"{ragged_paged_attention.launches} launches in "
                             f"{steps} steps (want {want}), others {other}")
    for i, r in enumerate(res):
        if r[3] != "length" or len(r[2]) != n:
            raise AssertionError(f"{label} stream {i}: {r[3]!r} after "
                                 f"{len(r[2])} tokens")
    return {"streams": [r[2] for r in res], "stats": st, "steps": steps,
            "launches": ragged_paged_attention.launches, "res": res}


def swap_bandwidth(engine, smi: str, label: str) -> dict:
    """Swap-out (the gathers on the engine's stream, the copy to pinned
    memory on the copy stream, ``engine._copy_out``) and swap-in (the
    non-blocking copies to the card and the scatters, ``scatter_blocks``)
    of SWAP_COPY_BLOCKS blocks, timed with CUDA events (the median of 5
    after one warm-up), beside a plain pinned ``copy_`` of the same bytes
    each way; the round trip must give the gathered bytes back."""
    bs = engine.args.block_size
    ids = engine.pool.allocate(SWAP_COPY_BLOCKS)
    caches = (engine.k_cache, engine.v_cache)
    nbytes = SWAP_COPY_BLOCKS * engine._swap_block_bytes()

    def timed(fn, stream=None):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ret = fn()
        end.record(stream)
        end.synchronize()
        return start.elapsed_time(end), ret

    def out():
        dev = [gather_blocks(c, ids, block_size=bs) for c in caches]
        host, _ = engine._copy_out(dev, engine._gathered(), per_block=False)
        return dev, host

    try:
        dev, host = timed(out, engine._copy_stream)[1]
        for c, h in zip(caches, host):
            scatter_blocks(c, ids, h, block_size=bs)
        back = [gather_blocks(c, ids, block_size=bs) for c in caches]
        if not all(torch.equal(a, b) for a, b in zip(dev, back)):
            raise AssertionError(f"{label}: swap round trip not bit-exact")
        t_out = statistics.median(timed(out, engine._copy_stream)[0]
                                  for _ in range(5))
        t_in = statistics.median(timed(lambda: [
            scatter_blocks(c, ids, h, block_size=bs)
            for c, h in zip(caches, host)])[0] for _ in range(5))
        d = torch.empty(nbytes, dtype=torch.uint8, device=engine.device)
        h = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        timed(lambda: h.copy_(d, non_blocking=True))
        p_out = statistics.median(timed(lambda: h.copy_(
            d, non_blocking=True))[0] for _ in range(5))
        p_in = statistics.median(timed(lambda: d.copy_(
            h, non_blocking=True))[0] for _ in range(5))
    finally:
        engine.pool.release(ids)
    gbs = {k: nbytes / (ms * 1e-3) / 1e9 for k, ms in (
        ("out", t_out), ("in", t_in), ("plain_out", p_out),
        ("plain_in", p_in))}
    log(f"  [{smi}] {label}: swap of {SWAP_COPY_BLOCKS} blocks "
        f"({nbytes / 1e6:.1f} MB): out {t_out:.3f} ms "
        f"({gbs['out']:.2f} GB/s) vs a plain pinned copy_ {p_out:.3f} ms "
        f"({gbs['plain_out']:.2f} GB/s); in {t_in:.3f} ms "
        f"({gbs['in']:.2f} GB/s) vs {p_in:.3f} ms ({gbs['plain_in']:.2f} "
        f"GB/s); the round trip is bit-exact")
    return gbs


async def _swap_runs(cfg, params, seed: int, smi: str, kv) -> dict:
    model = "llama3_8b"
    label = f"llama3_8b, {kv or 'bf16'} KV"
    working = SWAP_REQUESTS * -(-(SWAP_PROMPT + SWAP_OUTPUT) // 16)
    prompts = swap_prompts(cfg, seed, SWAP_REQUESTS, SWAP_PROMPT)
    big = _swap_engine(cfg, params, seed, kv, working + 64)
    small = _swap_engine(cfg, params, seed, kv, working // 2 + 1,
                         swap_host_bytes=SWAP_HOST_BYTES)
    try:
        await _warm(big, model)
        ref = await _measured(big, model, prompts, SWAP_OUTPUT,
                              f"{label}, big pool")
        # the gate's reference on the serial loop, which tie_rule's re-run
        # reproduces: where a request finishes before another, the
        # pipelined loop's overshoot step adds its row to the batch, and
        # a near tie can flip at another M (a tail token, call 2)
        big.args.pipeline_decode = False
        ref_serial = await _measured(big, model, prompts, SWAP_OUTPUT,
                                     f"{label}, big pool, serial loop")
        big.args.pipeline_decode = True
        if big.scheduler.preempt_swap_total or \
                big.scheduler.preempt_recompute_total:
            raise AssertionError(f"{label}: the big pool preempted")
        await _warm(small, model)
        spy = SwapSpy(small)
        swap = await _measured(small, model, prompts, SWAP_OUTPUT,
                               f"{label}, swap")
        st = small.swap_stats()  # the warm-ups preempt nothing
        if (st["preempt_swap"] == 0 or st["preempt_recompute"]
                or st["recomputed_tokens"]
                or st["swap_out_blocks"] != st["swap_in_blocks"]
                or st["swapped_blocks"] or st["swap_host_bytes"]):
            raise AssertionError(f"{label}: swap stats {st}")
        trips = spy.check(label)
        # recompute on the same pool: the engine's swapper taken away, as
        # EngineArgs.preempt_swap=False leaves it
        small.scheduler.swapper = None
        r0 = small.scheduler.preempt_recompute_total
        rec = await _measured(small, model, prompts, SWAP_OUTPUT,
                              f"{label}, recompute")
        small.scheduler.swapper = small
        n_rec = small.scheduler.preempt_recompute_total - r0
        # equal to the big pool's, or parting first at a near tie
        want = ref_serial["streams"]
        same = sum(a == b for a, b in zip(want, swap["streams"]))
        same_rec = sum(a == b for a, b in zip(want, rec["streams"]))
        same_pipe = sum(a == b for a, b in zip(want, ref["streams"]))
        await tie_rule(big, model, f"{label}, swap vs big pool", prompts,
                       want, swap["streams"], SWAP_OUTPUT,
                       names=("big pool", "swap"))
    finally:
        await small.close()
        await big.close()
    log(f"  [{smi}] {label}: {SWAP_REQUESTS} requests x {SWAP_PROMPT} + "
        f"{SWAP_OUTPUT} tokens; pool {small.num_blocks} blocks against a "
        f"working set of {working}: {st['preempt_swap']} swap preemptions "
        f"({trips} round trips, every victim's digest equal), "
        f"{st['swap_out_blocks']} blocks out = {st['swap_in_blocks']} in, "
        f"{st['swap_in_blocked']} blocked swap-in passes, no recompute; "
        f"host bytes and swapped blocks 0 at the end; {swap['steps']} steps "
        f"(ragged kernel {swap['launches']} launches)")
    log(f"  [{smi}] {label}, swap:      {stats_line(swap['stats'])}")
    log(f"  [{smi}] {label}, recompute: {stats_line(rec['stats'])} "
        f"({n_rec} recompute preemptions, {rec['steps']} steps)")
    log(f"  [{smi}] {label}, no preemption ({big.num_blocks} blocks): "
        f"{stats_line(ref['stats'])} ({ref['steps']} steps)")
    log(f"  {label}: {same} of {SWAP_REQUESTS} swap streams, {same_rec} "
        f"recompute streams and {same_pipe} of the big pool's pipelined "
        f"streams equal to the big pool's serial streams outright")
    return {"small": small, "big": big, "swap": swap, "rec": rec,
            "ref": ref, "stats": st}


async def _tier_runs(engine, seed: int, smi: str) -> dict:
    """G2 onboarding, then the G3 cascade, on a bf16 engine with a host and
    a disk tier (see :func:`swap_phase`)."""
    model, cfg, bs = "llama3_8b", engine.cfg, engine.args.block_size
    kv = engine.kvbm

    def held(prompt):
        probe = engine.restore_probe(PreprocessedRequest(model=model,
                                                         token_ids=prompt))
        return probe.sequence_hashes()

    async def serve_one(prompt, label):
        reset_counts()
        f0, o0 = engine.forward_steps, kv.onboarded_blocks
        r = await stream(engine, model, prompt, 32)
        await _idle(engine)
        steps = engine.forward_steps - f0
        if (ragged_paged_attention.launches != cfg.num_layers * steps
                or len(r[2]) != 32):
            raise AssertionError(f"{label}: {len(r[2])} tokens, ragged "
                                 f"kernel {ragged_paged_attention.launches} "
                                 f"launches in {steps} steps")
        return r, kv.onboarded_blocks - o0

    async def gate(prompt, want, got, label):
        if want != got:  # the re-run prefills cold, as the reference did
            cb, engine.scheduler.onboard_cb = engine.scheduler.onboard_cb, None
            try:
                await tie_rule(engine, model, label, [prompt], [want],
                               [got], 32, names=("cold", "onboarded"))
            finally:
                engine.scheduler.onboard_cb = cb
        return want == got

    await _warm(engine, model)
    # G2: serve, drop the device prefix cache, serve again
    prompt = swap_prompts(cfg, seed + 1, 1, TIER_PROMPT)[0]
    hashes = held(prompt)
    cold, _ = await serve_one(prompt, "G2 cold")
    if kv.offloaded_blocks < len(hashes):
        raise AssertionError(f"G2: {kv.offloaded_blocks} blocks offloaded")
    d_cold = engine.blocks_digest([engine.pool.lookup(h) for h in hashes])
    engine.pool.clear()
    warm, onboarded = await serve_one(prompt, "G2 onboarded")
    d_warm = engine.blocks_digest([engine.pool.lookup(h) for h in hashes])
    if onboarded != len(hashes) or int(d_cold) != int(d_warm):
        raise AssertionError(f"G2: {onboarded} of {len(hashes)} blocks "
                             f"onboarded, digests {int(d_cold)} vs "
                             f"{int(d_warm)}")
    g2_same = await gate(prompt, cold[2], warm[2], "G2 onboarded stream")
    ttft = [(r[1][0] - r[0]) * 1e3 for r in (cold, warm)]
    log(f"  [{smi}] G2 onboarding, llama3_8b bf16, a {TIER_PROMPT}-token "
        f"prompt on a {TIER_HOST_BYTES >> 30} GiB host tier: "
        f"{kv.offloaded_blocks} blocks offloaded, {onboarded} of "
        f"{len(hashes)} matchable onboarded after pool.clear() (digest "
        f"equal to the cold run's blocks); TTFT cold {ttft[0]:.2f} ms, "
        f"onboarded {ttft[1]:.2f} ms ({ttft[0] / ttft[1]:.2f}x); stream "
        + ("equal" if g2_same else "parting at a near tie"))
    # G3: a host tier of a few blocks over the disk tier
    kv.clear()
    kv.resize_host(CASCADE_HOST_BLOCKS * engine._swap_block_bytes())
    prompt = swap_prompts(cfg, seed + 2, 1, CASCADE_PROMPT)[0]
    hashes = held(prompt)
    first, _ = await serve_one(prompt, "G3 cold")
    cascaded = (len(kv.host), len(kv.disk))
    if cascaded[0] > CASCADE_HOST_BLOCKS or cascaded[1] < len(hashes) - \
            CASCADE_HOST_BLOCKS:
        raise AssertionError(f"G3: host/disk blocks {cascaded}")
    engine.pool.clear()
    again, none = await serve_one(prompt, "G3 promoting")  # and recomputing
    on_host = kv.host_resident(hashes)
    promoted = next((i for i, h in enumerate(hashes) if h not in on_host),
                    len(hashes))  # the leading run now on the host
    engine.pool.clear()
    last, got = await serve_one(prompt, "G3 onboarded")
    if none or promoted != CASCADE_HOST_BLOCKS or got != promoted:
        raise AssertionError(f"G3: onboarded {none} while promoting, "
                             f"{promoted} promoted, {got} onboarded")
    g3_same = [await gate(prompt, first[2], r[2], f"G3 stream {i}")
               for i, r in enumerate((again, last))]
    log(f"  [{smi}] G3 cascade, a {CASCADE_PROMPT}-token prompt on a "
        f"{CASCADE_HOST_BLOCKS}-block host tier over a disk tier: "
        f"{cascaded[0]} blocks on the host, {cascaded[1]} cascaded to disk; "
        f"the next admission promoted {promoted} to the host (recomputing), "
        f"the one after onboarded {got}; streams equal to the cold one: "
        f"{g3_same}")
    return {"ttft_cold": ttft[0], "ttft_onboarded": ttft[1],
            "onboarded": onboarded}


def swap_phase(seed: int, smi: str) -> None:
    """Phase 14: preempt-to-swap and the KVBM tiers on Llama-3-8B at full
    width and depth (random weights from the serving seed, every engine
    warmed up, steps captured, the pipelined loop on):

    - swap, in bf16 and int8 KV: SWAP_REQUESTS requests of SWAP_PROMPT
      tokens x SWAP_OUTPUT (ignore_eos) on a pool of half their working
      set plus one block, with SWAP_HOST_BYTES of host budget: swap
      preemptions, none recomputed, blocks out = in, no host byte or
      swapped block left; each victim's ``blocks_digest`` equal before
      its swap-out and after its swap-in (:class:`SwapSpy`); the streams
      equal to a never-preempting pool's, or parting first at a near tie
      (``tie_rule``: the batch rows differ, and bf16 GEMMs round apart at
      another M); the ragged kernel once a layer every step. The same
      requests again on the small pool without its swapper (recompute
      preemption) and the tok/s, TTFT and ITL of all three; swap-out and
      swap-in GB/s beside a plain pinned copy (:func:`swap_bandwidth`).
    - G2 onboarding: a TIER_PROMPT-token prompt on a TIER_HOST_BYTES host
      tier, served, ``pool.clear()``, served again: every matchable block
      onboarded (digest equal to the cold run's), both TTFTs, the stream
      gated as above.
    - G3: a host tier of CASCADE_HOST_BLOCKS blocks over a disk tier in
      TIER_DIR (removed after): a CASCADE_PROMPT-token prompt cascades to
      disk, the next admission promotes the prefix's first blocks to the
      host while it recomputes, the one after onboards them."""
    cfg = get_model_config("llama3_8b")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        seed), torch.device("cuda"))
    log(f"swap and tier phase: llama3_8b weights drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    for kv in (None, "int8"):
        out = asyncio.run(_swap_runs(cfg, params, seed, smi, kv))
        swap_bandwidth(out["small"], smi, f"llama3_8b {kv or 'bf16'} KV")
        _release(out["small"])
        _release(out["big"])
        del out
    shutil.rmtree(TIER_DIR, ignore_errors=True)
    engine = _swap_engine(cfg, params, seed, None, 1024, max_model_len=8192,
                          kvbm_host_bytes=TIER_HOST_BYTES,
                          kvbm_disk_dir=str(TIER_DIR),
                          kvbm_disk_bytes=CASCADE_DISK_BYTES)

    async def tiers():
        try:
            return await _tier_runs(engine, seed, smi)
        finally:
            await engine.close()

    try:
        asyncio.run(tiers())
    finally:
        shutil.rmtree(TIER_DIR, ignore_errors=True)
        _release(engine)
    del params
    gc.collect()
    torch.cuda.empty_cache()


def _release(engine) -> None:
    engine.drop_graphs()  # they hold the weights and caches
    engine.params = engine.k_cache = engine.v_cache = None
    engine._embed_cache = None
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    t_start = time.perf_counter()
    smi, kind = device_phase()

    def mark(what: str) -> None:
        log(f"[{time.perf_counter() - t_start:.1f} s] {what} done")

    main_case = kernel_phase(a.seed)
    mark("phases 1 (device, kernel build) and 2 (attention kernels)")
    main_case.update(sample_kernel_phase(a.seed))
    mark("phase 2 (the draw kernel)")
    main_case.update(qmm_kernel_phase(a.seed, smi))
    mark("phase 2 (the dequant-GEMM)")
    gc.collect()
    torch.cuda.empty_cache()
    engine, served, streams, phase3 = serving_phase(
        a.seed, smi, solo=True, extra=sampled_extra(
            "llama3_8b", a.seed, smi, True, burst=True,
            spec=dict(guided=True, repetitive=True,
                      draft_depths=SPEC_DRAFT_DEPTHS)),
        compare_eager=True, warmup=True, spec_k=SPEC_K)
    launches = {"ragged_paged_attention": served["ragged_paged_attention"],
                "gumbel_argmax": phase3["extra"]["launches"]}
    greedy, drawn = phase3["stats"], phase3["extra"]["stats"]
    log(f"  [{smi}] llama3_8b, pipelined loop, greedy vs seeded sampled "
        f"batch (8 x 32 tokens, same call): decode step wall "
        f"{greedy['step_ms']:.3f} vs {drawn['step_ms']:.3f} ms, ITL mean "
        f"{greedy['itl_mean']:.2f} vs {drawn['itl_mean']:.2f} ms, p50 "
        f"{greedy['itl_p50']:.2f} vs {drawn['itl_p50']:.2f} ms; the draw "
        f"kernel {main_case['gumbel_argmax']['ms']:.4f} ms a step against "
        f"its bound {main_case['gumbel_argmax']['bound_ms']:.5f} ms")
    mark("phase 3")
    graph_step_check(engine, "llama3_8b", a.seed)
    full_width_step(engine, "llama3_8b", a.seed)
    step_profile(engine, "llama3_8b", a.seed)
    launches["paged_attention_decode"] = dense_decode_step(engine, a.seed,
                                                           smi)
    launches["flash_prefill"] = embedding_phase(engine, a.seed, smi)
    bf16_blocks = engine.num_blocks
    prompts = serving_prompts(engine.cfg, a.seed)
    embed_vec = asyncio.run(engine.embed([prompts[1]]))[0]
    ref = checkpoint_phase(engine, a.seed, smi, {
        "prompts": prompts, "streams": streams, "solo": phase3["solo"],
        "solo_hashes": phase3["solo_hashes"],
        "embed": (prompts[1], embed_vec)})  # releases the engine
    del engine
    mark("phases 4-6")
    launches["ragged_paged_attention_int8"] = int8_phase(
        a.seed, smi, bf16_blocks, streams)
    mark("phase 7")
    try:
        # the parent holds no model: the worker sizes its pool from what is
        # free; then two workers share the card, each with a fixed pool
        agg = worker_phase(ref, smi, phase3["stats"])
        disagg_phase(ref, smi, agg)
        mark("phase 8")
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    # the Llama engines are gone: DeepSeek-V2-Lite has the card to itself
    launches.update(mla_phase(a.seed, smi))
    mark("phases 9-10")
    launches.update(gemma_phase(a.seed, smi))
    mark("phase 11")
    family_checks(a.seed, smi)
    mark("phase 12")
    quant_llama_phase(a.seed, smi)
    mark("phase 13a")
    launches.update(llama70b_phase(a.seed, smi))
    mark("phase 13b")
    swap_phase(a.seed, smi)
    mark("phase 14")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    kernels = []
    for k in KERNELS:
        m = main_case[k["name"]]
        kernels.append({
            "name": k["name"], "route": k["route"], "source": k["source"],
            "replaces": k["replaces"], "launches": launches[k["name"]],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
