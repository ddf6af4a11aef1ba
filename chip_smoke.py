#!/usr/bin/env python3
"""Smoke run of the torch port on one CUDA card (an H100 for this port).

    python3 chip_smoke.py [--seed N]

Phases, each of which must pass or the script exits non-zero before it
prints any result:

1. Device: the card's name and power limit (nvidia-smi), and the build of
   every CUDA kernel of the main path from the sources in this checkout
   (one nvcc per source, started together).
2. Kernels: each kernel against its plain PyTorch version on the card,
   with its tolerance — small mixed cases (f32 and bf16, window, sinks,
   both head dims) and the Llama-3-8B attention geometry — and its time
   beside the plain version's, a PyTorch library call's (a yardstick the
   port never calls) and the least time the card could take.
3. Serving: ``AsyncTorchEngine`` with the llama3_8b preset at full width
   and depth on random weights from a seeded generator, eight concurrent
   greedy requests. The kernels' launch counts are set to 0 just before
   and read just after; every kernel must have launched.
4. Full-width step: one packed ragged step through the kernel against the
   same step through the plain attention; logits must agree.
5. Step profile: a decode-only and a prefill step at full width, timed on
   the host and traced with torch.profiler (device busy time by kernel).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without CUDA, or without
the rest of the repository beside it, the script fails.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from dynamo_tpu_torch.engine.config import EngineArgs
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.engine.model import make_ragged_step_fn
from dynamo_tpu_torch.engine.scheduler import PrefillWork, SeqState, StepPlan
from dynamo_tpu_torch.models import get_model_config
from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.ops.ragged_attention import (
    ragged_attention_ref, ragged_paged_attention,
)
from dynamo_tpu_torch.protocols import PreprocessedRequest, StopConditions

#: published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and dense
#: operations/s by input type (bf16 on tensor cores, f32 without them)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
#: kernel-vs-plain tolerances (absolute and relative): f32 differs by
#: summation order only; in bf16 both round the output to 8 mantissa bits
#: and the kernel also rounds P to bf16 before P.V, a step or two apart
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: full-width step: the kernel rounds P to bf16 before P.V where the plain
#: version keeps it in f32, so each of 32 layers' attention outputs may
#: differ by a bf16 step or two, carried through the residual stream: the
#: logits may differ by this share of their largest magnitude
STEP_RTOL = 0.05

#: every kernel of the main path
KERNELS = [{
    "name": "ragged_paged_attention",
    "route": "cuda",
    "source": "dynamo_tpu_torch/ops/csrc/ragged_attention.cu",
    "replaces": "dynamo_tpu/ops/ragged_attention.py:78",
    "build": "ragged_attention",
    "wrapper": ragged_paged_attention,
}]


def log(msg: str) -> None:
    print(msg, flush=True)


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
    _build.build([k["build"] for k in KERNELS])
    log(f"kernel build: {time.perf_counter() - t0:.3f} s wall")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    return smi, torch.cuda.get_device_name(0)


# ------------------------------------------------------------------ phase 2


def make_case(rows, *, H, KV, hd, bs, dtype, pad_rows, pad_tokens, seed):
    """Attention operands on the card for rows of (q_len, kv_len), each row
    on its own random blocks of a shared paged cache."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    need = [-(-kv // bs) for _, kv in rows]
    num_blocks = sum(need) + 8
    W = max(need)
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


def bound_ms(case, window: int) -> tuple[float, str]:
    """Least time for this case's work: the bytes it must move (q and out of
    the real tokens, every K/V row a token can see, the tables) over HBM
    bandwidth, or its operations over the peak rate for its input type."""
    H, hd = case["q"].shape[1:]
    KV = case["kc"].shape[1]
    esz = case["q"].element_size()
    nbytes = case["bt"].numel() * 4 + case["rows3"].numel() * 4
    ops = 0
    for ql, kv in case["rows"]:
        first = max(kv - ql - window + 1, 0) if window else 0
        nbytes += 2 * ql * H * hd * esz + 2 * (kv - first) * KV * hd * esz
        for p in range(kv - ql, kv):
            seen = min(p + 1, window) if window else p + 1
            ops += 4 * hd * H * seen
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[case["dtype"]]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, iters: int) -> float:
    """Median device time of ``fn`` with L2 evicted before each call (the
    engine reads each layer's pages once per step, cold)."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        times.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in times)


def sdpa_fn(case, window: int):
    """PyTorch's scaled_dot_product_attention over each row's gathered K/V
    (gather done up front): the library yardstick. No sinks."""
    bs = case["bs"]
    calls = []
    for r, (ql, kv) in enumerate(case["rows"]):
        q0 = int(case["rows3"][r, 0])
        keys = torch.arange(kv, device="cuda")
        slots = case["bt"][r, keys // bs].long() * bs + keys % bs
        k = case["kc"][slots].permute(1, 0, 2)[None]  # [1, KV, kv, hd]
        v = case["vc"][slots].permute(1, 0, 2)[None]
        q = case["q"][q0:q0 + ql].permute(1, 0, 2)[None]  # [1, H, ql, hd]
        pos = torch.arange(kv - ql, kv, device="cuda")
        mask = keys[None, :] <= pos[:, None]
        if window:
            mask &= keys[None, :] > pos[:, None] - window
        calls.append((q, k, v, None if bool(mask.all()) else mask))

    def run():
        for q, k, v, m in calls:
            F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                           enable_gqa=True)
    return run


def check_case(label, case, window=0, sinks=False, iters=20):
    """Kernel vs plain version on one case; returns the numbers."""
    args = (case["q"], case["kc"], case["vc"], case["bt"], case["rows3"])
    kw = dict(block_size=case["bs"], window=window,
              sinks=case["sinks"] if sinks else None)
    got = ragged_paged_attention(*args, **kw)
    want = ragged_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    t = case["t"]
    g, w = got[:t].float(), want[:t].float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{label}: non-finite kernel output")
    err = float((g - w).abs().max())
    tol = TOL[case["dtype"]]
    torch.testing.assert_close(g, w, atol=tol, rtol=tol,
                               msg=lambda m: f"{label}: {m}")
    res = dict(max_abs_err=err, tol=tol,
               ms=time_ms(lambda: ragged_paged_attention(*args, **kw), iters),
               plain_ms=time_ms(lambda: ragged_attention_ref(*args, **kw),
                                max(3, iters // 5)),
               library_ms=(None if sinks
                           else time_ms(sdpa_fn(case, window), iters)))
    res["bound_ms"], res["bound_by"] = bound_ms(case, window)
    log(f"  {label}: max_abs_err {err:.3e} (tol {tol}) kernel "
        f"{res['ms']:.4f} ms plain {res['plain_ms']:.4f} ms library "
        f"{res['library_ms']} ms bound {res['bound_ms']:.5f} ms "
        f"({res['bound_by']})")
    return res


def kernel_phase(seed: int) -> dict:
    log("kernel phase: ragged_paged_attention vs ragged_attention_ref")
    small = [(1, 20), (6, 24), (1, 9), (11, 11), (37, 80)]
    for dtype in (torch.float32, torch.bfloat16):
        case = make_case(small, H=8, KV=2, hd=128, bs=16, dtype=dtype,
                         pad_rows=3, pad_tokens=5, seed=seed)
        for window, sinks in ((0, False), (7, False), (0, True)):
            check_case(f"small {str(dtype)[6:]} window={window} "
                       f"sinks={sinks}", case, window, sinks, iters=5)
    case = make_case(small, H=16, KV=4, hd=64, bs=16, dtype=torch.bfloat16,
                     pad_rows=2, pad_tokens=0, seed=seed + 1)
    check_case("small bf16 hd=64 window=7 sinks=True", case, 7, True,
               iters=5)
    # Llama-3-8B attention geometry: decode rows, a fresh 512-token prefill
    # chunk, a 128-token chunk deep into its context, padding rows
    llama = make_case([(1, 1000), (1, 3000), (512, 512), (128, 2048)],
                      H=32, KV=8, hd=128, bs=16, dtype=torch.bfloat16,
                      pad_rows=4, pad_tokens=6, seed=seed + 2)
    main = check_case("llama3_8b mixed bf16", llama)
    check_case("llama3_8b mixed bf16 window=512 sinks=True", llama, 512,
               True, iters=5)
    case = make_case([(1, 1500), (40, 700), (1, 9)], H=8, KV=2, hd=128,
                     bs=16, dtype=torch.float32, pad_rows=1, pad_tokens=2,
                     seed=seed + 4)
    check_case("long rows float32 sinks=True", case, 0, True, iters=5)
    rng = np.random.default_rng(seed)
    decode = make_case([(1, int(k)) for k in rng.integers(65, 1057, 8)],
                       H=32, KV=8, hd=128, bs=16, dtype=torch.bfloat16,
                       pad_rows=0, pad_tokens=0, seed=seed + 3)
    check_case("llama3_8b 8 decode rows bf16", decode)
    return main


# ------------------------------------------------------------------ phase 3


async def serve(engine, prompts, max_tokens):
    async def one(p):
        req = PreprocessedRequest(
            model="llama3_8b", token_ids=p,
            stop_conditions=StopConditions(max_tokens=max_tokens,
                                           ignore_eos=True))
        t0 = time.perf_counter()
        stamps, toks, reason = [], [], None
        async for out in engine.generate(req):
            stamps.append(time.perf_counter())
            toks.extend(out.token_ids)
            reason = out.finish_reason or reason
        return t0, stamps, toks, reason

    try:
        t0 = time.perf_counter()
        res = await asyncio.gather(*(one(p) for p in prompts))
        return res, time.perf_counter() - t0
    finally:
        await engine.close()


def serving_phase(seed: int, smi: str):
    cfg = get_model_config("llama3_8b")
    args = EngineArgs(block_size=16, max_num_seqs=8,
                      max_num_batched_tokens=2048, max_model_len=4096,
                      seed=seed)
    t0 = time.perf_counter()
    events = []
    engine = AsyncTorchEngine(cfg, args, event_cb=events.append)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(engine.params))
    log(f"serving phase: llama3_8b V{cfg.vocab_size} D{cfg.hidden_size} "
        f"F{cfg.intermediate_size} L{cfg.num_layers} H{cfg.num_heads} "
        f"KV{cfg.num_kv_heads} hd{cfg.head_dim} {cfg.dtype}: "
        f"{n_params * 2 / 1e9:.2f} GB of random weights, "
        f"{engine.num_blocks} KV blocks, set up in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, int(n))))
               for n in rng.integers(64, 1025, 8)]
    max_tokens = 32
    for k in KERNELS:
        k["wrapper"].launches = 0
    res, wall = asyncio.run(serve(engine, prompts, max_tokens))
    launches = {k["name"]: k["wrapper"].launches for k in KERNELS}

    for i, (_t0, _st, toks, reason) in enumerate(res):
        if reason != "length" or len(toks) != max_tokens:
            raise AssertionError(f"stream {i}: finish {reason!r} after "
                                 f"{len(toks)} tokens, want length/"
                                 f"{max_tokens}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} never launched in the "
                                 "serving run")
    want = cfg.num_layers * engine.steps
    if launches["ragged_paged_attention"] != want:
        raise AssertionError(f"ragged kernel launched "
                             f"{launches['ragged_paged_attention']} times "
                             f"in {engine.steps} steps, want {want}")
    stored = sum(len(e.stored_blocks) for e in events)
    if stored == 0:
        raise AssertionError("no KV stored events")
    ttft = [st[0] - t0 for t0, st, _, _ in res]
    itl = [b - a for _, st, _, _ in res for a, b in zip(st, st[1:])]
    n_tok = sum(len(r[2]) for r in res)
    log(f"  [{smi}] 8 streams x {max_tokens} tokens, prompts "
        f"{sorted(len(p) for p in prompts)}: {engine.steps} ragged steps, "
        f"{launches['ragged_paged_attention']} kernel launches, "
        f"{stored} KV blocks stored")
    log(f"  [{smi}] TTFT mean {statistics.mean(ttft) * 1e3:.2f} ms max "
        f"{max(ttft) * 1e3:.2f} ms; ITL mean {statistics.mean(itl) * 1e3:.2f} "
        f"ms p50 {statistics.median(itl) * 1e3:.2f} ms; "
        f"{n_tok / wall:.2f} tok/s over {wall:.2f} s")
    return engine, launches


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# ------------------------------------------------------------------ phase 4


def full_width_step(engine, seed: int) -> float:
    """One mixed ragged step at full width, kernel vs plain attention, on
    the serving engine's weights and cache (fresh blocks)."""
    cfg, bs = engine.cfg, engine.args.block_size
    rng = np.random.default_rng(seed + 7)

    def seq(n):
        s = SeqState(request_id="step", req=None, ctx=None, sink=None)
        s.tokens = list(map(int, rng.integers(0, cfg.vocab_size, n)))
        s.block_table = engine.pool.allocate(-(-n // bs))
        return s

    a, b, c = seq(701), seq(328), seq(64)

    def run(plan, fn):
        ops, _ = engine.pack(plan)
        tensors = [torch.from_numpy(x).cuda() for x in ops]
        logits, _, _ = fn(engine.params, *tensors, engine.k_cache,
                          engine.v_cache)
        return logits

    kernel_fn = engine.step_fn
    plain_fn = make_ragged_step_fn(cfg, bs, attention=ragged_attention_ref)
    # context for the step under test
    run(StepPlan(prefill=[PrefillWork(a, 0, 700, False),
                          PrefillWork(b, 0, 200, False)]), kernel_fn)
    plan = StepPlan(prefill=[PrefillWork(b, 200, 128, True),
                             PrefillWork(c, 0, 64, True)], decode=[a])
    # both runs write the same slots before reading them, so the plain run
    # and the kernel run see the same context
    want = run(plan, plain_fn)[:3]
    got = run(plan, kernel_fn)[:3]
    torch.cuda.synchronize()
    if got.shape != (3, cfg.vocab_size) or not bool(
            torch.isfinite(got).all()):
        raise AssertionError("full-width step: bad logits")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    same = (got.argmax(-1) == want.argmax(-1)).tolist()
    log(f"full-width step (decode kv 701, chunk 128 at kv 328, prefill 64): "
        f"max |logit diff| {err:.4e}, logit scale {scale:.3f} (tolerance "
        f"{STEP_RTOL} of it), argmax agree {same}")
    if err > STEP_RTOL * scale:
        raise AssertionError(f"full-width step logits differ by {err}")
    return err


def step_profile(engine, seed: int) -> None:
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
        log(f"step profile, {name}: wall {statistics.median(walls):.3f} ms "
            f"(traced {traced_ms:.3f} ms), device busy {busy_ms:.3f} ms, "
            f"idle share {max(0.0, 1 - busy_ms / traced_ms):.3f}")
        top = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)
        for kname, (n, us) in top[:6]:
            log(f"    {us / 1e3:9.3f} ms  x{n:<4d} {kname[:70]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    t_start = time.perf_counter()
    smi, kind = device_phase()
    main_case = kernel_phase(a.seed)
    engine, launches = serving_phase(a.seed, smi)
    full_width_step(engine, a.seed)
    step_profile(engine, a.seed)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    kernels = [{
        "name": k["name"], "route": k["route"], "source": k["source"],
        "replaces": k["replaces"], "launches": launches[k["name"]],
        "max_abs_err": main_case["max_abs_err"], "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"], "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"]} for k in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
