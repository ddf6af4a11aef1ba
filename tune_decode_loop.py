#!/usr/bin/env python3
"""Where a decode step's host time goes under serving, on one CUDA card.

    python3 tune_decode_loop.py [--model llama3_8b] [--tokens 64]
                                [--rounds 2] [--profile N] [--seed N]
                                [--sampled] [--graphs N]

Builds one ``AsyncTorchEngine`` of the preset at full width and depth on
random weights from the seed, and serves ``chip_smoke.py``'s eight
concurrent greedy requests (after one warm-up request) on the serial
decode loop (``pipeline_decode`` off: each step's launches in a worker
thread, then the wait for its tokens, then the commit) and on the
engine's depth-2 pipelined loop, in the order serial, pipelined,
pipelined, serial, ``--rounds`` times, on an emptied prefix cache each
time. Each run prints TTFT, ITL, tok/s and the decode step wall
(``chip_smoke.StepClock``). Before the runs it times one decode step's
parts: the host time of its launches (``_step``), the wait for its
tokens, and the device time between two events around it.

``--sampled`` times the step's parts for a seeded sampled batch (the
temperature, top-k and top-p of ``chip_smoke.SAMPLED``: the cuts, the
draw kernel, the staged sampling operands) against the same greedy batch,
in turns greedy, sampled, sampled, greedy, before the serving runs.

``--graphs N`` times one greedy decode step (8 rows at kv ~1000) run
eagerly and replayed as the engine's captured graphs, in N alternating
pairs (eager, captured, captured, eager, ...): the host ms of the step's
launches (``_step``), the device ms between events around them, and the
wall ms until its tokens are on the host; it prints the medians and the
quartiles of each, and the engine's captures and graph pool.

``--profile N`` then serves the requests once more on the pipelined loop
under ``cProfile`` and prints the N functions with the most time of their
own (cProfile slows every Python call and no native one, so it finds
candidates; the loop runs measure what they cost).

The card's name and power limit come first; every number is this run's.
"""

from __future__ import annotations

import argparse
import asyncio
import cProfile
import io
import pstats
import statistics
import sys
import time

import torch

import chip_smoke
from dynamo_tpu_torch.engine.config import EngineArgs
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.engine import sampling
from dynamo_tpu_torch.engine.scheduler import SeqState
from dynamo_tpu_torch.models import get_model_config
from dynamo_tpu_torch.protocols import (
    PreprocessedRequest, SamplingOptions, StopConditions,
)


#: name -> pipeline_decode
LOOPS = {"serial": False, "pipelined": True}


def decode_seqs(engine, sampled: bool = False) -> list:
    """Eight decoding sequences at kv ~1000, their blocks allocated."""
    seqs = []
    for i in range(8):
        t, k, p = chip_smoke.SAMPLED[i]
        opts = (SamplingOptions(temperature=t, top_k=k or None, top_p=p,
                                seed=i + 1) if sampled else SamplingOptions())
        s = SeqState(request_id=f"p{i}", req=PreprocessedRequest(
            model="x", token_ids=[1] * 1000, sampling_options=opts),
            ctx=None, sink=None)
        s.tokens = [1 + i] * (1000 + i)
        s.step_idx = len(s.tokens)
        engine.scheduler._ensure_blocks(s, len(s.tokens))
        seqs.append(s)
    return seqs


def quartiles(xs) -> str:
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    return f"{q2:.3f} [{q1:.3f}, {q3:.3f}]"


def graph_pairs(engine, pairs: int) -> str:
    """One greedy decode step, eager against captured, in ``pairs``
    alternating pairs: the host ms of its launches, its device ms between
    events, its wall ms until the tokens landed; medians [quartiles]."""
    seqs = decode_seqs(engine)
    ops = engine._decode_operands(seqs, 0)
    samp = engine._sampling_plan(seqs)
    res = {False: ([], [], []), True: ([], [], [])}
    for graphs in (False, True, True):  # first uses, and the capture
        engine.use_graphs = graphs
        engine._step(ops, False, None, samp)["copied"].synchronize()
    order = [False, True, True, False] * (pairs // 2) + [False, True] * (
        pairs % 2)
    for graphs in order:
        engine.use_graphs = graphs
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        e0.record()
        out = engine._step(ops, False, None, samp)
        e1.record()
        t1 = time.perf_counter()
        out["copied"].synchronize()
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        host, dev, wall = res[graphs]
        host.append((t1 - t0) * 1e3)
        dev.append(e0.elapsed_time(e1))
        wall.append((t2 - t0) * 1e3)
    engine.use_graphs = True
    for s in seqs:
        engine.pool.release(s.block_table)
    lines = []
    for graphs, name in ((False, "eager"), (True, "captured")):
        host, dev, wall = res[graphs]
        lines.append(f"{name}: launches {quartiles(host)} ms of host, "
                     f"device {quartiles(dev)} ms, wall {quartiles(wall)} "
                     f"ms")
    return (f"one greedy decode step, 8 rows at kv ~1000, {pairs} pairs in "
            f"turns, median [quartiles]: " + "; ".join(lines)
            + f"; {chip_smoke.graph_line(engine)}")


def step_parts(engine, n: int = 20, sampled: bool = False) -> str:
    """Median host ms of one 8-row decode step's launches, of the wait for
    its tokens after them, and its device ms (events around the step); and
    for a greedy batch the host ms of the same step launched as before the
    staging buffers (four pageable copies, the step, the argmax,
    ``.tolist()``). ``sampled``: each row draws with its own seed."""
    seqs = decode_seqs(engine, sampled)
    ops = engine._decode_operands(seqs, 0)
    # the engine's path for both: the greedy batch's plan draws nothing
    samp = engine._sampling_plan(seqs)
    host, wait, dev = [], [], []
    for _ in range(n + 3):
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        e0.record()
        out = engine._step(ops, False, None, samp)
        e1.record()
        t1 = time.perf_counter()
        out["copied"].synchronize()
        t2 = time.perf_counter()
        host.append((t1 - t0) * 1e3)
        wait.append((t2 - t1) * 1e3)
        torch.cuda.synchronize()
        dev.append(e0.elapsed_time(e1))
    med = lambda xs: statistics.median(xs[3:])  # noqa: E731
    kind = "seeded sampled" if sampled else "greedy"
    # the sampler alone, on one step's logits and staged operands: its
    # launches' host time and its device time, apart from the forward's
    logits = torch.randn((len(seqs), engine.cfg.vocab_size),
                         device=engine.device)
    rows = torch.from_numpy(sampling.pack_rows(
        samp["temp"], samp["top_k"], samp["top_p"],
        samp["keys"])).to(engine.device)
    s_host, s_dev = [], []
    for _ in range(n + 3):
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        e0.record()
        engine._sample(logits, samp, rows)
        e1.record()
        s_host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        s_dev.append(e0.elapsed_time(e1))
    head = (f"one {kind} decode step, 8 rows at kv ~1000: launches "
            f"{med(host):.3f} ms of host, then {med(wait):.3f} ms waiting "
            f"for its tokens; device {med(dev):.3f} ms; its sampling "
            f"alone {med(s_host):.3f} ms of host, {med(s_dev):.3f} ms of "
            f"device")
    if sampled:
        for s in seqs:
            engine.pool.release(s.block_table)
        return f"{head} (medians of {n})"
    pageable = []
    for _ in range(n + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t = [torch.from_numpy(a).to(engine.device) for a in ops]
        logits, _, _ = engine.step_fn(engine.params, t[0], t[1], None, t[3],
                                      engine.k_cache, engine.v_cache)
        toks = logits.argmax(-1)
        torch.log_softmax(logits, -1).gather(1, toks[:, None])
        toks.tolist()
        pageable.append((time.perf_counter() - t0) * 1e3)
    for s in seqs:
        engine.pool.release(s.block_table)
    return (f"{head}; with pageable operand copies and a synchronous copy "
            f"of the tokens {med(pageable):.3f} ms of wall (medians of {n})")


async def serve_loops(engine, prompts, tokens: int, order,
                      profile: int = 0) -> list:
    clock = chip_smoke.StepClock(engine)

    async def one(p, n):
        t0 = time.perf_counter()
        stamps, toks = [], []
        async for out in engine.generate(PreprocessedRequest(
                model="m", token_ids=p,
                stop_conditions=StopConditions(max_tokens=n,
                                               ignore_eos=True))):
            stamps.append(time.perf_counter())
            toks.extend(out.token_ids)
        return t0, stamps, toks, None

    results = []
    try:
        await one(list(range(1, 17)), 2)
        for name in order:
            engine.args.pipeline_decode = LOOPS[name]
            engine.pool.clear()
            clock.records.clear()
            t0 = time.perf_counter()
            res = await asyncio.gather(*(one(p, tokens) for p in prompts))
            st = chip_smoke.serving_stats(res, time.perf_counter() - t0)
            st["step_ms"], st["step_n"] = clock.decode_step_ms()
            results.append((name, st, [r[2] for r in res]))
        if profile:
            engine.args.pipeline_decode = True
            engine.pool.clear()
            prof = cProfile.Profile()
            prof.enable()
            await asyncio.gather(*(one(p, tokens) for p in prompts))
            prof.disable()
            out = io.StringIO()
            pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(
                profile)
            results.append(("profile", out.getvalue(), None))
    finally:
        await engine.close()
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="llama3_8b")
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--profile", type=int, default=0, metavar="N")
    ap.add_argument("--sampled", action="store_true",
                    help="also time a seeded sampled step against a greedy "
                         "one, in turns")
    ap.add_argument("--graphs", type=int, default=0, metavar="N",
                    help="time a decode step eager against captured in N "
                         "alternating pairs")
    a = ap.parse_args()
    smi, _kind = chip_smoke.device_phase()
    cfg = get_model_config(a.model)
    engine = AsyncTorchEngine(cfg, EngineArgs(
        block_size=16, max_num_seqs=8, max_num_batched_tokens=2048,
        max_model_len=4096, seed=a.seed))
    if a.graphs:
        print(f"[{smi}] {a.model}: {graph_pairs(engine, a.graphs)}",
              flush=True)
    print(f"[{smi}] {a.model}: {step_parts(engine)}", flush=True)
    if a.sampled:
        for sampled in (False, True, True, False):
            print(f"[{smi}] {a.model}: {step_parts(engine, sampled=sampled)}",
                  flush=True)
    order = ["serial", "pipelined", "pipelined", "serial"] * a.rounds
    if not order:
        return 0
    prompts = chip_smoke.serving_prompts(cfg, a.seed)
    results = asyncio.run(serve_loops(engine, prompts, a.tokens, order,
                                         a.profile))
    first = results[0][2]
    for name, st, streams in results:
        if name == "profile":
            print(f"[{smi}] {a.model}, pipelined loop under cProfile, the "
                  f"{a.profile} functions with the most own time:\n{st}")
            continue
        same = "" if streams == first else " (streams differ from run 1)"
        print(f"[{smi}] {a.model}, 8 streams x {a.tokens} tokens, {name}: "
              f"{chip_smoke.stats_line(st)}{same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
