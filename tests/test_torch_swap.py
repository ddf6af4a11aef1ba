"""Preempt-to-swap in the torch port against the JAX package on the CPU:
``tests/test_swap.py``'s cases re-run on ``AsyncTorchEngine`` with the JAX
engine's tiny weights carried across by ``params_from_jax``.

- A sequence swapped out and back resumes with the stream a never-swapped
  run gives, and the JAX engine gives on the same workload (plain and int8
  KV, greedy and seeded; GQA and ``mla_tiny``), and swap preemptions
  happened.
- With the host budget sufficient nothing is recomputed, and the swap
  counters balance; an exhausted budget falls back to recompute.
- Cancelling a swapped sequence returns every host byte and block.
- ``SwapStore``'s budget shared with the G2 tier, and ``make_room``'s
  eviction, answer as the JAX classes do under one sequence of calls.
- Under a stand-in for the card's graph cache the caches are never rebound
  and the swapped streams stay those of the eager run.
- With swap copies ready at once, the scheduler plans as the JAX
  scheduler does, step by step.
- The worker's swap counters and gauges carry the JAX worker's names.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import model as M
from dynamo_tpu.engine.cache import BlockPool as JaxBlockPool
from dynamo_tpu.engine.cache import SwapStore as JaxSwapStore
from dynamo_tpu.engine.config import EngineArgs as JaxEngineArgs
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import AsyncJaxEngine
from dynamo_tpu.engine.scheduler import Scheduler as JaxScheduler
from dynamo_tpu.engine.scheduler import SeqState as JaxSeqState
from dynamo_tpu.kvbm.manager import KvbmManager as JaxKvbmManager
from dynamo_tpu.kvbm.tiers import HostTier as JaxHostTier
from dynamo_tpu.models import get_model_config as jax_preset
from dynamo_tpu.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols import SamplingOptions as JaxSampling
from dynamo_tpu.protocols import StopConditions as JaxStop
from dynamo_tpu_torch.engine import model as TM
from dynamo_tpu_torch.engine.cache import BlockPool, SwapStore
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.engine.scheduler import Scheduler, SeqState
from dynamo_tpu_torch.engine.weights import params_from_jax
from dynamo_tpu_torch.kvbm import HostTier, KvbmManager
from dynamo_tpu_torch.models import get_model_config
from dynamo_tpu_torch.protocols import (
    PreprocessedRequest, SamplingOptions, StopConditions,
)
from tests.test_torch_graphs import RerunGraphs

pytestmark = pytest.mark.anyio

BS = 4
N, ISL, OSL = 4, 32, 24

_PARAMS: dict = {}


def _tiny_params():
    """ModelConfig.tiny()'s JAX weights (drawn once) and their port copy."""
    if "tiny" not in _PARAMS:
        jp = M.init_params(JaxModelConfig.tiny(), jax.random.key(0))
        _PARAMS["tiny"] = (jp, params_from_jax(
            jax.tree.map(np.asarray, jp), "cpu"))
    return _PARAMS["tiny"]


def _mla_params():
    """mla_tiny's weights drawn by the port's init and handed to JAX."""
    if "mla" not in _PARAMS:
        cfg = get_model_config("mla_tiny")
        tp = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        _PARAMS["mla"] = (jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp),
                          tp)
    return _PARAMS["mla"]


def _settings(pool: str, **kw) -> dict:
    """A pool of about half the workload's peak working set ("small") or
    all of it with headroom ("big": never preempts)."""
    working = N * ((ISL + OSL + BS - 1) // BS)
    nb = {"small": working // 2 + 1, "big": working + 8}[pool]
    out = dict(block_size=BS, num_blocks=nb, max_num_seqs=N,
               max_num_batched_tokens=64, max_model_len=256,
               decode_batch_buckets=(N,), enable_prefix_caching=False)
    out.update(kw)
    return out


def port_engine(pool="small", model="tiny", **kw) -> AsyncTorchEngine:
    if model == "tiny":
        cfg, params = ModelConfig.tiny(), _tiny_params()[1]
    else:
        cfg, params = get_model_config("mla_tiny"), _mla_params()[1]
    return AsyncTorchEngine(cfg, EngineArgs(**_settings(pool, **kw)),
                            params=params, device="cpu")


def jax_engine(pool="small", model="tiny", **kw) -> AsyncJaxEngine:
    if model == "tiny":
        cfg, params = JaxModelConfig.tiny(), _tiny_params()[0]
    else:
        cfg, params = jax_preset("mla_tiny"), _mla_params()[0]
    return AsyncJaxEngine(cfg, JaxEngineArgs(prefill_buckets=(ISL,),
                                             **_settings(pool, **kw)),
                          params=params)


def prompt(i):
    return [(7 * i + j) % 200 + 1 for j in range(ISL)]


def port_req(tokens, **sampling):
    return PreprocessedRequest(
        model="tiny", token_ids=list(tokens),
        stop_conditions=StopConditions(max_tokens=OSL, ignore_eos=True),
        sampling_options=SamplingOptions(**sampling))


def jax_req(tokens, **sampling):
    return JaxRequest(
        model="tiny", token_ids=list(tokens),
        stop_conditions=JaxStop(max_tokens=OSL, ignore_eos=True),
        sampling_options=JaxSampling(**sampling))


async def collect(eng, r, ctx=None):
    toks, reason = [], None
    async for out in eng.generate(r, ctx):
        toks.extend(out.token_ids)
        if out.finish_reason is not None:
            reason = out.finish_reason
    return toks, reason


async def run_workload(eng, make_req=port_req, **sampling):
    res = await asyncio.gather(
        *[collect(eng, make_req(prompt(i), **sampling)) for i in range(N)])
    return [t for t, _ in res]


# ------------------------------------------------------------- determinism


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("sampling", [dict(temperature=0.0),
                                      dict(temperature=0.9, seed=3)])
async def test_swap_roundtrip_bit_identical(kv_dtype, sampling):
    """Swapped streams equal the never-preempting run's and the JAX
    engine's swapped streams on the same weights (int8 moves as packed
    (q, s) bundles, so its round trip is bit-exact too)."""
    e_swap = port_engine("small", kv_cache_dtype=kv_dtype)
    e_big = port_engine("big", kv_cache_dtype=kv_dtype)
    j_swap = jax_engine("small", kv_cache_dtype=kv_dtype)
    swapped = await run_workload(e_swap, **sampling)
    baseline = await run_workload(e_big, **sampling)
    jax_swapped = await run_workload(j_swap, jax_req, **sampling)
    assert e_swap.scheduler.preempt_swap_total > 0, \
        "scenario generated no swap preemptions: nothing was proven"
    assert j_swap.scheduler.preempt_swap_total > 0
    assert e_big.scheduler.preempt_swap_total == 0
    assert swapped == baseline == jax_swapped
    assert all(len(t) == OSL for t in swapped)
    assert set(e_swap.swap_stats()) == set(j_swap.swap_stats())
    for e in (e_swap, e_big, j_swap):
        await e.close()


async def test_mla_swap_streams_match_jax():
    """mla_tiny's latent and rope pools swap out and back: streams equal
    to the JAX engine's on the same workload and to the big pool's."""
    e_swap = port_engine("small", model="mla")
    e_big = port_engine("big", model="mla")
    j_swap = jax_engine("small", model="mla")
    swapped = await run_workload(e_swap)
    baseline = await run_workload(e_big)
    jax_swapped = await run_workload(j_swap, jax_req)
    assert e_swap.scheduler.preempt_swap_total > 0
    assert swapped == baseline == jax_swapped
    for e in (e_swap, e_big, j_swap):
        await e.close()


async def test_swapped_streams_under_replayed_graphs():
    """With a stand-in for the card's graph cache (every later use of a
    step re-runs the callable its first use captured, which holds the
    caches it saw), swap-ins write into the same cache tensors and the
    streams equal the eager big-pool run's."""
    eng = port_engine("small")
    eng.graphs, eng.use_graphs = RerunGraphs(), True
    k0, v0 = eng.k_cache, eng.v_cache
    swapped = await run_workload(eng, temperature=0.9, seed=3)
    baseline = await run_workload(port_engine("big"), temperature=0.9,
                                  seed=3)
    assert eng.scheduler.preempt_swap_total > 0
    assert eng.graphs.replays > 0
    assert eng.k_cache is k0 and eng.v_cache is v0
    assert swapped == baseline
    await eng.close()


async def test_oversubscribed_workload_recomputes_nothing():
    """With a sufficient host budget every preemption goes through swap:
    no recompute preemption, no recomputed token, and the swap volume
    balances out, with nothing left parked."""
    eng = port_engine("small")
    toks = await run_workload(eng)
    st = eng.swap_stats()
    assert all(len(t) == OSL for t in toks)
    assert st["preempt_swap"] > 0
    assert st["preempt_recompute"] == 0
    assert st["recomputed_tokens"] == 0
    assert st["swap_out_blocks"] > 0
    assert st["swap_out_blocks"] == st["swap_in_blocks"]
    assert st["swapped_seqs"] == 0
    assert st["swapped_blocks"] == 0
    assert st["swap_host_bytes"] == 0
    await eng.close()


async def test_budget_exhausted_falls_back_to_recompute():
    """A host budget too small for one block: every preemption releases
    and recomputes, and the streams still equal the big pool's."""
    eng = port_engine("small", swap_host_bytes=64)
    toks = await run_workload(eng)
    baseline = await run_workload(port_engine("big"))
    st = eng.swap_stats()
    assert st["swap_out_blocks"] == 0
    assert st["preempt_swap"] == 0
    assert st["preempt_recompute"] > 0
    assert st["recomputed_tokens"] > 0
    assert toks == baseline
    await eng.close()


async def test_preempt_swap_off_recomputes():
    """preempt_swap=False (the worker's --no-preempt-swap): recompute
    preemption only, and the same streams."""
    eng = port_engine("small", preempt_swap=False)
    toks = await run_workload(eng)
    assert eng.scheduler.swapper is None
    assert eng.swap_stats()["preempt_recompute"] > 0
    assert toks == await run_workload(port_engine("big"))
    await eng.close()


async def test_cancel_while_swapped_tears_down():
    """Cancelling a sequence parked in the swapped queue frees its host
    bundle and reservation; the other streams finish, and after close()
    no host byte stays reserved and no block stays counted swapped."""

    class Ctx:
        cancelled = False
        expired = False
        id = "cancel-target"

    eng = port_engine("small")
    ctxs = [Ctx() for _ in range(N)]
    tasks = [asyncio.ensure_future(collect(eng, port_req(prompt(i)),
                                           ctxs[i])) for i in range(N)]
    for _ in range(20000):
        if eng.scheduler.swapped:
            break
        await asyncio.sleep(0.001)
    assert eng.scheduler.swapped, "no sequence was ever swapped out"
    victim = eng.scheduler.swapped[0]
    victim.ctx.cancelled = True
    eng._wake.set()
    results = await asyncio.gather(*tasks)
    assert len(results[ctxs.index(victim.ctx)][0]) < OSL
    done = [r for c, r in zip(ctxs, results) if c is not victim.ctx]
    assert all(len(t) == OSL for t, _ in done)
    assert not eng.scheduler.swapped
    await eng.close()
    assert eng._swap.used == 0
    assert eng.pool.swapped_blocks == 0
    assert eng.pool.num_active_blocks == 0


# ------------------------------------------------------------ the planner


class _Swapper:
    """A swapper whose copies are ready at once, with a host budget of
    ``budget`` blocks: the scheduler's side of swap, without an engine."""

    def __init__(self, budget: int):
        self.budget = budget
        self.log: list = []

    def swap_out(self, seq):
        n = -(-seq.num_computed // BS)
        if n > self.budget:
            return False
        self.budget -= n
        seq.swap = n
        self.log.append(("out", seq.request_id, n))
        return True

    def swap_status(self, seq):
        return "ready" if seq.swap is not None else "failed"

    def swap_in(self, seq):
        self.budget += seq.swap
        self.log.append(("in", seq.request_id, seq.swap))
        seq.swap = None
        return True

    def swap_drop(self, seq):
        self.budget += seq.swap or 0
        seq.swap = None


class _Sink(list):
    put_nowait = list.append


class _Ctx:
    cancelled = expired = False

    def __init__(self, tenant: str, priority: str):
        self.tenant, self.priority = tenant, priority


def _plans(jax: bool, budget: int, qos: bool) -> list:
    """Every plan of one scheduler over a pressured workload, with its
    swapper's log, committing each planned token as the engines do (a
    sampled token is a function of the sequence's length)."""
    kw = dict(_settings("small", num_blocks=40), max_num_seqs=8,
              decode_batch_buckets=(8,), max_num_batched_tokens=48,
              qos_scheduling=qos)
    if jax:
        args = JaxEngineArgs(**kw)
        pool, state, req = JaxBlockPool(args.num_blocks), JaxSeqState, \
            JaxRequest
        sched_cls, stop = JaxScheduler, JaxStop
    else:
        args = EngineArgs(**kw)
        pool, state, req = BlockPool(args.num_blocks), SeqState, \
            PreprocessedRequest
        sched_cls, stop = Scheduler, StopConditions
    swapper = _Swapper(budget)
    sched = sched_cls(args, pool, swapper=swapper)
    for i in range(10):
        # with QoS scheduling: two tenants, and three classes in turn
        ctx = _Ctx(f"t{i % 2}", ("interactive", "standard", "batch")[i % 3]
                   ) if qos else None
        sched.add(state(request_id=f"r{i}", ctx=ctx, sink=_Sink(), req=req(
            model="tiny", token_ids=prompt(i)[:12 + 2 * i],
            stop_conditions=stop(max_tokens=OSL, ignore_eos=True))))
    out = []
    for _ in range(400):
        if not sched.has_work:
            break
        plan = sched.plan()
        out.append(([(w.seq.request_id, w.start, w.chunk, w.sample)
                     for w in plan.prefill],
                    [s.request_id for s in plan.decode],
                    [s.request_id for s in sched.swapped]))
        for w in plan.prefill:
            sched.commit_computed(w.seq, w.start + w.chunk)
        for s in plan.decode:
            sched.commit_computed(s, len(s.tokens))
        for s in [w.seq for w in plan.prefill if w.sample] + plan.decode:
            tok = len(s.tokens) % 200 + 1
            sched.append_token(s, tok)
            reason = sched.check_finish(s, tok)
            if reason is not None:
                sched.finish(s, reason)
    assert not sched.has_work
    counters = (sched.preempt_swap_total, sched.preempt_recompute_total,
                sched.swap_in_total, sched.recomputed_tokens_total,
                sched.swap_in_blocked_total)
    return out, swapper.log, counters


@pytest.mark.parametrize("qos", [False, True])
@pytest.mark.parametrize("budget", [1000, 12, 0])
def test_scheduler_plans_match_jax_with_swap(budget, qos):
    """With swap copies ready at once, the port's scheduler makes the JAX
    scheduler's plans step by step: the same chunks and decode rows, the
    same swapped queue, swap-outs and swap-ins, and counters, whether the
    host budget takes every victim, some, or none."""
    got, want = _plans(False, budget, qos), _plans(True, budget, qos)
    assert got == want
    if budget == 1000:
        assert got[2][0] > 0 and got[2][1] == 0  # swap preemptions only
    if budget == 0:
        assert got[2][0] == 0 and got[2][1] > 0


# ------------------------------------------------------- budget accounting


def _shared_budget_answers(store_cls, host_cls, block):
    """tests/test_swap.py's shared-allowance sequence, as a list of the
    answers it gets."""
    out = []
    g2_used = {"v": 0}
    store = store_cls(1000, external_used=lambda: g2_used["v"])
    out += [store.reserve(600), store.reserve(600)]
    store.release(600)
    g2_used["v"] = 700
    out += [store.reserve(600), store.reserve(300)]
    store.release(300)
    out.append(store.used)
    box = {}
    host = host_cls(1000, external_used=lambda: box["store"].used)
    box["store"] = store2 = store_cls(1000, external_used=lambda: host.used)
    out += [host.put(1, block, block), 1 in host,
            host.put(2, block, block), 2 in host,
            store2.reserve(500), store2.reserve(300)]
    evicted = host.put(3, block, block)
    out += [3 in host, [e[0] for e in evicted], host.used, store2.used]
    store2.release(300)
    out.append(store2.used)
    return out


def test_swap_store_budget_shared_with_g2():
    """SwapStore and HostTier share one allowance in both directions, and
    the port's pair answers the JAX pair's sequence of calls alike."""
    got = _shared_budget_answers(SwapStore, HostTier,
                                 torch.zeros(150, dtype=torch.uint8))
    want = _shared_budget_answers(JaxSwapStore, JaxHostTier,
                                  np.zeros(150, np.uint8))
    assert got == want
    assert got[:5] == [True, False, False, True, 0]
    assert got[-5:-1] == [True, [1], 600, 300]


def _make_room_answers(store_cls, mgr_cls, block):
    mgr = mgr_cls(host_bytes=1200)
    store = store_cls(1200, external_used=lambda: mgr.host.used,
                      make_room=mgr.make_host_room)
    for h in (1, 2, 3, 4):
        mgr.put(h, block, block)
    out = [mgr.host.used, store.reserve(700), mgr.host.used, store.used,
           sorted(h for h in (1, 2, 3, 4) if h in mgr.host)]
    store.release(700)
    return out


def test_swap_reserve_evicts_full_g2_lru():
    """A host tier that filled the shared allowance yields to a swap
    reservation (make_host_room evicts its LRU), as in the JAX package."""
    got = _make_room_answers(SwapStore, KvbmManager,
                             torch.zeros(150, dtype=torch.uint8))
    want = _make_room_answers(JaxSwapStore, JaxKvbmManager,
                              np.zeros(150, np.uint8))
    assert got == want
    assert got[1] and got[2] + got[3] <= 1200 and 4 in got[4]


# ---------------------------------------------------------------- worker


class _Registry:
    """Records what a worker registers: (kind, name) -> callback."""

    def __init__(self):
        self.series = {}

    def _add(self, kind, name):
        reg = self

        class _Metric:
            def add_callback(self, fn):
                reg.series[kind, name] = fn

        return _Metric()

    def counter(self, name, help_=""):
        return self._add("counter", name)

    def gauge(self, name, help_=""):
        return self._add("gauge", name)


async def test_worker_registers_the_jax_swap_metrics():
    """The worker's swap series carry the JAX worker's names and kinds
    (``dynamo_tpu/engine/main.py``'s preempt-to-swap block) and read the
    engine's swap_stats at each scrape."""
    from dynamo_tpu_torch.engine.main import register_swap_metrics

    eng = port_engine("small")
    reg = _Registry()
    register_swap_metrics(reg, eng)
    assert set(reg.series) == {
        ("counter", n) for n in (
            "swap_out_blocks_total", "swap_in_blocks_total",
            "preempt_swap_total", "swap_in_seqs_total",
            "preempt_recompute_total", "preempt_recomputed_tokens_total",
            "swap_in_blocked_total")} | {
        ("gauge", "swap_host_bytes"), ("gauge", "swapped_blocks")}
    await run_workload(eng)
    st = eng.swap_stats()
    assert reg.series["counter", "preempt_swap_total"]() == {
        None: st["preempt_swap"]} and st["preempt_swap"] > 0
    assert reg.series["counter", "swap_out_blocks_total"]() == {
        None: st["swap_out_blocks"]}
    await eng.close()
