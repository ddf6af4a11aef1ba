"""KV pulls between workers in the torch port (``kv_pull``,
``export_blocks``, ``attach_restored``, the restore and onboard pulls of
``DecodeWorkerHandler``), held against the JAX package
(``tests/test_restore.py``, ``tests/test_onboard.py``).

The engines are tiny CPU engines on the JAX package's random weights. Pull
frames cross the wire codec (``FakePullClient``). Every wait on a pull is
bounded by the handler's own timeouts and by ``asyncio.wait_for``.
"""

import asyncio
import time

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import model as M
from dynamo_tpu.engine.config import EngineArgs as JaxEngineArgs
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import AsyncJaxEngine
from dynamo_tpu.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols import StopConditions as JaxStop
from dynamo_tpu_torch.disagg import handlers as H
from dynamo_tpu_torch.disagg.handlers import DecodeWorkerHandler, KvPullHandler
from dynamo_tpu_torch.disagg.transfer import (
    OnboardConfig, RestoreConfig, restore_pull_timeout,
)
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.engine.weights import params_from_jax
from dynamo_tpu_torch.protocols import (
    PreprocessedRequest, SamplingOptions, StopConditions,
)
from dynamo_tpu_torch.runtime.codec import packb, unpackb
from dynamo_tpu_torch.runtime.context import Context

pytestmark = pytest.mark.anyio

BS = 4
SETTINGS = dict(block_size=BS, num_blocks=256, max_num_seqs=8,
                max_num_batched_tokens=256, max_model_len=512)
VOCAB = ModelConfig.tiny().vocab_size
PREFIX = [(i * 7) % (VOCAB - 2) + 1 for i in range(12 * BS)]
WAIT_S = 60

_PARAMS: dict = {}


def _jparams():
    if "jax" not in _PARAMS:
        _PARAMS["jax"] = M.init_params(JaxModelConfig.tiny(),
                                       jax.random.key(0))
    return _PARAMS["jax"]


def make_engine(**kw) -> AsyncTorchEngine:
    if "torch" not in _PARAMS:
        _PARAMS["torch"] = params_from_jax(
            jax.tree.map(np.asarray, _jparams()), "cpu")
    return AsyncTorchEngine(ModelConfig.tiny(),
                            EngineArgs(**{**SETTINGS, **kw}),
                            params=_PARAMS["torch"], device="cpu")


def make_jax_engine() -> AsyncJaxEngine:
    return AsyncJaxEngine(JaxModelConfig.tiny(), JaxEngineArgs(
        prefill_buckets=(8, 16, 32, 64), **SETTINGS), params=_jparams())


def req(tokens, n=4, seed=None, temp=0.0):
    return PreprocessedRequest(
        model="m", token_ids=list(tokens),
        stop_conditions=StopConditions(max_tokens=n, ignore_eos=True),
        sampling_options=SamplingOptions(temperature=temp, seed=seed))


async def drain(eng, r):
    async def run():
        out = []
        async for o in eng.generate(r):
            out.extend(o.token_ids)
        return out
    return await asyncio.wait_for(run(), WAIT_S)


async def through(h, r, ctx=None):
    async def run():
        out = []
        async for f in h.generate(r.to_wire(), ctx or Context()):
            out.extend(f.get("token_ids") or [])
        return out
    return await asyncio.wait_for(run(), WAIT_S)


class _Stream:
    def __init__(self, agen):
        self._agen = agen
        self.cancelled = False

    def __aiter__(self):
        return self._agen

    async def cancel(self):
        self.cancelled = True
        await self._agen.aclose()


class FakePullClient:
    """kv_pull over the wire codec: instance id → a KvPullHandler."""

    def __init__(self, peers: dict, fail: bool = False, delay: float = 0.0):
        self.peers = peers
        self.fail = fail
        self.delay = delay
        self.requests = []

    def instance(self, iid):
        return object() if iid in self.peers else None

    async def generate(self, request, mode="direct", instance_id=None):
        assert mode == "direct"
        self.requests.append((instance_id, unpackb(packb(request))))
        if self.fail:
            raise ConnectionError("peer gone")
        handler = self.peers[instance_id]

        async def frames():
            if self.delay:
                await asyncio.sleep(self.delay)
            async for f in handler.generate(request, None):
                yield unpackb(packb(f))
        return _Stream(frames())


# ------------------------------------------------------ export / attach

async def test_export_and_attach_against_jax_engine():
    """Both engines export the same hash run for the same prompt, with the
    same shapes and values (f32, 1e-5); blocks exported by either engine,
    attached to the other, continue into the JAX engine's stream."""
    prompt = PREFIX + [201]
    t_eng, j_eng = make_engine(), make_jax_engine()
    try:
        t_toks = await drain(t_eng, req(prompt, 6))
        j_toks = []
        async for o in j_eng.generate(JaxRequest(
                model="m", token_ids=prompt,
                stop_conditions=JaxStop(max_tokens=6, ignore_eos=True))):
            j_toks.extend(o.token_ids)
        assert t_toks == j_toks
        t_probe = t_eng.restore_probe(req(prompt))
        j_probe = j_eng.restore_probe(JaxRequest(model="m",
                                                 token_ids=prompt))
        hashes = t_probe.sequence_hashes()
        assert hashes == j_probe.sequence_hashes() and len(hashes) == 12
        assert t_eng.resident_prefix_blocks(t_probe) == 12
        t_blocks = [b async for b in t_eng.export_blocks(hashes)]
        j_blocks = [b async for b in j_eng.export_blocks(hashes)]
        assert [h for h, _k, _v in t_blocks] == hashes
        assert [h for h, _k, _v in j_blocks] == hashes
        for (_h, tk, tv), (_j, jk, jv) in zip(t_blocks, j_blocks):
            assert tuple(tk.shape) == jk.shape == (2, BS, 2, 16)
            np.testing.assert_allclose(tk.numpy(), jk, atol=1e-5)
            np.testing.assert_allclose(tv.numpy(), jv, atol=1e-5)
        # a leading run only, and at most max_blocks
        assert len([b async for b in t_eng.export_blocks(
            hashes, max_blocks=5)]) == 5
        assert [b async for b in t_eng.export_blocks([12345] + hashes)] == []
        assert t_eng.pool.num_active_blocks == 0
    finally:
        await t_eng.close()
        await j_eng.close()

    # JAX blocks into a fresh torch engine, torch blocks into a fresh JAX
    # engine: both continue into the unbroken stream
    t2, j2 = make_engine(), make_jax_engine()
    try:
        events = []
        t2.event_cb = events.append
        n = t2.attach_restored(t_probe, 0, [(h, torch.from_numpy(k),
                                             torch.from_numpy(v))
                                            for h, k, v in j_blocks])
        assert n == 12 and t2.resident_prefix_blocks(t_probe) == 12
        assert [b.block_hash for e in events for b in e.stored_blocks] == \
            hashes
        assert await drain(t2, req(prompt, 6)) == j_toks
        assert t2.scheduler.prefix_hit_tokens == 12 * BS
        assert j2.attach_restored(j_probe, 0, [(h, k.numpy(), v.numpy())
                                               for h, k, v in t_blocks]) == 12
        toks = []
        async for o in j2.generate(JaxRequest(
                model="m", token_ids=prompt,
                stop_conditions=JaxStop(max_tokens=6, ignore_eos=True))):
            toks.extend(o.token_ids)
        assert toks == j_toks
    finally:
        await t2.close()
        await j2.close()


async def test_attach_stops_at_torn_entry():
    eng = make_engine()
    try:
        await drain(eng, req(PREFIX + [1], 2))
        probe = eng.restore_probe(req(PREFIX + [1]))
        blocks = [b async for b in eng.export_blocks(
            probe.sequence_hashes())]
        other = make_engine()
        # a hash out of order after three blocks: three attach, no more
        torn = blocks[:3] + [blocks[5]] + blocks[4:]
        assert other.attach_restored(probe, 0, torn) == 3
        # a block of another geometry first: nothing attaches, no leak
        bad = [(blocks[0][0], blocks[0][1][:, :2], blocks[0][2])]
        free0 = other.pool.num_free_blocks
        fresh = make_engine()
        assert fresh.attach_restored(probe, 0, bad) == 0
        assert fresh.pool.num_active_blocks == 0
        assert other.pool.num_free_blocks == free0
        await other.close()
        await fresh.close()
    finally:
        await eng.close()


# ------------------------------------------------------------- onboard

async def _peer(prompt_tail=200):
    """Engine A holding PREFIX in its prefix cache, and its pull handler."""
    a = make_engine()
    await drain(a, req(PREFIX + [prompt_tail], 2))
    return a, KvPullHandler(a)


def _onboard_req(tokens, sources):
    r = req(tokens)
    r.onboard = {"sources": sources, "block_size": BS}
    return r


async def test_onboard_peer_pull_bit_identical():
    """A peer pull gives the local stream; both workers' Prometheus
    counters read the handlers' counts."""
    from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

    a = make_engine()
    await drain(a, req(PREFIX + [200], 2))
    served_m, pulled_m = MetricsRegistry(), MetricsRegistry()
    pull = KvPullHandler(a, metrics=served_m)
    b = make_engine()
    ref = make_engine()
    try:
        tokens = PREFIX + [201]
        want = await drain(ref, req(tokens))
        h = DecodeWorkerHandler(b, pull_clients=[FakePullClient({2: pull})],
                                metrics=pulled_m)
        h.instance_id = 1
        got = await through(h, _onboard_req(tokens, [[2, 12, 1.0]]))
        assert got == want
        assert h.counts["onboard"] == {"pulled": 1}
        assert h.counts["onboard_blocks"]["peer"] == 12
        assert pull.served == {"onboard": 12}
        text = pulled_m.render()
        for line in ('dynamo_prefix_onboard_total{outcome="pulled"} 1',
                     'dynamo_prefix_onboard_blocks_total{source="peer"} 12',
                     'dynamo_kv_pull_outcome_total{outcome="pulled"} 1',
                     "dynamo_prefix_onboard_seconds_count 1"):
            assert line in text
        assert ('dynamo_kv_restore_served_blocks_total{reason="onboard"} 12'
                in served_m.render())
        assert b.scheduler.prefix_hit_tokens == 12 * BS
        assert a.pool.num_active_blocks == 0
    finally:
        for e in (a, b, ref):
            await e.close()


async def test_onboard_dedupes_simultaneous_same_prefix():
    a, pull = await _peer()
    b, ref = make_engine(), make_engine()
    try:
        wants = [await drain(ref, req(PREFIX + [210 + i])) for i in range(3)]
        client = FakePullClient({2: pull}, delay=0.05)
        h = DecodeWorkerHandler(b, pull_clients=[client])
        h.instance_id = 1
        gots = await asyncio.gather(*[
            through(h, _onboard_req(PREFIX + [210 + i], [[2, 12, 1.0]]))
            for i in range(3)])
        assert list(gots) == wants
        assert h.counts["onboard"].get("pulled") == 1 and len(
            client.requests) == 1
        assert sum(h.counts["onboard"].values()) == 3
    finally:
        for e in (a, b, ref):
            await e.close()


async def test_onboard_budget_separate_from_restore():
    eng = make_engine()
    try:
        h = DecodeWorkerHandler(
            eng, restore_config=RestoreConfig(enabled=True),
            onboard_config=OnboardConfig(max_concurrent=1,
                                         pull_timeout_cap_s=0.2))
        h.instance_id = 1
        await h._onboard_slots.acquire()  # saturate the onboard budget
        info = await asyncio.wait_for(h._onboard_prefix(
            _onboard_req(PREFIX + [1], [[2, 11, 1.0]]), Context()), WAIT_S)
        assert info["reason"] == "budget"
        assert info["outcome"] == "recomputed"
        assert h._restore_slots._value == h.restore_config.max_concurrent
    finally:
        await eng.close()


async def test_onboard_failed_pull_recomputes_exactly():
    a, pull = await _peer()
    b, ref = make_engine(), make_engine()
    try:
        tokens = PREFIX + [220]
        want = await drain(ref, req(tokens))
        h = DecodeWorkerHandler(
            b, pull_clients=[FakePullClient({2: pull}, fail=True)])
        h.instance_id = 1
        got = await through(h, _onboard_req(tokens, [[2, 12, 1.0]]))
        assert got == want
        assert h.counts["onboard"] == {"recomputed": 1}
        assert h.counts["pull_outcomes"] == {"dead": 1}
        assert b.pool.num_active_blocks == 0
    finally:
        for e in (a, b, ref):
            await e.close()


# ------------------------------------------------------------- restore

async def test_pull_timeout_respects_deadline(monkeypatch):
    """One pull's budget is min(cap, remaining / 2): a slow pull never eats
    the whole deadline and then recomputes anyway."""
    seen = {}

    async def fake_pull(client, iid, hashes, timeout_s, reason="restore"):
        seen["timeout"] = timeout_s
        return []

    monkeypatch.setattr(H, "pull_restore_blocks", fake_pull)
    eng = make_engine()
    try:
        h = DecodeWorkerHandler(eng, pull_clients=[FakePullClient({2: None})],
                                restore_config=RestoreConfig(
                                    pull_timeout_cap_s=5.0))
        h.instance_id = 1
        r = req(list(range(8 * BS)), 4)
        r.restore = {"emitted": 2, "sources": [[2, 6, 1.0]],
                     "block_size": BS}
        ctx = Context()
        ctx.set_timeout_ms(4000)
        info = await h._restore_migrated(r, ctx)
        assert info["pulls"] == 1 and info["stale_adverts"] == 1
        assert seen["timeout"] <= min(5.0, 2.0) + 1e-6
        seen.clear()
        ctx2 = Context()
        ctx2.set_timeout_ms(30)  # thin budget: no pull at all
        info = await h._restore_migrated(r, ctx2)
        assert info["reason"] == "deadline" and not seen
        assert restore_pull_timeout(5.0, None) == 5.0
        assert restore_pull_timeout(5.0, 0.01) is None
    finally:
        await eng.close()


async def test_slow_pull_times_out_and_cancels_the_stream():
    a, pull = await _peer()
    b = make_engine()
    try:
        client = FakePullClient({2: pull}, delay=2.0)
        h = DecodeWorkerHandler(b, pull_clients=[client],
                                restore_config=RestoreConfig(
                                    pull_timeout_cap_s=0.2))
        h.instance_id = 1
        r = req(PREFIX + [200, 5], 2)
        r.restore = {"sources": [[2, 12, 1.0]], "block_size": BS}
        t0 = time.monotonic()
        info = await asyncio.wait_for(h._restore_migrated(r, Context()),
                                      WAIT_S)
        assert time.monotonic() - t0 < 1.5
        assert info["outcome"] == "recomputed"
        assert h.counts["pull_outcomes"] == {"slow": 1}
    finally:
        await a.close()
        await b.close()


async def test_restore_budget_bounded_wait_then_recompute():
    eng = make_engine()
    try:
        h = DecodeWorkerHandler(eng, restore_config=RestoreConfig(
            max_concurrent=1, pull_timeout_cap_s=0.2))
        h.instance_id = 1
        await h._restore_slots.acquire()  # saturate the budget
        r = req(list(range(8 * BS)), 4)
        r.restore = {"emitted": 2, "sources": [[2, 6, 1.0]],
                     "block_size": BS}
        t0 = time.monotonic()
        info = await h._restore_migrated(r, Context())
        waited = time.monotonic() - t0
        assert info["outcome"] == "recomputed" and info["reason"] == "budget"
        assert 0.15 <= waited < 1.5
    finally:
        await eng.close()


@pytest.mark.parametrize("seed,temp", [(None, 0.0), (17, 0.9)])
async def test_restore_from_torch_peer_bit_identical(seed, temp):
    """A stream broken after k tokens resumes on another worker from a
    restore plan naming the torch peer that served it: the prefix is
    pulled (not recomputed) and the rest of the stream is the unbroken
    one's, greedy and seeded."""
    n, k = 10, 4
    a = make_engine()
    b = make_engine()
    try:
        prompt = PREFIX + [230]
        unbroken = await drain(a, req(prompt, n, seed, temp))
        pull = KvPullHandler(a)
        h = DecodeWorkerHandler(b, pull_clients=[FakePullClient({2: pull})])
        h.instance_id = 1
        migrated = req(prompt + unbroken[:k], n - k, seed, temp)
        full = (len(migrated.token_ids) - 1) // BS
        migrated.restore = {"emitted": k, "sources": [[2, full, 1.0]],
                            "block_size": BS}
        got = await through(h, migrated)
        assert got == unbroken[k:]
        assert h.counts["migration"] == {"restored": 1}
        assert h.counts["migration_blocks"]["restored"] == full
        assert pull.served == {"restore": full}
        assert a.pool.num_active_blocks == 0
        assert b.pool.num_active_blocks == 0
    finally:
        await a.close()
        await b.close()


async def test_restore_without_sources_recomputes():
    """No peer can be pulled from (the pre-pull behaviour of the port):
    the request is recomputed, with the stream a plain request gets."""
    eng, ref = make_engine(), make_engine()
    try:
        r = req(PREFIX + [7], 5)
        want = await drain(ref, req(PREFIX + [7], 5))
        r.restore = {"sources": [[7, 12, 1.0]]}
        h = DecodeWorkerHandler(eng)
        assert await through(h, r) == want
        assert h.counts["migration"] == {"recomputed": 1}
    finally:
        await eng.close()
        await ref.close()
