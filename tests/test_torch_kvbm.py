"""The KVBM host and disk tiers of the torch port against the JAX package on
the CPU: ``tests/test_kvbm.py``'s cases re-run on ``dynamo_tpu_torch.kvbm``
and ``AsyncTorchEngine`` (the JAX engine's tiny weights carried across by
``params_from_jax``).

- The tiers' LRU, budgets and the disk round trip answer as the JAX tiers
  do; the disk files are the JAX package's (bf16 and packed int8 blocks
  included), and each package reads the other's.
- The manager's cascade to disk and promotion back to the host tier.
- Offload → clear → onboarding, and the disk cascade, give the JAX
  engine's streams; the KV events with a host tier on are the JAX
  engine's, event for event.
- ``export_blocks`` and ``resident_prefix_blocks`` serve a prefix that
  lives only in the host or the disk tier.
"""

import asyncio
import os
import shutil

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import model as M
from dynamo_tpu.engine.config import EngineArgs as JaxEngineArgs
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import AsyncJaxEngine
from dynamo_tpu.kvbm import DiskTier as JaxDiskTier
from dynamo_tpu.kvbm import HostTier as JaxHostTier
from dynamo_tpu.kvbm import KvbmManager as JaxKvbmManager
from dynamo_tpu.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols import StopConditions as JaxStop
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.engine.weights import params_from_jax
from dynamo_tpu_torch.kvbm import DiskTier, HostTier, KvbmManager
from dynamo_tpu_torch.protocols import PreprocessedRequest, StopConditions

pytestmark = pytest.mark.anyio

PROMPT = list(range(1, 30))
SETTINGS = dict(block_size=4, num_blocks=64, max_num_seqs=8,
                max_num_batched_tokens=64, max_model_len=256,
                decode_batch_buckets=(1, 2, 4, 8))

_PARAMS: dict = {}


def _params():
    if not _PARAMS:
        jp = M.init_params(JaxModelConfig.tiny(), jax.random.key(0))
        _PARAMS["jax"] = jp
        _PARAMS["torch"] = params_from_jax(jax.tree.map(np.asarray, jp),
                                           "cpu")
    return _PARAMS["jax"], _PARAMS["torch"]


def port_engine(events=None, **kw) -> AsyncTorchEngine:
    return AsyncTorchEngine(ModelConfig.tiny(),
                            EngineArgs(**{**SETTINGS, **kw}),
                            params=_params()[1], device="cpu",
                            event_cb=events.append if events is not None
                            else None)


def jax_engine(events=None, **kw) -> AsyncJaxEngine:
    return AsyncJaxEngine(JaxModelConfig.tiny(),
                          JaxEngineArgs(prefill_buckets=(8, 16, 32, 64),
                                        **{**SETTINGS, **kw}),
                          params=_params()[0],
                          event_cb=events.append if events is not None
                          else None)


async def collect(eng, tokens, max_tokens=8):
    cls = (JaxRequest, JaxStop) if isinstance(eng, AsyncJaxEngine) else (
        PreprocessedRequest, StopConditions)
    req = cls[0](model="tiny", token_ids=list(tokens),
                 stop_conditions=cls[1](max_tokens=max_tokens,
                                        ignore_eos=True))
    toks = []
    async for out in eng.generate(req):
        toks.extend(out.token_ids)
    return toks


async def until(cond, tries=200):
    for _ in range(tries):
        if cond():
            return True
        await asyncio.sleep(0.02)
    return cond()


def _blk_bytes() -> int:
    """One tiny block's k + v bytes (f32)."""
    cfg = ModelConfig.tiny()
    return 2 * cfg.num_layers * 4 * cfg.num_kv_heads * cfg.head_dim * 4


# ------------------------------------------------------------------ tiers


def page(i, nbytes=256):
    return np.full((nbytes // 4,), i, np.float32)


def _host_answers(host_cls, make):
    t = host_cls(capacity_bytes=4 * 512)
    out = [t.put(i, make(i), make(i)) == [] for i in range(4)]
    out.append(len(t))
    t.get(0)
    ev = t.put(9, make(9), make(9))
    out += [[e[0] for e in ev], 0 in t, 9 in t, 1 in t, t.used]
    out.append([e[0] for e in t.evict_to_capacity(512)])
    return out


def test_host_tier_lru_and_budget():
    got = _host_answers(HostTier, lambda i: torch.from_numpy(page(i)))
    assert got == _host_answers(JaxHostTier, page)
    assert got[5] == [1] and got[-1] == [2, 3, 0]


def _disk_answers(disk_cls, make, d):
    t = disk_cls(str(d), capacity_bytes=3 * 512)
    for i in range(5):
        t.put(i, make(i), make(i))
    out = [len(t), 0 in t, 1 in t, t.used, sorted(os.listdir(d))]
    k, v = t.get(4)
    out.append(np.asarray(k).tolist())
    t.clear()
    out.append(os.listdir(d))
    return out


def test_disk_tier_roundtrip(tmp_path):
    got = _disk_answers(DiskTier, lambda i: torch.from_numpy(page(i)),
                        tmp_path / "port")
    want = _disk_answers(JaxDiskTier, page, tmp_path / "jax")
    assert got == want
    assert got[0] == 3 and got[-1] == []


@pytest.mark.parametrize("kind", ["bfloat16", "packed_int8", "float32"])
def test_disk_files_are_the_jax_format(tmp_path, kind):
    """A bf16, packed int8 or f32 block written by either package's disk
    tier holds the same arrays, and each package reads the other's file
    back bit for bit. A stale file is swept at start."""
    rng = np.random.default_rng(3)
    if kind == "packed_int8":  # an MLA-like asymmetric pair of rows
        k = rng.integers(0, 256, (2, 4 * 1 * 36), dtype=np.uint8)
        v = rng.integers(0, 256, (2, 4 * 1 * 20), dtype=np.uint8)
    else:
        dt = ml_dtypes.bfloat16 if kind == "bfloat16" else np.float32
        k = rng.standard_normal((2, 4, 2, 16)).astype(dt)
        v = rng.standard_normal((2, 4, 2, 16)).astype(dt)

    def to_torch(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())

    pd, jd = tmp_path / "port", tmp_path / "jax"
    jd.mkdir()
    (jd / "00000000000000ff.npz").write_bytes(b"stale")
    port, jaxt = DiskTier(str(pd), 1 << 20), JaxDiskTier(str(jd), 1 << 20)
    assert os.listdir(jd) == []
    h = 0x1234_5678_9ABC_DEF0
    port.put(h, to_torch(k), to_torch(v))
    jaxt.put(h, k, v)
    name = f"{h:016x}.npz"
    with np.load(pd / name) as a, np.load(jd / name) as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            assert a[f].dtype == b[f].dtype, f
            np.testing.assert_array_equal(a[f], b[f])
    # swap the two files: each package reads the other's
    shutil.copy(jd / name, tmp_path / "x")
    shutil.copy(pd / name, jd / name)
    shutil.copy(tmp_path / "x", pd / name)
    pk, pv = port.get(h)
    jk, jv = jaxt.get(h)
    for t, a in ((pk, k), (pv, v), (jk, k), (jv, v)):
        got = np.asarray(t.view(torch.int16) if isinstance(t, torch.Tensor)
                         and t.dtype == torch.bfloat16 else t)
        want = a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.view(want.dtype), want)
    assert pk.dtype == to_torch(k).dtype


def _manager_answers(mgr_cls, make, d):
    m = mgr_cls(host_bytes=2 * 512, disk_dir=str(d), disk_bytes=16 * 512)
    changes = []
    m.on_change = lambda s, r: changes.append((list(s), r))
    for i in range(5):
        m.put(i, make(i), make(i))
    out = [len(m.host), len(m.disk), m.match_prefix([0, 1, 2, 3, 4]),
           m.in_host(0), m.in_disk(0), m.in_lower_tier(0),
           m.filter_not_local([0, 4, 7])]
    k, _ = m.get(0)  # a disk hit is promoted to the host tier
    out += [np.asarray(k).tolist(), 0 in m.host, sorted(m.host_resident(
        range(5))), m.get_local(1) is not None, 1 in m.host]
    m.make_host_room(512)
    out += [len(m.host), m.stats()["host_bytes"]]
    m.resize_host(0)
    out += [len(m.host), len(m.disk)]
    m.clear()
    out += [len(m.disk), m.stats(), changes]
    return out


def test_manager_cascade_and_promote(tmp_path):
    got = _manager_answers(KvbmManager, lambda i: torch.from_numpy(page(i)),
                           tmp_path / "port")
    want = _manager_answers(JaxKvbmManager, page, tmp_path / "jax")
    assert got == want
    assert got[:3] == [2, 3, 5]


# ---------------------------------------------------------------- engines


async def _offload_clear_onboard(eng):
    first = await collect(eng, PROMPT)
    assert await until(
        lambda: eng.kvbm.offloaded_blocks >= len(PROMPT) // 4)
    eng.pool.clear()  # the device prefix cache goes, the tiers stay
    second = await collect(eng, PROMPT)
    return first, second


async def test_offload_clear_onboard_matches_jax():
    """A prompt served, the device prefix cache cleared, the prompt served
    again: it onboards from the host tier, and both streams equal the JAX
    engine's doing the same."""
    eng = port_engine(kvbm_host_bytes=64 << 20)
    jeng = jax_engine(kvbm_host_bytes=64 << 20)
    got = await _offload_clear_onboard(eng)
    want = await _offload_clear_onboard(jeng)
    assert got[0] == got[1] == want[0] == want[1]
    assert eng.kvbm.onboarded_blocks == (len(PROMPT) - 1) // 4
    assert eng.kvbm.onboarded_blocks == jeng.kvbm.onboarded_blocks
    assert eng.scheduler.prefix_hit_tokens > 0
    assert set(eng.kvbm.stats()) == set(jeng.kvbm.stats())
    assert set(eng.kv_tier_occupancy()) == set(jeng.kv_tier_occupancy())
    assert eng.kv_tier_occupancy()["g2"]["blocks"] == len(eng.kvbm.host)
    await eng.close()
    await jeng.close()


async def _disk_cascade(eng):
    first = await collect(eng, PROMPT)
    assert await until(lambda: len(eng.kvbm.disk) > 0)
    eng.pool.clear()
    # disk-resident prefix: no file read in admission, a background
    # promotion and a recompute
    second = await collect(eng, PROMPT)
    assert await until(lambda: len(eng.kvbm.host) >= 2)
    eng.pool.clear()
    third = await collect(eng, PROMPT)
    return first, second, third


async def test_onboard_from_disk_after_host_pressure_matches_jax(tmp_path):
    """A host tier of two blocks: the prefix cascades to disk, is promoted
    back and onboarded, and every stream equals the JAX engine's."""
    kw = dict(kvbm_host_bytes=2 * _blk_bytes(), kvbm_disk_bytes=64 << 20)
    eng = port_engine(kvbm_disk_dir=str(tmp_path / "port"), **kw)
    jeng = jax_engine(kvbm_disk_dir=str(tmp_path / "jax"), **kw)
    got = await _disk_cascade(eng)
    want = await _disk_cascade(jeng)
    assert got == want
    assert len(set(map(tuple, got))) == 1
    assert eng.kvbm.onboarded_blocks > 0
    await eng.close()
    await jeng.close()


async def _events_workload(eng):
    """Prompt A; prompt B evicts A's blocks from a small pool (they live on
    in the host tier: no removed event); clear; A again, onboarded."""
    other = [200 - t for t in PROMPT]
    out = [await collect(eng, PROMPT)]
    assert await until(lambda: eng.kvbm.offloaded_blocks >= 7)
    out.append(await collect(eng, other))
    assert await until(lambda: eng.kvbm.offloaded_blocks >= 14)
    eng.pool.clear()
    out.append(await collect(eng, PROMPT))
    return out


async def test_kv_events_with_host_tier_match_jax():
    events, jevents = [], []
    kw = dict(kvbm_host_bytes=64 << 20, num_blocks=16)
    eng = port_engine(events, **kw)
    jeng = jax_engine(jevents, **kw)
    got = await _events_workload(eng)
    want = await _events_workload(jeng)
    await eng.close()
    await jeng.close()
    assert got == want
    assert [e.to_wire() for e in events] == [e.to_wire() for e in jevents]
    assert any(e.cleared for e in events)
    assert eng.kvbm.onboarded_blocks > 0


async def test_export_and_resident_from_host_and_disk(tmp_path):
    """After the device cache is cleared, a pull is served from the tiers.
    With every block in the host tier, all count as resident (admission
    onboards them); once the tier shrinks to three blocks the rest cascade
    to disk, which does not count. Either way every exported block equals
    the device copy exported before the clear."""
    eng = port_engine(kvbm_host_bytes=64 << 20,
                      kvbm_disk_dir=str(tmp_path), kvbm_disk_bytes=1 << 20)
    await collect(eng, PROMPT)
    probe = eng.restore_probe(PreprocessedRequest(model="tiny",
                                                  token_ids=PROMPT))
    hashes = probe.sequence_hashes()
    assert await until(
        lambda: eng.kvbm.offloaded_blocks >= len(hashes))
    before = [(h, k.clone(), v.clone())
              async for h, k, v in eng.export_blocks(hashes)]
    assert len(before) == len(hashes) == eng.resident_prefix_blocks(probe)
    eng.pool.clear()

    async def exported():
        after = [x async for x in eng.export_blocks(hashes)]
        assert [h for h, _, _ in after] == hashes
        for (h, k, v), (h2, k2, v2) in zip(before, after):
            assert h == h2 and torch.equal(k, k2) and torch.equal(v, v2)

    assert eng.resident_prefix_blocks(probe) == len(hashes)
    await exported()
    eng.kvbm.resize_host(3 * _blk_bytes())
    on_host = eng.kvbm.host_resident(hashes)
    assert len(on_host) < len(hashes) and len(eng.kvbm.disk) > 0
    lead = 0
    while lead < len(hashes) and hashes[lead] in on_host:
        lead += 1
    assert eng.resident_prefix_blocks(probe) == lead
    await exported()
    assert len([x async for x in eng.export_blocks(hashes, 2)]) == 2
    await eng.close()


async def test_swap_budget_shared_with_host_tier():
    """swap_host_bytes None with a host tier: swap reserves against the
    tier's budget, and the tier's puts evict down to what swap leaves."""
    eng = port_engine(kvbm_host_bytes=10 * _blk_bytes())
    assert eng._swap.budget == 10 * _blk_bytes()
    assert eng._swap.make_room == eng.kvbm.make_host_room
    assert eng._swap.reserve(4 * _blk_bytes())
    assert eng.kvbm.host._external() == 4 * _blk_bytes()
    own = port_engine(kvbm_host_bytes=10 * _blk_bytes(), swap_host_bytes=77)
    assert own._swap.budget == 77 and own._swap.external_used is None
    await eng.close()
    await own.close()
