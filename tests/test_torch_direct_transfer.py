"""The port's direct device-to-device KV transfer (``dynamo_tpu_torch/
disagg/transfer.py``), held against the JAX package's
(``dynamo_tpu/disagg/transfer.py``, ``tests/test_disagg.py``'s direct
tests).

- Two torch engines of one process negotiate ``"proc"``: every KV frame is
  a KvDirectFrame (through the port's msgpack codec), offers equal pulls,
  and the greedy stream is the JAX aggregated engine's; int8 pools ship
  the packed bundle bit for bit. A decode side with the direct transfer
  off gets host-staged frames; a failing pull recomputes locally, releases
  the blocks on both sides and is counted; unclaimed offers expire.
- JAX and torch engines in one process stay host-staged in both
  directions, and ``choose_mode`` picks ``"ipc"`` only for the same host
  and the same card with both ends CUDA.
- The ``"ipc"`` bookkeeping, through a same-process stand-in for the CUDA
  IPC layer (the card's own runs in ``chip_smoke.py``): layer-group
  offers, retraction when a transfer cannot be placed, and no offer or
  mapping left once a request ended, a cancelled one included.

Every wait on a stream is bounded, so a fault fails the test instead of
hanging it.
"""

import asyncio
import socket

import msgpack
import numpy as np
import pytest
import torch

from dynamo_tpu.disagg import transfer as JT
from dynamo_tpu_torch.disagg import transfer as T
from dynamo_tpu_torch.disagg.handlers import (
    DecodeWorkerHandler, PrefillWorkerHandler,
)
from dynamo_tpu_torch.disagg.protocols import (
    DisaggConfig, KvChunkFrame, KvLayerFrame, dtype_name,
)
from dynamo_tpu_torch.disagg.transfer import (
    DirectTransferManager, KvDirectFrame,
)
from dynamo_tpu_torch.runtime.codec import packb, unpackb
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
from tests.test_torch_disagg import (
    PROMPT, WAIT_S, CodecPrefillClient, _settled, jax_alone, jax_reference,
    make_engine, req, through_handler,
)

pytestmark = pytest.mark.anyio

HOST = socket.gethostname()


def direct_engine(**kw):
    """A tiny CPU engine with the direct transfer on (its default)."""
    return make_engine(kv_transfer_direct=True, **kw)


class SpyClient:
    """Routes the decode handler's prefill calls to an in-process prefill
    handler; every frame crosses the port's msgpack codec, its kind
    recorded. ``cancel_after``: the request is cancelled when the
    prefill handler yields that many frames, the last of them lost in
    transit."""

    def __init__(self, ph, cancel_after=None):
        self.ph = ph
        self.frames = []
        self.cancel_after = cancel_after

    def available_ids(self):
        return [1]

    async def generate(self, request, ctx=None, mode="round_robin",
                       instance_id=None):
        async def stream():
            gen = self.ph.generate(request, ctx)
            try:
                async for frame in gen:
                    self.frames.append(
                        "direct" if KvDirectFrame.is_wire(frame) else
                        "chunk" if KvChunkFrame.is_wire(frame) else
                        "layer" if KvLayerFrame.is_wire(frame) else "final")
                    if (self.cancel_after is not None and len(self.frames)
                            >= self.cancel_after):
                        raise asyncio.CancelledError()  # lost in transit
                    yield unpackb(packb(frame))
            finally:
                await gen.aclose()
        return stream()


class StandInIpc:
    """A same-process stand-in for ``disagg.ipc.CudaIpc``: "exported"
    tensors are kept by handle and "opened" by reference. It counts the
    handles mapped, as the card's layer does."""

    platform = "cuda"
    _memory: dict = {}

    def __init__(self, uuid="GPU-standin"):
        self.uuid = uuid
        self.opened = {}

    @staticmethod
    def exportable():
        return True

    def device_uuid(self):
        return self.uuid

    @staticmethod
    def ready_event():
        return None

    def export(self, tensors, ready):
        arrays = []
        for t in tensors:
            h = np.random.default_rng().bytes(64)
            StandInIpc._memory[h] = t
            arrays.append({"shape": list(t.shape), "dtype": dtype_name(t),
                           "handle": h, "offset": 0})
        return {"arrays": arrays, "event": bytes(64), "device": self.uuid}

    def open(self, desc):
        out, held = [], []
        for a in desc["arrays"]:
            out.append(StandInIpc._memory[a["handle"]])
            self.opened[a["handle"]] = self.opened.get(a["handle"], 0) + 1
            held.append(a["handle"])
        return out, held

    def release(self, held):
        for h in held:
            self.opened[h] -= 1
            if not self.opened[h]:
                del self.opened[h]
                StandInIpc._memory.pop(h, None)

    @property
    def mapped(self):
        return len(self.opened)


def ipc_pair(**kw):
    """A prefill and a decode engine whose managers stand for two processes
    of one host on one card (the stand-in IPC layer)."""
    pre, dec = direct_engine(**kw), direct_engine(**kw)
    pre.direct_transfer.close()
    dec.direct_transfer.close()
    pre.direct_transfer = DirectTransferManager(
        ipc=StandInIpc(), token=f"{HOST}:1:prefill")
    pre.direct_transfer.grace_s = 0.05
    dec.direct_transfer = DirectTransferManager(ipc=StandInIpc())
    return pre, dec


async def _no_outstanding(*mgrs):
    for _ in range(100):
        if not any(m.outstanding() for m in mgrs):
            return True
        await asyncio.sleep(0.02)
    return False


# ------------------------------------------------------------ same process


@pytest.mark.parametrize("layer_groups", [4, 0])
async def test_same_process_pair_negotiates_proc(layer_groups):
    """Every KV frame is a descriptor (no page bytes), the response carries
    no bundle, offers equal pulls, nothing stays in the registry, and the
    greedy stream is the JAX aggregated engine's."""
    (want,) = await jax_alone([PROMPT])
    pre = direct_engine()
    dec = direct_engine(kv_transfer_layer_groups=layer_groups)
    free = (pre.pool.num_free_blocks, dec.pool.num_free_blocks)
    client = SpyClient(PrefillWorkerHandler(pre))
    dh = DecodeWorkerHandler(dec, client,
                             DisaggConfig(max_local_prefill_length=8))
    try:
        got, _lps, _r = await through_handler(dh, req())
        assert got == want
        kinds = client.frames
        assert kinds[-1] == "final" and kinds.count("final") == 1
        assert set(kinds[:-1]) == {"direct"} and len(kinds) >= 3
        n = len(kinds) - 1
        assert pre.direct_transfer.stats == {"offers": n, "pulls": 0,
                                             "pull_failures": 0}
        assert dec.direct_transfer.stats["pulls"] == n
        assert dec.direct_transfer.stats["pull_failures"] == 0
        assert pre.direct_transfer.outstanding() == 0
        assert not T._offers
        rep = dh.report()
        assert rep["transfer_paths"] == {"proc": 1}
        assert rep["transfers"][-1]["path"] == "proc"
        assert rep["remote_prefills"] == {"placed": 1}
        assert "fallbacks" not in rep
        (rec,) = pre.extract_records()
        assert rec["mode"] == "proc"
        assert rep["transfers"][-1]["digest"] == rec["digest"]
        kinds = [f[0] for f in rec["frames"]]
        assert "tail" not in kinds
        assert ("layer" in kinds) == bool(layer_groups)
        assert await _settled(dec, free[1])
        assert await _settled(pre, free[0])
    finally:
        await pre.close()
        await dec.close()


async def test_decode_direct_off_gets_host_staged_frames():
    """kv_transfer_direct off on the decode side: no capability, so the
    prefill engine ships host-staged chunk and layer frames."""
    (want,) = await jax_alone([PROMPT])
    pre, dec = direct_engine(), make_engine()
    assert dec.direct_capability() is None
    client = SpyClient(PrefillWorkerHandler(pre))
    dh = DecodeWorkerHandler(dec, client,
                             DisaggConfig(max_local_prefill_length=8))
    try:
        got, _lps, _r = await through_handler(dh, req())
        assert got == want
        assert "direct" not in client.frames
        assert client.frames.count("chunk") >= 2
        assert client.frames.count("layer") == 2
        assert pre.direct_transfer.stats["offers"] == 0
        assert dh.report()["transfers"][-1]["path"] == "host"
        assert pre.extract_records()[-1]["mode"] == "host"
    finally:
        await pre.close()
        await dec.close()


async def test_failing_pull_recomputes_locally():
    """A pull that fails: the stream is drained, the prompt recomputed
    locally (the same stream), the failure counted (metrics too), every
    block released on both sides and no offer left behind."""
    (want,) = await jax_alone([PROMPT])
    pre, dec = direct_engine(), direct_engine()
    free = (pre.pool.num_free_blocks, dec.pool.num_free_blocks)

    def boom(desc):
        raise RuntimeError("synthetic pull failure")

    dec.direct_transfer._pull = boom
    metrics = MetricsRegistry()
    client = SpyClient(PrefillWorkerHandler(pre))
    dh = DecodeWorkerHandler(dec, client,
                             DisaggConfig(max_local_prefill_length=8),
                             metrics=metrics)
    try:
        got, _lps, _r = await through_handler(dh, req())
        assert got == want
        rep = dh.report()
        assert rep["fallbacks"] == {"recompute_direct_pull": 1}
        assert rep["direct_pull_failures"] == {"pull": 1}
        assert dec.direct_transfer.stats["pull_failures"] == 1
        assert "dynamo_kv_direct_pull_failures_total 1" in metrics.render()
        assert await _settled(dec, free[1])
        assert await _settled(pre, free[0])
        assert pre.direct_transfer.outstanding() == 0
    finally:
        await pre.close()
        await dec.close()


async def test_direct_transfer_int8_kv_bit_exact():
    """int8 pools on both ends: the packed uint8 bundle moves by reference,
    the placed blocks' digest equals the prefill engine's, and the stream
    is the JAX aggregated int8 engine's."""
    want, _ = await jax_reference(kv_cache_dtype="int8")
    pre = direct_engine(kv_cache_dtype="int8")
    dec = direct_engine(kv_cache_dtype="int8")
    client = SpyClient(PrefillWorkerHandler(pre))
    dh = DecodeWorkerHandler(dec, client,
                             DisaggConfig(max_local_prefill_length=8))
    try:
        got, _lps, _r = await through_handler(dh, req())
        assert got == want
        assert set(client.frames[:-1]) == {"direct"}
        assert dec.direct_transfer.stats["pulls"] >= 2
        (rec,) = pre.extract_records()
        assert dh.report()["transfers"][-1]["digest"] == rec["digest"]
    finally:
        await pre.close()
        await dec.close()


def test_offer_ttl_eviction():
    """Unclaimed offers do not pin their tensors: a "proc" offer is swept
    after the TTL (and a retract drops one at once); an "ipc" offer is
    revoked past its TTL, a pull of it fails, and it is freed after the
    grace."""
    mgr = DirectTransferManager(ttl_s=0.01)
    meta = {"num_tokens": 4, "n": 1, "block_size": 4, "start_block": 0}
    desc = mgr.offer("proc", [torch.zeros(2, 2)], meta)
    assert desc["uuid"] in T._offers and mgr.outstanding() == 1
    asyncio.run(asyncio.sleep(0.02))
    mgr.offer("proc", [torch.zeros(2, 2)], meta)  # the sweep rides it
    assert desc["uuid"] not in T._offers
    d2 = mgr.offer("proc", [torch.zeros(2, 2)], meta)
    mgr.retract(d2)
    assert d2["uuid"] not in T._offers
    with pytest.raises(RuntimeError):
        mgr.pull(d2)
    assert mgr.stats["pull_failures"] == 1
    mgr.close()
    assert not T._offers

    pre = DirectTransferManager(ttl_s=0.01, ipc=StandInIpc(),
                                token=f"{HOST}:1:prefill")
    pre.grace_s = 0.05
    dec = DirectTransferManager(ipc=StandInIpc())
    try:
        d = pre.offer("ipc", [torch.ones(3), torch.ones(3)], meta)
        assert pre.outstanding() == 1 and pre.held_bytes() == 24
        asyncio.run(asyncio.sleep(0.02))
        assert pre.outstanding() == 1  # revoked, inside the grace
        with pytest.raises(RuntimeError, match="not on offer"):
            dec.pull(d)
        asyncio.run(asyncio.sleep(0.06))
        assert pre.outstanding() == 0 and pre.held_bytes() == 0
    finally:
        pre.close()
        dec.close()


# ------------------------------------------------------- negotiation, wire


def _cap(token, platform, uuid=None):
    return f"kv_direct:{token}{'@' + uuid if uuid else ''}/{platform}"


@pytest.mark.parametrize("cap,want", [
    ("self", "proc"),
    (_cap(f"{HOST}:2:peer", "cuda", "GPU-standin"), "ipc"),
    (_cap(f"{HOST}:2:peer", "cuda", "GPU-other"), None),
    (_cap("otherhost:2:peer", "cuda", "GPU-standin"), None),
    (_cap(f"{HOST}:2:peer", "cuda"), None),
    (_cap(f"{HOST}:2:peer", "cpu"), None),
    (_cap(f"{HOST}:2:peer", "tpu"), None),
    (_cap(f"{HOST}:2:peer", "gpu"), None),
    ("jax", None),
    (None, None),
])
def test_choose_mode_table(cap, want):
    """Same process: "proc"; the same host and card, both CUDA: "ipc";
    another host or card, a peer without a card's identity, a JAX peer
    (cpu, tpu, gpu; its process token is another), none: host-staged."""
    mgr = DirectTransferManager(ipc=StandInIpc())
    if cap == "self":
        cap = mgr.capability()
    elif cap == "jax":
        cap = JT.DirectTransferManager().capability()
    try:
        assert mgr.choose_mode([cap] if cap else []) == want
        # the JAX side never picks a direct path for the port's capability
        assert JT.DirectTransferManager().choose_mode(
            [mgr.capability()]) is None
    finally:
        mgr.close()


def test_direct_disabled_and_cpu_capabilities():
    """A CPU manager advertises its process and platform "cpu": another
    process gets host-staged bundles; a decode engine with the transfer
    off advertises nothing; the port's token is not the JAX module's."""
    mgr = DirectTransferManager()
    assert mgr.capability() == f"kv_direct:{T.proc_token()}/cpu"
    assert mgr.choose_mode([mgr.capability()]) == "proc"
    assert mgr.choose_mode([_cap(f"{HOST}:2:peer", "cpu")]) is None
    assert T.proc_token() != JT.proc_token()
    mgr.close()


def test_descriptors_survive_the_codec_and_match_jax():
    """A "proc" descriptor has the JAX one's keys in its order; "proc" and
    "ipc" descriptors (handles as bytes) come back from the port's
    msgpack equal, and the frame encodes as the ``msgpack`` package
    encodes it."""
    meta = {"num_tokens": 8, "n": 2, "block_size": 4, "start_block": 0,
            "start_layer": 1, "total_layers": 2}
    k = torch.zeros(1, 2, 4, 2, 16, dtype=torch.bfloat16)
    mgr = DirectTransferManager()
    ipc = DirectTransferManager(ipc=StandInIpc(), token=f"{HOST}:1:prefill")
    jmgr = JT.DirectTransferManager()
    try:
        d = mgr.offer("proc", [k, k], dict(meta))
        jd = jmgr.offer("proc", [np.zeros((1, 2, 4, 2, 16), np.float32)] * 2,
                        dict(meta))
        assert list(d) == list(jd)
        assert d["arrays"][0] == {"shape": [1, 2, 4, 2, 16],
                                  "dtype": "bfloat16"}
        di = ipc.offer("ipc", [k, k], dict(meta))
        for desc in (d, di):
            wire = KvDirectFrame(desc).to_wire()
            assert packb(wire) == msgpack.packb(wire, use_bin_type=True)
            back = unpackb(packb(wire))
            assert KvDirectFrame.is_wire(back)
            assert KvDirectFrame.from_wire(back).desc == desc
        assert isinstance(di["arrays"][0]["handle"], bytes)
        assert di["uuid"] < 2 ** 64 and d["uuid"] < 2 ** 64
    finally:
        mgr.close()
        ipc.close()
        JT._offers.clear()


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
async def test_jax_torch_pairs_stay_host_staged(direction):
    """A JAX prefill engine and a torch decode engine, and the reverse, in
    one process and both with the direct transfer on: neither offers the
    other a direct pull, every KV frame carries its bytes, and the stream
    is the JAX aggregated engine's."""
    from dynamo_tpu.disagg.handlers import DecodeWorkerHandler as JaxDecode
    from dynamo_tpu.disagg.handlers import PrefillWorkerHandler as JaxPrefill
    from dynamo_tpu.disagg.protocols import DisaggConfig as JaxDisaggConfig
    from dynamo_tpu.engine.config import EngineArgs as JaxEngineArgs
    from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
    from dynamo_tpu.engine.engine import AsyncJaxEngine
    from tests.test_torch_disagg import SETTINGS, _jparams

    (want,) = await jax_alone([PROMPT])
    jeng = AsyncJaxEngine(
        JaxModelConfig.tiny(), JaxEngineArgs(
            prefill_buckets=(8, 16, 32, 64),
            decode_batch_buckets=(1, 2, 4, 8), **SETTINGS),
        params=_jparams())
    assert jeng.direct_transfer is not None
    teng = direct_engine()
    if direction == "jax_to_torch":
        pre, dec = jeng, teng
        client = CodecPrefillClient(JaxPrefill(pre))
        dh = DecodeWorkerHandler(dec, client,
                                 DisaggConfig(max_local_prefill_length=8))
    else:
        pre, dec = teng, jeng
        client = CodecPrefillClient(PrefillWorkerHandler(pre))
        dh = JaxDecode(dec, client,
                       JaxDisaggConfig(max_local_prefill_length=8))
    try:
        got, _lps, _r = await through_handler(dh, req())
        assert got == want
        assert client.frames.count("chunk") >= 2
        assert client.frames.count("final") == 1
        assert pre.direct_transfer.stats["offers"] == 0
        assert dec.direct_transfer.stats["pulls"] == 0
        if direction == "jax_to_torch":
            assert dh.report()["transfers"][-1]["path"] == "host"
        else:
            assert teng.extract_records()[-1]["mode"] == "host"
    finally:
        await pre.close()
        await dec.close()


# ------------------------------------------------------------ "ipc" offers


@pytest.mark.parametrize("layer_groups", [4, 0])
async def test_ipc_offers_pulled_and_released(layer_groups):
    """Two managers standing for two processes on one card negotiate
    "ipc": chunk offers, then one offer a layer group of the tail (or
    chunk offers to the end); every offer pulled, released and freed, no
    handle left mapped, and the stream is the JAX aggregated engine's."""
    (want,) = await jax_alone([PROMPT])
    pre, dec = ipc_pair(kv_transfer_layer_groups=layer_groups)
    client = SpyClient(PrefillWorkerHandler(pre))
    dh = DecodeWorkerHandler(dec, client,
                             DisaggConfig(max_local_prefill_length=8))
    try:
        got, _lps, _r = await through_handler(dh, req())
        await dh.drain_releases()
        assert got == want
        n = client.frames.count("direct")
        assert n == len(client.frames) - 1
        assert pre.direct_transfer.stats["offers"] == n
        assert dec.direct_transfer.stats["pulls"] == n
        (rec,) = pre.extract_records()
        assert rec["mode"] == "ipc"
        kinds = [f[0] for f in rec["frames"]]
        if layer_groups:
            assert kinds[-2:] == ["layer", "layer"]  # the tiny model's L
        else:
            assert set(kinds) == {"chunk"}
        tr = dh.report()["transfers"][-1]
        assert tr["path"] == "ipc" and tr["digest"] == rec["digest"]
        assert [f[0] for f in tr["frames"]] == kinds
        assert dh.report()["transfer_paths"] == {"ipc": 1}
        assert await _no_outstanding(pre.direct_transfer)
        assert dec.direct_transfer.ipc.mapped == 0
    finally:
        await pre.close()
        await dec.close()


async def test_ipc_offers_retracted_when_not_placed():
    """The decode side cannot place the transfer (no blocks): every offer
    after that is retracted unread, the one pulled is released, the
    prompt is recomputed locally, and the producer frees them all."""
    (want,) = await jax_alone([PROMPT])
    pre, dec = ipc_pair()
    dec.alloc_inject = lambda n: None
    client = SpyClient(PrefillWorkerHandler(pre))
    dh = DecodeWorkerHandler(dec, client,
                             DisaggConfig(max_local_prefill_length=8))
    try:
        got, _lps, _r = await through_handler(dh, req())
        await dh.drain_releases()
        assert got == want
        assert dh.report()["fallbacks"] == {"recompute_no_blocks": 1}
        assert dec.direct_transfer.stats["pulls"] == 1  # the first frame
        assert client.frames.count("direct") >= 3
        assert await _no_outstanding(pre.direct_transfer)
        assert dec.direct_transfer.ipc.mapped == 0
    finally:
        await pre.close()
        await dec.close()


@pytest.mark.parametrize("cancel_after", [1, 3])
async def test_ipc_cancelled_request_leaves_no_offer(cancel_after):
    """A request cancelled mid-stream, a descriptor lost in transit: the
    decode side releases what it pulled, the prefill side revokes the
    offer nobody claimed, and once the grace passed no offer, block or
    mapping is left on either."""
    pre, dec = ipc_pair()
    free = (pre.pool.num_free_blocks, dec.pool.num_free_blocks)
    client = SpyClient(PrefillWorkerHandler(pre), cancel_after=cancel_after)
    dh = DecodeWorkerHandler(dec, client,
                             DisaggConfig(max_local_prefill_length=8))
    try:
        with pytest.raises(asyncio.CancelledError):
            await asyncio.wait_for(dh._generate_disagg(req(), None)
                                   .__anext__(), WAIT_S)
        await dh.drain_releases()
        assert pre.direct_transfer.stats["offers"] >= cancel_after
        assert await _no_outstanding(pre.direct_transfer)
        assert dec.direct_transfer.ipc.mapped == 0
        assert await _settled(dec, free[1])
        assert await _settled(pre, free[0])
    finally:
        await pre.close()
        await dec.close()
