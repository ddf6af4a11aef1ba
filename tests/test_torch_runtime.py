"""The port's distributed runtime against the JAX package's.

The torch worker joins the JAX package's fleet, so each module the port
copied must speak the same wire and keep the same semantics:

- the control plane: a hub of either package serves a client of either
  (KV, leases, watches, pub/sub, request/reply, work queues, durable
  streams, objects);
- endpoints and clients: token streams over the TCP response plane, typed
  terminal errors across the hop, cancellation upstream;
- the request context, the runtime config, the metrics registry and the
  task tracker;
- the model card's registration bytes and the KV-event and load-metric
  publishers' payloads, byte for byte.
"""

import asyncio
import dataclasses
import gc
import weakref

import msgpack
import pytest

from dynamo_tpu.llm import model_card as jcard
from dynamo_tpu.router import protocols as jproto
from dynamo_tpu.router import publisher as jpub
from dynamo_tpu.runtime import config as jconfig
from dynamo_tpu.runtime import context as jcontext
from dynamo_tpu.runtime import control_plane as jplane
from dynamo_tpu.runtime import metrics as jmetrics
from dynamo_tpu_torch.llm import model_card
from dynamo_tpu_torch.router import protocols
from dynamo_tpu_torch.router import publisher
from dynamo_tpu_torch.runtime import DistributedRuntime
from dynamo_tpu_torch.runtime import config, context, control_plane, metrics
from dynamo_tpu_torch.runtime.streams import batched
from dynamo_tpu_torch.runtime.tasks import OnErrorPolicy, TaskTracker

pytestmark = pytest.mark.anyio

PAIRS = {"jax-hub/port-client": (jplane, control_plane),
         "port-hub/jax-client": (control_plane, jplane),
         "port-hub/port-client": (control_plane, control_plane)}


async def _next(it, timeout=5.0):
    return await asyncio.wait_for(it.__anext__(), timeout)


@pytest.mark.parametrize("pair", sorted(PAIRS))
async def test_control_plane_interop(pair):
    server_mod, client_mod = PAIRS[pair]
    hub = server_mod.ControlPlaneServer()
    addr = await hub.start()
    a = await client_mod.RemoteControlPlane(addr).connect()
    b = await client_mod.RemoteControlPlane(addr).connect()
    try:
        # KV + watches
        watch = await b.watch_prefix("k/")
        events = watch.__aiter__()
        assert await a.kv_create("k/1", b"one")
        assert not await a.kv_create("k/1", b"again")
        await a.kv_put("k/2", b"\x00" * 300)
        assert await b.kv_get("k/1") == b"one"
        assert await b.kv_get_prefix("k/") == {"k/1": b"one",
                                               "k/2": b"\x00" * 300}
        assert (await _next(events)).key == "k/1"
        assert (await _next(events)).value == b"\x00" * 300
        assert await a.kv_delete("k/1") == 1
        ev = await _next(events)
        assert (ev.type, ev.key) == ("delete", "k/1")
        # leases: revocation deletes the keys put under them
        lease = await a.lease_create(5.0)
        assert lease > 2 ** 32 and await a.lease_keepalive(lease)
        await a.kv_put("k/leased", b"x", lease_id=lease)
        await a.lease_revoke(lease)
        assert await b.kv_get("k/leased") is None
        assert not await a.lease_keepalive(lease)
        # pub/sub
        sub = await b.subscribe("subj.>")
        msgs = sub.__aiter__()
        await a.publish("subj.x", b"payload")
        assert await _next(msgs) == ("subj.x", b"payload")
        # request/reply
        async def echo(payload: bytes) -> bytes:
            return payload[::-1]
        cancel = await b.serve("svc", echo)
        assert await a.request("svc", b"abc") == b"cba"
        await cancel()
        with pytest.raises(Exception):
            await a.request("svc", b"abc", timeout=2.0)
        # work queue
        await a.queue_push("q", b"job")
        assert await b.queue_depth("q") == 1
        assert await b.queue_pop("q", timeout=1.0) == b"job"
        # durable stream, resumed from a start offset
        for i in range(3):
            assert await a.stream_publish("s", bytes([i])) == i + 1
        stream = (await b.stream_subscribe("s", start_seq=1)).__aiter__()
        assert [await _next(stream) for _ in range(2)] == [(2, b"\x01"),
                                                           (3, b"\x02")]
        assert await b.stream_last_seq("s") == 3
        assert await b.stream_first_seq("s") == 1
        # object store
        await a.object_put("bucket", "name", b"blob")
        assert await b.object_get("bucket", "name") == b"blob"
    finally:
        await a.close()
        await b.close()
        await hub.stop()


async def test_service_handler_survives_garbage_collection():
    """A service handler suspended mid-request (as the worker's is while it
    opens the response stream) is not collected by a garbage-collector pass:
    its reply still reaches the requester. asyncio holds tasks weakly: an
    unreferenced handler task awaiting a future only it can reach is closed
    with GeneratorExit, and the request times out with no reply."""
    hub = control_plane.ControlPlaneServer()
    addr = await hub.start()
    worker = await control_plane.RemoteControlPlane(addr).connect()
    client = await control_plane.RemoteControlPlane(addr).connect()
    waiting = []

    async def handler(payload):
        fut = asyncio.get_running_loop().create_future()
        waiting.append(weakref.ref(fut))
        return await fut

    try:
        await worker.serve("svc", handler)
        reply = asyncio.ensure_future(client.request("svc", b"x", timeout=5))
        while not waiting:
            await asyncio.sleep(0.01)
        gc.collect()
        fut = waiting[0]()
        assert fut is not None, "the handler's task was collected"
        fut.set_result(b"done")
        assert await reply == b"done"
    finally:
        await client.close()
        await worker.close()
        await hub.stop()


async def test_endpoint_streams_errors_and_cancel_over_tcp():
    hub = control_plane.ControlPlaneServer()
    addr = await hub.start()
    worker = await DistributedRuntime.create(address=addr)
    caller = await DistributedRuntime.create(address=addr)
    seen = {}

    async def handler(request, ctx):
        if request.get("refuse"):
            raise context.InvalidRequestError("no such thing")
        for i in range(request["n"]):
            yield {"i": i, "ctx": ctx.id}
            await asyncio.sleep(0.01)
            if ctx.cancelled:
                seen["cancelled"] = True
                return

    try:
        ep = worker.namespace("ns").component("comp").endpoint("gen")
        handle = await ep.serve_endpoint(handler)
        client = await caller.namespace("ns").component("comp").endpoint(
            "gen").client().start()
        assert await client.wait_for_instances() == [handle.lease_id]
        ctx = context.Context()
        got = [f async for f in await client.generate({"n": 5}, ctx=ctx)]
        assert [f["i"] for f in got] == list(range(5))
        assert {f["ctx"] for f in got} == {ctx.id}
        # a typed terminal error keeps its class across the hop
        with pytest.raises(context.InvalidRequestError) as err:
            async for _ in await client.generate({"refuse": True}):
                pass
        assert err.value.code == "invalid_request"
        assert not err.value.retryable
        # cancellation travels upstream and stops the handler
        ctx = context.Context()
        stream = await client.generate({"n": 1000}, ctx=ctx)
        async for f in stream:
            if f["i"] == 3:
                ctx.cancel()
                break
        for _ in range(100):
            if seen.get("cancelled"):
                break
            await asyncio.sleep(0.02)
        assert seen.get("cancelled")
        # deregistration reaches the client's discovery watch
        await handle.stop()
        for _ in range(100):
            if not client.instance_ids():
                break
            await asyncio.sleep(0.02)
        assert client.instance_ids() == []
        await client.stop()
    finally:
        await caller.shutdown()
        await worker.shutdown()
        await hub.stop()


async def test_refused_frame_ends_the_stream_in_an_error(monkeypatch):
    """A response frame the codec refuses (over ``MAX_FRAME``) ends the
    stream in a StreamError at the caller: before, the server's reader
    died and the caller waited forever (a 2048-token chunk frame of
    Llama-3-8B's bf16 KV is over 256 MiB)."""
    from dynamo_tpu_torch.runtime import codec

    hub = control_plane.ControlPlaneServer()
    addr = await hub.start()
    worker = await DistributedRuntime.create(address=addr)
    caller = await DistributedRuntime.create(address=addr)

    async def handler(request, ctx):
        yield {"small": b"x"}
        yield {"large": b"x" * 4096}

    monkeypatch.setattr(codec, "MAX_FRAME", 1024)
    try:
        ep = worker.namespace("ns").component("comp").endpoint("gen")
        await ep.serve_endpoint(handler)
        client = await caller.namespace("ns").component("comp").endpoint(
            "gen").client().start()
        await client.wait_for_instances()
        got = []

        async def consume():
            async for f in await client.generate({}):
                got.append(f)

        with pytest.raises(context.StreamError):
            await asyncio.wait_for(consume(), 10)
        assert got == [{"small": b"x"}]
        await client.stop()
    finally:
        await caller.shutdown()
        await worker.shutdown()
        await hub.stop()


async def test_runtime_refuses_the_system_status_server(monkeypatch):
    monkeypatch.setenv("DYN_SYSTEM_PORT", "9090")
    with pytest.raises(NotImplementedError, match="A12"):
        await DistributedRuntime.create()


def test_context_wire_matches_jax():
    for kw in ({}, {"tenant": "acme", "priority": "interactive"},
               {"priority": "bogus"}):
        for timeout_ms in (None, 1500):
            jc = jcontext.Context(id="ab" * 16, annotations={"a": 1}, **kw)
            pc = context.Context(id="ab" * 16, annotations={"a": 1}, **kw)
            if timeout_ms is not None:
                jc.set_timeout_ms(timeout_ms)
                pc.set_timeout_ms(timeout_ms)
            jw, pw = jc.to_wire(), pc.to_wire()
            # traceparents carry a fresh random span id per hop
            assert {**jw, "traceparent": None} == {**pw, "traceparent": None}
            assert abs(jw.get("deadline_ms", 0) - pw.get("deadline_ms", 0)) \
                <= 5
            jr, pr = jcontext.Context.from_wire(pw), context.Context.from_wire(jw)
            assert (jr.id, jr.tenant, jr.priority) == (pr.id, pr.tenant,
                                                       pr.priority)
            assert (jr.deadline is None) == (pr.deadline is None)
    for code, cls in (("overloaded", context.OverloadedError),
                      ("deadline", context.DeadlineExceededError),
                      ("invalid_request", context.InvalidRequestError)):
        e = context.stream_error_from_wire("m", code, True)
        assert type(e) is cls and not e.retryable
        je = jcontext.stream_error_from_wire("m", code, True)
        assert (e.code, e.retryable) == (je.code, je.retryable)
    assert context.stream_error_from_wire("m", None, True).retryable


def test_runtime_config_matches_jax():
    env = {"DYN_CONTROL_PLANE": "h:1,h:2", "DYN_LEASE_TTL": "3.5",
           "DYN_NAMESPACE": "prod", "DYN_WORKER_MAX_INFLIGHT": "8",
           "DYN_BUSY_THRESHOLD": "0.9", "DYN_DRAIN_TIMEOUT": "7"}
    got = dataclasses.asdict(config.RuntimeConfig.load(env=env))
    want = dataclasses.asdict(jconfig.RuntimeConfig.load(env=env))
    assert got == want
    for bad in ({"DYN_LEASE_TTL": "0"}, {"DYN_MAX_INFLIGHT": "x"}):
        with pytest.raises(config.ConfigError):
            config.RuntimeConfig.load(env=bad)


def test_metrics_render_matches_jax():
    def fill(reg):
        reg.counter("requests_total", "requests").inc(route="a", model='m"1')
        reg.counter("requests_total").inc(2, route="b", model="m")
        reg.gauge("slots", "slots").set(4)
        reg.gauge("blocks").add_callback(lambda: {(("tier", "g1"),): 7})
        h = reg.histogram("lat_seconds", "latency")
        for v in (0.002, 0.03, 2.0, 100.0):
            h.observe(v, phase="x")
        return "\n".join(l for l in reg.render().splitlines()
                         if "uptime" not in l)

    assert fill(metrics.MetricsRegistry()) == fill(jmetrics.MetricsRegistry())


async def test_task_tracker_policies_and_join():
    shut = asyncio.Event()
    root = TaskTracker("root", on_shutdown=shut.set)
    child = root.child("c", max_concurrency=1)
    order = []

    async def work(i):
        order.append(i)
        await asyncio.sleep(0.01)

    for i in range(3):
        child.spawn(work(i))

    async def fail():
        raise RuntimeError("boom")

    root.spawn(fail(), on_error=OnErrorPolicy.SHUTDOWN)
    await asyncio.wait_for(shut.wait(), 2)
    await root.join(graceful_timeout=2)
    assert order == [0, 1, 2] and root.errors == 1 and root.inflight == 0
    with pytest.raises(RuntimeError, match="closed"):
        child.spawn(work(9))


async def test_batched_coalesces_and_relays_errors():
    async def gen():
        for i in range(5):
            yield i
        raise ValueError("late")

    got = []
    with pytest.raises(ValueError, match="late"):
        async for items in batched(gen(), maxsize=2):
            got.extend(items)
    assert got == list(range(5))


class _Rt:
    """The slice of a runtime ``register_llm`` touches."""

    def __init__(self, plane):
        self.plane = plane

    async def primary_lease(self):
        return 0x1A2B3C

    def record_registration(self, key, value):
        pass


class _Ep:
    def __init__(self):
        self.name = "generate"
        self.component = type("C", (), {"name": "backend", "namespace": type(
            "N", (), {"name": "dynamo"})()})()


async def test_register_llm_bytes_match_jax():
    planes = []
    for mod, plane_mod in ((model_card, control_plane), (jcard, jplane)):
        plane = plane_mod.LocalControlPlane()
        plane._next_lease = 0x1A2B3B  # the same lease id on both planes
        assert await plane.lease_create() == 0x1A2B3C
        card = mod.ModelDeploymentCard(
            display_name="Llama 3/8B", kv_cache_block_size=16,
            eos_token_ids=[128001, 128009], tokenizer_ref="/ckpt")
        card.runtime_config.total_kv_blocks = 31337
        card.runtime_config.max_num_seqs = 8
        await mod.register_llm(_Rt(plane), _Ep(), card)
        planes.append(await plane.kv_get_prefix("models/"))
        await plane.close()
    assert planes[0] == planes[1]
    assert sorted(planes[0]) == ["models/llama-3-8b/1a2b3c/chat",
                                 "models/llama-3-8b/1a2b3c/completions"]


async def test_publishers_bytes_match_jax():
    streams = []
    for pub_mod, proto, plane_mod in ((publisher, protocols, control_plane),
                                      (jpub, jproto, jplane)):
        plane = plane_mod.LocalControlPlane()
        kv = pub_mod.KvEventPublisher(plane, worker_id=2 ** 60 + 1,
                                      kv_block_size=16)
        await kv.start_resync_responder()
        blocks = [proto.StoredBlock(2 ** 64 - 1 - i, 7 * i) for i in range(3)]
        await kv.publish_stored(None, blocks[:2])
        await kv.publish_stored(blocks[1].block_hash, blocks[2:])
        await kv.publish_removed([blocks[2].block_hash])
        kv.publish_sync(proto.KvCacheEvent.stored(99, None, [
            proto.StoredBlock(5, 6)]))
        await asyncio.sleep(0.01)
        await plane.publish(f"{proto.KV_RESYNC_SUBJECT}.kv_events", b"")
        await asyncio.sleep(0.05)
        await kv.publish_cleared()
        metrics_sub = (await plane.subscribe(proto.KV_METRICS_SUBJECT)
                       ).__aiter__()
        wm = pub_mod.WorkerMetricsPublisher(plane, worker_id=3)
        await wm.publish(proto.ForwardPassMetrics(
            worker_stats=proto.WorkerStats(request_active_slots=2),
            kv_stats=proto.KvStats(kv_total_blocks=100,
                                   gpu_cache_usage_perc=0.25)))
        _subject, load = await _next(metrics_sub)
        sub = (await plane.stream_subscribe("kv_events")).__aiter__()
        n = await plane.stream_last_seq("kv_events")
        streams.append(([await _next(sub) for _ in range(n)], load))
        await kv.stop()
        await plane.close()
    (port_events, port_load), (jax_events, jax_load) = streams
    assert port_events == jax_events and len(port_events) >= 6
    assert port_load == jax_load
    wid, m = publisher.parse_load_event(jax_load)
    assert wid == 3 and m.kv_stats.gpu_cache_usage_perc == 0.25
    first = msgpack.unpackb(port_events[0][1], raw=False)
    assert jproto.RouterEvent.from_wire(
        first).event.stored_blocks[0].block_hash == 2 ** 64 - 1
