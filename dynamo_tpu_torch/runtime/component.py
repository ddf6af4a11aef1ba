"""Namespace → Component → Endpoint service model with discovery, the
port's copy of ``dynamo_tpu/runtime/component.py`` on the same keys and
subjects:

- instance key:   ``instances/<ns>/<comp>/<ep>:<lease-hex>``
- request subject: ``<ns>_<comp>.<ep>-<lease-hex>``

A served endpoint registers a control-plane request handler on its subject
and writes its instance key under its process's primary lease; lease loss
deletes the key, and every client's prefix watch drops the instance.
Requests carry a response-plane ``ConnectionInfo`` so token streams flow
worker→requester directly; the control-plane reply is only an acceptance
ack. In-process endpoints short-circuit through asyncio queues.

Not ported yet (ROADMAP A12): chaos injection, tracing spans, locality
labels on the instance record, and the canary health checks.
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
from dataclasses import dataclass
from typing import Any, AsyncIterator, Callable, Optional

from dynamo_tpu_torch.runtime.codec import packb, unpackb
from dynamo_tpu_torch.runtime.context import (
    CURRENT_REQUEST,
    Context,
    DeadlineExceededError,
    OverloadedError,
    StreamError,
    STREAM_ERR_MSG,
    stream_error_from_wire,
)
from dynamo_tpu_torch.runtime.control_plane import NoRespondersError, Watch
from dynamo_tpu_torch.runtime.response_plane import (
    ConnectionInfo,
    ResponseReceiver,
    StreamSender,
    make_local_stream,
)
from dynamo_tpu_torch.runtime.streams import batched

logger = logging.getLogger("dynamo.component")

INSTANCE_ROOT = "instances"

#: handler(request, context) -> async iterator of response payloads
EndpointHandler = Callable[[Any, Context], AsyncIterator[Any]]


def instance_key(ns: str, comp: str, ep: str, lease_id: int) -> str:
    return f"{INSTANCE_ROOT}/{ns}/{comp}/{ep}:{lease_id:x}"


def instance_subject(ns: str, comp: str, ep: str, lease_id: int) -> str:
    return f"{ns}_{comp}.{ep}-{lease_id:x}"


@dataclass(frozen=True)
class Instance:
    namespace: str
    component: str
    endpoint: str
    instance_id: int  # lease id
    #: free-form worker-provided info (e.g. dp_rank, served model) readable by
    #: clients for selection logic
    metadata: Optional[dict] = None

    @property
    def subject(self) -> str:
        return instance_subject(self.namespace, self.component, self.endpoint, self.instance_id)

    def to_wire(self) -> dict:
        return {
            "namespace": self.namespace,
            "component": self.component,
            "endpoint": self.endpoint,
            "instance_id": self.instance_id,
            "metadata": self.metadata or {},
        }

    @staticmethod
    def from_wire(d: dict) -> "Instance":
        return Instance(
            d["namespace"],
            d["component"],
            d["endpoint"],
            d["instance_id"],
            d.get("metadata") or {},
        )


class Namespace:
    def __init__(self, runtime, name: str):
        self._runtime = runtime
        self.name = name

    def component(self, name: str) -> "Component":
        return Component(self._runtime, self, name)


class Component:
    def __init__(self, runtime, namespace: Namespace, name: str):
        self._runtime = runtime
        self.namespace = namespace
        self.name = name

    def endpoint(self, name: str) -> "Endpoint":
        return Endpoint(self._runtime, self, name)

    @property
    def path(self) -> str:
        return f"{self.namespace.name}/{self.name}"


class ServeHandle:
    """Handle to a live served endpoint; ``stop()`` deregisters it."""

    def __init__(self, endpoint: "Endpoint", lease_id: int, cancel_serve, inflight: set):
        self.endpoint = endpoint
        self.lease_id = lease_id
        self._cancel_serve = cancel_serve
        self._inflight = inflight
        self._stopped = asyncio.Event()

    async def _deregister(self, kv_delete: bool):
        """Shared teardown for stop() and kill(): forget the replay
        record, stop serving, drop the in-process short-circuit entry.
        ``kv_delete`` is the goodbye — stop() says it, kill() leaves the
        instance key to die with the lease TTL."""
        rt = self.endpoint._runtime
        ns = self.endpoint.component.namespace.name
        comp = self.endpoint.component.name
        ep = self.endpoint.name
        key = instance_key(ns, comp, ep, self.lease_id)
        rt.drop_registration(key)
        if kv_delete:
            await rt.plane.kv_delete(key)
        if self._cancel_serve:
            await self._cancel_serve()
        rt._local_endpoints.pop(
            instance_subject(ns, comp, ep, self.lease_id), None)

    async def stop(self, graceful: bool = True,
                   timeout: Optional[float] = None):
        """Deregister, then (graceful) wait for in-flight streams to finish.

        ``timeout`` bounds the graceful drain (``DYN_DRAIN_TIMEOUT`` at the
        mains): streams still running when it expires are cancelled instead
        of holding shutdown hostage.
        """
        await self._deregister(kv_delete=True)
        if graceful and self._inflight:
            tasks = list(self._inflight)
            if timeout is not None:
                done, pending = await asyncio.wait(tasks, timeout=timeout)
                if pending:
                    logger.warning(
                        "drain timeout (%.1fs): cancelling %d in-flight "
                        "streams", timeout, len(pending))
                    for t in pending:
                        t.cancel()
                    await asyncio.gather(*pending, return_exceptions=True)
            else:
                await asyncio.gather(*tasks, return_exceptions=True)
        self._stopped.set()

    async def wait(self):
        await self._stopped.wait()

    async def kill(self):
        """SIGKILL-grade in-process death (chaos ``worker.kill``): stop
        serving and drop the local short-circuit entry WITHOUT deleting
        the instance key, draining, or completing in-flight streams —
        exactly what a killed process looks like from outside. Discovery
        learns of the death only when the lease TTL expires, which is the
        path proactive death handling (docs/robustness.md) must cover."""
        await self._deregister(kv_delete=False)
        self._stopped.set()


class Endpoint:
    def __init__(self, runtime, component: Component, name: str):
        self._runtime = runtime
        self.component = component
        self.name = name

    @property
    def path(self) -> str:
        return f"{self.component.path}/{self.name}"

    async def serve_endpoint(
        self,
        handler: EndpointHandler,
        metadata: Optional[dict] = None,
        lease_id: Optional[int] = None,
        max_inflight: Optional[int] = None,
    ) -> ServeHandle:
        """Register this endpoint and start handling requests.

        ``handler(request, context)`` must return an async iterator of
        msgpack-serializable responses (ref: component/endpoint.rs:61).

        ``max_inflight`` bounds concurrent requests on this endpoint
        (default ``DYN_WORKER_MAX_INFLIGHT``; 0 = unbounded): excess is
        rejected at the ack with a typed TERMINAL "overloaded" stream error
        — retryable-vs-terminal is what stops Migration from re-sending
        into a saturated fleet (docs/robustness.md).
        """
        rt = self._runtime
        ns, comp, ep = self.component.namespace.name, self.component.name, self.name
        lease = lease_id if lease_id is not None else await rt.primary_lease()
        subject = instance_subject(ns, comp, ep, lease)
        inflight: set[asyncio.Task] = set()
        if max_inflight is None:
            max_inflight = getattr(rt.config, "worker_max_inflight", 0)

        # slots reserved between admission and task creation: the awaited
        # response-stream connect below yields, so a concurrent ack burst
        # would otherwise all pass the len(inflight) check before any of
        # them lands in the set — exceeding the cap exactly when it matters
        reserved = [0]

        async def on_request(payload: bytes) -> bytes:
            envelope = unpackb(payload)
            ctx = Context.from_wire(envelope.get("ctx", {}))
            # admission BEFORE opening the response stream: a shed request
            # must be cheap for the worker (no socket, no handler task)
            if max_inflight and len(inflight) + reserved[0] >= max_inflight:
                return packb({
                    "ok": False, "code": "overloaded", "retryable": False,
                    "error": f"worker at capacity ({max_inflight} in flight)"})
            if ctx.expired:
                return packb({
                    "ok": False, "code": "deadline", "retryable": False,
                    "error": "request deadline expired before dispatch"})
            info = ConnectionInfo.from_wire(envelope["conn"])
            # Connect the response stream BEFORE acking so a worker that
            # cannot reach the requester fails the request instead of
            # leaving the requester waiting on a stream that never opens.
            reserved[0] += 1
            try:
                sender = await StreamSender.connect(info, ctx)
            except Exception as e:
                logger.exception("failed to open response stream to %s:%s", info.host, info.port)
                return packb({"ok": False, "error": f"response stream connect failed: {e!r}"})
            finally:
                reserved[0] -= 1
            task = asyncio.get_running_loop().create_task(
                _pump_handler(handler, envelope.get("req"), ctx, sender)
            )
            inflight.add(task)
            task.add_done_callback(inflight.discard)
            return packb({"ok": True})

        cancel_serve = await rt.plane.serve(subject, on_request)
        # in-process short-circuit path
        rt._local_endpoints[subject] = (handler, inflight, max_inflight)

        meta = dict(metadata or {})
        # under the k8s operator every pod gets DYN_POD_NAME; stamping it
        # into the instance record lets the controller delete THIS pod's
        # discovery keys the moment it scales the pod away, instead of
        # waiting out the lease TTL (ref role: operator/internal/etcd/)
        pod = os.environ.get("DYN_POD_NAME")
        if pod and "pod" not in meta:
            meta["pod"] = pod
        # locality labels, read by a decode worker that picks a near
        # prefill instance (router/topology.py); none set, none published
        if "topo" not in meta:
            from dynamo_tpu_torch.router.topology import TopologyLabels

            topo = TopologyLabels.from_env()
            if topo:
                meta["topo"] = topo.to_metadata()
        inst = Instance(ns, comp, ep, lease, metadata=meta)
        value = packb(inst.to_wire())
        key = instance_key(ns, comp, ep, lease)
        created = await rt.plane.kv_create(key, value, lease_id=lease)
        if not created:
            await rt.plane.kv_put(key, value, lease_id=lease)
        rt.record_registration(key, value)  # replayed after a hub restart
        logger.info("serving %s (instance %x)", subject, lease)
        return ServeHandle(self, lease, cancel_serve, inflight)

    def client(self) -> "Client":
        return Client(self._runtime, self)


async def _pump_handler(handler: EndpointHandler, request: Any, ctx: Context, sender: StreamSender):
    """Drive one request through a handler, pumping output into a sender.

    Shared by the remote (socket) and in-process (queue) paths so their
    error/cancellation semantics cannot diverge. (The JAX package's pump
    also records a ``worker.handle`` tracing span; not ported, ROADMAP
    A12.)
    """
    CURRENT_REQUEST.set(ctx)  # worker-side log lines carry the request id
    logger.debug("handling request (traceparent=%s)", ctx.traceparent)
    # handler output rides batched(): items that pile up while a send is in
    # flight coalesce into one send_many() — one transport write per batch
    # over the corked response plane
    stream = batched(handler(request, ctx), maxsize=64)
    try:
        async for items in stream:
            if ctx.cancelled:
                break
            await sender.send_many(items)
        await sender.complete()
    except asyncio.CancelledError:
        await sender.error("worker shutting down")
        raise
    except StreamError as e:
        # typed failure from the handler (overload/deadline/invalid
        # request): preserve its taxonomy across the hop
        try:
            await sender.error(str(e), code=e.code, retryable=e.retryable)
        except Exception:
            pass
    except Exception as e:
        logger.exception("endpoint handler failed")
        try:
            await sender.error(f"handler error: {e!r}")
        except Exception:
            pass
    finally:
        # deterministic teardown of the pump task + handler generator (a
        # cancel-break above must not leave them draining into the bounded
        # queue until GC)
        await stream.aclose()


class Client:
    """Endpoint client: discovery watch + random/round-robin/direct routing.

    Combines the reference's endpoint ``Client`` (ref: component/client.rs) and
    ``PushRouter`` (ref: pipeline/network/egress/push_router.rs:33): it watches
    the instance prefix, keeps live/down sets, and on ``NoResponders`` or a
    broken stream reports the instance down so the next pick avoids it.
    """

    def __init__(self, runtime, endpoint: Endpoint):
        self._runtime = runtime
        self.endpoint = endpoint
        self._instances: dict[int, Instance] = {}
        self._down: set[int] = set()
        # per-instance circuit breaker: consecutive transport failures; at
        # _breaker_threshold the breaker is OPEN (instance also in _down).
        # The canary success path (report_instance_up) HALF-closes an open
        # breaker — one more failure reopens immediately, a real success
        # (record_success) closes it.
        self._fail_streak: dict[int, int] = {}
        self._half_open: set[int] = set()
        self._breaker_threshold = max(
            1, getattr(runtime.config, "circuit_threshold", 3))
        # load-saturated workers (WorkerMonitor): skipped by rr/random
        # routing but NOT dead — distinct from _down so a recovered canary
        # can't accidentally clear a load signal or vice versa
        self._busy: set[int] = set()
        self._watch: Optional[Watch] = None
        self._watch_task: Optional[asyncio.Task] = None
        self._ready = asyncio.Event()
        self._rr = 0
        #: instance_id -> live ResponseReceivers streaming FROM it. When
        #: the instance's key is deleted (lease expiry / deregistration)
        #: each live stream gets a GRACE window (worker_lost_grace): a
        #: gracefully-draining worker deregisters first and keeps
        #: streaming — its frames keep arriving and the stream completes
        #: untouched — while a lease-expired corpse's stream stays silent
        #: and is failed RETRYABLY when the window closes, so Migration
        #: fires on the lease TTL instead of a long transport timeout
        #: (docs/robustness.md "proactive death handling"). A SIGKILLed
        #: remote worker's TCP reset usually beats this; the in-process
        #: short-circuit path and a silently-wedged worker have no other
        #: death signal at all.
        self._live_streams: dict[int, set] = {}
        self._lost_grace = max(
            0.0, getattr(runtime.config, "worker_lost_grace", 5.0))
        self._break_tasks: set = set()  # strong refs for grace monitors
        #: listeners fn(typ, instance_id) fired on discovery put/delete —
        #: the KV router purges radix/link-cost state through this
        self._instance_listeners: list = []
        # Trailing ':' so an endpoint name that is a prefix of a sibling
        # ("gen" vs "generate") cannot absorb the sibling's instances.
        self._prefix = (
            f"{INSTANCE_ROOT}/{endpoint.component.namespace.name}/"
            f"{endpoint.component.name}/{endpoint.name}:"
        )

    def add_instance_listener(self, fn) -> None:
        """Register fn(typ, instance_id) for discovery events ('put' on
        registration, 'delete' on lease expiry/deregistration)."""
        self._instance_listeners.append(fn)

    def _track_stream(self, instance_id: int, receiver) -> None:
        live = self._live_streams.setdefault(instance_id, set())
        live.add(receiver)

        def done(iid=instance_id, r=receiver):
            s = self._live_streams.get(iid)
            if s is not None:
                s.discard(r)
                if not s:
                    self._live_streams.pop(iid, None)

        receiver.on_done = done

    def _break_streams(self, instance_id: int) -> None:
        live = self._live_streams.pop(instance_id, None)
        if not live:
            return
        if self._lost_grace <= 0:
            for r in live:
                self._fail_stream(r, instance_id)
            return
        logger.warning(
            "instance %x deregistered with %d live streams; breaking any "
            "still silent after %.1fs", instance_id, len(live),
            self._lost_grace)
        task = asyncio.get_running_loop().create_task(
            self._grace_break(instance_id, live))
        self._break_tasks.add(task)
        task.add_done_callback(self._break_tasks.discard)

    @staticmethod
    def _fail_stream(r, instance_id: int) -> None:
        r.fail(f"instance {instance_id:x} deregistered (lease lost)",
               retryable=True, code="worker_lost")

    #: extra silent windows granted to a stream that has produced NO
    #: frames yet: a drain-accepted request mid-prefill (or mid-XLA-
    #: compile) legitimately emits nothing for a TTFT-scale interval,
    #: which one decode-scale window would misread as death. A stream
    #: that HAS streamed and goes silent is dead after one window.
    PRE_FIRST_FRAME_WINDOWS = 4

    async def _grace_break(self, instance_id: int, live: set) -> None:
        """Fail only streams with NO frame arrivals across a grace
        window: a draining worker's streams keep producing (and complete
        on their own); a dead worker's are silent since the kill. Streams
        still active keep being watched — a worker dying MID-drain must
        not leave them hanging forever (iteration cap is a backstop far
        above any drain timeout)."""
        marks = {r: (r.activity(), 0) for r in live}
        for _ in range(240):
            await asyncio.sleep(self._lost_grace)
            nxt = {}
            for r, (mark, silent) in marks.items():
                if r.on_done is None:
                    continue  # stream finished cleanly
                act = r.activity()
                if act != mark:
                    nxt[r] = (act, 0)  # producing: re-watch
                    continue
                silent += 1
                budget = (self.PRE_FIRST_FRAME_WINDOWS if act == 0 else 1)
                if silent >= budget:
                    self._fail_stream(r, instance_id)
                else:
                    nxt[r] = (mark, silent)
            marks = nxt
            if not marks:
                return

    async def start(self) -> "Client":
        self._watch = await self._runtime.plane.watch_prefix(self._prefix)
        for k, v in self._watch.snapshot.items():
            self._apply("put", k, v)
        self._ready.set()
        self._watch_task = asyncio.get_running_loop().create_task(self._watch_loop())
        return self

    async def stop(self):
        if self._watch_task:
            self._watch_task.cancel()
        if self._watch:
            await self._watch.cancel()

    async def _watch_loop(self):
        try:
            async for ev in self._watch:
                try:
                    self._apply(ev.type, ev.key, ev.value)
                except Exception:
                    # One bad instance value must not kill discovery.
                    logger.exception("ignoring malformed instance event for %s", ev.key)
        except asyncio.CancelledError:
            pass

    def _apply(self, typ: str, key: str, value: bytes):
        # key = instances/<ns>/<comp>/<ep>:<lease-hex>
        try:
            lease_hex = key.rsplit(":", 1)[1]
            iid = int(lease_hex, 16)
        except (IndexError, ValueError):
            return
        if typ == "put":
            d = unpackb(value)
            self._instances[iid] = Instance.from_wire(d)
            self._down.discard(iid)
            self._fail_streak.pop(iid, None)  # fresh registration: closed
            self._half_open.discard(iid)
        else:
            self._instances.pop(iid, None)
            self._down.discard(iid)
            self._fail_streak.pop(iid, None)
            self._half_open.discard(iid)
            # the authoritative death signal: break every stream still
            # flowing from this instance so migration starts NOW
            self._break_streams(iid)
        for fn in self._instance_listeners:
            try:
                fn("put" if typ == "put" else "delete", iid)
            except Exception:
                logger.exception("instance listener failed for %x", iid)

    def instance_ids(self) -> list[int]:
        return sorted(self._instances)

    def instances(self) -> list[Instance]:
        return [self._instances[i] for i in sorted(self._instances)]

    def instance(self, instance_id: int) -> Optional[Instance]:
        return self._instances.get(instance_id)

    def available_ids(self) -> list[int]:
        # the busy set may come from a SHARED monitor spanning several
        # models' clients — only ids this client actually owns count
        busy = self._busy & set(self._instances)
        ids = set(self._instances) - self._down - busy
        if not ids and busy:
            # every worker saturated: routing to a busy worker beats
            # NoResponders (the reference degrades the same way — busy is
            # backpressure, not failure)
            ids = set(self._instances) - self._down
        if not ids and self._instances:
            # every REGISTERED instance is marked down. Down-marking is a
            # soft signal (a blipped stream under fault injection marks a
            # perfectly live worker); lease loss is the authoritative death
            # signal and would have removed the instance entirely. Routing
            # to a down-but-registered instance as a last resort beats
            # leaving the fleet unreachable until a canary runs — a real
            # success then clears the mark (record_success).
            ids = set(self._instances)
        return sorted(ids)

    def set_busy_instances(self, instance_ids) -> None:
        """Replace the load-busy set (ref: worker_monitor.rs
        update_free_instances) — typically called by WorkerMonitor."""
        self._busy = set(instance_ids)

    def report_instance_down(self, instance_id: int):
        logger.warning("instance %x reported down", instance_id)
        self._down.add(instance_id)
        if instance_id in self._half_open:
            # trial traffic failed: reopen immediately, no fresh streak
            self._half_open.discard(instance_id)
            self._fail_streak[instance_id] = self._breaker_threshold
            logger.warning("instance %x circuit breaker RE-OPENED "
                           "(half-open trial failed)", instance_id)
            return
        streak = self._fail_streak.get(instance_id, 0) + 1
        self._fail_streak[instance_id] = streak
        if streak == self._breaker_threshold:
            logger.warning("instance %x circuit breaker OPEN "
                           "(%d consecutive failures)", instance_id, streak)

    def report_instance_up(self, instance_id: int):
        """Restore a previously-down instance to the routable set (the
        canary success path). An OPEN breaker only HALF-closes here: the
        instance takes trial traffic, but a single further failure reopens
        it; a real success (record_success) closes it."""
        if instance_id in self._down:
            logger.info("instance %x restored", instance_id)
        self._down.discard(instance_id)
        if self._fail_streak.get(instance_id, 0) >= self._breaker_threshold:
            self._half_open.add(instance_id)

    def record_success(self, instance_id: int):
        """Real traffic reached the instance: fully close its breaker and
        clear any stale down mark (self-healing without waiting for the
        canary when last-resort routing succeeded)."""
        self._fail_streak.pop(instance_id, None)
        self._half_open.discard(instance_id)
        self._down.discard(instance_id)

    def breaker_state(self, instance_id: int) -> str:
        """closed | half-open | open — for tests, metrics and dynctl."""
        if instance_id in self._half_open:
            return "half-open"
        if self._fail_streak.get(instance_id, 0) >= self._breaker_threshold:
            return "open"
        return "closed"

    async def wait_for_instances(self, timeout: float = 30.0) -> list[int]:
        deadline = asyncio.get_running_loop().time() + timeout
        while True:
            ids = self.available_ids()
            if ids:
                return ids
            if asyncio.get_running_loop().time() > deadline:
                raise TimeoutError(f"no instances for {self._prefix}")
            await asyncio.sleep(0.05)

    # -- routing --
    def _pick(self, mode: str, instance_id: Optional[int]) -> Instance:
        if mode == "direct":
            assert instance_id is not None
            inst = self._instances.get(instance_id)
            if inst is None:
                raise NoRespondersError(f"instance {instance_id:x} not found")
            return inst
        ids = self.available_ids()
        if not ids:
            raise NoRespondersError(self._prefix)
        if mode == "random":
            return self._instances[random.choice(ids)]
        # round robin
        self._rr += 1
        return self._instances[ids[self._rr % len(ids)]]

    async def generate(
        self,
        request: Any,
        ctx: Optional[Context] = None,
        mode: str = "round_robin",
        instance_id: Optional[int] = None,
        retries: int = 1,
    ) -> ResponseReceiver:
        """Issue a request; returns a receiver over the response stream."""
        ctx = ctx or Context()
        if ctx.expired:
            raise DeadlineExceededError(
                "request deadline expired before dispatch")
        attempts = 0
        while True:
            inst = self._pick(mode, instance_id)
            try:
                return await self._generate_to(inst, request, ctx)
            except OverloadedError:
                # the worker is alive and SHED the request — not a failure
                # signal: don't mark it down / feed its breaker, just try
                # another instance while the budget lasts
                attempts += 1
                if mode == "direct" or attempts > retries:
                    raise
            except DeadlineExceededError:
                raise  # no instance can beat an expired clock
            except (NoRespondersError, StreamError):
                # StreamError here is pre-stream (ack failed / worker could
                # not open the response path) — safe to fail over, nothing
                # was generated yet.
                self.report_instance_down(inst.instance_id)
                attempts += 1
                if mode == "direct" or attempts > retries:
                    raise

    async def _generate_to(self, inst: Instance, request: Any, ctx: Context) -> ResponseReceiver:
        rt = self._runtime
        local = rt._local_endpoints.get(inst.subject)
        if local is not None:
            handler, inflight, max_inflight = local
            # same admission/deadline contract as the remote ack path —
            # in-process short-circuiting must not bypass overload shedding
            if max_inflight and len(inflight) >= max_inflight:
                raise OverloadedError(
                    f"worker at capacity ({max_inflight} in flight)")
            if ctx.expired:
                raise DeadlineExceededError(
                    "request deadline expired before dispatch")
            info, receiver, queue = make_local_stream(ctx)
            sender = StreamSender.local(queue)
            task = asyncio.get_running_loop().create_task(
                _pump_handler(handler, request, ctx, sender)
            )
            inflight.add(task)
            task.add_done_callback(inflight.discard)
            self.record_success(inst.instance_id)
            self._track_stream(inst.instance_id, receiver)
            return receiver

        server = await rt.response_server()
        info, receiver = server.register_stream(ctx)
        ctx_wire = ctx.to_wire()
        envelope = packb(
            {"ctx": ctx_wire, "conn": info.to_wire(), "req": request}
        )
        try:
            ack = await rt.plane.request(inst.subject, envelope,
                                         timeout=rt.config.request_timeout)
        except NoRespondersError:
            server.abandon_stream(info)
            raise
        except StreamError:
            server.abandon_stream(info)
            raise
        except (asyncio.TimeoutError, TimeoutError, RuntimeError,
                ConnectionError) as e:
            # Dispatch-ack failure to a worker whose lease hasn't expired
            # yet (e.g. SIGKILL'd corpse still advertised): the hub's
            # forward times out and relays a generic error. This is
            # PRE-STREAM by construction — no token was produced — so
            # surface it as a retryable StreamError: generate()'s failover
            # marks the instance down and re-picks instead of bubbling a
            # client-visible 500.
            server.abandon_stream(info)
            raise StreamError(f"dispatch ack failed: {e!r}") from e
        except Exception:
            server.abandon_stream(info)
            raise
        resp = unpackb(ack)
        if not resp.get("ok"):
            server.abandon_stream(info)
            raise stream_error_from_wire(
                resp.get("error", STREAM_ERR_MSG), resp.get("code"),
                resp.get("retryable", True))
        self.record_success(inst.instance_id)
        self._track_stream(inst.instance_id, receiver)
        return receiver
