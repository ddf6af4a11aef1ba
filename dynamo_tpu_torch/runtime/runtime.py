"""DistributedRuntime: per-process cluster handle, the port's copy of
``dynamo_tpu/runtime/runtime.py``.

It owns the control-plane client, a primary lease kept alive in the
background (its loss makes every instance registered under it vanish
cluster-wide), the lazy response-plane server, and the process-local
endpoint registry used for in-process short-circuiting. The system status
server (``DYN_SYSTEM_PORT``) is not ported: setting it raises (ROADMAP
A12).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from dynamo_tpu_torch.runtime.component import Namespace
from dynamo_tpu_torch.runtime.config import RuntimeConfig, setup_logging
from dynamo_tpu_torch.runtime.control_plane import (
    ControlPlane,
    LocalControlPlane,
    RemoteControlPlane,
)
from dynamo_tpu_torch.runtime.response_plane import ResponseStreamServer

logger = logging.getLogger("dynamo.runtime")


class DistributedRuntime:
    def __init__(self, plane: ControlPlane, config: RuntimeConfig, owns_plane: bool):
        self.plane = plane
        self.config = config
        self._owns_plane = owns_plane
        self._primary_lease: Optional[int] = None
        self._lease_lock = asyncio.Lock()
        self._keepalive_task: Optional[asyncio.Task] = None
        self._response_server: Optional[ResponseStreamServer] = None
        self._response_server_lock = asyncio.Lock()
        # subject -> (handler, inflight set); see component._generate_to
        self._local_endpoints: dict = {}
        self._shutdown_event = asyncio.Event()
        # key -> value written under the primary lease; replayed when the
        # hub restarts and the lease must be recreated (see _recover_lease)
        self._registrations: dict[str, bytes] = {}
        #: secondary leases kept alive alongside the primary (DP-rank
        #: instance identities — see adopt_lease)
        self._extra_leases: set[int] = set()
        self._recover_lock = asyncio.Lock()
        # structured concurrency root (ref: utils/tasks/tracker.rs):
        # components spawn through runtime.tracker (or a child of it);
        # shutdown() drains the whole tree. SHUTDOWN-policy task failures
        # trip the runtime's shutdown event (critical-task semantics).
        from dynamo_tpu_torch.runtime.tasks import TaskTracker

        self.tracker = TaskTracker(
            "runtime", on_shutdown=self._shutdown_event.set)
        # per-runtime metrics registry (the JAX package's system status
        # server exposes it; the port's has none yet, ROADMAP A12)
        from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

        self.metrics = MetricsRegistry()

    def record_registration(self, key: str, value: bytes) -> None:
        self._registrations[key] = value

    def adopt_lease(self, lease_id: int) -> None:
        """Keep a SECONDARY lease alive in the keepalive loop (DP-rank
        instance identities each need their own lease — the instance key
        embeds it). If such a lease is ever lost (hub restart, missed
        TTLs), its recorded registrations are re-bound to the primary
        lease: key NAMES (and so instance ids) stay stable, only the
        backing TTL object changes."""
        self._extra_leases.add(lease_id)

    def drop_registration(self, key: str) -> None:
        self._registrations.pop(key, None)

    @staticmethod
    async def create(
        address: Optional[str] = None,
        plane: Optional[ControlPlane] = None,
        config: Optional[RuntimeConfig] = None,
        owns_plane: bool = True,
    ) -> "DistributedRuntime":
        """Connect to ``DYN_CONTROL_PLANE`` (or ``address``), else run in-process.

        Pass ``owns_plane=False`` when several runtimes share one plane object;
        the owner is responsible for closing it.
        """
        setup_logging()
        config = config or RuntimeConfig.from_env()
        if config.system_port:
            raise NotImplementedError(
                f"DYN_SYSTEM_PORT={config.system_port}: the system status "
                "server (/health, /live, /metrics) is not ported to the torch "
                "runtime yet (ROADMAP A12); unset it")
        owns = owns_plane
        if plane is None:
            addr = address or config.control_plane_address
            if addr:
                plane = await RemoteControlPlane(addr).connect()
                logger.info("connected to control plane at %s", addr)
            else:
                plane = LocalControlPlane()
                logger.info("running with in-process control plane")
        return DistributedRuntime(plane, config, owns)

    def namespace(self, name: Optional[str] = None) -> Namespace:
        return Namespace(self, name or self.config.namespace)

    async def primary_lease(self) -> int:
        async with self._lease_lock:
            if self._primary_lease is None:
                self._primary_lease = await self.plane.lease_create(self.config.lease_ttl)
                self._keepalive_task = asyncio.get_running_loop().create_task(
                    self._keepalive_loop()
                )
                if hasattr(self.plane, "add_reconnect_callback"):
                    self.plane.add_reconnect_callback(self._recover_lease)
        return self._primary_lease

    async def _recover_lease(self) -> None:
        """After a hub restart the lease and every key under it are gone:
        mint a fresh lease and re-put the recorded registrations (instance
        keys and model entries keep their original names — only the backing
        TTL lease changes), so the worker survives a dynctl restart instead
        of becoming an undiscoverable zombie.

        Serialized + idempotent: the reconnect callback and the keepalive
        not-ok path can both fire after one restart; a second concurrent
        recovery would re-bind keys to a lease nobody keeps alive."""
        async with self._recover_lock:
            try:  # someone else may have recovered while we waited
                if (self._primary_lease is not None
                        and await self.plane.lease_keepalive(self._primary_lease)):
                    return
            except Exception:
                pass
            new_lease = await self.plane.lease_create(self.config.lease_ttl)
            self._primary_lease = new_lease
            for key, value in list(self._registrations.items()):
                try:
                    await self.plane.kv_put(key, value, lease_id=new_lease)
                except Exception:
                    logger.exception("re-registration of %s failed", key)
            logger.info("recovered primary lease (%x) and %d registrations "
                        "after control-plane restart", new_lease,
                        len(self._registrations))

    async def _keepalive_loop(self):
        """Refresh the primary lease; transient errors are retried.

        A definitively-lost lease (keepalive returns False — typically the
        hub restarted and forgot it) triggers recovery: a fresh lease is
        minted and the recorded registrations are re-put, so the worker
        rejoins the cluster instead of dying. Only when recovery itself
        fails is the shutdown event tripped (the process is then an
        undiscoverable zombie and the supervisor should restart it).
        """
        import time as _time

        interval = max(self.config.lease_ttl / 3.0, 0.5)
        # continuous-failure budget before declaring this process a zombie.
        # A strike COUNT is the wrong unit: a hub FAILOVER keeps keepalives
        # erroring for standby takeover_after + client reconnect backoff —
        # several seconds — and a count tuned for transient blips would
        # suicide the entire fleet right when the standby is about to
        # serve it. Only a hub unreachable well past any takeover window
        # is fatal; once reconnected, the reconnect callback recovers the
        # lease and replays registrations.
        fail_budget_s = max(10.0, 5 * interval)
        failures = 0
        failing_since: Optional[float] = None
        try:
            while not self._shutdown_event.is_set():
                await asyncio.sleep(interval)
                try:
                    ok = await self.plane.lease_keepalive(self._primary_lease)
                except asyncio.CancelledError:
                    raise
                except Exception:
                    now = _time.monotonic()
                    if failing_since is None:
                        failing_since = now
                    failures += 1
                    logger.warning(
                        "lease keepalive error (%d consecutive, %.1fs)",
                        failures, now - failing_since, exc_info=True
                    )
                    if now - failing_since >= fail_budget_s:
                        logger.error("lease keepalive failing persistently; shutting down")
                        self._shutdown_event.set()
                        return
                    continue
                failing_since = None
                for extra in list(self._extra_leases):
                    try:
                        ok2 = await self.plane.lease_keepalive(extra)
                    except Exception:
                        continue  # transient; retried next tick
                    if not ok2:
                        # the rank's lease is gone (its keys with it):
                        # re-bind its recorded keys to the primary lease —
                        # identity (key names) is preserved
                        self._extra_leases.discard(extra)
                        # a lease id appears as ':<hex>' in instance keys
                        # and as a '/<hex>/' path segment in models/ keys
                        # (llm/model_card.py) — re-bind both kinds
                        pats = (f":{extra:x}", f"/{extra:x}/")
                        for key, value in list(self._registrations.items()):
                            if key.endswith(pats[0]) or pats[1] in key:
                                try:
                                    await self.plane.kv_put(
                                        key, value,
                                        lease_id=self._primary_lease)
                                except Exception:
                                    logger.exception(
                                        "re-bind of %s failed", key)
                        logger.warning(
                            "secondary lease %x lost; its registrations "
                            "re-bound to the primary lease", extra)
                if not ok:
                    # the hub may have restarted (all lease state lost):
                    # recovery replays registrations under a fresh lease
                    try:
                        await self._recover_lease()
                        failures = 0
                        continue
                    except Exception:
                        logger.error("primary lease %x lost and recovery "
                                     "failed; shutting down",
                                     self._primary_lease or 0, exc_info=True)
                        self._shutdown_event.set()
                        return
                failures = 0
        except asyncio.CancelledError:
            pass

    async def response_server(self) -> ResponseStreamServer:
        # lock: a second caller must not observe the server between
        # construction and start() (lazy-init race under concurrent generate)
        async with self._response_server_lock:
            if self._response_server is None:
                server = ResponseStreamServer()
                await server.start()
                self._response_server = server
        return self._response_server

    @property
    def is_shutdown(self) -> bool:
        return self._shutdown_event.is_set()

    async def wait_shutdown(self):
        await self._shutdown_event.wait()

    async def shutdown(self):
        # idempotence keys on a cleanup flag, NOT the shutdown event: a
        # critical-task failure sets the event first, and the subsequent
        # explicit shutdown() must still run the cleanup
        if getattr(self, "_cleanup_done", False):
            return
        self._cleanup_done = True
        self._shutdown_event.set()
        await self.tracker.join(graceful_timeout=5.0)
        if self._keepalive_task:
            self._keepalive_task.cancel()
        if self._primary_lease is not None:
            try:
                await self.plane.lease_revoke(self._primary_lease)
            except Exception:
                pass
        if self._response_server:
            await self._response_server.stop()
        if self._owns_plane:
            await self.plane.close()
        logger.info("runtime shut down")
