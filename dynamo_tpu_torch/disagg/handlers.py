"""Disagg worker handlers, the port's copy of
``dynamo_tpu/disagg/handlers.py``: decode-first conditional
disaggregation and the KV pulls between workers.

- ``DecodeWorkerHandler`` serves the decode (or aggregated) component's
  ``generate``. A prompt longer than the live ``max_local_prefill_length``
  goes to the prefill fleet (a queue claim, then a near instance, then
  round robin); its first token and KV come back as chunk frames while
  the prefill runs, layer frames of the last chunk, and the final
  response, and are scattered into this engine's cache. Prompts at or
  under the threshold, and every transfer that cannot be placed, are
  prefilled locally (counted: ``report()["fallbacks"]``). A request with a
  ``restore`` (migration) or ``onboard`` plan first pulls the prefix it
  can from the named peers' ``kv_pull`` endpoints and attaches it, then
  computes only the rest.
- ``PrefillWorkerHandler`` serves the prefill component's ``generate``,
  with chunk and layer frames only when the decode side advertised them
  (``kv_chunks``, ``kv_layers``), so torch and JAX workers of either role
  serve in one fleet.
- ``KvPullHandler`` serves ``kv_pull`` in every role: blocks by sequence
  hash from the device prefix cache, with separate budgets for restore
  and onboard pulls.
- ``DisaggConfigWatcher`` keeps the threshold live from the control plane.

KV moves device to device when the decode worker's ``kv_direct``
capability lets the prefill worker offer it (``disagg/transfer.py``: the
same process, or CUDA IPC on one card); the prefill stream then carries
KvDirectFrame descriptors, pulled, scattered and released here. Anything
else, a JAX peer in either role included, moves host-staged over the
response plane. A pull that fails is counted
(``kv_direct_pull_failures_total``) and the prompt recomputed locally.
The port has no KVBM tier (A8e): a plan's ``g4_blocks`` counts as "not
here", and no ``kv_session`` endpoint is served (A8c). Spans wait for A12b. The handlers' counts (``report()``,
the worker's exit report) are the one record of what they did; the
metrics registry's counters read them at scrape time. A request the
engine cannot serve (multimodal input: ``engine.refusal``) is rejected
as an invalid request, a terminal error the frontend answers with a 400
instead of migrating it; so is a guided constraint that no token
sequence over the vocabulary can satisfy.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import logging
import random
import time
from typing import Optional

from dynamo_tpu_torch.disagg.protocols import (
    DisaggConfig, KvChunkFrame, KvLayerFrame, PrefillResponse,
)
from dynamo_tpu_torch.disagg.transfer import (
    DirectKvBundle, KvDirectFrame, OnboardConfig, RestoreConfig, pull_bundle,
    pull_restore_blocks, restore_pull_timeout,
)
from dynamo_tpu_torch.engine.engine import refusal
from dynamo_tpu_torch.protocols import PreprocessedRequest
from dynamo_tpu_torch.runtime.codec import packb
from dynamo_tpu_torch.runtime.context import InvalidRequestError
from dynamo_tpu_torch.runtime.control_plane import NoRespondersError

logger = logging.getLogger("dynamo_torch.disagg")

#: request annotation by which a decode worker advertises that it consumes
#: mid-prefill KvChunkFrames (pipelined transfer)
KV_CHUNKS_ANNOTATION = "kv_chunks"
#: request annotation by which a decode worker advertises that it scatters
#: LAYER SLICES of the tail chunk as they land
KV_LAYERS_ANNOTATION = "kv_layers"
#: the KV audit plane's subject for stale-advert reports
KV_AUDIT_SUSPECT_SUBJECT = "kv_audit_suspect"

#: Prometheus counters that read ``DecodeWorkerHandler.counts`` at scrape
#: time, the one record of these counts: family -> (counts family, label;
#: None for one unlabelled series, the sum of the counts family)
COUNTER_FAMILIES = {
    "kv_transfer_bytes_total": (
        "transfer_bytes", "path",
        "disagg KV bytes placed on this decode worker, by link path"),
    "kv_transfers_total": (
        "transfer_paths", "path",
        "remote prefills' KV transfers on this decode worker, by link path: "
        "proc | ipc | host"),
    "kv_direct_pull_failures_total": (
        "direct_pull_failures", None,
        "direct KV pulls that failed (the prompt was recomputed locally)"),
    "prefill_claim_fallback_total": (
        "fallbacks", "reason",
        "queued prefill dispatches that degraded to round robin, and "
        "remote prefills recomputed locally, by reason"),
    "migration_total": (
        "migration", "outcome",
        "migrated streams inherited by this worker, by outcome: "
        "restored | partial | recomputed"),
    "migration_restored_blocks_total": (
        "migration_blocks", None,
        "KV blocks attached from peer pulls on migrated streams"),
    "migration_recomputed_tokens_total": (
        "migration_tokens", None,
        "prompt tokens of migrated streams re-prefilled locally"),
    "prefix_onboard_total": (
        "onboard", "outcome",
        "admissions that carried an onboard plan, by outcome: pulled | "
        "local | recomputed"),
    "prefix_onboard_blocks_total": (
        "onboard_blocks", "source",
        "prefix blocks attached by routine onboarding, by source"),
    "kv_pull_outcome_total": (
        "pull_outcomes", "outcome",
        "restore/onboard pull attempts by outcome: pulled | stale_advert | "
        "torn | slow | dead"),
}
#: histograms of what the counts do not keep: family -> help
HISTOGRAM_FAMILIES = {
    "kv_transfer_seconds": "remote-prefill stream + KV placement wall per "
                           "request, by link path",
    "migration_restore_seconds": "KV-restore phase wall per migrated stream",
    "prefix_onboard_seconds": "onboard phase wall per admission",
}


def _series(counts: dict, label: Optional[str]):
    """A scrape callback: one counts family as Prometheus series."""
    if label is None:
        return lambda: {None: sum(counts.values())} if counts else {}
    return lambda: {((label, k),): v for k, v in counts.items()}


class PrefillWorkerHandler:
    """Serves the prefill component's ``generate``: chunk frames while the
    prefill computes, then the final PrefillResponse with the tail."""

    def __init__(self, engine):
        self.engine = engine

    async def generate(self, request: dict, ctx):
        req = PreprocessedRequest.from_wire(request)
        # chunk frames only when the decode side asked for them: a decode
        # worker that reads the first frame as the response keeps working
        if KV_CHUNKS_ANNOTATION in (req.annotations or []):
            async for frame in self.engine.prefill_extract_stream(req, ctx):
                yield frame
        else:
            resp = await self.engine.prefill_extract(req, ctx)
            yield resp.to_wire()


class DisaggConfigWatcher:
    """Watches the conditional-disagg threshold in the control-plane KV
    store (``DisaggConfig.KEY``, an integer payload) and updates a
    DisaggConfig live."""

    def __init__(self, plane, config: DisaggConfig):
        self.plane = plane
        self.config = config
        self._watch = None
        self._task = None

    async def start(self) -> "DisaggConfigWatcher":
        self._watch = await self.plane.watch_prefix(DisaggConfig.KEY)
        for _k, v in self._watch.snapshot.items():
            self._apply(v)
        self._task = asyncio.get_running_loop().create_task(self._loop())
        return self

    async def stop(self):
        if self._task:
            self._task.cancel()
        if self._watch:
            await self._watch.cancel()

    def _apply(self, value: bytes):
        try:
            n = int(value.decode())
        except (ValueError, AttributeError):
            logger.warning("ignoring bad disagg threshold payload %r", value)
            return
        if n != self.config.max_local_prefill_length:
            logger.info("disagg max_local_prefill_length: %d -> %d",
                        self.config.max_local_prefill_length, n)
            self.config.max_local_prefill_length = n

    async def _loop(self):
        try:
            async for ev in self._watch:
                if ev.type == "put":
                    self._apply(ev.value)
        except asyncio.CancelledError:
            pass


class KvPullHandler:
    """Serves a worker's ``kv_pull`` endpoint: peers rebuilding a migrated
    stream, or onboarding a hot prefix, pull blocks by sequence hash out of
    this worker's device prefix cache, one block a frame
    (``kvbm.distributed._pack_block``). Restore and onboard pulls queue on
    separate concurrency caps, so routine onboarding never starves a
    restore racing a migration deadline."""

    #: absolute per-request serve cap, whatever the puller asked for
    MAX_SERVE_BLOCKS = 8192

    def __init__(self, engine, metrics=None):
        self.engine = engine
        self._serve_slots = {
            "restore": asyncio.Semaphore(
                max(1, RestoreConfig.from_env().max_concurrent)),
            "onboard": asyncio.Semaphore(
                max(1, OnboardConfig.from_env().max_concurrent)),
        }
        #: blocks served, by reason
        self.served: dict[str, int] = {}
        if metrics is not None:
            metrics.counter(
                "kv_restore_served_blocks_total",
                "KV blocks this worker served to peers' restore/onboard "
                "pulls, by reason").add_callback(
                    _series(self.served, "reason"))

    async def generate(self, request: dict, ctx):
        from dynamo_tpu_torch.kvbm.distributed import _pack_block

        hashes = list(request.get("hashes") or [])
        asked = request.get("max_blocks")
        reason = request.get("reason") or "restore"
        budget = min(len(hashes) if asked is None else int(asked),
                     self.MAX_SERVE_BLOCKS)
        served = 0
        # waiters are bounded by the PULLER's wait: a puller that gives up
        # cancels the stream, releasing the slot
        async with self._serve_slots.get(reason,
                                         self._serve_slots["restore"]):
            async for h, k, v in self.engine.export_blocks(
                    hashes, max_blocks=budget):
                served += 1
                yield _pack_block(h, k, v)
        if served:
            self.served[reason] = self.served.get(reason, 0) + served


class DecodeWorkerHandler:
    """Serves the decode (or aggregated) component's ``generate``.

    ``prefill_client``: a runtime Client of the prefill component's
    generate endpoint, or None for aggregated serving. ``pull_clients``:
    Clients of ``kv_pull`` endpoints (this component's and, in a disagg
    deployment, the prefill component's), the transport of restore and
    onboard pulls."""

    def __init__(self, engine, prefill_client=None,
                 config: Optional[DisaggConfig] = None, prefill_queue=None,
                 metrics=None, topo_labels=None, pull_clients=None,
                 restore_config=None, onboard_config=None, plane=None):
        self.engine = engine
        self.prefill_client = prefill_client
        self.config = config or DisaggConfig()
        #: optional PrefillQueueClient: queued dispatch with claim/fallback
        self.prefill_queue = prefill_queue
        #: this worker's locality labels (None: read DYN_TOPO_* lazily)
        self._topo_labels = topo_labels
        #: counts by family and key: the exit report, and the Prometheus
        #: counters of COUNTER_FAMILIES
        self.counts: dict[str, dict] = collections.defaultdict(dict)
        self._hist = {}
        if metrics is not None:
            for fam, (key, label, help_) in COUNTER_FAMILIES.items():
                metrics.counter(fam, help_).add_callback(
                    _series(self.counts[key], label))
            self._hist = {fam: metrics.histogram(fam, help_)
                          for fam, help_ in HISTOGRAM_FAMILIES.items()}
        #: the last remote prefills' transfers, one record a request
        self.transfers: collections.deque = collections.deque(maxlen=256)
        #: control plane for stale-advert reports (else a pull client's)
        self._plane = plane
        self.pull_clients = list(pull_clients or [])
        self.restore_config = restore_config or RestoreConfig.from_env()
        #: this worker's own instance id, excluded from pull sources
        self.instance_id = None
        #: at most max_concurrent restores in flight
        self._restore_slots = asyncio.Semaphore(
            max(1, self.restore_config.max_concurrent))
        self.onboard_config = onboard_config or OnboardConfig.from_env()
        #: a SEPARATE budget for routine onboard pulls
        self._onboard_slots = asyncio.Semaphore(
            max(1, self.onboard_config.max_concurrent))
        #: first missing hash → the in-flight onboard of that prefix: a
        #: prefix arriving N-wide pulls once
        self._onboard_inflight: dict[int, asyncio.Future] = {}
        #: direct pulls' releases still waiting for their scatter
        self._releases: set = set()

    # ------------------------------------------------------------- counts

    def _count(self, family: str, key: str, n: int = 1) -> None:
        d = self.counts[family]
        d[key] = d.get(key, 0) + n

    def _observe(self, family: str, value: float, **labels) -> None:
        if family in self._hist:
            self._hist[family].observe(value, **labels)

    def report(self) -> dict:
        """Counts and transfer records for the worker's exit report, each
        placed transfer's digest read back (the device waits)."""
        return {**{k: dict(v) for k, v in self.counts.items() if v},
                "transfers": [{**r, "digest": int(r["digest"])}
                              if "digest" in r else r
                              for r in self.transfers]}

    # ------------------------------------------------------------ routing

    def _labels(self):
        if self._topo_labels is None:
            from dynamo_tpu_torch.router.topology import TopologyLabels

            self._topo_labels = TopologyLabels.from_env()
        return self._topo_labels

    def _nearest_prefill_instance(self):
        """The nearest routable prefill instance by locality labels, or
        None when the labels prefer none (then plain round robin)."""
        from dynamo_tpu_torch.router.topology import (
            LINK_CLASSES, TopologyLabels, link_class,
        )

        instances = getattr(self.prefill_client, "instances", None)
        my = self._labels()
        if instances is None or not my:
            return None
        try:
            insts = instances()
        except Exception:
            return None
        routable = set(self.prefill_client.available_ids())
        ranks = {i.instance_id: LINK_CLASSES.index(link_class(
                     TopologyLabels.from_metadata(i.metadata), my))
                 for i in insts if i.instance_id in routable}
        if not ranks or min(ranks.values()) == max(ranks.values()):
            return None
        lo = min(ranks.values())
        return random.choice([i for i, r in ranks.items() if r == lo])

    def _use_remote_prefill(self, req: PreprocessedRequest) -> bool:
        if self.prefill_client is None:
            return False
        if not self.prefill_client.available_ids():
            return False  # no prefill worker up: serve locally
        return len(req.token_ids) > self.config.max_local_prefill_length

    async def _local(self, req, ctx):
        async for out in self.engine.generate(req, ctx):
            yield out.to_wire()

    async def generate(self, request: dict, ctx):
        req = PreprocessedRequest.from_wire(request)
        why = refusal(req)
        if why is not None:
            raise InvalidRequestError(
                f"the torch worker cannot serve this request yet: it "
                f"needs {why}")
        bs = self.engine.args.block_size
        if req.restore is not None:
            # stateful migration: rebuild the recoverable prefix from
            # surviving peers, then serve locally (generate()'s prefix
            # match picks the attached blocks up). When little was
            # recovered and the rest is still past the threshold, the
            # remote-prefill decision below takes it.
            info = await self._restore_migrated(req, ctx)
            unrecovered = (len(req.token_ids)
                           - info.get("covered_blocks", 0) * bs)
            if not (self._use_remote_prefill(req)
                    and unrecovered > self.config.max_local_prefill_length):
                async for out in self._local(req, ctx):
                    yield out
                return
        elif req.onboard is not None and self.onboard_config.enabled:
            # routine onboarding, skipped only when the prompt goes to the
            # prefill pool anyway and even a full pull would leave it there
            best = max([int(n) for _w, n, _c in
                        (req.onboard.get("sources") or [])], default=0)
            est_tail = len(req.token_ids) - best * bs
            if (not self._use_remote_prefill(req)
                    or est_tail <= self.config.max_local_prefill_length):
                info = await self._onboard_prefix(req, ctx)
                unrecovered = (len(req.token_ids)
                               - info.get("covered_blocks", 0) * bs)
                if not (self._use_remote_prefill(req) and unrecovered
                        > self.config.max_local_prefill_length):
                    async for out in self._local(req, ctx):
                        yield out
                    return
        if self._use_remote_prefill(req):
            yielded = False
            try:
                async for out in self._generate_disagg(req, ctx):
                    yielded = True
                    yield out
                return
            except Exception:
                if yielded:  # mid-stream failure: surface, never duplicate
                    raise
                logger.exception("remote prefill failed; falling back local")
                self._count("fallbacks", "stream_error")
        async for out in self._local(req, ctx):
            yield out

    # ------------------------------------------------------ restore/onboard

    def _client_for_instance(self, instance_id: int):
        """The pull client whose discovery set covers ``instance_id``'s
        kv_pull endpoint, or None."""
        for c in self.pull_clients:
            try:
                if c.instance(instance_id) is not None:
                    return c
            except Exception:
                continue
        return None

    @staticmethod
    def _remaining_s(ctx):
        return (ctx.remaining_s() if ctx is not None
                and hasattr(ctx, "remaining_s") else None)

    def _report_suspect(self, wid: int, cause: str = "stale_advert") -> None:
        """Tell the routers' KV audit plane that ``wid`` advertised blocks
        it could not serve (fire and forget)."""
        from dynamo_tpu_torch.router.publisher import _spawn_publish

        plane = self._plane
        if plane is None:
            for c in self.pull_clients:
                rt = getattr(c, "_runtime", None)
                if rt is not None:
                    plane = rt.plane
                    break
        if plane is None:
            return
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            return
        _spawn_publish(self, plane.publish(
            KV_AUDIT_SUSPECT_SUBJECT, packb({"worker_id": wid,
                                             "cause": cause})))

    async def _pull_from_sources(self, probe, hashes, sources, covered,
                                 want, cfg, ctx, info,
                                 reason: str = "restore") -> int:
        """Try the best-ranked source and one failover over ``kv_pull`` and
        attach what lands contiguously. Returns the new covered count;
        sets info["reason"] = "deadline" when the budget is too thin."""
        for wid, blocks, _cost in sources[:2]:
            client = self._client_for_instance(wid)
            if client is None:
                continue
            end = min(blocks, want)
            if end <= covered:
                continue
            # each pull gets at most half of what is left
            timeout = restore_pull_timeout(cfg.pull_timeout_cap_s,
                                           self._remaining_s(ctx))
            if timeout is None:
                info["reason"] = "deadline"
                return covered
            info["pulls"] += 1
            try:
                pulled = await pull_restore_blocks(
                    client, wid, hashes[covered:end], timeout, reason=reason)
            except Exception as e:
                info["pull_failures"] += 1
                self._count("pull_outcomes", "slow" if isinstance(
                    e, asyncio.TimeoutError) else "dead")
                logger.warning("%s pull from %x failed (%s); trying next "
                               "source / recompute", reason, wid, e)
                continue
            if not pulled:
                # the source answered with nothing of the advertised run
                info["pull_failures"] += 1
                info["stale_adverts"] = info.get("stale_adverts", 0) + 1
                self._count("pull_outcomes", "stale_advert")
                self._report_suspect(wid)
                logger.warning("%s pull from %x returned nothing for %d "
                               "advertised blocks (stale advert)", reason,
                               wid, end - covered)
                continue
            attached = self.engine.attach_restored(probe, covered, pulled)
            covered += attached
            info["restored_blocks"] += attached
            if attached:
                self._count("pull_outcomes", "pulled")
                break
            self._count("pull_outcomes", "torn")
        return covered

    def _sources(self, plan: dict, covered: int, want: int) -> list:
        """The plan's pull sources other than this worker that hold more
        than ``covered`` blocks: longest usable run first, cheapest link
        on ties."""
        out = [(int(w), int(n), float(c))
               for w, n, c in (plan.get("sources") or [])
               if int(w) != (self.instance_id or -1) and int(n) > covered]
        out.sort(key=lambda t: (-min(t[1], want), t[2]))
        return out

    async def _restore_migrated(self, req, ctx) -> dict:
        """Execute a migrated request's restore plan: pull the recoverable
        prefix from the cheapest surviving source and attach it. Returns
        the outcome (also counted); never raises: the caller's generate
        recomputes whatever was not restored."""
        cfg = self.restore_config
        bs = self.engine.args.block_size
        t0 = time.time()
        info = {"outcome": "recomputed", "restored_blocks": 0,
                "local_blocks": 0, "pulls": 0, "pull_failures": 0,
                "reason": None}
        matchable = covered = 0
        slot = False
        try:
            if not cfg.enabled:
                info["reason"] = "disabled"
                return info
            probe = self.engine.restore_probe(req)
            if probe is None:
                info["reason"] = "unmatchable"
                return info
            hashes = probe.sequence_hashes()
            matchable = len(hashes)
            covered = self.engine.resident_prefix_blocks(probe)
            info["local_blocks"] = covered
            want = min(matchable, covered + max(0, cfg.max_blocks))
            sources = self._sources(req.restore or {}, covered, want)
            if covered >= matchable:
                return info
            if not sources or want - covered < cfg.min_blocks:
                info["reason"] = "no_sources"
                return info
            timeout = restore_pull_timeout(cfg.pull_timeout_cap_s,
                                           self._remaining_s(ctx))
            if timeout is None:
                info["reason"] = "deadline"
                return info
            # burst cap: a bounded wait for a slot beats recomputing at
            # once (the first restore of a shared prefix makes the rest
            # local hits), but a slot that never frees means recompute
            try:
                await asyncio.wait_for(self._restore_slots.acquire(),
                                       timeout=timeout)
            except asyncio.TimeoutError:
                info["reason"] = "budget"
                return info
            slot = True
            # a concurrent restore may have attached what we need
            covered = self.engine.resident_prefix_blocks(probe)
            info["local_blocks"] = covered
            if covered >= matchable:
                return info
            sources = [s for s in sources if s[1] > covered]
            want = min(matchable, covered + max(0, cfg.max_blocks))
            covered = await self._pull_from_sources(
                probe, hashes, sources, covered, want, cfg, ctx, info,
                reason="restore")
            return info
        except Exception:
            logger.exception("KV restore failed; recomputing")
            return info
        finally:
            if slot:
                self._restore_slots.release()
            if info["restored_blocks"] > 0 or info["local_blocks"] > 0:
                info["outcome"] = ("restored" if covered >= matchable
                                   else "partial")
            info["covered_blocks"] = covered
            info["recomputed_tokens"] = max(0, len(req.token_ids)
                                            - covered * bs)
            self._count("migration", info["outcome"])
            self._count("migration_blocks", "restored",
                        info["restored_blocks"])
            self._count("migration_tokens", "recomputed",
                        info["recomputed_tokens"])
            self._observe("migration_restore_seconds", time.time() - t0)

    async def _onboard_prefix(self, req, ctx) -> dict:
        """Execute the router's onboard plan: pull the prompt prefix this
        worker lacks from the cheapest peer holding it and attach it.
        Never raises; every failure degrades to the recompute. A plan's
        ``g4_blocks`` counts as not here (the port has no G4 tier)."""
        cfg = self.onboard_config
        bs = self.engine.args.block_size
        t0 = time.time()
        info = {"outcome": "recomputed", "restored_blocks": 0,
                "local_blocks": 0, "pulls": 0, "pull_failures": 0,
                "reason": None}
        matchable = covered = 0
        slot = False
        dedup_key = fut = None
        try:
            probe = self.engine.restore_probe(req)
            if probe is None:
                info["reason"] = "unmatchable"
                return info
            hashes = probe.sequence_hashes()
            matchable = len(hashes)
            covered = self.engine.resident_prefix_blocks(probe)
            info["local_blocks"] = covered
            if covered >= matchable:
                return info  # the plan was stale: the prefix is local
            want = min(matchable, covered + max(0, cfg.max_blocks))
            sources = self._sources(req.onboard or {}, covered, want)
            if not sources or want - covered < cfg.min_blocks:
                info["reason"] = "no_sources"
                return info
            timeout = restore_pull_timeout(cfg.pull_timeout_cap_s,
                                           self._remaining_s(ctx))
            if timeout is None:
                info["reason"] = "deadline"
                return info
            # a shared prefix arriving N-wide pulls ONCE: followers wait
            # for the first puller, then find the prefix local
            dedup_key = hashes[covered]
            holder = self._onboard_inflight.get(dedup_key)
            if holder is not None:
                try:
                    await asyncio.wait_for(asyncio.shield(holder), timeout)
                except Exception:
                    pass
                covered = self.engine.resident_prefix_blocks(probe)
                info["local_blocks"] = covered
                info["reason"] = "dedup"
                dedup_key = None
                return info
            fut = asyncio.get_running_loop().create_future()
            self._onboard_inflight[dedup_key] = fut
            try:
                await asyncio.wait_for(self._onboard_slots.acquire(),
                                       timeout=timeout)
            except asyncio.TimeoutError:
                info["reason"] = "budget"
                return info
            slot = True
            covered = max(covered, self.engine.resident_prefix_blocks(probe))
            info["local_blocks"] = covered
            if covered >= matchable:
                return info
            sources = [s for s in sources if s[1] > covered]
            want = min(matchable, covered + max(0, cfg.max_blocks))
            covered = await self._pull_from_sources(
                probe, hashes, sources, covered, want, cfg, ctx, info,
                reason="onboard")
            return info
        except Exception:
            logger.exception("prefix onboard failed; recomputing")
            return info
        finally:
            if slot:
                self._onboard_slots.release()
            if fut is not None:
                if self._onboard_inflight.get(dedup_key) is fut:
                    del self._onboard_inflight[dedup_key]
                if not fut.done():
                    fut.set_result(None)
            if info["restored_blocks"] > 0:
                info["outcome"] = "pulled"
            elif matchable > 0 and info["local_blocks"] >= matchable:
                info["outcome"] = "local"
            info["covered_blocks"] = covered
            info["recomputed_tokens"] = max(0, len(req.token_ids)
                                            - covered * bs)
            self._count("onboard", info["outcome"])
            self._count("onboard_blocks", "peer", info["restored_blocks"])
            self._observe("prefix_onboard_seconds", time.time() - t0)

    # ------------------------------------------------------- remote prefill

    async def _open_prefill_stream(self, preq, ctx):
        """The prefill stream: a queue claim, then (after a claim fallback)
        the nearest labelled instance, then round robin."""
        instance_id = None
        fallback_reason = None
        if self.prefill_queue is not None:
            instance_id = await self.prefill_queue.acquire(ctx)
            if instance_id is None:
                fallback_reason = "timeout"
            elif instance_id not in self.prefill_client.available_ids():
                logger.warning("claimed prefill instance %x not routable; "
                               "falling back to round robin", instance_id)
                instance_id = None
                fallback_reason = "unroutable"
        stream = None
        if instance_id is not None:
            try:
                stream = await self.prefill_client.generate(
                    preq.to_wire(), ctx=ctx, mode="direct",
                    instance_id=instance_id)
            except NoRespondersError:
                logger.warning("claimed prefill instance %x unreachable; "
                               "falling back to round robin", instance_id)
                fallback_reason = "unreachable"
        if stream is None and fallback_reason is not None:
            self._count("fallbacks", fallback_reason)
            near = self._nearest_prefill_instance()
            if near is not None:
                try:
                    stream = await self.prefill_client.generate(
                        preq.to_wire(), ctx=ctx, mode="direct",
                        instance_id=near)
                except NoRespondersError:
                    logger.warning("near prefill instance %x unreachable; "
                                   "falling back to round robin", near)
        if stream is None:
            stream = await self.prefill_client.generate(
                preq.to_wire(), ctx=ctx, mode="round_robin")
        return stream

    def _release(self, bundle, rec: dict) -> None:
        """Give a direct bundle back once its scatter completed, in a task
        of its own (a cancelled request still releases); its seconds add
        to the transfer record."""
        async def run():
            try:
                rec["release_s"] += await coro
            except Exception:
                logger.exception("direct KV release failed")

        coro = self.engine.direct_transfer.release(bundle)
        task = asyncio.get_running_loop().create_task(run())
        self._releases.add(task)
        task.add_done_callback(self._releases.discard)

    async def drain_releases(self) -> None:
        """Wait for the direct pulls' releases still under way."""
        if self._releases:
            await asyncio.gather(*list(self._releases),
                                 return_exceptions=True)

    async def _generate_disagg(self, req: PreprocessedRequest, ctx):
        caps = [KV_CHUNKS_ANNOTATION]
        if self.engine.args.kv_transfer_layer_groups > 1:
            caps.append(KV_LAYERS_ANNOTATION)
        direct_cap = self.engine.direct_capability()
        if direct_cap:
            caps.append(direct_cap)
        preq = dataclasses.replace(
            req, annotations=list(req.annotations or []) + caps)
        stream = await self._open_prefill_stream(preq, ctx)
        eng = self.engine
        mgr = eng.direct_transfer
        bs = eng.args.block_size
        total = (len(req.token_ids) + bs - 1) // bs
        ids = None  # decode-side blocks, allocated at the first frame
        placed = True  # False: recompute locally after draining the stream
        why = None  # the first reason placement failed
        next_block = 0
        presp = None
        owned = False  # ids not yet handed to a sequence
        # layer-slice assembly: blocks count as placed once every layer
        # of their slice landed
        lnext = 0
        lblocks = None
        # the link path (proc | ipc | host); each frame: (kind, bytes,
        # arrival, scatter s, pull s); release_s: the direct releases
        path = "host"
        rec = {"id": getattr(ctx, "id", None), "prompt": len(req.token_ids),
               "frames": [], "release_s": 0.0}
        t_xfer0 = time.time()

        async def place(bundle, start_layer=None) -> None:
            if isinstance(bundle, DirectKvBundle):
                k, v = bundle.k, bundle.v
            else:
                k, v = await eng.stage_bundle(bundle)
            eng.scatter_chunk(ids[bundle.start_block:
                                  bundle.start_block + bundle.num_blocks],
                              k, v, start_layer=start_layer)

        try:
            async for frame in stream:
                t_recv = time.time()
                direct = KvDirectFrame.is_wire(frame)
                chunk = KvChunkFrame.is_wire(frame)
                layer = KvLayerFrame.is_wire(frame)
                if not (chunk or layer or direct):
                    presp = PrefillResponse.from_wire(frame)
                    continue
                if not placed:
                    # keep draining (the last frame has the token); an
                    # offer that will not be pulled is dropped now
                    if direct and mgr is not None:
                        mgr.retract(KvDirectFrame.from_wire(frame).desc)
                    continue
                pull_s = 0.0
                if direct:
                    df = KvDirectFrame.from_wire(frame)
                    try:
                        if mgr is None:
                            raise RuntimeError("direct KV frame on a worker "
                                               "with kv_transfer_direct off")
                        ch = pull_bundle(mgr, df)
                    except Exception:
                        logger.exception("direct KV pull failed; the "
                                         "prompt is recomputed locally")
                        if mgr is not None:
                            mgr.retract(df.desc)
                        self._count("direct_pull_failures", "pull")
                        placed, why = False, "direct_pull"
                        continue
                    pull_s = time.time() - t_recv
                    path = df.desc.get("mode") or path
                    layer = ch.total_layers is not None
                else:
                    ch = (KvLayerFrame.from_wire(frame) if layer
                          else KvChunkFrame.from_wire(frame)).bundle
                n = ch.num_blocks
                tl = ch.total_layers
                try:
                    if (not eng.check_bundle_dims(ch)
                            or ch.start_block + n > total):
                        placed, why = False, "bundle_dims"
                        continue
                    if tl is None:
                        # full depth: extends the contiguous range, and
                        # never interleaves a torn layer assembly
                        if ch.start_block != next_block or lnext != 0:
                            placed, why = False, "torn"
                            continue
                    elif (ch.start_block != next_block
                            or ch.start_layer != lnext
                            or (lblocks is not None and lblocks != n)):
                        placed, why = False, "torn"
                        continue
                    if ids is None:
                        ids = eng.alloc_inject(total)
                        if ids is None:
                            placed, why = False, "no_blocks"
                            continue
                        owned = True
                    try:
                        if tl is None:
                            await place(ch)
                            next_block += n
                        else:
                            await place(ch, start_layer=ch.start_layer)
                            lnext += ch.k.shape[0]
                            lblocks = n
                            if lnext >= tl:  # every layer landed
                                next_block += n
                                lnext, lblocks = 0, None
                    except Exception:
                        logger.exception("KV chunk scatter failed")
                        placed, why = False, "scatter"
                        continue
                    rec["frames"].append(("layer" if layer else "chunk",
                                          ch.nbytes, t_recv,
                                          time.time() - t_recv - pull_s,
                                          pull_s))
                finally:
                    if direct:
                        self._release(ch, rec)
            if presp is None:
                raise RuntimeError("prefill worker returned no response")
            t_recv = time.time()
            tail = presp.bundle
            if presp.token_id < 0:
                placed, why = False, why or "prefill_failed"
            if placed and ids is None and tail is not None:
                # no chunk frames: the whole bundle comes with the response
                if (tail.start_block == 0 and eng.check_bundle_dims(tail)
                        and tail.num_blocks == total):
                    ids = eng.alloc_inject(total)
                    owned = ids is not None
                    if ids is None:
                        placed, why = False, "no_blocks"
                else:
                    placed, why = False, "bundle_dims"
            if placed and tail is not None:
                n = tail.num_blocks
                if (eng.check_bundle_dims(tail)
                        and tail.start_block == next_block
                        and tail.start_block + n <= total):
                    try:
                        await place(tail)
                        next_block += n
                        rec["frames"].append(("tail", tail.nbytes, t_recv,
                                              time.time() - t_recv, 0.0))
                    except Exception:
                        logger.exception("KV tail scatter failed")
                        placed, why = False, "scatter"
                else:
                    placed, why = False, "torn"
            if placed and next_block < total:
                placed, why = False, "incomplete"
            rec.update(placed=placed, path=path,
                       stream_s=time.time() - t_xfer0)
            self.transfers.append(rec)
            self._count("transfer_paths", path)
            self._count("transfer_bytes", path,
                        sum(f[1] for f in rec["frames"]))
            self._observe("kv_transfer_seconds", rec["stream_s"], path=path)
            if not placed:
                # the documented degradation, counted: recompute locally
                self._count("fallbacks", f"recompute_{why}")
                if owned:
                    owned = False
                    eng.release_inject(ids)
                async for out in self._local(req, ctx):
                    yield out
                return
            self._count("remote_prefills", "placed")
            # the bytes the blocks hold, held against the prefill worker's
            rec["digest"] = eng.blocks_digest(ids)
            owned = False  # ownership passes to the sequence
            async for out in eng.generate_prefilled(req, presp.token_id,
                                                    presp.logprob, ids, ctx):
                yield out.to_wire()
        finally:
            # an exception or a cancellation after alloc_inject never
            # leaks the injected blocks
            if owned and ids is not None:
                eng.release_inject(ids)
