"""Direct device-to-device KV transfer and KV pulls between workers: the
port's copy of ``dynamo_tpu/disagg/transfer.py``.

The host-staged KvBundle path (``protocols.py``) copies every page through
host memory and the response plane's msgpack. When the prefill and the
decode worker can reach each other's device memory, only a descriptor
rides the response plane and the pages move device to device, as the
reference moves them with NIXL:

1. ``"proc"``: both engines in one process. The gathered tensors move by
   reference through an in-process offer registry. A gather's output is a
   fresh tensor that no later step writes.
2. ``"ipc"``: two processes on one card (the port's counterpart of the JAX
   module's ``"ici"``). The prefill worker exports the gathered tensors as
   CUDA IPC handles (``disagg/ipc.py``); the decode worker maps them, its
   stream waits for the producer's gather, its scatter reads the mapped
   memory, and once that read completed it lets the mapping go and marks
   the offer released on a release board (a small file both processes
   map). The producer frees an offer when it is released, when the
   decode side retracts it unread, or after the TTL.
3. anything else, a JAX peer included: the caller keeps the host-staged
   path.

The decode worker advertises ``kv_direct:<proc>@<device uuid>/cuda`` (the
JAX format ``kv_direct:<proc>/<platform>``; on the CPU ``kv_direct:<proc>
/cpu``); the prefill worker compares it with its own identity. A JAX
worker never matches platform ``cuda`` and the port's process token is
its own, so a torch worker paired with a JAX worker stays host-staged in
either role. A failed pull degrades to local recompute on the decode
side. Peer-to-peer between cards waits for ROADMAP A11; the JAX
``kv.direct_pull`` span and its chaos hook wait for A12a and A12b.

A worker rebuilding a migrated stream (``restore``) or onboarding a hot
prefix at admission (``onboard``) pulls blocks by sequence hash from a
peer's ``kv_pull`` endpoint (``handlers.KvPullHandler``) and attaches
them through its prefix cache. Every failure degrades to recompute with
exact token accounting.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import mmap
import os
import socket
import tempfile
import threading
import time
import uuid as _uuidlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from dynamo_tpu_torch.disagg.protocols import dtype_name

logger = logging.getLogger("dynamo_torch.disagg.transfer")

#: annotation prefix by which a decode worker advertises direct-pull reach
KV_DIRECT_ANNOTATION = "kv_direct"

_proc_token: Optional[str] = None
_uuid_counter = itertools.count(1)
# below 2**56: the descriptor's msgpack carries it as a uint64
_uuid_base = int.from_bytes(os.urandom(4), "big") << 24

# in-process offer registry ("proc"), shared by every engine of the
# process: uid -> (expiry, tensors, id of the offering manager)
_offers: dict[int, tuple[float, list, int]] = {}
_offers_lock = threading.Lock()

#: release-board slot states ("ipc" offers)
FREE, OFFERED, CLAIMED, RELEASED, REVOKED = range(5)
#: "ipc" offers outstanding at once, at most (16 bytes a slot)
BOARD_SLOTS = 1 << 16
#: seconds an offer revoked unclaimed (past its TTL, or its stream ended
#: early) stays mapped for a pull already under way
GRACE_S = 5.0


def proc_token() -> str:
    """This process's identity for same-process detection: hostname, pid
    and a random suffix (pid reuse across worker restarts). The port's
    own: it differs from the JAX module's token in the same process."""
    global _proc_token
    if _proc_token is None:
        _proc_token = (f"{socket.gethostname()}:{os.getpid()}:"
                       f"{_uuidlib.uuid4().hex[:8]}")
    return _proc_token


def _host(token: str) -> str:
    return token.rsplit(":", 2)[0]


def _sweep_locked(now: float) -> None:
    dead = [u for u, (exp, _, _) in _offers.items() if exp < now]
    for u in dead:
        del _offers[u]
    if dead:
        logger.warning("evicted %d expired direct-KV offers (the decode "
                       "side never pulled them)", len(dead))


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class _Board:
    """Release board: (uid, state) int64 pairs, one a slot, in a file that
    the producing and the consuming process both map. The producer writes
    OFFERED and REVOKED, the consumer CLAIMED and RELEASED."""

    def __init__(self, path: str, slots: Optional[int] = None):
        """Creates the file with ``slots`` slots, or maps an existing one
        (``slots`` None)."""
        fd = (os.open(path, os.O_RDWR) if slots is None else
              os.open(path, os.O_RDWR | os.O_CREAT | os.O_EXCL, 0o600))
        try:
            if slots is not None:
                os.ftruncate(fd, slots * 16)
            self._mm = mmap.mmap(fd, 0)
        finally:
            os.close(fd)
        self.words = np.frombuffer(self._mm, np.int64).reshape(-1, 2)
        self.path = path

    def state(self, slot: int, uid: int) -> int:
        """The slot's state while it holds offer ``uid``, else FREE."""
        u, st = self.words[slot]
        return int(st) if int(u) == uid else FREE

    def set(self, slot: int, state: int) -> None:
        self.words[slot, 1] = state

    def close(self) -> None:
        del self.words
        self._mm.close()


@dataclass
class _Offer:
    """A live "ipc" offer on the producer: the exported tensors and their
    ready event stay referenced until the offer is freed."""

    tensors: list
    ready: object
    slot: int
    expiry: float
    revoked: Optional[float] = None


@dataclass
class _Lease:
    """What one "ipc" pull holds on the consumer until its release."""

    board: _Board
    slot: int
    uid: int
    held: list


class DirectTransferManager:
    """One an engine: direct KV transfer offers (prefill side) and pulls
    (decode side). The "proc" registry is process-global, so a decode
    engine finds a co-located prefill engine's offer whichever manager
    made it. ``ipc`` is the CUDA IPC layer (``disagg/ipc.py``), made for a
    CUDA ``device``; tests hand in a same-process stand-in. ``token``
    replaces this process's token (tests stand for another process)."""

    def __init__(self, ttl_s: float = 60.0, device=None, ipc=None,
                 token: Optional[str] = None):
        self.ttl_s = ttl_s
        self.grace_s = GRACE_S
        self.device = torch.device(device if device is not None else "cpu")
        if ipc is None and self.device.type == "cuda":
            from dynamo_tpu_torch.disagg.ipc import CudaIpc

            ipc = CudaIpc(self.device)
        self.ipc = ipc
        self.token = token or proc_token()
        self.stats = {"offers": 0, "pulls": 0, "pull_failures": 0}
        self._live: dict[int, _Offer] = {}
        self._board: Optional[_Board] = None
        self._free_slots: list[int] = []
        self._boards: dict[str, _Board] = {}  # consumer side, by path

    # ------------------------------------------------------------ capability

    def _platform(self) -> str:
        return self.ipc.platform if self.ipc is not None else self.device.type

    def capability(self) -> str:
        """What a decode worker advertises in request annotations."""
        proc = self.token
        if self.ipc is not None:
            proc += "@" + self.ipc.device_uuid()
        return f"{KV_DIRECT_ANNOTATION}:{proc}/{self._platform()}"

    @staticmethod
    def parse_capability(annotations) -> Optional[tuple[str, str]]:
        """(proc, platform) from a request's annotations, or None."""
        for a in annotations or []:
            if isinstance(a, str) and a.startswith(KV_DIRECT_ANNOTATION + ":"):
                body = a.split(":", 1)[1]
                if "/" in body:
                    proc, platform = body.rsplit("/", 1)
                    return proc, platform
        return None

    def choose_mode(self, annotations) -> Optional[str]:
        """Prefill-side path selection: "proc" (same process), "ipc" (same
        host, same card, both ends CUDA) or None (host-staged). A wrong
        direct choice costs the decode side a recompute, so only offer
        what can be pulled."""
        cap = self.parse_capability(annotations)
        if cap is None:
            return None
        peer, platform = cap
        token, _, uuid = peer.partition("@")
        if token == self.token:
            return "proc"
        if (platform == "cuda" and self._platform() == "cuda" and uuid
                and _host(token) == _host(self.token)
                and uuid == self.ipc.device_uuid()
                and self.ipc.exportable()):
            return "ipc"
        return None

    # ----------------------------------------------------------- prefill side

    def ready(self, mode: Optional[str]):
        """Called right after a gather is enqueued: for "ipc", an
        interprocess event behind it, which the consumer's stream waits
        for; else None."""
        return self.ipc.ready_event() if mode == "ipc" else None

    def offer(self, mode: str, arrays: list, meta: dict,
              ready=None) -> dict:
        """Register tensors for a pull; returns the wire descriptor.
        ``meta`` carries num_tokens, n, block_size, start_block (and a
        layer slice's start_layer, total_layers); ``ready`` is
        :meth:`ready`'s event of the gather that made ``arrays``."""
        uid = _uuid_base + next(_uuid_counter)
        now = time.monotonic()
        desc = {
            "mode": mode,
            "proc": self.token,
            "uuid": uid,
            "arrays": [{"shape": list(x.shape), "dtype": dtype_name(x)}
                       for x in arrays],
            **meta,
        }
        if mode == "proc":
            with _offers_lock:
                _sweep_locked(now)
                _offers[uid] = (now + self.ttl_s, arrays, id(self))
        elif mode == "ipc":
            self._sweep(now)
            board = self._producer_board()
            if not self._free_slots:
                raise RuntimeError(f"{BOARD_SLOTS} direct-KV offers "
                                   "outstanding: the release board is full")
            slot = self._free_slots.pop()
            desc.update(self.ipc.export(arrays, ready))
            desc["board"], desc["slot"] = board.path, slot
            board.words[slot] = (uid, OFFERED)
            self._live[uid] = _Offer(arrays, ready, slot, now + self.ttl_s)
        else:
            raise ValueError(f"unknown transfer mode {mode!r}")
        self.stats["offers"] += 1
        return desc

    def _producer_board(self) -> _Board:
        if self._board is None:
            path = os.path.join(tempfile.gettempdir(),
                                f"dyn-kv-offers-{os.getpid()}-"
                                f"{_uuidlib.uuid4().hex[:8]}")
            self._board = _Board(path, BOARD_SLOTS)
            self._free_slots = list(range(BOARD_SLOTS - 1, -1, -1))
        return self._board

    def _free(self, uid: int) -> None:
        o = self._live.pop(uid)
        self._board.set(o.slot, FREE)
        self._free_slots.append(o.slot)

    def _sweep(self, now: float) -> None:
        """Free the "ipc" offers that were released, revoke those past
        their TTL unclaimed, and free revoked ones after the grace (or a
        claimed one never released after twice the TTL: its puller died).
        Runs on every registry touch."""
        for uid, o in list(self._live.items()):
            st = self._board.state(o.slot, uid)
            if st == RELEASED:
                self._free(uid)
            elif st == OFFERED and now > o.expiry:
                self._board.set(o.slot, REVOKED)
                o.revoked = now
                logger.warning("direct-KV offer %d expired unpulled", uid)
            elif st == REVOKED and now > (o.revoked or now) + self.grace_s:
                self._free(uid)
            elif st == CLAIMED and now > o.expiry + self.ttl_s:
                logger.warning("direct-KV offer %d claimed and never "
                               "released: freed", uid)
                self._free(uid)

    def retract(self, desc: dict) -> None:
        """Drop an offer that will not be pulled. On the decode side (an
        "ipc" offer of another process) the offer is marked released
        unread and its producer frees it at its next sweep; on the
        producer (its stream ended early) an unclaimed offer is revoked
        and freed after the grace; a "proc" offer leaves the registry."""
        now = time.monotonic()
        mode = desc.get("mode")
        if mode == "proc":
            with _offers_lock:
                _offers.pop(desc["uuid"], None)
                _sweep_locked(now)
        elif mode == "ipc":
            uid = desc["uuid"]
            if desc.get("proc") == self.token:
                o = self._live.get(uid)
                if (o is not None
                        and self._board.state(o.slot, uid) == OFFERED):
                    self._board.set(o.slot, REVOKED)
                    o.revoked = now
                self._sweep(now)
            else:
                board = self._consumer_board(desc["board"])
                if board.state(desc["slot"], uid) == OFFERED:
                    board.set(desc["slot"], RELEASED)

    def outstanding(self) -> int:
        """Offers of this manager not freed yet (after a sweep)."""
        now = time.monotonic()
        if self._live:
            self._sweep(now)
        with _offers_lock:
            _sweep_locked(now)
            proc = sum(o == id(self) for _e, _a, o in _offers.values())
        return proc + len(self._live)

    def held_bytes(self) -> int:
        """Bytes of the tensors this manager's outstanding offers hold."""
        with _offers_lock:
            proc = sum(_nbytes(a) for _e, a, o in _offers.values()
                       if o == id(self))
        return proc + sum(_nbytes(o.tensors) for o in self._live.values())

    # ------------------------------------------------------------ decode side

    def _consumer_board(self, path: str) -> _Board:
        b = self._boards.get(path)
        if b is None:
            b = self._boards[path] = _Board(path)
        return b

    def pull(self, desc: dict) -> tuple[list, Optional[_Lease]]:
        """The offered tensors on this engine's device and, for "ipc", the
        lease that :meth:`release` gives back once they were read. Raises
        on any failure (the caller recomputes locally)."""
        try:
            out = self._pull(desc)
            self.stats["pulls"] += 1
            return out
        except Exception:
            self.stats["pull_failures"] += 1
            raise

    def _pull(self, desc: dict) -> tuple[list, Optional[_Lease]]:
        mode = desc.get("mode")
        if mode == "proc":
            if desc.get("proc") != self.token:
                raise RuntimeError("same-process KV descriptor from another "
                                   "process (capability skew)")
            with _offers_lock:
                entry = _offers.pop(desc["uuid"], None)
                _sweep_locked(time.monotonic())
            if entry is None:
                raise RuntimeError(f"direct KV offer {desc['uuid']} expired "
                                   "or already claimed")
            return entry[1], None
        if mode == "ipc":
            if self.ipc is None or desc.get("device") != \
                    self.ipc.device_uuid():
                raise RuntimeError("CUDA IPC descriptor for another device")
            board = self._consumer_board(desc["board"])
            uid, slot = desc["uuid"], desc["slot"]
            st = board.state(slot, uid)
            if st != OFFERED:
                raise RuntimeError(f"direct KV offer {uid} not on offer "
                                   f"(state {st}): expired, revoked or "
                                   "claimed")
            board.set(slot, CLAIMED)
            try:
                tensors, held = self.ipc.open(desc)
            except BaseException:
                board.set(slot, RELEASED)
                raise
            return tensors, _Lease(board, slot, uid, held)
        raise RuntimeError(f"unknown transfer mode {mode!r}")

    def release(self, bundle: "DirectKvBundle"):
        """Give a pulled bundle back once the work enqueued on its tensors
        (the scatter) completed: records that point on the current stream
        now, and returns a coroutine that waits for it off the event loop,
        drops the mappings and marks the offer released; it returns its
        seconds. A "proc" bundle holds nothing."""
        lease, bundle.lease = bundle.lease, None
        bundle.k = bundle.v = None
        done = None
        if lease is not None and self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return self._finish_release(lease, done)

    async def _finish_release(self, lease: Optional[_Lease], done) -> float:
        t0 = time.perf_counter()
        if lease is None:
            return 0.0
        try:
            if done is not None:
                await asyncio.to_thread(done.synchronize)
            self.ipc.release(lease.held)
        finally:
            if lease.board.state(lease.slot, lease.uid) == CLAIMED:
                lease.board.set(lease.slot, RELEASED)
        return time.perf_counter() - t0

    def close(self) -> None:
        """Free every offer and unmap the boards (the engine is closing)."""
        with _offers_lock:
            for u in [u for u, (_e, _a, o) in _offers.items()
                      if o == id(self)]:
                del _offers[u]
        self._live.clear()
        for b in self._boards.values():
            b.close()
        self._boards.clear()
        if self._board is not None:
            self._board.close()
            try:
                os.unlink(self._board.path)
            except OSError:
                pass
            self._board = None


# ------------------------------------------------------------------- wire

class KvDirectFrame:
    """Response-plane frame carrying a direct-transfer descriptor instead of
    page bytes, at a KvChunkFrame's or a KvLayerFrame's place in the
    stream: ``{"kv_direct": desc}``, the JAX module's wire."""

    def __init__(self, desc: dict):
        self.desc = desc

    def to_wire(self) -> dict:
        return {"kv_direct": self.desc}

    @staticmethod
    def is_wire(d: dict) -> bool:
        return isinstance(d, dict) and "kv_direct" in d

    @staticmethod
    def from_wire(d: dict) -> "KvDirectFrame":
        return KvDirectFrame(d["kv_direct"])


class DirectKvBundle:
    """KvBundle-shaped view over pulled device tensors, so the decode
    handler's checks and scatter treat both transports alike. ``lease``
    (an "ipc" pull) goes back through ``DirectTransferManager.release``
    once the scatter was enqueued."""

    def __init__(self, k, v, num_tokens: int, block_size: int,
                 start_block: int, num_blocks: int, start_layer: int = 0,
                 total_layers=None, lease=None):
        self.k = k
        self.v = v
        self.num_tokens = num_tokens
        self.block_size = block_size
        self.start_block = start_block
        self.num_blocks = num_blocks
        # a layer slice: layers [start_layer, start_layer + k.shape[0]) of
        # a total_layers-deep cache
        self.start_layer = start_layer
        self.total_layers = total_layers
        self.lease = lease
        self.nbytes = _nbytes((k, v))


def pull_bundle(mgr: DirectTransferManager, frame: KvDirectFrame
                ) -> DirectKvBundle:
    d = frame.desc
    (k, v), lease = mgr.pull(d)
    return DirectKvBundle(k=k, v=v, num_tokens=d["num_tokens"],
                          block_size=d["block_size"],
                          start_block=d.get("start_block", 0),
                          num_blocks=d.get("n", k.shape[1]),
                          start_layer=d.get("start_layer", 0),
                          total_layers=d.get("total_layers"), lease=lease)


# ------------------------------------------------------- KV-restore pulls


@dataclass
class RestoreConfig:
    """Worker-side KV-restore policy (``DYN_RESTORE_*`` env).

    ``pull_timeout_cap_s`` bounds ONE pull attempt; the effective timeout
    is also clamped to half the request's remaining deadline
    (:func:`restore_pull_timeout`). ``max_blocks`` / ``max_concurrent``
    cap the restore burst a worker absorbs."""

    enabled: bool = True
    pull_timeout_cap_s: float = 5.0
    max_blocks: int = 4096
    max_concurrent: int = 2
    #: restores recovering fewer blocks than this are not worth a network
    #: round trip: recompute instead
    min_blocks: int = 1

    @classmethod
    def from_env(cls, env=None) -> "RestoreConfig":
        env = os.environ if env is None else env
        _f = _env_caster(env)
        return cls(
            enabled=env.get("DYN_RESTORE", "1") not in ("0", "false", "off"),
            pull_timeout_cap_s=_f("DYN_RESTORE_PULL_TIMEOUT", 5.0, float),
            max_blocks=_f("DYN_RESTORE_MAX_BLOCKS", 4096, int),
            max_concurrent=_f("DYN_RESTORE_MAX_CONCURRENT", 2, int),
            min_blocks=_f("DYN_RESTORE_MIN_BLOCKS", 1, int),
        )


def _env_caster(env):
    def _f(key, default, cast):
        raw = env.get(key)
        if raw is None or raw == "":
            return default
        try:
            return cast(raw)
        except ValueError:
            raise ValueError(f"bad {key}={raw!r}") from None

    return _f


@dataclass
class OnboardConfig:
    """Routine prefix onboarding policy (``DYN_ONBOARD_*`` env): the
    admission-path twin of :class:`RestoreConfig` with its own concurrency
    budget, so onboard pulls never starve crash-restore pulls (or the
    reverse). Its pull cap is lower: a miss costs one recompute."""

    enabled: bool = True
    pull_timeout_cap_s: float = 2.0
    max_blocks: int = 4096
    max_concurrent: int = 2
    min_blocks: int = 1

    @classmethod
    def from_env(cls, env=None) -> "OnboardConfig":
        env = os.environ if env is None else env
        _f = _env_caster(env)
        return cls(
            enabled=env.get("DYN_ONBOARD", "1") not in ("0", "false", "off"),
            pull_timeout_cap_s=_f("DYN_ONBOARD_PULL_TIMEOUT", 2.0, float),
            max_blocks=_f("DYN_ONBOARD_MAX_BLOCKS", 4096, int),
            max_concurrent=_f("DYN_ONBOARD_MAX_CONCURRENT", 2, int),
            min_blocks=_f("DYN_ONBOARD_MIN_BLOCKS", 1, int),
        )


def restore_pull_timeout(cap_s: float,
                         remaining_s: Optional[float]) -> Optional[float]:
    """Timeout of one pull: ``min(cap, remaining / 2)``, so a timed-out
    pull leaves the other half of the budget to the recompute. None when
    the budget is too thin to risk a pull."""
    if remaining_s is None:
        return cap_s
    if remaining_s <= 0.05:
        return None
    t = min(cap_s, remaining_s / 2.0)
    return t if t > 0 else None


async def pull_restore_blocks(client, instance_id: int, hashes: list[int],
                              timeout_s: float,
                              reason: str = "restore") -> list:
    """Pull a contiguous run of KV blocks from ``instance_id``'s
    ``kv_pull`` endpoint: ordered [(seq_hash, k, v), ...], the longest
    leading run the peer could serve (possibly short, never reordered).
    Raises on transport failure or timeout (the caller recomputes).
    ``reason`` ("restore" | "onboard") picks the serving peer's budget."""
    from dynamo_tpu_torch.kvbm.distributed import _unpack_block

    stream = await client.generate(
        {"hashes": list(hashes), "reason": reason},
        mode="direct", instance_id=instance_id)

    async def consume():
        out = []
        async for frame in stream:
            if not isinstance(frame, dict) or "hash" not in frame:
                continue
            out.append(_unpack_block(frame))
        return out

    try:
        return await asyncio.wait_for(consume(), timeout=timeout_s)
    except (asyncio.TimeoutError, asyncio.CancelledError):
        # tell the serving peer to stop gathering into a dead stream
        try:
            await stream.cancel()
        except Exception:
            pass
        raise
