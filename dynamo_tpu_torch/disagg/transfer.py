"""KV pulls between workers: the port's copy of the pull budgets and the
pull client of ``dynamo_tpu/disagg/transfer.py``.

A worker rebuilding a migrated stream (``restore``) or onboarding a hot
prefix at admission (``onboard``) pulls blocks by sequence hash from a
peer's ``kv_pull`` endpoint (``handlers.KvPullHandler``) and attaches
them through its prefix cache. Every failure degrades to recompute with
exact token accounting. The direct device-to-device transfer of the JAX
module (``DirectTransferManager``, ``KvDirectFrame``) waits for ROADMAP
A8d: the port moves KV host-staged only.
"""

from __future__ import annotations

import asyncio
import os
from dataclasses import dataclass
from typing import Optional


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
