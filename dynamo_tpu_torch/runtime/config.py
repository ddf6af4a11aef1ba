"""Typed, layered runtime configuration (``DYN_*``), the port's copy of
``dynamo_tpu/runtime/config.py``:

1. dataclass defaults,
2. an optional config file (``DYN_CONFIG_FILE``: TOML or JSON),
3. ``DYN_<FIELD>`` environment variables (highest precedence).

Values are coerced to the field's declared type; a bad value or an unknown
key in the config file raises :class:`ConfigError` naming the offender.
The environment surface is the JAX package's (``DYN_CONTROL_PLANE``,
``DYN_LEASE_TTL``, ``DYN_NAMESPACE``, ``DYN_REQUEST_TIMEOUT``,
``DYN_SYSTEM_PORT``, ``DYN_LOG``, ``DYN_LOGGING_JSONL``,
``DYN_WORKER_MAX_INFLIGHT``, ``DYN_DRAIN_TIMEOUT``, ...); the runtime
refuses the ones the port does not serve yet (``DYN_SYSTEM_PORT``: the
system status server, ROADMAP A12).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import typing
from dataclasses import dataclass
from typing import Optional


class ConfigError(Exception):
    """A configuration value failed validation; message names the field."""


_TRUTHY = {"1", "true", "yes", "on"}
_FALSY = {"0", "false", "no", "off", ""}


def _coerce(name: str, value, typ):
    """Coerce ``value`` (often a string from the env) to ``typ``."""
    origin = typing.get_origin(typ)
    if origin is typing.Union:  # Optional[T]
        args = [a for a in typing.get_args(typ) if a is not type(None)]
        if value is None:
            return None
        return _coerce(name, value, args[0])
    if value is None:  # null for a non-Optional field: fail loudly
        raise ConfigError(f"config field '{name}': null is not allowed")
    try:
        if typ is bool:
            if isinstance(value, bool):
                return value
            s = str(value).strip().lower()
            if s in _TRUTHY:
                return True
            if s in _FALSY:
                return False
            raise ValueError(f"not a boolean: {value!r}")
        if typ is int:
            return int(str(value).strip())
        if typ is float:
            return float(str(value).strip())
        if typ is str:
            return str(value)
    except (TypeError, ValueError) as e:
        raise ConfigError(f"config field '{name}': {e}") from None
    return value


@dataclass
class RuntimeConfig:
    """Process-wide runtime knobs (ref: config.rs RuntimeConfig)."""

    #: dynctl address (host:port); None = in-process control plane
    control_plane_address: Optional[str] = None
    #: primary lease TTL seconds; instances vanish this long after a crash
    lease_ttl: float = 10.0
    namespace: str = "dynamo"
    #: request-plane ack timeout (seconds)
    request_timeout: float = 10.0
    #: canary health-check cadence (seconds) and failure threshold
    health_check_interval: float = 30.0
    health_check_failures: int = 3
    #: system status server port (0 = disabled)
    system_port: int = 0
    #: KV-load fraction above which routing skips a worker (WorkerMonitor);
    #: None = load monitoring off (ref: worker_monitor.rs busy_threshold)
    busy_threshold: Optional[float] = None
    #: default end-to-end request deadline (seconds) applied by the frontend
    #: when the client sends no ``X-Request-Timeout-Ms``; None = no deadline
    request_deadline: Optional[float] = None
    #: frontend admission: max concurrent in-flight HTTP LLM requests
    #: (0 = unbounded); excess gets 429 + Retry-After
    max_inflight: int = 0
    #: frontend admission: max in-flight requests PER MODEL (0 = unbounded)
    max_queue: int = 0
    #: worker admission: max concurrent requests per served endpoint
    #: (0 = unbounded); excess is rejected with a terminal "overloaded"
    #: stream error so Migration does not burn its budget on a full fleet
    worker_max_inflight: int = 0
    #: consecutive transport failures that OPEN a client's per-instance
    #: circuit breaker (canary success half-closes it; a real success closes)
    circuit_threshold: int = 3
    #: graceful SIGTERM drain bound (seconds): in-flight streams get this
    #: long to finish before shutdown forces them
    drain_timeout: float = 30.0
    #: proactive death handling (docs/robustness.md): after an instance's
    #: discovery key is deleted, a live stream from it is failed RETRYABLY
    #: once it has produced no frames for this long. The grace window is
    #: what distinguishes a gracefully-DRAINING worker (deregisters first,
    #: keeps streaming until done — its streams must not be broken) from a
    #: lease-expired corpse (streams silent since death). 0 = break
    #: immediately on the delete event.
    worker_lost_grace: float = 5.0

    def __post_init__(self):
        if self.busy_threshold is not None and not 0 < self.busy_threshold <= 1:
            raise ConfigError(
                "config field 'busy_threshold': must be in (0, 1]")
        if self.lease_ttl <= 0:
            raise ConfigError("config field 'lease_ttl': must be > 0")
        if self.request_timeout <= 0:
            raise ConfigError("config field 'request_timeout': must be > 0")
        if self.health_check_failures < 1:
            raise ConfigError(
                "config field 'health_check_failures': must be >= 1")
        if self.health_check_interval <= 0:
            raise ConfigError(
                "config field 'health_check_interval': must be > 0")
        if not self.namespace:
            raise ConfigError("config field 'namespace': must be non-empty")
        if self.request_deadline is not None and self.request_deadline <= 0:
            raise ConfigError(
                "config field 'request_deadline': must be > 0")
        for fname in ("max_inflight", "max_queue", "worker_max_inflight"):
            if getattr(self, fname) < 0:
                raise ConfigError(f"config field '{fname}': must be >= 0")
        if self.circuit_threshold < 1:
            raise ConfigError(
                "config field 'circuit_threshold': must be >= 1")
        if self.drain_timeout <= 0:
            raise ConfigError("config field 'drain_timeout': must be > 0")
        if self.worker_lost_grace < 0:
            raise ConfigError(
                "config field 'worker_lost_grace': must be >= 0")

    # -- layered loading -----------------------------------------------------

    #: field name → env var (control_plane_address keeps its historical name)
    _ENV_OVERRIDES = {
        "control_plane_address": "DYN_CONTROL_PLANE",
        "health_check_interval": "DYN_HEALTH_CHECK_INTERVAL",
        "health_check_failures": "DYN_HEALTH_CHECK_FAILURES",
        "busy_threshold": "DYN_BUSY_THRESHOLD",
    }

    @classmethod
    def load(cls, config_file: Optional[str] = None,
             env: Optional[dict] = None) -> "RuntimeConfig":
        """defaults < config file < DYN_* env (highest wins)."""
        env = os.environ if env is None else env
        # `from __future__ import annotations` stringifies field.type;
        # resolve the real types for coercion
        hints = typing.get_type_hints(cls)
        fields = {f.name: f for f in dataclasses.fields(cls)
                  if not f.name.startswith("_")}
        values: dict = {}

        path = config_file or env.get("DYN_CONFIG_FILE")
        if path:
            file_vals = cls._read_file(path)
            unknown = set(file_vals) - set(fields)
            if unknown:
                raise ConfigError(
                    f"unknown config key(s) in {path}: {sorted(unknown)}")
            values.update(file_vals)

        for name, f in fields.items():
            var = cls._ENV_OVERRIDES.get(name, f"DYN_{name.upper()}")
            if var in env:
                values[name] = env[var]

        coerced = {
            name: _coerce(name, values[name], hints[name])
            for name in values
        }
        return cls(**coerced)

    @staticmethod
    def _read_file(path: str) -> dict:
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError as e:
            raise ConfigError(f"cannot read config file {path}: {e}") from None
        text = raw.decode()
        if path.endswith(".json"):
            try:
                return json.loads(text)
            except json.JSONDecodeError as e:
                raise ConfigError(f"bad JSON in {path}: {e}") from None
        try:
            try:
                import tomllib  # 3.11+
            except ModuleNotFoundError:
                import tomli as tomllib  # 3.10 fallback

            return tomllib.loads(text)
        except Exception as e:
            raise ConfigError(f"bad TOML in {path}: {e}") from None

    @staticmethod
    def from_env() -> "RuntimeConfig":
        return RuntimeConfig.load()


_LOGGING_CONFIGURED = False


def setup_logging():
    global _LOGGING_CONFIGURED
    if _LOGGING_CONFIGURED:
        return
    _LOGGING_CONFIGURED = True
    level = os.environ.get("DYN_LOG", "info").upper()
    if os.environ.get("DYN_LOGGING_JSONL"):
        fmt = ('{"ts":"%(asctime)s","level":"%(levelname)s",'
               '"target":"%(name)s","rid":"%(rid)s","msg":"%(message)s"}')
    else:
        fmt = "%(asctime)s %(levelname)-7s %(name)s [%(rid)s]: %(message)s"
    logging.basicConfig(level=getattr(logging, level, logging.INFO), format=fmt)

    # every record carries the current request id (trace correlation across
    # frontend and worker processes — ref: logging.rs:150-215)
    class _RidFilter(logging.Filter):
        def filter(self, record):
            from dynamo_tpu_torch.runtime.context import CURRENT_REQUEST

            ctx = CURRENT_REQUEST.get()
            record.rid = ctx.id[:16] if ctx is not None else "-"
            return True

    for h in logging.getLogger().handlers:
        h.addFilter(_RidFilter())
