"""Multi-tenant QoS: priority classes and the fair-share policy the engine
scheduler reads — the port's copy of the part of ``dynamo_tpu/qos`` that
the scheduler needs.

Knobs (read by :meth:`QosConfig.load`, same spelling as the JAX package):

- ``DYN_QOS_WEIGHTS`` — ``interactive=4,standard=2,batch=1``
- ``DYN_QOS_AGING_S`` — waiting age that bypasses the fair order
- ``DYN_QOS_TENANTS`` — JSON per-tenant overrides; the scheduler reads each
  tenant's ``weight``. The other keys (``priority``, ``rate``, ``burst``,
  ``max_inflight``, ``api_keys``) are the frontend's quotas and are
  accepted and not used here.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field
from typing import Optional

logger = logging.getLogger("dynamo_torch.qos")


class ConfigError(Exception):
    """A QoS knob holds a value the policy cannot use."""


class PriorityClass:
    INTERACTIVE = "interactive"
    STANDARD = "standard"
    BATCH = "batch"


#: every legal class, best-first. Rank = index: lower ranks are admitted
#: first on ties and preempted last.
CLASSES = (PriorityClass.INTERACTIVE, PriorityClass.STANDARD,
           PriorityClass.BATCH)
CLASS_RANK = {c: i for i, c in enumerate(CLASSES)}
DEFAULT_CLASS = PriorityClass.STANDARD
DEFAULT_TENANT = "default"

_DEFAULT_WEIGHTS = {PriorityClass.INTERACTIVE: 4.0,
                    PriorityClass.STANDARD: 2.0,
                    PriorityClass.BATCH: 1.0}
_TENANT_KEYS = {"priority", "rate", "burst", "max_inflight", "weight",
                "api_keys"}


def normalize_priority(raw, *, warn: bool = True) -> str:
    """Map a wire priority string onto a known class; absent → the default
    class, malformed → the default class (with a warning if ``warn``)."""
    if raw is None or raw == "":
        return DEFAULT_CLASS
    cls = str(raw).strip().lower()
    if cls in CLASS_RANK:
        return cls
    if warn:
        logger.warning("unknown priority class %r; using %r", raw,
                       DEFAULT_CLASS)
    return DEFAULT_CLASS


@dataclass
class QosConfig:
    """Class weights, per-tenant weight overrides and aging."""

    weights: dict = field(default_factory=lambda: dict(_DEFAULT_WEIGHTS))
    #: seconds a waiting sequence may age before it bypasses the fair
    #: order (anti-starvation); 0 disables aging
    aging_s: float = 30.0
    #: tenant name → fair-share weight (overrides the class weight)
    tenant_weights: dict = field(default_factory=dict)

    def __post_init__(self):
        for c, w in self.weights.items():
            if c not in CLASS_RANK:
                raise ConfigError(f"DYN_QOS_WEIGHTS: unknown class {c!r}")
            if not w > 0:
                raise ConfigError(
                    f"DYN_QOS_WEIGHTS: weight for {c!r} must be > 0")
        for c in CLASSES:
            self.weights.setdefault(c, _DEFAULT_WEIGHTS[c])
        if self.aging_s < 0:
            raise ConfigError("DYN_QOS_AGING_S: must be >= 0")
        for name, w in self.tenant_weights.items():
            if not w > 0:
                raise ConfigError(
                    f"DYN_QOS_TENANTS[{name!r}].weight: must be > 0")

    def weight_for(self, tenant: str, cls: str) -> float:
        """Fair-share weight: the tenant override wins, else class weight."""
        w = self.tenant_weights.get(tenant)
        if w is not None:
            return w
        return self.weights.get(cls, _DEFAULT_WEIGHTS[DEFAULT_CLASS])

    @classmethod
    def load(cls, env: Optional[dict] = None) -> "QosConfig":
        env = os.environ if env is None else env
        kw: dict = {}
        raw = env.get("DYN_QOS_WEIGHTS")
        if raw:
            weights: dict = {}
            for part in raw.split(","):
                part = part.strip()
                if not part:
                    continue
                if "=" not in part:
                    raise ConfigError(
                        f"DYN_QOS_WEIGHTS: expected class=weight, got {part!r}")
                name, _, val = part.partition("=")
                try:
                    weights[name.strip().lower()] = float(val)
                except ValueError:
                    raise ConfigError(
                        f"DYN_QOS_WEIGHTS: bad weight {val!r}") from None
            kw["weights"] = weights
        if "DYN_QOS_AGING_S" in env:
            try:
                kw["aging_s"] = float(str(env["DYN_QOS_AGING_S"]).strip())
            except ValueError:
                raise ConfigError("DYN_QOS_AGING_S: not a float: "
                                  f"{env['DYN_QOS_AGING_S']!r}") from None
        raw = env.get("DYN_QOS_TENANTS")
        if raw:
            try:
                parsed = json.loads(raw)
            except json.JSONDecodeError as e:
                raise ConfigError(f"DYN_QOS_TENANTS: bad JSON: {e}") from None
            if not isinstance(parsed, dict):
                raise ConfigError("DYN_QOS_TENANTS: must be a JSON object")
            tw = {}
            for name, spec in parsed.items():
                if not isinstance(spec, dict):
                    raise ConfigError(
                        f"DYN_QOS_TENANTS[{name!r}]: must be an object")
                unknown = set(spec) - _TENANT_KEYS
                if unknown:
                    raise ConfigError(
                        f"DYN_QOS_TENANTS[{name!r}]: unknown key(s) "
                        f"{sorted(unknown)}")
                if spec.get("weight") is not None:
                    tw[name] = float(spec["weight"])
            kw["tenant_weights"] = tw
        return cls(**kw)
