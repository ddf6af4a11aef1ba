"""Prometheus-style metrics registry (no external deps), the port's copy
of ``dynamo_tpu/runtime/metrics.py``: counters, gauges and histograms with
labels, auto-prefixed ``dynamo_*`` names, rendered in the Prometheus text
exposition format.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

_DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def _escape_label_value(v) -> str:
    """Prometheus exposition escaping for label values: backslash, double
    quote, and newline must be escaped or the scrape output is corrupt
    (e.g. a model name containing ``"``)."""
    return (str(v).replace("\\", "\\\\")
            .replace('"', '\\"').replace("\n", "\\n"))


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _merge_callback_values(values: dict, callbacks: list, name: str,
                           base: Optional[dict] = None) -> dict:
    """Fold scrape-time callback samples into ``values`` (shared by Counter
    and Gauge render). Each callback returns dict[labels, value]; ``labels``
    is None (no labels) or a TUPLE of (name, value) pairs — a dict cannot
    key a dict. Keys must be None or ((name, value), ...) pairs — an
    iterable of anything else (e.g. a bare string, whose sort would
    silently yield characters) is a caller bug. ``base`` labels (the
    registry's default labels, e.g. the frontend replica id) merge under
    the callback's own labels."""
    for cb in callbacks:
        try:
            for labels, v in cb().items():
                d = {str(k): str(bv) for k, bv in (base or {}).items()}
                if labels is not None:
                    d.update((str(n), str(lv)) for n, lv in labels)
                values[tuple(sorted(d.items()))] = v
        except Exception:
            logging.getLogger("dynamo.metrics").exception(
                "metric %s scrape callback failed", name)
    return values


class Counter:
    def __init__(self, name: str, help_: str, base: Optional[dict] = None):
        self.name = name
        self.help = help_
        self._base = dict(base or {})
        self._values: dict[tuple, float] = {}
        self._callbacks: list = []
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels):
        key = tuple(sorted({**self._base, **labels}.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def add_callback(self, fn):
        """fn() -> dict[labels, value] evaluated at scrape time (the
        _merge_callback_values contract, shared with Gauge). For monotonic
        totals OWNED elsewhere (e.g. the engine's swap/preempt counters) —
        the callback value replaces the stored sample so the series stays
        a true counter."""
        self._callbacks.append(fn)

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        values = _merge_callback_values(dict(self._values), self._callbacks,
                                        self.name, self._base)
        for key, v in sorted(values.items()):
            lines.append(f"{self.name}{_fmt_labels(dict(key))} {v}")
        return "\n".join(lines)


class Gauge:
    def __init__(self, name: str, help_: str, base: Optional[dict] = None):
        self.name = name
        self.help = help_
        self._base = dict(base or {})
        self._values: dict[tuple, float] = {}
        self._callbacks: list = []
        self._lock = threading.Lock()

    def set(self, value: float, **labels):
        key = tuple(sorted({**self._base, **labels}.items()))
        with self._lock:
            self._values[key] = value

    def remove(self, **labels):
        """Drop one labeled series (label-churn hygiene: a departed
        worker's gauge must leave /metrics, not linger as a 0-valued
        series forever — unbounded cardinality under fleet churn)."""
        key = tuple(sorted({**self._base, **labels}.items()))
        with self._lock:
            self._values.pop(key, None)

    def add_callback(self, fn):
        """fn() -> dict[labels, value] evaluated at scrape time (the
        _merge_callback_values contract, shared with Counter)."""
        self._callbacks.append(fn)

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        values = _merge_callback_values(dict(self._values), self._callbacks,
                                        self.name, self._base)
        for key, v in sorted(values.items()):
            lines.append(f"{self.name}{_fmt_labels(dict(key))} {v}")
        return "\n".join(lines)


class Histogram:
    def __init__(self, name: str, help_: str, buckets=_DEFAULT_BUCKETS,
                 base: Optional[dict] = None):
        self.name = name
        self.help = help_
        self.buckets = tuple(buckets)
        self._base = dict(base or {})
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, **labels):
        key = tuple(sorted({**self._base, **labels}.items()))
        with self._lock:
            counts = self._counts.setdefault(key, [0] * (len(self.buckets) + 1))
            self._sums[key] = self._sums.get(key, 0.0) + value
            # per-bucket (non-cumulative) counts: render() cumulates.
            # Incrementing EVERY matching bucket here double-counted once
            # render added them up (le="1.0" could exceed the total count)
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
                    break
            counts[-1] += 1  # +Inf (total observations)

    def time(self, **labels):
        return _Timer(self, labels)

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        for key, counts in sorted(self._counts.items()):
            labels = dict(key)
            cum = 0
            for i, b in enumerate(self.buckets):
                cum += counts[i]
                lines.append(f'{self.name}_bucket{_fmt_labels({**labels, "le": str(b)})} {cum}')
            lines.append(f'{self.name}_bucket{_fmt_labels({**labels, "le": "+Inf"})} {counts[-1]}')
            lines.append(f"{self.name}_sum{_fmt_labels(labels)} {self._sums.get(key, 0.0)}")
            lines.append(f"{self.name}_count{_fmt_labels(labels)} {counts[-1]}")
        return "\n".join(lines)


class _Timer:
    def __init__(self, hist: Histogram, labels: dict):
        self._hist = hist
        self._labels = labels

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.observe(time.perf_counter() - self._t0, **self._labels)


class MetricsRegistry:
    def __init__(self, prefix: str = "dynamo",
                 default_labels: Optional[dict] = None):
        self.prefix = prefix
        #: labels stamped on EVERY sample this registry records (e.g.
        #: ``{"replica": "fe-1"}`` in multi-frontend deployments, so a
        #: fleet scrape can sum per-replica series instead of letting
        #: identical label sets clobber each other). Empty by default —
        #: single-replica exposition stays byte-identical.
        self.default_labels = dict(default_labels or {})
        self._metrics: dict[str, object] = {}
        self._start = time.time()

    def counter(self, name: str, help_: str = "") -> Counter:
        full = f"{self.prefix}_{name}"
        if full not in self._metrics:
            self._metrics[full] = Counter(full, help_ or name,
                                          base=self.default_labels)
        return self._metrics[full]  # type: ignore[return-value]

    def gauge(self, name: str, help_: str = "") -> Gauge:
        full = f"{self.prefix}_{name}"
        if full not in self._metrics:
            self._metrics[full] = Gauge(full, help_ or name,
                                        base=self.default_labels)
        return self._metrics[full]  # type: ignore[return-value]

    def histogram(self, name: str, help_: str = "", buckets=_DEFAULT_BUCKETS) -> Histogram:
        full = f"{self.prefix}_{name}"
        if full not in self._metrics:
            self._metrics[full] = Histogram(full, help_ or name, buckets,
                                            base=self.default_labels)
        return self._metrics[full]  # type: ignore[return-value]

    def render(self) -> str:
        up = (f"# HELP {self.prefix}_uptime_seconds "
              f"Seconds since this registry was created\n"
              f"# TYPE {self.prefix}_uptime_seconds gauge\n"
              f"{self.prefix}_uptime_seconds {time.time() - self._start}")
        parts = [m.render() for m in self._metrics.values()]  # type: ignore[attr-defined]
        return "\n".join([up] + parts) + "\n"
