"""Metrics registry: counters, gauges and histograms with labels, exported
as Prometheus text or JSON.

One process-global `default_registry()` is the dashboard surface: the
serving layer's `ServiceMetrics` mirrors its counters and latency
reservoirs into it, and a scraper can read `prometheus_text()`.

Names follow `spin_<subsystem>_<noun>[_unit]`, e.g.
`spin_serve_requests_total` or `spin_serve_latency_seconds`: counters end
in `_total`, durations are seconds. Labels are few and bounded (path,
reason, stage), never ids.

Everything here is host-side Python over plain dicts under one lock per
metric, safe to call from background threads (snapshot writers, guarded
solves) while the tick loop reads.
"""

from __future__ import annotations

import threading
from typing import Iterable, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry", "set_default_registry", "DEFAULT_BUCKETS"]

# Latency-oriented default buckets (seconds): 100µs … ~100s, log-spaced.
DEFAULT_BUCKETS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1,
                   1.0, 3.0, 10.0, 30.0, 100.0)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


class _Metric:
    def __init__(self, name: str, help_: str):
        if not name.replace("_", "").isalnum():
            raise ValueError(f"metric name must be [a-z0-9_], got {name!r}")
        self.name = name
        self.help = help_
        self._lock = threading.Lock()


class Counter(_Metric):
    """Monotonic counter, optionally labeled."""

    kind = "counter"

    def __init__(self, name: str, help_: str = ""):
        super().__init__(name, help_)
        self._values: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        k = _label_key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def collect(self) -> dict:
        with self._lock:
            return {_label_str(k): v for k, v in sorted(self._values.items())}


class Gauge(_Metric):
    """Last-write-wins instantaneous value, optionally labeled."""

    kind = "gauge"

    def __init__(self, name: str, help_: str = ""):
        super().__init__(name, help_)
        self._values: dict[tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        k = _label_key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def collect(self) -> dict:
        with self._lock:
            return {_label_str(k): v for k, v in sorted(self._values.items())}


class Histogram(_Metric):
    """Prometheus-style histogram: cumulative bucket counts + sum + count."""

    kind = "histogram"

    def __init__(self, name: str, help_: str = "",
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        super().__init__(name, help_)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        # per label-set: [per-bucket counts..., +Inf count], sum
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}

    def observe(self, value: float, **labels) -> None:
        v = float(value)
        k = _label_key(labels)
        with self._lock:
            counts = self._counts.setdefault(k, [0] * (len(self.buckets) + 1))
            for i, bound in enumerate(self.buckets):
                if v <= bound:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._sums[k] = self._sums.get(k, 0.0) + v

    def summary(self, **labels) -> dict:
        k = _label_key(labels)
        with self._lock:
            counts = list(self._counts.get(k, []))
            total = sum(counts)
            return {"count": total, "sum": self._sums.get(k, 0.0),
                    "mean": (self._sums.get(k, 0.0) / total) if total else 0.0}

    def collect(self) -> dict:
        with self._lock:
            out = {}
            for k, counts in sorted(self._counts.items()):
                cum, rows = 0, {}
                for bound, c in zip(self.buckets, counts):
                    cum += c
                    rows[f"le={bound:g}"] = cum
                rows["le=+Inf"] = cum + counts[-1]
                out[_label_str(k)] = {"buckets": rows,
                                      "sum": self._sums.get(k, 0.0),
                                      "count": cum + counts[-1]}
            return out


class MetricsRegistry:
    """Named metric store with get-or-create accessors and two exporters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help_: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help_, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get_or_create(Counter, name, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help_)

    def histogram(self, name: str, help_: str = "",
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help_, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    # -- exporters -----------------------------------------------------------

    def to_json(self) -> dict:
        """JSON-ready nested dict: {name: {type, help, values}}."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: {"type": m.kind, "help": m.help,
                         "values": m.collect()} for m in metrics}

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (v0.0.4)."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        lines: list[str] = []
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            collected = m.collect()
            if isinstance(m, Histogram):
                for labels, row in collected.items():
                    base = labels[1:-1] if labels else ""
                    for le, cum in row["buckets"].items():
                        bound = le.split("=", 1)[1]
                        inner = (base + "," if base else "") + f'le="{bound}"'
                        lines.append(
                            f"{m.name}_bucket{{{inner}}} {cum}")
                    lines.append(f"{m.name}_sum{labels} {row['sum']}")
                    lines.append(f"{m.name}_count{labels} {row['count']}")
            else:
                for labels, v in collected.items():
                    lines.append(f"{m.name}{labels} {v}")
        return "\n".join(lines) + ("\n" if lines else "")


_default = MetricsRegistry()
_default_lock = threading.Lock()


def default_registry() -> MetricsRegistry:
    """The process-global registry (dashboards, benchmark exports)."""
    return _default


def set_default_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the global registry (hermetic tests); returns the previous one."""
    global _default
    with _default_lock:
        prev, _default = _default, registry
    return prev
