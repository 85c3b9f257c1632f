"""Serve-layer accounting: typed counters, gauges and histograms.

Port of the accounting part of the JAX package's ``serve/telemetry.py``
(``Counter``, ``Gauge``, ``Histogram``, ``MetricsRegistry`` with its
Prometheus text exposition) and a ``Telemetry`` that holds one registry.
The engine's accounting lives here and ``ServeEngine.stats()`` is a view
over it, so the registry and the stats dict cannot disagree. Histograms
keep Prometheus ``le`` buckets (a value on an edge falls in the bucket
that edge bounds) plus a bounded window of raw observations for exact
percentiles.

Tracing is off: the reference's ``Tracer``, ``RetraceWatchdog`` and
``MemorySampler`` are not ported yet.

One ``Telemetry`` belongs to one engine: collector-callback metrics
(gauges reading live engine state) cannot be re-registered, so sharing a
registry across engines fails loudly instead of double counting.
"""
from __future__ import annotations

import bisect
import math
import re
from collections import OrderedDict, deque
from typing import Callable

import numpy as np

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _fmt_num(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return format(f, ".10g")


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

class Counter:
    """Monotonic counter. ``fn`` makes it a collector: the value is read
    from the callback at collection time (no double accounting for
    subsystems that already keep Python-side counts)."""
    kind = "counter"
    __slots__ = ("_value", "_fn")

    def __init__(self, fn: Callable[[], float] | None = None):
        self._value = 0.0
        self._fn = fn

    def inc(self, n: float = 1.0):
        if n < 0:
            raise ValueError("counters only go up")
        self._value += n

    @property
    def value(self) -> float:
        return float(self._fn()) if self._fn is not None else self._value

    def reset(self):
        self._value = 0.0


class Gauge:
    kind = "gauge"
    __slots__ = ("_value", "_fn")

    def __init__(self, fn: Callable[[], float] | None = None):
        self._value = 0.0
        self._fn = fn

    def set(self, v: float):
        self._value = float(v)

    @property
    def value(self) -> float:
        return float(self._fn()) if self._fn is not None else self._value

    def reset(self):
        self._value = 0.0


class Histogram:
    """Fixed-bucket histogram + bounded raw-observation window.

    Bucketing is Prometheus ``le`` semantics: ``observe(v)`` lands in the
    first bucket whose (upper) edge is ``>= v`` — a value exactly on an
    edge counts in the bucket that edge bounds, anything beyond the last
    finite edge lands in the final ``+Inf`` bucket. The window keeps the
    most recent ``window`` raw values so percentiles are exact over the
    recent past (what an operator watches) without per-observation host
    memory growth.
    """
    kind = "histogram"
    __slots__ = ("edges", "_counts", "_count", "_sum", "_max", "_window")

    def __init__(self, edges, window: int = 65536):
        edges = tuple(float(e) for e in edges)
        if not edges:
            raise ValueError("histogram needs at least one bucket edge")
        if list(edges) != sorted(edges) or len(set(edges)) != len(edges):
            raise ValueError(f"bucket edges must be strictly increasing: "
                             f"{edges}")
        if not math.isinf(edges[-1]):
            edges = edges + (math.inf,)
        self.edges = edges
        self._counts = [0] * len(edges)
        self._count = 0
        self._sum = 0.0
        self._max = 0.0
        self._window: deque[float] = deque(maxlen=window)

    def observe(self, v: float):
        v = float(v)
        self._counts[bisect.bisect_left(self.edges, v)] += 1
        self._count += 1
        self._sum += v
        if v > self._max:
            self._max = v
        self._window.append(v)

    @property
    def counts(self) -> list[int]:
        return list(self._counts)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def max(self) -> float:
        """Largest value observed since the last reset (not windowed)."""
        return self._max

    @property
    def window(self):
        return self._window

    def percentiles(self, ps=(50, 95, 99)) -> dict:
        if not self._window:
            return {f"p{p}": 0.0 for p in ps}
        arr = np.asarray(self._window, np.float64)
        return {f"p{p}": float(np.percentile(arr, p)) for p in ps}

    def reset(self):
        self._counts = [0] * len(self.edges)
        self._count = 0
        self._sum = 0.0
        self._max = 0.0
        self._window.clear()


class _Family:
    """Labelled children of one metric name (``metric{label="..."}``)."""

    def __init__(self, factory: Callable, label_names: tuple):
        self._factory = factory
        self.label_names = label_names
        self._children: OrderedDict[tuple, object] = OrderedDict()

    def labels(self, **kv):
        if set(kv) != set(self.label_names):
            raise ValueError(f"expected labels {self.label_names}, "
                             f"got {tuple(kv)}")
        key = tuple(str(kv[n]) for n in self.label_names)
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = self._factory()
        return child

    def items(self):
        return self._children.items()

    @property
    def total(self) -> float:
        return sum(c.value for c in self._children.values())

    def reset(self):
        for c in self._children.values():
            c.reset()


class _Entry:
    __slots__ = ("kind", "help", "metric", "labels")

    def __init__(self, kind, help, metric, labels):
        self.kind, self.help, self.metric, self.labels = (kind, help, metric,
                                                          labels)


class MetricsRegistry:
    """Named, typed metrics with get-or-create registration and a
    Prometheus text exposition. ``reset()`` zeroes values but keeps every
    registration (collector callbacks read live state and are untouched —
    their owners reset their own counts)."""

    def __init__(self):
        self._entries: OrderedDict[str, _Entry] = OrderedDict()

    def _register(self, name, help, kind, factory, labels, fn):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        labels = tuple(labels)
        for ln in labels:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        ent = self._entries.get(name)
        if ent is not None:
            if ent.kind != kind or ent.labels != labels:
                raise ValueError(
                    f"metric {name!r} already registered as {ent.kind}"
                    f"{ent.labels or ''}, not {kind}{labels or ''}")
            if fn is not None:
                raise ValueError(
                    f"metric {name!r} already registered; a collector "
                    "callback cannot be rebound (one Telemetry per engine)")
            return ent.metric
        if labels and fn is not None:
            raise ValueError("collector callbacks and labels are exclusive")
        metric = _Family(factory, labels) if labels else factory(fn)
        self._entries[name] = _Entry(kind, help, metric, labels)
        return metric

    def counter(self, name, help="", *, labels=(), fn=None) -> Counter:
        return self._register(name, help, "counter",
                              lambda f=None: Counter(f), labels, fn)

    def gauge(self, name, help="", *, labels=(), fn=None) -> Gauge:
        return self._register(name, help, "gauge",
                              lambda f=None: Gauge(f), labels, fn)

    def histogram(self, name, help="", *, edges, window=65536,
                  labels=()) -> Histogram:
        edges = tuple(edges)
        return self._register(name, help, "histogram",
                              lambda f=None: Histogram(edges, window),
                              labels, None)

    def get(self, name):
        ent = self._entries.get(name)
        return ent.metric if ent is not None else None

    def names(self) -> list[str]:
        return list(self._entries)

    def reset(self):
        for ent in self._entries.values():
            ent.metric.reset()

    # -- exposition --------------------------------------------------------

    @staticmethod
    def _label_str(names, values, extra=()):
        parts = [f'{n}="{v}"' for n, v in zip(names, values)]
        parts += [f'{n}="{v}"' for n, v in extra]
        return "{%s}" % ",".join(parts) if parts else ""

    def _render_one(self, lines, name, ent, label_values, metric):
        ls = self._label_str(ent.labels, label_values)
        if ent.kind == "histogram":
            cum = 0
            for edge, c in zip(metric.edges, metric.counts):
                cum += c
                le = "+Inf" if math.isinf(edge) else _fmt_num(edge)
                lel = self._label_str(ent.labels, label_values,
                                      extra=(("le", le),))
                lines.append(f"{name}_bucket{lel} {cum}")
            lines.append(f"{name}_sum{ls} {_fmt_num(metric.sum)}")
            lines.append(f"{name}_count{ls} {metric.count}")
        else:
            lines.append(f"{name}{ls} {_fmt_num(metric.value)}")

    def render_prometheus(self) -> str:
        lines = []
        for name, ent in self._entries.items():
            if ent.help:
                lines.append(f"# HELP {name} {ent.help}")
            lines.append(f"# TYPE {name} {ent.kind}")
            if ent.labels:
                for label_values, child in ent.metric.items():
                    self._render_one(lines, name, ent, label_values, child)
            else:
                self._render_one(lines, name, ent, (), ent.metric)
        return "\n".join(lines) + "\n"


class Telemetry:
    """One engine's accounting bundle: a MetricsRegistry (the engine's
    stats substrate), with tracing off: the reference's tracer, retrace
    watchdog and memory sampling are not ported."""

    def __init__(self):
        self.registry = MetricsRegistry()

    def reset(self):
        """Post-warm-up reset: zero the metrics (registrations are kept)."""
        self.registry.reset()

    def render_prometheus(self) -> str:
        return self.registry.render_prometheus()
