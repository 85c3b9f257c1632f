"""Serve-layer observability: metrics, event tracing, Perfetto export,
the retrace watchdog and memory watermarks.

Port of the JAX package's ``serve/telemetry.py``:

- ``MetricsRegistry``: typed counters, gauges and histograms with a
  Prometheus text exposition. The engine's accounting lives here and
  ``ServeEngine.stats()`` is a view over it, so the registry and the
  stats dict cannot disagree. Histograms keep Prometheus ``le`` buckets
  (a value on an edge falls in the bucket that edge bounds) plus a
  bounded window of raw observations for exact percentiles.
- ``Tracer``: a monotonic-clock timeline of spans, instants and counter
  samples in a bounded ring, exported in the Chrome trace format (open
  it at ui.perfetto.dev). ``validate_trace`` holds a trace to the
  documented schema (event names, track metadata, span nesting); the
  schema is the reference's, so either package's validator accepts the
  other's traces.
- ``RetraceWatchdog``: per-entry-point gauges of ``_cache_size()`` and a
  counter of its growth after ``mark_steady()``. The port has no jit, so
  an entry point's size is the number of distinct (shape, dtype)
  signatures it has been called with (``CallSignatures``): a new shape
  mid-serve means new cuBLAS plans and allocator growth on a live tick.
  The kernel libraries built or loaded (``kernels.build``) are counted
  too: an nvcc build in the middle of serving is the port's recompile.
- ``MemorySampler``: host RSS from ``/proc/self/statm`` and the card's
  allocator bytes from ``torch.cuda.memory_stats()``, which reads host
  counters and does not sync; on the CPU the device gauges stay 0.

Disabled is nearly free: the tracer is off by default and every call site
guards with ``if tracer:``; memory sampling is opt-in.

One ``Telemetry`` belongs to one engine: collector-callback metrics
(gauges reading live engine state) cannot be re-registered, so sharing a
registry across engines fails loudly instead of double counting.
"""
from __future__ import annotations

import bisect
import json
import math
import os
import re
import time
from collections import OrderedDict, deque
from typing import Callable

import numpy as np
import torch

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


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

# The documented event schema (the reference's). Spans ("X") nest within a
# track; instants ("i") are points; counters ("C") are sampled series.
# validate_trace rejects any event outside this vocabulary, so the schema
# below IS the compatibility contract for trace consumers. A data-sharded
# engine's "collective" span (the all-gather of a tick's tokens over
# "data") nests in its host_sync span.
SPAN_NAMES = frozenset({
    # engine tick phases (track "tick")
    "tick", "plan", "chunk_dispatch", "decode_dispatch", "host_sync",
    "collective", "retire",
    # request lifecycle (track "slot<i>")
    "prefill", "decode",
    # replica lifecycle (track "replica<i>")
    "replica", "recover",
})
INSTANT_NAMES = frozenset({
    "submit",                       # track "queue": request enqueued
    "chunk",                        # slot: one prefill chunk dispatched
    "cache_hit", "cache_miss",      # slot: prefix-cache probe outcome
    "park", "unpark",               # slot: coalesced onto an in-flight key
    "snapshot",                     # slot: snapshot inserted into the cache
    "first_token",                  # slot: first token observed
    "token",                        # slot: one decode token (ITL sample)
    "retire", "drop",               # slot / queue: request withdrawn
    "recompile",                    # track "tick": entry point grew mid-serve
    "evict", "disk_load",           # track "cache": store internals
    "disk_corrupt",                 # cache: quarantined unreadable file
    "replica_dead", "failover", "checkpoint", "shed",   # serve/replicas.py
})
COUNTER_NAMES = frozenset({"memory"})


class Tracer:
    """Bounded ring of trace events on a monotonic clock.

    A disabled tracer is a cheap no-op: call sites guard with ``if tr:``
    and every method returns at once. Spans are recorded begin/end against
    a per-track stack and stored as complete ("X") events; instants and
    counter samples append directly. ``export()`` renders the Chrome trace
    JSON.
    """

    def __init__(self, enabled: bool = True, max_events: int = 1 << 18,
                 on_event: Callable | None = None):
        self.enabled = bool(enabled)
        self.on_event = on_event
        self._t0 = time.perf_counter()
        self._events: deque[tuple] = deque(maxlen=max_events)
        self._tids: OrderedDict[str, int] = OrderedDict()
        self._stacks: dict[str, list] = {}

    def __bool__(self) -> bool:
        return self.enabled

    def __len__(self) -> int:
        return len(self._events)

    def _tid(self, track: str) -> int:
        tid = self._tids.get(track)
        if tid is None:
            tid = self._tids[track] = len(self._tids)
        return tid

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _push(self, ev: tuple):
        self._events.append(ev)
        if self.on_event is not None:
            self.on_event(ev)

    def instant(self, track: str, name: str, **args):
        if not self.enabled:
            return
        self._push(("i", name, self._tid(track), self._now_us(), 0.0,
                    args or None))

    def counter(self, track: str, name: str, **values):
        if not self.enabled:
            return
        self._push(("C", name, self._tid(track), self._now_us(), 0.0,
                    values))

    def begin(self, track: str, name: str, **args):
        if not self.enabled:
            return
        self._stacks.setdefault(track, []).append(
            (name, self._now_us(), args or None))

    def end(self, track: str, **args):
        if not self.enabled:
            return
        stack = self._stacks.get(track)
        if not stack:
            return  # unbalanced end: dropped, never raised into serving
        name, t0, a0 = stack.pop()
        merged = dict(a0 or {})
        merged.update(args)
        self._push(("X", name, self._tid(track), t0, self._now_us() - t0,
                    merged or None))

    def export(self, path: str | None = None) -> dict:
        """Chrome trace-event JSON. Open spans are flushed with their
        current duration and tagged ``unterminated`` (a live engine's
        in-flight requests)."""
        now = self._now_us()
        open_spans = [("X", name, self._tid(track), t0, now - t0,
                       {**(a0 or {}), "unterminated": True})
                      for track, stack in self._stacks.items()
                      for name, t0, a0 in stack]
        trace_events = [{"ph": "M", "pid": 1, "tid": 0,
                         "name": "process_name",
                         "args": {"name": "serve-engine"}}]
        for track, tid in self._tids.items():
            trace_events.append({"ph": "M", "pid": 1, "tid": tid,
                                 "name": "thread_name",
                                 "args": {"name": track}})
            trace_events.append({"ph": "M", "pid": 1, "tid": tid,
                                 "name": "thread_sort_index",
                                 "args": {"sort_index": tid}})
        for ph, name, tid, ts, dur, args in list(self._events) + open_spans:
            ev = {"ph": ph, "name": name, "pid": 1, "tid": tid,
                  "ts": round(ts, 3)}
            if ph == "X":
                ev["dur"] = round(dur, 3)
            elif ph == "i":
                ev["s"] = "t"
            if args:
                ev["args"] = args
            trace_events.append(ev)
        trace = {"displayTimeUnit": "ms", "traceEvents": trace_events}
        if path is not None:
            with open(path, "w") as f:
                json.dump(trace, f, default=str)
        return trace


#: a shared always-off tracer for call sites with no telemetry attached
NULL_TRACER = Tracer(enabled=False, max_events=1)


def format_event(ev: tuple) -> str:
    """One human-readable line per tracer event (the --log-events sink)."""
    ph, name, tid, ts, dur, args = ev
    kv = " ".join(f"{k}={v}" for k, v in (args or {}).items())
    head = f"[{ts / 1e3:10.3f}ms] t{tid} {name}"
    if ph == "X":
        return f"{head} {dur / 1e3:.3f}ms {kv}".rstrip()
    return f"{head} {kv}".rstrip()


_NEST_EPS_US = 1.0


def validate_trace(trace) -> list[str]:
    """Check a trace dict against the documented schema.

    Returns a list of problems (empty = valid): unknown phases or event
    names, events on tracks with no thread_name metadata, missing or
    negative timestamps or durations, and partially overlapping spans on
    one track (spans must nest).
    """
    if not isinstance(trace, dict) or not isinstance(
            trace.get("traceEvents"), list):
        return ["trace must be a dict with a traceEvents list"]
    events = trace["traceEvents"]
    threads = {(ev.get("pid"), ev.get("tid")) for ev in events
               if ev.get("ph") == "M" and ev.get("name") == "thread_name"}
    errs = []
    spans_by_track: dict[tuple, list] = {}
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        name = ev.get("name")
        where = f"event {i} ({name!r})"
        if ph == "M":
            if name not in ("process_name", "thread_name",
                            "thread_sort_index"):
                errs.append(f"{where}: unknown metadata {name!r}")
            continue
        if ph not in ("X", "i", "C"):
            errs.append(f"{where}: unknown phase {ph!r}")
            continue
        allowed = {"X": SPAN_NAMES, "i": INSTANT_NAMES,
                   "C": COUNTER_NAMES}[ph]
        if name not in allowed:
            errs.append(f"{where}: name not in schema for ph={ph}")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errs.append(f"{where}: bad ts {ts!r}")
            continue
        key = (ev.get("pid"), ev.get("tid"))
        if key not in threads:
            errs.append(f"{where}: track {key} has no thread_name metadata")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"{where}: bad dur {dur!r}")
            else:
                spans_by_track.setdefault(key, []).append((ts, dur, name))
        elif ph == "i" and ev.get("s") not in ("t", "p", "g"):
            errs.append(f"{where}: instant missing scope 's'")
    for key, spans in spans_by_track.items():
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack = []  # end times of open ancestors
        for ts, dur, name in spans:
            while stack and ts >= stack[-1] - _NEST_EPS_US:
                stack.pop()
            if stack and ts + dur > stack[-1] + _NEST_EPS_US:
                errs.append(f"track {key}: span {name!r} at ts={ts:.1f} "
                            "overlaps its enclosing span without nesting")
            stack.append(ts + dur)
    return errs


# ---------------------------------------------------------------------------
# retrace watchdog
# ---------------------------------------------------------------------------

def _signature(x):
    """The (shape, dtype) signature of a call's arguments: tensors and
    arrays by shape and dtype, containers by their items, anything else
    by its type only (ints are values, as a jit traces them)."""
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return (tuple(x.shape), str(x.dtype))
    if isinstance(x, (list, tuple)):
        return tuple(_signature(v) for v in x)
    return type(x).__name__


class CallSignatures:
    """A callable that counts the distinct (shape, dtype) signatures it is
    called with: the port's ``_cache_size()`` of an engine entry point,
    read by RetraceWatchdog as the reference reads a jit cache."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self._seen: set = set()

    def __call__(self, *args):
        self._seen.add(_signature(args))
        return self.fn(*args)

    def _cache_size(self) -> int:
        return len(self._seen)


class RetraceWatchdog:
    """Per-entry-point cache-size gauges and a mid-serve retrace counter.

    Each registered object's ``_cache_size()`` is sampled on every
    ``check()`` into ``serve_jit_cache_size{entry=...}``. Growth observed
    after ``mark_steady()`` (the engine's post-warm-up ``reset_stats()``)
    means a live tick met a new shape or built a kernel library; it
    increments ``serve_retraces_total{entry=...}`` and emits a
    ``recompile`` trace instant. Before steady, baselines track silently.
    """

    def __init__(self, registry: MetricsRegistry, tracer: Tracer):
        self._gauge = registry.gauge(
            "serve_jit_cache_size",
            "distinct call signatures (kernel libraries) per entry point",
            labels=("entry",))
        self._counter = registry.counter(
            "serve_retraces_total",
            "entry-point growth observed after mark_steady (mid-serve "
            "new shapes or kernel builds)", labels=("entry",))
        self._tracer = tracer
        self._entries: dict[str, Callable] = {}
        self._baseline: dict[str, int] = {}
        self.steady = False

    def register(self, name: str, obj) -> bool:
        """Track one object; returns False (and ignores it) when it has
        no ``_cache_size()``."""
        size_fn = getattr(obj, "_cache_size", None)
        if size_fn is None:
            return False
        self._entries[name] = size_fn
        self._baseline[name] = size_fn()
        return True

    def mark_steady(self):
        """Every signature seen so far is warm-up; growth from here on is
        a mid-serve retrace."""
        for name, size_fn in self._entries.items():
            self._baseline[name] = size_fn()
        self.steady = True

    def check(self):
        for name, size_fn in self._entries.items():
            size = size_fn()
            self._gauge.labels(entry=name).set(size)
            grew = size - self._baseline[name]
            if grew > 0:
                if self.steady:
                    self._counter.labels(entry=name).inc(grew)
                    if self._tracer:
                        self._tracer.instant("tick", "recompile", entry=name,
                                             traces=int(size))
                self._baseline[name] = size

    @property
    def retraces(self) -> int:
        return int(self._counter.total)

    def cache_sizes(self) -> dict:
        return {name: size_fn() for name, size_fn in self._entries.items()}


# ---------------------------------------------------------------------------
# memory watermarks
# ---------------------------------------------------------------------------

class MemorySampler:
    """Host RSS and the card's allocated bytes, with since-reset
    watermarks.

    Host side reads ``/proc/self/statm`` (a few microseconds); device side
    reads ``torch.cuda.memory_stats()`` (``allocated_bytes.all.current``
    and ``.peak``: host-side allocator counters, no device sync) once CUDA
    is initialised. Without a card the device gauges stay 0.
    """

    def __init__(self, registry: MetricsRegistry):
        self.rss = registry.gauge("serve_host_rss_bytes",
                                  "host resident set size")
        self.rss_peak = registry.gauge("serve_host_rss_peak_bytes",
                                       "peak host RSS since reset")
        self.dev = registry.gauge("serve_device_bytes_in_use",
                                  "device allocator bytes in use")
        self.dev_peak = registry.gauge("serve_device_peak_bytes",
                                       "peak device bytes since reset")
        self._page = os.sysconf("SC_PAGE_SIZE")
        self._statm = os.path.exists("/proc/self/statm")

    def _host_rss(self) -> int:
        if self._statm:
            try:
                with open("/proc/self/statm") as f:
                    return int(f.read().split()[1]) * self._page
            except (OSError, ValueError, IndexError):
                pass
        import resource
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024

    @staticmethod
    def _device_stats() -> dict | None:
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return None
        return torch.cuda.memory_stats()

    def sample(self, tracer: Tracer = NULL_TRACER):
        rss = self._host_rss()
        self.rss.set(rss)
        if rss > self.rss_peak.value:
            self.rss_peak.set(rss)
        dev_mb = 0.0
        stats = self._device_stats()
        if stats:
            in_use = stats.get("allocated_bytes.all.current", 0)
            self.dev.set(in_use)
            peak = stats.get("allocated_bytes.all.peak", in_use)
            if peak > self.dev_peak.value:
                self.dev_peak.set(peak)
            dev_mb = in_use / 2**20
        if tracer:
            tracer.counter("mem", "memory", rss_mb=round(rss / 2**20, 2),
                           device_mb=round(dev_mb, 2))


# ---------------------------------------------------------------------------
# the bundle an engine carries
# ---------------------------------------------------------------------------

class Telemetry:
    """One engine's observability bundle: registry, tracer, watchdog and
    optional memory sampling every ``memory_every`` ticks.

    ``Telemetry()`` is what an engine gets when none is passed: metrics on
    (they are the stats substrate), tracing off, memory sampling off.
    """

    def __init__(self, *, trace: bool = False, memory: bool = False,
                 memory_every: int = 8, max_events: int = 1 << 18,
                 on_event: Callable | None = None):
        self.registry = MetricsRegistry()
        self.tracer = Tracer(enabled=trace, max_events=max_events,
                             on_event=on_event)
        self.watchdog = RetraceWatchdog(self.registry, self.tracer)
        self.memory = MemorySampler(self.registry) if memory else None
        self.memory_every = max(1, int(memory_every))
        self._ticks = 0

    def on_tick(self):
        """Per-tick introspection (the engine calls it after every step):
        the watchdog, and the memory watermarks every memory_every ticks."""
        self.watchdog.check()
        if self.memory is not None and self._ticks % self.memory_every == 0:
            self.memory.sample(self.tracer)
        self._ticks += 1

    def reset(self):
        """Post-warm-up reset: zero the metrics and declare the entry
        points steady (growth from here is a mid-serve retrace). The trace
        timeline is kept: warm-up events are real events."""
        self.registry.reset()
        self.watchdog.mark_steady()

    def render_prometheus(self) -> str:
        return self.registry.render_prometheus()

    def export_trace(self, path: str | None = None) -> dict:
        return self.tracer.export(path)
