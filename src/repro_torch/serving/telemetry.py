"""Metrics registry + span tracer of the serving stack (the JAX package's
``serving/telemetry.py``; its DESIGN.md §11).

Two cooperating pieces, both stamped from the engine's injectable clock, so
a run under a virtual clock and its trace can be diffed line for line:

  * :class:`MetricsRegistry` — counters / gauges / histograms with labels.
    Histograms are fixed-bucket for Prometheus exposition but ALSO retain
    raw samples, so ``percentile(q)`` is exact (it matches
    ``numpy.percentile``): the one source of every p50/p95 of
    ``EngineStats``.  The registry renders the Prometheus text format
    (``render()``) and a JSON-able ``snapshot()``.
  * :class:`Tracer` — per-request lifecycle spans and per-iteration
    engine-phase spans on (pid, tid) tracks, exported as Chrome trace event
    JSON (``{"traceEvents": [...]}``) that loads in Perfetto or
    chrome://tracing.  Spans nest per track; the tracer refuses double
    closes and reports open spans.

Naming: metric names are ``spa_<subsystem>_<quantity>[_<unit>]`` with
subsystem one of ``engine|pool|prefix|tier|slo|fault|cache``; durations are
``_seconds``, sizes ``_pages``/``_tokens``, ratios ``_ratio``.  Names, help
strings and bucket edges are the JAX package's, letter for letter.

Everything here is host-side bookkeeping: nothing touches the decode step,
so decode outputs are identical with telemetry on.
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Span", "TraceEvent", "Tracer", "Telemetry",
    "DEFAULT_LATENCY_BUCKETS", "percentile",
]

LabelKV = Tuple[Tuple[str, str], ...]

# Latency-ish default buckets (seconds / steps): 1e-4 .. ~1e3, log-spaced.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = tuple(
    round(10.0 ** (e / 3.0), 6) for e in range(-12, 10)
)


def percentile(samples: Iterable[float], q: float) -> float:
    """Exact percentile with linear interpolation — the same estimator
    as ``numpy.percentile(..., method="linear")``.  Single source for
    every p50/p95 in the serving stack."""
    xs = sorted(float(x) for x in samples)
    if not xs:
        return 0.0
    if len(xs) == 1:
        return xs[0]
    pos = (q / 100.0) * (len(xs) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


def _labels_kv(labels: Optional[Dict[str, str]]) -> LabelKV:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render_labels(kv: LabelKV) -> str:
    if not kv:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in kv)
    return "{" + inner + "}"


class Counter:
    """Monotonic counter.  ``inc`` only; negative increments are bugs."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = _labels_kv(labels)
        self.value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        assert n >= 0, f"counter {self.name} decremented by {n}"
        self.value += n

    def set(self, v: float) -> None:
        """Absolute set — for counters mirrored from an existing
        monotonic source (EngineStats ints)."""
        self.value = float(v)


class Gauge:
    """Point-in-time value (occupancy, depth, level)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = _labels_kv(labels)
        self.value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Histogram:
    """Fixed-bucket histogram that also retains raw samples.

    The buckets feed Prometheus exposition (cumulative ``_bucket``
    series); the retained samples make ``percentile`` EXACT, matching
    ``numpy.percentile`` — serving runs here are small enough (10^2-10^4
    observations) that retaining floats is cheaper than being wrong
    about tail latency.  ``max_samples`` caps retention for long-lived
    daemons; past the cap percentiles degrade gracefully to the
    bucket-implied estimate.

    Also list-compatible (``len`` / ``append`` / iteration), so callers
    that treat ``EngineStats.e2e_latencies`` as a list keep working.
    """

    kind = "histogram"

    def __init__(self, name: str = "", help: str = "",
                 buckets: Tuple[float, ...] = DEFAULT_LATENCY_BUCKETS,
                 labels: Optional[Dict[str, str]] = None,
                 max_samples: int = 100_000):
        self.name = name
        self.help = help
        self.labels = _labels_kv(labels)
        self.buckets = tuple(sorted(buckets))
        self.bucket_counts = [0] * (len(self.buckets) + 1)  # +inf tail
        self.count = 0
        self.sum = 0.0
        self.max_samples = max_samples
        self.samples: List[float] = []

    def observe(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.sum += x
        i = self._bucket_index(x)
        self.bucket_counts[i] += 1
        if len(self.samples) < self.max_samples:
            self.samples.append(x)

    # list-compat shims (EngineStats latency fields were List[float])
    append = observe

    def extend(self, xs: Iterable[float]) -> None:
        for x in xs:
            self.observe(x)

    def __len__(self) -> int:
        return self.count

    def __iter__(self):
        return iter(self.samples)

    def __bool__(self) -> bool:
        return self.count > 0

    def _bucket_index(self, x: float) -> int:
        lo, hi = 0, len(self.buckets)
        while lo < hi:
            mid = (lo + hi) // 2
            if x <= self.buckets[mid]:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def percentile(self, q: float) -> float:
        """Exact when samples are fully retained (the common case);
        bucket-upper-bound estimate past ``max_samples``."""
        if self.count <= len(self.samples):
            return percentile(self.samples, q)
        target = (q / 100.0) * self.count
        seen = 0
        for i, c in enumerate(self.bucket_counts):
            seen += c
            if seen >= target:
                return (self.buckets[i] if i < len(self.buckets)
                        else self.buckets[-1])
        return self.buckets[-1] if self.buckets else 0.0

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class MetricsRegistry:
    """Get-or-create store of metrics keyed on (name, labels)."""

    def __init__(self) -> None:
        self._metrics: Dict[Tuple[str, LabelKV], Any] = {}
        self._help: Dict[str, str] = {}
        # collectors run just before render()/snapshot() so gauges that
        # mirror live engine state (occupancy, queue depth) are fresh.
        self._collectors: List[Callable[[], None]] = []

    def _get(self, cls, name: str, help: str,
             labels: Optional[Dict[str, str]], **kw):
        key = (name, _labels_kv(labels))
        m = self._metrics.get(key)
        if m is None:
            m = cls(name, help or self._help.get(name, ""),
                    labels=labels, **kw)
            self._metrics[key] = m
            if help:
                self._help[name] = help
        assert m.kind == cls.kind, \
            f"metric {name} re-registered as {cls.kind}, was {m.kind}"
        return m

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Dict[str, str]] = None,
                  buckets: Tuple[float, ...] = DEFAULT_LATENCY_BUCKETS,
                  ) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def adopt(self, hist: Histogram, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Histogram:
        """Register an externally owned histogram (EngineStats owns its
        latency histograms so ``eng.stats = type(eng.stats)()`` resets
        still work; the registry renders whatever is adopted last)."""
        hist.name = name
        if help:
            hist.help = help
        hist.labels = _labels_kv(labels)
        self._metrics[(name, hist.labels)] = hist
        if help:
            self._help[name] = help
        return hist

    def add_collector(self, fn: Callable[[], None]) -> None:
        self._collectors.append(fn)

    def collect(self) -> None:
        for fn in self._collectors:
            fn()

    # ---- exposition ---------------------------------------------------

    def _grouped(self) -> Dict[str, List[Any]]:
        groups: Dict[str, List[Any]] = {}
        for (name, _), m in sorted(self._metrics.items()):
            groups.setdefault(name, []).append(m)
        return groups

    @staticmethod
    def _fmt(v: float) -> str:
        if v == math.inf:
            return "+Inf"
        if float(v).is_integer() and abs(v) < 1e15:
            return str(int(v))
        return repr(float(v))

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        self.collect()
        out: List[str] = []
        for name, metrics in self._grouped().items():
            kind = metrics[0].kind
            help_txt = self._help.get(name) or metrics[0].help
            if help_txt:
                out.append(f"# HELP {name} {help_txt}")
            out.append(f"# TYPE {name} {kind}")
            for m in metrics:
                if kind == "histogram":
                    cum = 0
                    for ub, c in zip(m.buckets, m.bucket_counts):
                        cum += c
                        kv = m.labels + (("le", self._fmt(ub)),)
                        out.append(f"{name}_bucket{_render_labels(kv)}"
                                   f" {cum}")
                    kv = m.labels + (("le", "+Inf"),)
                    out.append(f"{name}_bucket{_render_labels(kv)}"
                               f" {m.count}")
                    out.append(f"{name}_sum{_render_labels(m.labels)}"
                               f" {self._fmt(m.sum)}")
                    out.append(f"{name}_count{_render_labels(m.labels)}"
                               f" {m.count}")
                else:
                    out.append(f"{name}{_render_labels(m.labels)}"
                               f" {self._fmt(m.value)}")
        return "\n".join(out) + "\n"

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able registry dump."""
        self.collect()
        snap: Dict[str, Any] = {}
        for (name, kv), m in sorted(self._metrics.items()):
            key = name + _render_labels(kv)
            if m.kind == "histogram":
                snap[key] = {
                    "count": m.count, "sum": round(m.sum, 9),
                    "mean": round(m.mean, 9),
                    "p50": round(m.percentile(50), 9),
                    "p95": round(m.percentile(95), 9),
                }
            else:
                snap[key] = m.value
        return snap

    def format_summary(self, skip_zero: bool = False) -> str:
        """Human-oriented registry dump (``launch/serve.py``'s summary).
        Renders cleanly with zero observations everywhere;
        ``skip_zero`` drops never-incremented metrics for a compact
        default summary."""
        self.collect()
        lines: List[str] = []
        by_sub: Dict[str, List[str]] = {}
        for (name, kv), m in sorted(self._metrics.items()):
            parts = name.split("_")
            sub = parts[1] if len(parts) > 2 and parts[0] == "spa" \
                else "misc"
            label = name + _render_labels(kv)
            if m.kind == "histogram":
                if skip_zero and not m.count:
                    continue
                if m.count:
                    row = (f"  {label:<52s} n={m.count:<7d}"
                           f" mean={m.mean:.4g}"
                           f" p50={m.percentile(50):.4g}"
                           f" p95={m.percentile(95):.4g}")
                else:
                    row = f"  {label:<52s} n=0"
            else:
                if skip_zero and not m.value:
                    continue
                row = f"  {label:<52s} {self._fmt(m.value)}"
            by_sub.setdefault(sub, []).append(row)
        if not by_sub:
            return "  (no metrics recorded)"
        for sub in sorted(by_sub):
            lines.append(f"[{sub}]")
            lines.extend(by_sub[sub])
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Tracer
# ---------------------------------------------------------------------------

# Track (pid) assignments for the Chrome trace. Perfetto shows one
# process group per pid; request tracks get tid = request uid.
PID_ENGINE = 1
PID_REQUESTS = 2
PID_EVENTS = 3
PID_DEVICE = 4      # step/loop device-time slices (profiling)


@dataclasses.dataclass
class TraceEvent:
    """One Chrome-trace event. ``ph``: X=complete span, i=instant,
    C=counter, M=metadata.  ``ts``/``dur`` are in engine-clock seconds
    here; export converts to microseconds."""
    name: str
    ph: str
    ts: float
    pid: int
    tid: int
    dur: float = 0.0
    cat: str = ""
    args: Optional[Dict[str, Any]] = None

    def to_chrome(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "name": self.name, "ph": self.ph,
            "ts": round(self.ts * 1e6, 3),
            "pid": self.pid, "tid": self.tid,
        }
        if self.ph == "X":
            d["dur"] = round(self.dur * 1e6, 3)
        if self.cat:
            d["cat"] = self.cat
        if self.ph == "i":
            d["s"] = "t"  # thread-scoped instant
        if self.args is not None:
            d["args"] = self.args
        return d


@dataclasses.dataclass
class Span:
    name: str
    pid: int
    tid: int
    t0: float
    cat: str = ""
    args: Optional[Dict[str, Any]] = None
    closed: bool = False


class Tracer:
    """Span tracer over (pid, tid) tracks with per-track nesting.

    ``begin``/``end`` maintain a stack per track; ``end`` closes the
    innermost open span (optionally checked by name) and emits a
    complete event.  Ending an already closed span raises.  When disabled
    every call is an early return, so telemetry off costs one attribute
    check.
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 enabled: bool = True):
        self.enabled = enabled
        self.clock = clock or time.time
        self.events: List[TraceEvent] = []
        self._stacks: Dict[Tuple[int, int], List[Span]] = {}
        self._track_names: Dict[Tuple[int, int], str] = {}

    def _now(self) -> float:
        return float(self.clock())

    def name_track(self, pid: int, tid: int, name: str) -> None:
        if not self.enabled:
            return
        self._track_names[(pid, tid)] = name

    def begin(self, pid: int, tid: int, name: str, cat: str = "",
              args: Optional[Dict[str, Any]] = None) -> Optional[Span]:
        if not self.enabled:
            return None
        sp = Span(name=name, pid=pid, tid=tid, t0=self._now(),
                  cat=cat, args=dict(args) if args else None)
        self._stacks.setdefault((pid, tid), []).append(sp)
        return sp

    def end(self, pid: int, tid: int, name: Optional[str] = None,
            args: Optional[Dict[str, Any]] = None) -> Optional[Span]:
        if not self.enabled:
            return None
        stack = self._stacks.get((pid, tid)) or []
        if not stack:
            raise RuntimeError(
                f"end('{name}') on track ({pid},{tid}) with no open span")
        sp = stack[-1]
        if name is not None and sp.name != name:
            raise RuntimeError(
                f"end('{name}') but innermost open span on track "
                f"({pid},{tid}) is '{sp.name}'")
        if sp.closed:
            raise RuntimeError(f"span '{sp.name}' double-closed")
        stack.pop()
        sp.closed = True
        if args:
            sp.args = {**(sp.args or {}), **args}
        self.events.append(TraceEvent(
            name=sp.name, ph="X", ts=sp.t0, dur=self._now() - sp.t0,
            pid=pid, tid=tid, cat=sp.cat, args=sp.args))
        return sp

    def close_track(self, pid: int, tid: int,
                    args: Optional[Dict[str, Any]] = None) -> int:
        """Close every open span on a track, innermost first (request
        teardown on abort/shed — guarantees no orphans)."""
        if not self.enabled:
            return 0
        n = 0
        while self._stacks.get((pid, tid)):
            self.end(pid, tid, args=args)
            n += 1
        return n

    def instant(self, pid: int, tid: int, name: str, cat: str = "",
                args: Optional[Dict[str, Any]] = None) -> None:
        if not self.enabled:
            return
        self.events.append(TraceEvent(
            name=name, ph="i", ts=self._now(), pid=pid, tid=tid,
            cat=cat, args=dict(args) if args else None))

    def counter(self, pid: int, name: str,
                values: Dict[str, float]) -> None:
        """Counter-track sample (occupancy timelines)."""
        if not self.enabled:
            return
        self.events.append(TraceEvent(
            name=name, ph="C", ts=self._now(), pid=pid, tid=0,
            args={k: float(v) for k, v in values.items()}))

    # ---- inspection (tests) -------------------------------------------

    def open_spans(self) -> List[Span]:
        return [sp for st in self._stacks.values() for sp in st]

    def span_events(self, pid: Optional[int] = None,
                    tid: Optional[int] = None) -> List[TraceEvent]:
        return [e for e in self.events if e.ph == "X"
                and (pid is None or e.pid == pid)
                and (tid is None or e.tid == tid)]

    def event_stream(self) -> List[Tuple]:
        """Canonical (ph, name, ts, pid, tid, args) tuples (two runs of
        the same input give equal streams)."""
        return [(e.ph, e.name, round(e.ts, 9), e.pid, e.tid,
                 tuple(sorted((e.args or {}).items())))
                for e in self.events]

    # ---- export -------------------------------------------------------

    def to_chrome_trace(self) -> Dict[str, Any]:
        evs: List[Dict[str, Any]] = []
        for (pid, tid), name in sorted(self._track_names.items()):
            evs.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": tid, "args": {"name": name}})
        for pid, pname in ((PID_ENGINE, "engine"),
                           (PID_REQUESTS, "requests"),
                           (PID_EVENTS, "events"),
                           (PID_DEVICE, "device")):
            evs.append({"name": "process_name", "ph": "M", "pid": pid,
                        "tid": 0, "args": {"name": pname}})
        evs.extend(e.to_chrome() for e in self.events)
        return {"traceEvents": evs, "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)


class Telemetry:
    """Facade bundling registry + tracer + cache-dynamics cadence.

    ``Telemetry.disabled()`` is the default everywhere: the registry
    still exists (metric objects are only materialized when something
    renders them) but the tracer early-returns and cache-dynamics
    sampling is off, so the engine hot loop pays one attribute check.
    """

    def __init__(self, *, registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 clock: Optional[Callable[[], float]] = None,
                 dynamics_every: int = 0):
        self.registry = registry or MetricsRegistry()
        self.tracer = tracer or Tracer(clock=clock, enabled=False)
        if clock is not None:
            self.tracer.clock = clock
        # 0 = off; N = sample DecodeSession.cache_dynamics() every N
        # engine steps (host-side proxy diffing).
        self.dynamics_every = int(dynamics_every)

    @classmethod
    def disabled(cls) -> "Telemetry":
        return cls(tracer=Tracer(enabled=False))

    @classmethod
    def enabled(cls, clock: Optional[Callable[[], float]] = None,
                dynamics_every: int = 1) -> "Telemetry":
        return cls(tracer=Tracer(clock=clock, enabled=True),
                   clock=clock, dynamics_every=dynamics_every)

    @property
    def tracing(self) -> bool:
        return self.tracer.enabled
