"""Process-wide runtime accounting (the JAX package's ``core/runtime.py``).

The names and metrics are the JAX package's; their meanings carry over to
an eager port that compiles nothing at run time:

  * **Executable tracking.** ``track_executables`` registers a loaded
    kernel library (``kernels/_lib.py``) or a captured CUDA graph in a
    process-wide weak set; ``live_executable_count`` counts them.  On the
    CPU nothing is loaded and the count is 0.
  * **The one executable dropper.** ``drop_executables`` releases every
    tracked CUDA graph and, on a card, empties the caching allocator.  A
    loaded kernel library stays loaded.
  * **Trace accounting.** :class:`CompileTracker` counts *traces*: the
    first call of a wrapped entry point (``serve_step``,
    ``prefill_partial``, ``decode_loop``) at a new argument signature.
    That is when the JAX package retraces its jitted function, and when a
    CUDA graph of the call would be captured.  The signature is a cheap
    key the caller computes from what it already knows (batch, canvas,
    paged or dense, cache dtype, strategy), never a walk over tensors.
    Compile events are the kernel library's nvcc build (stage
    ``backend_compile``, none when the built library loads from disk).

Counting is always on: it costs one hash and one set lookup a call.
"""
from __future__ import annotations

import functools
import threading
import weakref
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

__all__ = [
    "track_executables", "live_executable_count", "drop_executables",
    "CompileTracker", "compile_tracker",
]

_LOCK = threading.Lock()
_TRACKED: "weakref.WeakSet" = weakref.WeakSet()


def track_executables(obj: Any) -> Any:
    """Register a loaded kernel library or a captured CUDA graph for
    live-executable accounting and return it unchanged."""
    with _LOCK:
        _TRACKED.add(obj)
    return obj


def live_executable_count() -> int:
    """Loaded kernel libraries plus captured CUDA graphs still alive."""
    with _LOCK:
        return len(_TRACKED)


def drop_executables(note: str = "") -> int:
    """Release every tracked CUDA graph and, with a card, empty the caching
    allocator.  Returns how many graphs were released; prints ``note``
    when given."""
    import torch
    with _LOCK:
        graphs = [o for o in _TRACKED if isinstance(o, torch.cuda.CUDAGraph)]
        for g in graphs:
            _TRACKED.discard(g)
    for g in graphs:
        g.reset()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    if note:
        print(f"[runtime] {note} (dropped {len(graphs)} tracked "
              f"executables)", flush=True)
    return len(graphs)


class CompileTracker:
    """Process-wide trace and compile accounting.

    ``wrap(fn, name=..., lane=..., signature=...)`` returns a function that
    calls ``fn`` and, when ``signature(*args, **kwargs)`` is new for this
    wrapper, counts one trace of ``name`` and of ``lane``.  Each wrapper
    keeps its own signatures, as each jitted function keeps its own cache.
    ``record_event`` adds a compile stage's duration.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.traces: Dict[str, int] = {}        # fn name -> trace count
        self.lane_traces: Dict[str, int] = {}   # lane signature -> count
        self.event_counts: Dict[str, int] = {}
        self.event_seconds: Dict[str, float] = {}

    # ---- trace counting ----------------------------------------------

    def wrap(self, fn: Callable, *, name: str, lane: str = "",
             signature: Optional[Callable[..., Hashable]] = None
             ) -> Callable:
        """Count traces of ``fn``: the first call at each signature (no
        ``signature``: the first call only).  Arguments pass through
        untouched."""
        seen: set = set()

        @functools.wraps(fn)
        def counted(*args, **kwargs):
            key = signature(*args, **kwargs) if signature else ()
            if key not in seen:
                seen.add(key)
                with self._lock:
                    self.traces[name] = self.traces.get(name, 0) + 1
                    if lane:
                        self.lane_traces[lane] = \
                            self.lane_traces.get(lane, 0) + 1
            return fn(*args, **kwargs)
        return counted

    def trace_count(self, name: Optional[str] = None) -> int:
        with self._lock:
            if name is not None:
                return self.traces.get(name, 0)
            return sum(self.traces.values())

    def top_retraced(self, k: int = 3) -> List[Tuple[str, int]]:
        """Lane signatures by descending trace count (``serve --profile``)."""
        with self._lock:
            items = sorted(self.lane_traces.items(),
                           key=lambda kv: (-kv[1], kv[0]))
        return items[:k]

    # ---- compile durations -------------------------------------------

    def record_event(self, stage: str, seconds: float) -> None:
        """One compile event of ``stage`` (the kernel library's nvcc build
        reports ``backend_compile``)."""
        with self._lock:
            self.event_counts[stage] = self.event_counts.get(stage, 0) + 1
            self.event_seconds[stage] = \
                self.event_seconds.get(stage, 0.0) + float(seconds)

    # ---- exposition --------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """JSON-safe dump."""
        with self._lock:
            return {
                "traces": dict(self.traces),
                "lane_traces": dict(self.lane_traces),
                "event_counts": dict(self.event_counts),
                "event_seconds": {k: round(v, 6) for k, v in
                                  self.event_seconds.items()},
                "live_executables": live_executable_count(),
            }

    def export_metrics(self, registry) -> None:
        """Mirror the counters into a metrics registry (the engine's
        collector): the ``spa_runtime_*`` series."""
        with self._lock:
            traces = dict(self.traces)
            events = dict(self.event_counts)
            seconds = dict(self.event_seconds)
        for name, n in sorted(traces.items()):
            registry.counter(
                "spa_runtime_trace_total",
                "entry-point traces (first call at a new signature)",
                labels={"fn": name}).set(n)
        for key, n in sorted(events.items()):
            registry.counter(
                "spa_runtime_compile_events_total",
                "compile events by stage",
                labels={"stage": key}).set(n)
        for key, s in sorted(seconds.items()):
            registry.counter(
                "spa_runtime_compile_seconds_total",
                "compile wall time by stage",
                labels={"stage": key}).set(s)
        registry.gauge(
            "spa_runtime_live_executables",
            "loaded kernel libraries and captured CUDA graphs",
        ).set(live_executable_count())

    def reset(self) -> None:
        """Zero all counters (tests, run boundaries).  Wrappers keep the
        signatures they have seen, as jitted functions keep their caches."""
        with self._lock:
            self.traces.clear()
            self.lane_traces.clear()
            self.event_counts.clear()
            self.event_seconds.clear()


_TRACKER = CompileTracker()


def compile_tracker() -> CompileTracker:
    """The process-wide tracker."""
    return _TRACKER
