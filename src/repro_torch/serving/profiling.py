"""Compute-path profiling beneath the telemetry facade (the JAX package's
``serving/profiling.py``; its DESIGN.md §12).

Three cooperating pieces, all off by default (construct nothing and the
decode path is untouched):

  * :class:`StepProfiler`: a decomposition of the decode step.  In
    host-loop mode (``DecodeSession.run`` / ``step``) the session fences
    consecutive segments with ``time.perf_counter`` reads they share:
    ``refresh`` (copy-on-write and cache rebuild, then a device sync),
    ``dispatch`` (the host issuing the step's kernel launches; on the CPU
    it computes the step) and ``device_wait`` (``torch.cuda.synchronize``
    on the session's device; nothing on the CPU).  So the segments tile
    the step: their sum equals the recorded total up to float summation.
    ``run_compiled`` is observed at loop level only, as in the JAX
    package, where the loop is one ``lax.while_loop``.  Observations land
    in the metrics registry (``spa_profile_*``) and, with a live tracer, as
    slices on the device track (``PID_DEVICE``).  ``torch_trace_dir``
    wraps a run in ``torch.profiler`` with a Chrome-trace export (the JAX
    package's ``jax_trace_dir``).
  * :class:`KernelPhaseProbes`: per-phase attribution of the SPA pipeline
    (identify, gather, attend, scatter, page_gather), replayed through the
    session's ``KernelBackend`` at config-derived shapes and timed with a
    first-call / steady split.  On a card these are the hand-written
    kernels (``cosine_drift``, ``gather_norm``, ``sparse_attention``,
    ``scatter_update_multi``, ``gather_pages``).  They never touch a
    session's state.
  * :class:`ProfileStore`: timing records persisted as JSON in the JAX
    store's format, key for key (``BENCH_artifacts/kernel_profiles.json``).

Everything here is host-side and runs between the step's calls, so decode
outputs are the same with profiling on.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.serving.telemetry import PID_DEVICE, Telemetry, TraceEvent

__all__ = [
    "time_compile_steady", "StepProfiler", "KernelPhaseProbes",
    "ProfileStore", "default_profile_path", "sync_outputs",
]


def sync_outputs(out: Any) -> None:
    """Wait for the device that holds ``out`` (a tensor, or a tuple, list
    or dict of them); nothing when it lies on the CPU."""
    stack = [out]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
                return
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (tuple, list)):
            stack.extend(x)


def time_compile_steady(fn: Callable, *args,
                        reps: int = 5) -> Tuple[float, float]:
    """(first-call seconds, best-of-reps steady seconds) of ``fn(*args)``,
    each call waited for on its device.  The first call pays whatever is
    built on first use (the kernel library's nvcc build, cuBLAS handles),
    so the records keep both numbers."""
    t0 = time.perf_counter()
    sync_outputs(fn(*args))
    compile_s = time.perf_counter() - t0
    best = float("inf")
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        sync_outputs(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return compile_s, best


class StepProfiler:
    """Fenced step-segment observation into the registry and the device
    track.

    ``sample_every=N`` fences every Nth step (1 = all); unsampled steps run
    the exact unprofiled path.  Hand it to ``DecodeSession(profiler=...)`` or
    ``ServingEngine(profiler=...)``; sessions call :meth:`observe_step` /
    :meth:`observe_loop` with the durations they measured.
    """

    SEGMENTS = ("refresh", "dispatch", "device_wait")

    def __init__(self, telemetry: Optional[Telemetry] = None, *,
                 sample_every: int = 1,
                 torch_trace_dir: Optional[str] = None):
        self.telemetry = telemetry or Telemetry.disabled()
        self.registry = self.telemetry.registry
        self.tracer = self.telemetry.tracer
        self.sample_every = max(int(sample_every), 1)
        self.torch_trace_dir = torch_trace_dir
        self.trace_path: Optional[str] = None
        self.steps_observed = 0
        self.loops_observed = 0
        self._lane_tids: Dict[str, int] = {}

    # ---- sampling ----------------------------------------------------

    def should_sample(self, step_idx: int) -> bool:
        return step_idx % self.sample_every == 0

    # ---- observation (called by DecodeSession) -----------------------

    def _tid(self, lane: str) -> int:
        tid = self._lane_tids.get(lane)
        if tid is None:
            tid = len(self._lane_tids) + 1
            self._lane_tids[lane] = tid
            self.tracer.name_track(PID_DEVICE, tid, f"device:{lane}")
        return tid

    def _hist(self, segment: str):
        return self.registry.histogram(
            "spa_profile_step_seconds",
            "fenced decode-step segment durations (host-loop mode)",
            labels={"segment": segment})

    def observe_step(self, lane: str, segments: Dict[str, float],
                     total_s: float) -> None:
        """One fenced host-loop step: ``segments`` tile ``total_s``."""
        self.steps_observed += 1
        for seg, dt in segments.items():
            self._hist(seg).observe(dt)
        self._hist("total").observe(total_s)
        if self.tracer.enabled:
            tid = self._tid(lane)
            end = float(self.tracer.clock())
            t = end - total_s
            for seg, dt in segments.items():
                self.tracer.events.append(TraceEvent(
                    name=f"step:{seg}", ph="X", ts=t, dur=dt,
                    pid=PID_DEVICE, tid=tid, cat="device"))
                t += dt

    def observe_loop(self, lane: str, steps: int,
                     total_s: float) -> None:
        """One ``run_compiled`` loop: loop level only (per-step averages
        derived)."""
        self.loops_observed += 1
        self.registry.histogram(
            "spa_profile_loop_seconds",
            "whole compiled-loop durations (run_compiled mode)",
        ).observe(total_s)
        self.registry.counter(
            "spa_profile_loop_steps_total",
            "decode steps executed inside compiled loops").inc(steps)
        if steps > 0:
            self.registry.histogram(
                "spa_profile_loop_step_seconds",
                "derived per-step average inside compiled loops",
            ).observe(total_s / steps)
        if self.tracer.enabled:
            tid = self._tid(lane)
            end = float(self.tracer.clock())
            self.tracer.events.append(TraceEvent(
                name=f"loop[{steps} steps]", ph="X", ts=end - total_s,
                dur=total_s, pid=PID_DEVICE, tid=tid, cat="device"))

    # ---- torch.profiler wrap -----------------------------------------

    @contextlib.contextmanager
    def torch_trace(self):
        """Wrap a run in ``torch.profiler`` (CPU activity, and CUDA on a
        card) when a trace dir was given, and export a Chrome trace to
        ``<torch_trace_dir>/trace.json`` (:attr:`trace_path`).  Raises when
        the profiler cannot start; a no-op without a trace dir."""
        if not self.torch_trace_dir:
            yield None
            return
        from torch import profiler as tp
        activities = [tp.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(tp.ProfilerActivity.CUDA)
        os.makedirs(self.torch_trace_dir, exist_ok=True)
        with tp.profile(activities=activities) as prof:
            yield prof
        path = os.path.join(self.torch_trace_dir, "trace.json")
        prof.export_chrome_trace(path)
        self.trace_path = path

    # ---- summaries ---------------------------------------------------

    def step_breakdown(self) -> Dict[str, Dict[str, float]]:
        """{segment: {count, mean_s, p50_s, p95_s, share}} from the
        recorded histograms (share = segment sum / total sum).  Empty when
        nothing was observed."""
        out: Dict[str, Dict[str, float]] = {}
        total_sum = 0.0
        hists = {}
        for seg in self.SEGMENTS + ("total",):
            h = self._hist(seg)
            if h.count:
                hists[seg] = h
                if seg == "total":
                    total_sum = h.sum
        for seg, h in hists.items():
            out[seg] = {
                "count": h.count, "mean_s": h.mean,
                "p50_s": h.percentile(50), "p95_s": h.percentile(95),
                "share": (h.sum / total_sum) if total_sum else 0.0,
            }
        return out

    def format_summary(self) -> str:
        """The decomposition as ``serve --profile`` prints it."""
        lines: List[str] = []
        bd = self.step_breakdown()
        if bd:
            lines.append("step-time decomposition (host-loop, fenced):")
            for seg in self.SEGMENTS + ("total",):
                row = bd.get(seg)
                if row is None:
                    continue
                lines.append(
                    f"  {seg:<12s} n={row['count']:<6d}"
                    f" mean={row['mean_s'] * 1e3:8.3f}ms"
                    f" p95={row['p95_s'] * 1e3:8.3f}ms"
                    f" share={row['share']:6.1%}")
        loop_h = self.registry.histogram(
            "spa_profile_loop_seconds",
            "whole compiled-loop durations (run_compiled mode)")
        if loop_h.count:
            step_h = self.registry.histogram(
                "spa_profile_loop_step_seconds",
                "derived per-step average inside compiled loops")
            lines.append(
                f"compiled loops: n={loop_h.count}"
                f" mean={loop_h.mean * 1e3:.3f}ms"
                f" per-step={step_h.mean * 1e3:.3f}ms (derived)")
        if not lines:
            return "  (no profiled steps recorded)"
        return "\n".join("  " + ln for ln in lines)


class KernelPhaseProbes:
    """Synthetic per-phase replay of the SPA pipeline through a
    KernelBackend (identify, gather, attend, scatter, page_gather).

    Shapes come from (cfg, strategy): proxy rank, head layout and d_model
    are the model's; batch, canvas, selection width and page are probe
    parameters.  Inputs are seeded normals in ``dtype`` (the JAX probes'
    f32 by default) on ``device``.  Each phase is timed with the first-call
    / steady split and records ``spa_profile_phase_seconds{phase=,backend=}``
    histograms; :meth:`run` also returns the kernel launches each phase
    made (one steady call's worth).
    """

    def __init__(self, cfg, *, strategy=None, backend=None,
                 batch: int = 2, seq: int = 128,
                 n_selected: Optional[int] = None, page: int = 16,
                 registry=None, dtype: torch.dtype = torch.float32,
                 device=None):
        from repro_torch.core.strategy import resolve_strategy
        from repro_torch.device import resolve_device
        from repro_torch.kernels.backend import resolve_backend
        self.cfg = cfg
        self.strategy = resolve_strategy(cfg, strategy)
        self.backend = (resolve_backend(backend) if backend is not None
                        else self.strategy.backend)
        self.batch = batch
        self.seq = seq
        self.n_selected = n_selected or max(8, seq // 4)
        self.page = page
        self.registry = registry
        self.dtype = dtype
        self.device = resolve_device(device)

    def _build(self) -> Dict[str, Tuple[Callable, tuple]]:
        cfg, strat, bk = self.cfg, self.strategy, self.backend
        b, n, k = self.batch, self.seq, self.n_selected
        d, hh, kvh, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)

        def normal(*shape):
            return torch.randn(shape, generator=gen, device=self.device,
                               dtype=torch.float32).to(self.dtype)

        x = normal(b, n, d)
        idx = torch.sort(torch.randint(0, n, (b, k), generator=gen,
                                       device=self.device)).values
        norm_w = normal(d) * 0.1
        q = normal(b, k, hh, hd)
        kk = normal(b, n, kvh, hd)
        vv = normal(b, n, kvh, hd)
        probes: Dict[str, Tuple[Callable, tuple]] = {}
        r = strat.proxy_dim(cfg)
        if r:
            probes["identify"] = (
                lambda pn, pc: bk.score_drift(strat, pn, pc),
                (normal(b, n, r), normal(b, n, r)))
        probes["gather"] = (
            lambda h, i, w: bk.gather_norm(h, i, w, cfg.norm_eps),
            (x, idx, norm_w))
        probes["attend"] = (
            lambda a, c, e, i: bk.attention(a, c, e, q_positions=i),
            (q, kk, vv, idx))
        rows_k = normal(b, k, kvh, hd)
        rows_h = normal(b, k, d)
        probes["scatter"] = (
            lambda bk_, bv_, bh_, i, rk, rv, rh: bk.scatter_multi(
                {"k": bk_, "v": bv_, "h": bh_}, i,
                {"k": rk, "v": rv, "h": rh}),
            (kk.clone(), vv.clone(), x.clone(), idx, rows_k, rows_k, rows_h))
        n_log = max(n // self.page, 1)
        n_pages = b * n_log + 1
        arena = normal(1, n_pages, self.page, hd)
        ptab = torch.randint(0, n_pages, (b, n_log), generator=gen,
                             device=self.device, dtype=torch.int32)
        probes["page_gather"] = (lambda a, pt: bk.gather_pages(a, pt),
                                 (arena, ptab))
        return probes

    def run(self, reps: int = 3) -> Dict[str, Dict[str, Any]]:
        """Time every phase probe; returns (and records)
        {phase: {compile_s, steady_s, launches}}."""
        from repro_torch.kernels import _lib
        out: Dict[str, Dict[str, Any]] = {}
        for phase, (fn, args) in self._build().items():
            compile_s, steady_s = time_compile_steady(fn, *args, reps=reps)
            before = _lib.launch_counts()
            sync_outputs(fn(*args))
            after = _lib.launch_counts()
            launches = {name: after[name] - before[name] for name in after
                        if after[name] != before[name]}
            out[phase] = {"compile_s": compile_s, "steady_s": steady_s,
                          "launches": launches}
            if self.registry is not None:
                labels = {"phase": phase, "backend": self.backend.name}
                self.registry.histogram(
                    "spa_profile_phase_seconds",
                    "synthetic per-phase replay (steady state)",
                    labels=labels).observe(steady_s)
                self.registry.histogram(
                    "spa_profile_phase_compile_seconds",
                    "synthetic per-phase replay (first call)",
                    labels=labels).observe(compile_s)
        return out


def default_profile_path() -> str:
    """``BENCH_artifacts/kernel_profiles.json`` at the repository root,
    wherever the caller runs from."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    return os.path.join(root, "BENCH_artifacts", "kernel_profiles.json")


class ProfileStore:
    """JSON-persisted timing records keyed on canonical key strings.

    Records are JSON dicts keyed by sorted ``k=v`` pairs
    (``backend=cuda|kernel=sparse_attention|shape=b2n256...``), in the JAX
    store's file format (``{"version": 1, "records": {...}}``), so either
    package reads the other's file.
    """

    VERSION = 1

    def __init__(self, path: Optional[str] = None):
        self.path = path or default_profile_path()
        self._records: Dict[str, Dict[str, Any]] = {}
        self.load()

    @staticmethod
    def key_of(**key: Any) -> str:
        return "|".join(f"{k}={key[k]}" for k in sorted(key))

    def load(self) -> None:
        if not os.path.exists(self.path):
            return
        try:
            with open(self.path) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError):
            return
        if isinstance(data, dict):
            recs = data.get("records")
            if isinstance(recs, dict):
                self._records = recs

    def save(self) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "w") as f:
            json.dump({"version": self.VERSION,
                       "records": self._records}, f, indent=1,
                      sort_keys=True)

    def get(self, **key: Any) -> Optional[Dict[str, Any]]:
        return self._records.get(self.key_of(**key))

    def put(self, record: Dict[str, Any], **key: Any) -> None:
        self._records[self.key_of(**key)] = {
            "key": {k: key[k] for k in sorted(key)}, **record}

    def __len__(self) -> int:
        return len(self._records)

    @property
    def records(self) -> Dict[str, Dict[str, Any]]:
        return dict(self._records)
