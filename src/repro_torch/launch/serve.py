"""Serving launcher: run the batched SPA-Cache engine on a freshly
initialized reduced model (the JAX package's ``launch/serve.py``, same
flags and summary).

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --requests 4 --gen-len 6 --canvas 24 --max-batch 2 \
      --pool-pages 10 --page-size 4

``--device`` picks where it runs (default: the CUDA card).  In paged mode
the shared-prefix cache is on unless ``--no-prefix-cache`` is given; with
it, half the requests are distinct prompts served one by one (each
publishes its prefill pages) and the rest repeat them, so the summary's
prefix line shows hits.  ``--host-pages N`` adds the host-RAM page tier
under the prefix index (``--host-dtype`` f32, int8 or auto), and the
summary's tier line counts demotions, drops and promotions.

``--serve`` runs the online front end instead of the offline loop: an
asyncio HTTP server on ``--port`` that streams per-token ndjson events per
request (``POST /generate``; ``GET /stats``, ``/metrics``,
``/debug/requests``, ``/debug/pool``), until interrupted.  ``--slo-ttft`` /
``--slo-deadline`` (seconds; 0 = off) turn on the SLO-aware policy and give
the ``--client`` request its SLO.  ``--client HOST:PORT`` streams one demo
request against a running server and prints each event's arrival.
``--trace-out PATH`` writes a Chrome trace of the run; ``--metrics``
samples the cache dynamics every step and prints the whole metrics
registry (the non-zero part always prints).

``--supervise`` wraps the engine in the fault supervisor (invariant
checks, NaN quarantine, watchdog, degradation ladder); ``--chaos-seed N``
injects faults at every site at ``--chaos-rate`` a probe, replayable from
the seed (it implies ``--supervise``).  The fault counters print with the
registry at exit, and an aborted request's output as ``<faulted>``.

``--ckpt PATH`` serves the weights of a checkpoint (``training/
checkpoint.py``; one the JAX package wrote loads too) instead of random
ones.  ``--profile`` fences every lane step into refresh / dispatch /
device_wait and prints the decomposition and the three lane signatures
traced most; ``--torch-trace-dir DIR`` (with ``--profile``) also wraps the
offline run in ``torch.profiler`` and writes ``DIR/trace.json``.  Any
``--arch`` of ``repro_torch.configs`` serves, the recurrent RecurrentGemma
and Mamba2 stacks included.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys

import numpy as np

from repro_torch.configs import get_arch, reduced
from repro_torch.core import runtime
from repro_torch.core.strategy import REGISTRY, strategy_from_spec
from repro_torch.dlm.decoding import DecodeSettings
from repro_torch.models import transformer
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.faults import FAULT_SITES, FaultPlan
from repro_torch.serving.profiling import StepProfiler
from repro_torch.serving.slo import SLOPolicy
from repro_torch.serving.telemetry import Telemetry, Tracer
from repro_torch.training.checkpoint import load_checkpoint
from repro_torch.weights import from_numpy_params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llada-8b")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--canvas", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--parallel-threshold", type=float, default=0.0)
    ap.add_argument("--strategy", default="",
                    choices=[""] + sorted(REGISTRY),
                    help="cache strategy override (default: cfg.spa)")
    ap.add_argument("--kernel-backend", default="",
                    choices=["", "torch", "cuda"],
                    help="hot-path kernel backend (default cuda: the CUDA "
                         "kernels on the card, their plain versions on "
                         "the CPU; torch = the plain versions everywhere)")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card)")
    ap.add_argument("--static-batching", action="store_true",
                    help="disable step-granular continuous batching")
    ap.add_argument("--pool-pages", type=int, default=0,
                    help="paged serving: total pages in the device cache "
                         "pool (page 0 is the reserved zero page); 0 = "
                         "dense per-lane slabs")
    ap.add_argument("--page-size", type=int, default=16,
                    help="canvas rows per cache page (the canvas length "
                         "must be a multiple)")
    ap.add_argument("--prefix-cache", dest="prefix_cache",
                    action="store_true", default=True,
                    help="shared-prefix radix cache: reuse prefill pages "
                         "across requests with matching prompt prefixes "
                         "and canvas layout (paged mode only; default on)")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false")
    ap.add_argument("--host-pages", type=int, default=0,
                    help="host-RAM page tier under the prefix index, its "
                         "budget in exact pages: evicted entries demote "
                         "there and promote back on a hit; 0 = off")
    ap.add_argument("--host-dtype", default="auto",
                    choices=["auto", "f32", "int8"],
                    help="host tier representation: f32 = promotions "
                         "bit-identical; int8 = about twice the pages; "
                         "auto = int8 for stable pages only")
    ap.add_argument("--serve", action="store_true",
                    help="online mode: run the asyncio streaming front end "
                         "instead of the offline batch loop")
    ap.add_argument("--port", type=int, default=8411)
    ap.add_argument("--slo-ttft", type=float, default=0.0,
                    help="TTFT target (s) attached to client requests; "
                         "enables the SLO-aware policy")
    ap.add_argument("--slo-deadline", type=float, default=0.0,
                    help="e2e deadline (s) for client requests")
    ap.add_argument("--client", default="",
                    help="HOST:PORT: run a streaming client against a "
                         "running --serve front end and exit")
    ap.add_argument("--supervise", action="store_true",
                    help="wrap the engine in the fault supervisor: "
                         "invariant checks, NaN quarantine, watchdog, "
                         "degradation ladder")
    ap.add_argument("--chaos-seed", type=int, default=-1,
                    help="inject faults at every site, replayable from "
                         "this seed; -1 = off")
    ap.add_argument("--chaos-rate", type=float, default=0.02,
                    help="firing probability a probe of every fault site "
                         "with --chaos-seed")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome trace JSON of the run (request "
                         "lifecycle spans, engine phases) to this path")
    ap.add_argument("--metrics", action="store_true",
                    help="sample the SPA cache dynamics every step and "
                         "print the whole metrics registry at exit")
    ap.add_argument("--profile", action="store_true",
                    help="fence every lane step into refresh / dispatch / "
                         "device_wait and print the decomposition and the "
                         "top-3 traced lane signatures at exit")
    ap.add_argument("--torch-trace-dir", default="",
                    help="with --profile: also wrap the offline run in "
                         "torch.profiler and write DIR/trace.json (Chrome "
                         "trace)")
    args = ap.parse_args(argv)
    if args.torch_trace_dir and not args.profile:
        ap.error("--torch-trace-dir needs --profile")
    if args.client:
        return _run_client(args)

    cfg = reduced(get_arch(args.arch))
    if args.ckpt:
        tree, meta = load_checkpoint(args.ckpt)
        params = from_numpy_params(tree, cfg, args.device)
        print(f"loaded checkpoint {args.ckpt} ({meta})")
    else:
        params = transformer.init_params(cfg, seed=0, device=args.device)
        print("no checkpoint given; serving an untrained reduced model")

    strategy = None
    if args.strategy:
        strategy = strategy_from_spec(
            dataclasses.replace(cfg.spa, identifier=args.strategy))
    if args.kernel_backend:
        strategy = (strategy or strategy_from_spec(cfg.spa)) \
            .with_backend(args.kernel_backend)
    slo_policy = SLOPolicy() if args.slo_ttft or args.slo_deadline else None
    fault_plan = None
    if args.chaos_seed >= 0:
        fault_plan = FaultPlan(seed=args.chaos_seed,
                               rates={s: args.chaos_rate for s in FAULT_SITES})
        print(f"chaos: seed={args.chaos_seed} rate={args.chaos_rate} on all "
              f"sites")
    telemetry = None
    if args.trace_out or args.metrics or args.profile:
        telemetry = Telemetry(tracer=Tracer(enabled=bool(args.trace_out)),
                              dynamics_every=1 if args.metrics else 0)
    profiler = None
    if args.profile:
        profiler = StepProfiler(
            telemetry, torch_trace_dir=args.torch_trace_dir or None)
    engine = ServingEngine(
        cfg, params, max_batch=args.max_batch, canvas_len=args.canvas,
        strategy=strategy, continuous=not args.static_batching,
        pool_pages=args.pool_pages, page_size=args.page_size,
        prefix_cache=args.prefix_cache, host_pages=args.host_pages,
        host_dtype=args.host_dtype, slo_policy=slo_policy,
        fault_plan=fault_plan, supervise=args.supervise, telemetry=telemetry,
        profiler=profiler,
        settings=DecodeSettings(parallel_threshold=args.parallel_threshold),
        device=args.device)
    if args.serve:
        return _serve_online(engine, args)
    with (profiler.torch_trace() if profiler is not None
          else contextlib.nullcontext()):
        _run_offline(engine, args)
    _summarize(engine, args)
    if profiler is not None and profiler.trace_path:
        print(f"torch trace -> {profiler.trace_path}")
    for req in engine.done[:3]:
        out = ("<faulted>" if req.output is None
               else f"{req.output[:10]}...")
        print(f"  req {req.uid}: out={out}")
    return 0


def _run_offline(engine, args) -> None:
    """Serve ``--requests`` random prompts.  With the prefix index, the
    first half are distinct prompts served one at a time (a cold request
    publishes only if the pool has a run's worth of pages to spare, which
    it rarely has beside a full batch), then the rest repeat them
    together, with one repeat held back and submitted at priority 5 after
    two engine steps (preemption on a full pool), and the last served
    alone."""
    cfg = engine.cfg
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size - 1,
                            int(rng.integers(6, 18))).astype(np.int32)
               for _ in range(args.requests)]
    if engine.prefix is None or args.requests < 2:
        for prompt in prompts:
            engine.submit(prompt, args.gen_len)
        engine.run()
        return
    uniq = prompts[: args.requests // 2]
    wall = 0.0
    for prompt in uniq:
        engine.submit(prompt, args.gen_len)
        engine.run()
        wall += engine._wall
    repeats = [uniq[(i + 1) % len(uniq)]
               for i in range(args.requests - len(uniq))]
    churn, late = repeats[:-1], []
    if len(churn) > 1:
        churn, late = churn[:-1], [churn[-1]]

    def on_step(e):
        if late and e.stats.steps >= 2:
            e.submit(late.pop(), args.gen_len, priority=5)

    for prompt in churn:
        engine.submit(prompt, args.gen_len)
    engine.run(on_step=on_step)
    wall += engine._wall
    while late:                  # the churn finished before step 2
        engine.submit(late.pop(), args.gen_len, priority=5)
        engine.run()
        wall += engine._wall
    engine.submit(repeats[-1], args.gen_len)
    engine.run()
    engine._wall += wall


def _summarize(engine, args) -> None:
    """End-of-run report: the headline, latency percentiles and SLO counts
    when anything completed, the paged pool's accounting, the metrics
    registry (non-zero series; all of them with ``--metrics``) and the
    trace file."""
    stats = engine.stats
    print(f"served {stats.requests_done} requests, "
          f"{stats.tokens_committed} tokens, {stats.steps} steps, "
          f"{stats.swaps} slot swaps, {stats.tps(engine._wall):.1f} tok/s")
    if stats.requests_done:
        pct = stats.percentiles()
        print(f"latency: e2e p50={pct['e2e_p50'] * 1e3:.0f}ms "
              f"p95={pct['e2e_p95'] * 1e3:.0f}ms | queue-wait "
              f"p50={pct['wait_p50'] * 1e3:.0f}ms "
              f"p95={pct['wait_p95'] * 1e3:.0f}ms")
        print(f"streaming: TTFT p50={pct['ttft_p50'] * 1e3:.0f}ms "
              f"p95={pct['ttft_p95'] * 1e3:.0f}ms | TPOT "
              f"p50={pct['tpot_p50'] * 1e3:.0f}ms "
              f"p95={pct['tpot_p95'] * 1e3:.0f}ms | SLO "
              f"{stats.slo_met} met / {stats.slo_missed} missed, "
              f"{stats.requests_shed} shed, "
              f"{stats.requests_canceled} canceled")
    else:
        print("latency: no requests completed")
    if engine.profiler is not None:
        _print_profile(engine)
    if engine.paged:
        print(f"pool: peak {stats.peak_pool_util:.1%} steady "
              f"{stats.steady_pool_util:.1%} of {engine.pool.capacity} "
              f"pages, {stats.preemptions} preemptions, "
              f"{stats.admission_stalls} admission stalls")
    if engine.prefix is not None:
        print(f"prefix: {stats.prefix_hits} hits ({stats.prefix_full_hits} "
              f"full), {stats.prefix_tokens_saved} prefill rows saved, "
              f"{stats.prefix_published} pages published "
              f"({stats.prefix_publish_skipped} skipped), "
              f"{stats.prefix_evicted_pages} evicted, "
              f"{engine.prefix.held_pages} held")
    if engine.host_pool is not None:
        host = engine.host_pool
        print(f"tier: {stats.prefix_demoted_pages} pages demoted, "
              f"{stats.prefix_dropped_pages} dropped, "
              f"{stats.prefix_promoted_pages} promoted in "
              f"{stats.prefix_promotions} promotions "
              f"({stats.promotion_stalls} stalls), "
              f"{engine.prefix.host_held_pages} held; host peak "
              f"{stats.peak_host_util:.1%} of {host.capacity_units} units "
              f"({engine.tier.host_dtype})")
    print("metrics registry " + "-" * 46)
    print(engine.telemetry.registry.format_summary(
        skip_zero=not args.metrics))
    if args.trace_out:
        engine.export_trace(args.trace_out)
        print(f"trace: {len(engine.telemetry.tracer.events)} events -> "
              f"{args.trace_out} (load in Perfetto / chrome://tracing)")


def _print_profile(engine) -> None:
    """``--profile`` report: the step-time decomposition and the three lane
    signatures traced most (zero profiled steps print a placeholder)."""
    print("step-time decomposition " + "-" * 39)
    print(engine.profiler.format_summary())
    top = runtime.compile_tracker().top_retraced(3)
    if top:
        print("most-retraced lane signatures:")
        for lane, n in top:
            print(f"  {n:4d} traces  {lane or '<unlabeled>'}")
    else:
        print("most-retraced lane signatures: none recorded")


def _serve_online(engine, args) -> int:
    """``--serve``: run the asyncio streaming front end until interrupted,
    then print the summary."""
    import asyncio

    from repro_torch.serving.frontend import AsyncFrontend

    async def amain():
        front = AsyncFrontend(engine, port=args.port, max_steps=4096)
        await front.start(serve_http=True)
        print(f"serving on http://{front.host}:{front.port}: POST "
              f"/generate {{prompt, gen_len, slo?}} streams ndjson; GET "
              f"/stats | /metrics (Prometheus) | /debug/requests | "
              f"/debug/pool", flush=True)
        try:
            await asyncio.Event().wait()      # until interrupted
        finally:
            await front.stop()
            _summarize(engine, args)

    try:
        asyncio.run(amain())
    except KeyboardInterrupt:
        pass
    return 0


def _run_client(args) -> int:
    """``--client HOST:PORT``: stream one demo request and print each
    event's arrival, then the server's TTFT / TPOT medians."""
    import asyncio
    import time

    from repro_torch.serving.frontend import fetch_stats, stream_request

    host, _, port = args.client.partition(":")
    prompt = np.random.default_rng(0).integers(0, 128, 8).astype(np.int32)
    slo = None
    if args.slo_ttft or args.slo_deadline:
        slo = {"ttft": args.slo_ttft or 1e9,
               "deadline": args.slo_deadline or 1e9}

    async def amain():
        t0 = time.time()
        n = 0
        async for ev in stream_request(host, int(port), prompt,
                                       args.gen_len, slo=slo):
            dt = time.time() - t0
            if ev["kind"] == "token":
                n += len(ev["tokens"])
                print(f"  +{dt * 1e3:7.1f}ms step {ev['step']:4d} "
                      f"tokens {ev['tokens']}")
            else:
                print(f"  +{dt * 1e3:7.1f}ms {ev['kind']} "
                      f"({n} tokens streamed)")
        stats = await fetch_stats(host, int(port))
        print(f"server: {stats['requests_done']} done, "
              f"TTFT p50={stats['ttft_p50'] * 1e3:.0f}ms, "
              f"TPOT p50={stats['tpot_p50'] * 1e3:.0f}ms")

    asyncio.run(amain())
    return 0


if __name__ == "__main__":
    sys.exit(main())
