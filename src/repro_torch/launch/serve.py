"""Serving launcher: run the batched SPA-Cache engine on a freshly
initialized reduced model (the offline path of the JAX package's
``launch/serve.py``, same flags and summary).

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --requests 4 --gen-len 6 --canvas 24 --max-batch 2 \
      --pool-pages 10 --page-size 4

``--device`` picks where it runs (default: the CUDA card).  Flags of the
engine parts that wait for later slices of the port (the prefix cache,
host tier, online front end, SLO policy, faults, telemetry, profiling,
checkpoints) are accepted by the parser and exit with an error that names
them; the prefix cache is therefore off by default here.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

from repro_torch.configs import get_arch, reduced
from repro_torch.core.strategy import REGISTRY, strategy_from_spec
from repro_torch.dlm.decoding import DecodeSettings
from repro_torch.models import transformer
from repro_torch.serving.engine import ServingEngine

# flag -> the value that leaves it off; any other value is an error
_LATER_FLAGS = {"ckpt": "", "prefix_cache": False, "host_pages": 0,
                "host_dtype": "auto", "serve": False, "slo_ttft": 0.0,
                "slo_deadline": 0.0, "client": "", "supervise": False,
                "chaos_seed": -1, "trace_out": "", "metrics": False,
                "profile": False, "jax_trace_dir": ""}


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
                    action="store_true", default=False)
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false")
    ap.add_argument("--host-pages", type=int, default=0)
    ap.add_argument("--host-dtype", default="auto",
                    choices=["auto", "f32", "int8"])
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--port", type=int, default=8411)
    ap.add_argument("--slo-ttft", type=float, default=0.0)
    ap.add_argument("--slo-deadline", type=float, default=0.0)
    ap.add_argument("--client", default="")
    ap.add_argument("--supervise", action="store_true")
    ap.add_argument("--chaos-seed", type=int, default=-1)
    ap.add_argument("--chaos-rate", type=float, default=0.02)
    ap.add_argument("--trace-out", default="")
    ap.add_argument("--metrics", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--jax-trace-dir", default="")
    args = ap.parse_args(argv)
    waiting = ["--" + name.replace("_", "-")
               for name, off in _LATER_FLAGS.items()
               if getattr(args, name) != off]
    if waiting:
        ap.error(f"{', '.join(waiting)}: not ported yet (the prefix cache, "
                 f"host tier, online front end, SLO policy, faults, "
                 f"telemetry, profiling and checkpoints wait for later "
                 f"slices of the port)")

    cfg = reduced(get_arch(args.arch))
    params = transformer.init_params(cfg, seed=0, device=args.device)
    print("no checkpoint given; serving an untrained reduced model")

    strategy = None
    if args.strategy:
        strategy = strategy_from_spec(
            dataclasses.replace(cfg.spa, identifier=args.strategy))
    if args.kernel_backend:
        strategy = (strategy or strategy_from_spec(cfg.spa)) \
            .with_backend(args.kernel_backend)
    engine = ServingEngine(
        cfg, params, max_batch=args.max_batch, canvas_len=args.canvas,
        strategy=strategy, continuous=not args.static_batching,
        pool_pages=args.pool_pages, page_size=args.page_size,
        settings=DecodeSettings(parallel_threshold=args.parallel_threshold),
        device=args.device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size - 1,
                            int(rng.integers(6, 18))).astype(np.int32)
               for _ in range(args.requests)]
    for prompt in prompts:
        engine.submit(prompt, args.gen_len)
    engine.run()
    _summarize(engine)
    for req in engine.done[:3]:
        print(f"  req {req.uid}: out={req.output[:10]}...")
    return 0


def _summarize(engine) -> None:
    """End-of-run report: the headline, latency percentiles when anything
    completed, and the paged pool's accounting."""
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
              f"p95={pct['tpot_p95'] * 1e3:.0f}ms")
    else:
        print("latency: no requests completed")
    if engine.paged:
        print(f"pool: peak {stats.peak_pool_util:.1%} steady "
              f"{stats.steady_pool_util:.1%} of {engine.pool.capacity} "
              f"pages, {stats.preemptions} preemptions, "
              f"{stats.admission_stalls} admission stalls")


if __name__ == "__main__":
    sys.exit(main())
